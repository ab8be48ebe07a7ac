"""Models: the printed classifiers the search trains (MLP, linear SVM)
and the LM substrate's dense/audio/moe decoder (layers, transformer,
moe, serving, steps)."""
