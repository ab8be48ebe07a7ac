"""Models: the printed classifiers the search trains (MLP, linear SVM)
and the LM substrate's dense/audio decoder (layers, transformer, serving,
steps)."""
