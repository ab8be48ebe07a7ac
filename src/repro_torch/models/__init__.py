"""Models: the printed classifiers the search trains (MLP, linear SVM)
and the LM substrate's dense/audio/moe/ssm/hybrid decoder (layers,
transformer, moe, ssm, serving, steps)."""
