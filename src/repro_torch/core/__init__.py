"""ADC semantics (spec, pruned-tree LUTs), the area model, NSGA-II, QAT,
the search and deployment artifacts."""
