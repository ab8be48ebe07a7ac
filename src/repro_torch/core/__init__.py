"""ADC semantics (spec, pruned-tree LUTs) and deployment artifacts."""
