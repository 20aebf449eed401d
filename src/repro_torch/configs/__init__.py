"""LargeVis hyper-parameters."""
