"""The port's pipeline stages: KNN graph, edge weights, samplers, layout,
metrics; and the methods the paper compares with (``baselines``)."""
