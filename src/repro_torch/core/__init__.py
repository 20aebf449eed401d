"""The port's pipeline stages: KNN graph, edge weights, samplers, layout,
metrics."""
