"""Checkpoints: the JAX package's on-disk format v2 (``checkpointer``,
its tree structure in ``treedef``), LargeVis's schemas over it
(``largevis_state``: fitted models and pipeline stage checkpoints) and
the trainer's periodic saves and resume (``manager``)."""
