"""Checkpoints: the JAX package's on-disk format v2 (``checkpointer``,
its tree structure in ``treedef``) and LargeVis's schemas over it
(``largevis_state``: fitted models and pipeline stage checkpoints)."""
