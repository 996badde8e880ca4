"""Training: the train step and its guarded optimizers, checkpoints,
visualization grids, and import of reference checkpoints."""
