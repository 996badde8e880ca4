"""Weight import from reference checkpoints."""
