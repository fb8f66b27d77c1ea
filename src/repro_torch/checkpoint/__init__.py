"""Training checkpoints."""
