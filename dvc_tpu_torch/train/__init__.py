"""Training: the group-VAE losses, the trainer, and checkpoint save,
discovery and resume."""
