"""Latent-swap conversion and the vocoder."""
