"""Data pipelines: the paired mel datasets, preprocessing, and the GE2E
speaker samplers (numpy draws on the host; the resident pool on the device)."""
