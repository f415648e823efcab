"""Command line: python -m dvc_tpu_torch.cli.run {serve,convert,vocode}."""
