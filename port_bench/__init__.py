"""The benchmark of dvc_tpu_torch: see port_bench/README.md."""
