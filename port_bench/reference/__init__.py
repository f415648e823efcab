"""Plain PyTorch and NumPy references that decide ``correct``.

Frozen copies of the published arithmetic, written against state dicts
that the benchmark makes from the seed.  Nothing here imports the program
(``dvc_tpu_torch``), the JAX package or JAX.
"""
