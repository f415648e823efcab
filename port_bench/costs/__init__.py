"""Operation and byte counts from shapes, and the chip's published peaks.

These are the yardstick of the benchmark: the per-layer metrics divide
these counts by measured time, so they read the same work whatever
implements it.  Nothing here imports the program.
"""

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
