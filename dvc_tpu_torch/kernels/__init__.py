"""Hand-written CUDA kernels for Hopper (sm_90a), each with a ctypes
binding, a plain PyTorch twin and a launch count.  Nothing is built or
loaded at import; the first CUDA launch builds into build/kernels/."""
