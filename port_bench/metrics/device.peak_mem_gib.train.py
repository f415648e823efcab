"""The window's peak of allocated device memory in GiB:
torch.cuda.max_memory_allocated after reset_peak_memory_stats at the
window's start."""


def read(records: dict):
    peak = records.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
