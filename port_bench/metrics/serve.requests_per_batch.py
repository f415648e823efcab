"""Requests a micro-batch over the window: the service's own counters,
Δrequests / Δbatches between the window's start and its last reply."""


def read(records: dict):
    c = records.get("counters") or {}
    if not c.get("batches"):
        return None
    return c["requests"] / c["batches"]
