"""Seconds a call of the vocoder's ``.batch`` takes (the upsampler and the
sampler for one drain), host clock around the call, which returns host
arrays and so ends synchronized; the mean over the calls the window made."""


def read(records: dict):
    lo, hi = records["window_ns"]
    s = [x["seconds"] for x in records["spans"]
         if x["name"] == "vocoder.batch" and lo <= x["t0"] <= hi]
    return sum(s) / len(s) if s else None
