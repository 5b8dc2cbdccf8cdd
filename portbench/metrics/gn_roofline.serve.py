"""The GroupNorms' byte bound (GroupNorm + FiLM + SiLU reads x once and
writes y once, at 3.35 TB/s; harness/work.py) over the device time inside
the GroupNorm ranges; percent."""

from harness.trace import device_s


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    s = device_s(tr, "pb.gn")
    if s <= 0:
        return None
    return 100.0 * rec["work"]["gn_bound_s"] * rec["traced_forwards"] / s
