"""The conv sites' summed bound (each site at the precision it runs:
operations at 989 / 1979 / 67 TOP/s for bf16 / int8 / f32 or bytes at
3.35 TB/s, whichever is larger; harness/work.py) over the device time
inside the conv-site ranges, a quantized site's quantize glue included;
percent."""

from harness.trace import device_s


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    s = device_s(tr, "pb.conv")
    if s <= 0:
        return None
    return 100.0 * rec["work"]["conv_bound_s"] * rec["traced_forwards"] / s
