"""Device ms a forward spends outside its conv sites and GroupNorms: the
time embedding, FiLM denses, concatenations, pooling and residual adds
(activities launched in the forward's range outside the conv-site and
GroupNorm ranges)."""

from harness.trace import device_s


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec["traced_forwards"]:
        return None
    s = device_s(tr, "pb.forward", ("pb.conv", "pb.gn"))
    return s * 1e3 / rec["traced_forwards"] if s > 0 else None
