"""Device ms a chain step spends outside the model's forward: the step
noise draws and the ancestral step's arithmetic (kernels launched in a
call's range outside the forward's)."""

from harness.trace import device_s


def read(rec):
    tr = rec.get("trace")
    if tr is None or not rec["traced_forwards"]:
        return None
    s = device_s(tr, "pb.call", ("pb.forward",), kernels_only=True)
    return s * 1e3 / rec["traced_forwards"] if s > 0 else None
