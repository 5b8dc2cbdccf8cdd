"""Host ms from the model's forward pre-hook to its post-hook, the time the
host takes to issue one forward (the call returns before the device is
done), averaged over the run's untraced forwards."""


def read(rec):
    ms = rec.get("host_forward_ms") or []
    return sum(ms) / len(ms) if ms else None
