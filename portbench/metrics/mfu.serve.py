"""The whole step's share of the chip's peak: a forward's conv work, each
site's operations at its precision's peak, over the wall time of a chain
step of the run's untraced calls (their whole time, chain boundaries
included, over their steps; the profiler slows a traced call's host);
percent."""


def read(rec):
    step_s = rec.get("untraced_step_s") or 0.0
    if step_s <= 0 or not rec.get("work"):
        return None
    return 100.0 * rec["work"]["conv_peak_s"] / step_s
