"""Per call, the wall time in which no chain step was in flight: from the
end of the last device activity a call launched to the start of the next
call's first forward kernel (the pipeline's batching, uploads, gather and
return), averaged over the traced calls' boundaries."""


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    calls, fwd = tr.range("pb.call"), tr.range("pb.forward")
    first = [None] * len(calls)
    last = [None] * len(calls)
    for s, e, _, _, t in tr.activities:
        c = calls.index(t)
        if c < 0:
            continue
        last[c] = e if last[c] is None else max(last[c], e)
        if fwd.index(t) >= 0 and (first[c] is None or s < first[c]):
            first[c] = s
    gaps = [first[c] - last[c - 1] for c in range(1, len(calls))
            if first[c] is not None and last[c - 1] is not None]
    return sum(gaps) / len(gaps) / 1e3 if gaps else None
