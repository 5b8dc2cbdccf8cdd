"""The share of the traced window in which no device activity ran: one
less the union of activity intervals over the window; percent."""


def read(rec):
    w = rec.get("window_s") or 0.0
    if w <= 0 or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / w)
