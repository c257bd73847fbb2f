"""The share of the traced epoch (its permutation, gathers, chunk calls and
CV pass) in which no kernel ran: 100 less the union of the kernel spans
over the epoch's time."""


def read(r):
    s = r.get("slice") or {}
    if "bunches" not in r or not s.get("busy_s") or s.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
