"""The share of the traced slice (back-to-back requests) in which the device
waited while the host was inside the serving decoder: 100 x the idle gaps of
the breakdown (`idle_gaps`, each gap put down to the innermost span the
host was in when the device went idle) under the program's "sednn.decode"
span and its stages ("sednn.decode.*"), over the slice's time.  A driver's
label is not counted.  None where the program has no decode spans (no
device copy of "sednn.decode.forward" in `device_label_s`)."""

PREFIX = "sednn.decode"


def read(r):
    s = r.get("slice") or {}
    if "sednn.decode.forward" not in (s.get("device_label_s") or {}) or s.get("window_s", 0) <= 0:
        return None
    gaps = (s.get("breakdown") or {}).get("idle_gaps") or []
    idle = sum(v for k, v in gaps if k == PREFIX or k.startswith(PREFIX + "."))
    return 100.0 * idle / s["window_s"]
