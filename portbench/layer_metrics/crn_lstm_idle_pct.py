"""How much of the CRN's recurrence the device waits on the host: 100 x the
idle gaps of the breakdown put down to the program's "sednn.decode.crn.lstm"
span (the innermost span the host was in when the device went idle) over
that span's device copies in the traced slice.  High where a step's two
launches cost the host more than the device; None where the program has no
such span."""

SPAN = "sednn.decode.crn.lstm"


def read(r):
    s = r.get("slice") or {}
    under = s.get("device_label_s") or {}
    if under.get(SPAN, 0) <= 0:
        return None
    gaps = (s.get("breakdown") or {}).get("idle_gaps") or []
    return 100.0 * sum(v for k, v in gaps if k == SPAN) / under[SPAN]
