"""The CRN's recurrence as a share of its roofline: the least time of the
traced slice's recurrences (crn_roofline.lstm_bound_s: each layer's input
projection and step products at the float32 peak, each step's cell update
at HBM bandwidth) over the device's copies of the program's
"sednn.decode.crn.lstm" span in the slice (each from the first operation
launched inside it to the last one's end).  None where the program has no
such span."""

SPAN = "sednn.decode.crn.lstm"


def read(r):
    under = (r.get("slice") or {}).get("device_label_s") or {}
    if under.get(SPAN, 0) <= 0 or "lstm_bound_s" not in r:
        return None
    return 100.0 * r["lstm_bound_s"] / under[SPAN]
