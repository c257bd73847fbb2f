"""The decode's signal processing as a share of the traced slice: 100 x the
device seconds of the program's STFT, features and overlap-add spans
("sednn.decode.stft", "sednn.decode.features", "sednn.decode.istft": their
copies on the device's timeline in `device_label_s`, each from the first
operation launched inside the span to the last one's end), over the slice's
time.  None where the program has no decode spans (no device copy of
"sednn.decode.forward")."""

STAGES = ("sednn.decode.stft", "sednn.decode.features", "sednn.decode.istft")


def read(r):
    s = r.get("slice") or {}
    under = s.get("device_label_s") or {}
    if "sednn.decode.forward" not in under or s.get("window_s", 0) <= 0:
        return None
    return 100.0 * sum(under.get(k, 0.0) for k in STAGES) / s["window_s"]
