"""The share of the traced epoch's time outside the chunk trainer's calls:
the epoch permutation, the chunk gathers, the CV pass and whatever the
device waited for the host.  The trainer's time is the device's copies of
the "chunk_train" label in the trace (first operation launched inside a
call to the last one's end)."""


def read(r):
    s = r.get("slice") or {}
    train_s = (s.get("device_label_s") or {}).get("chunk_train")
    if "bunches" not in r or not train_s or s.get("window_s", 0) <= 0:
        return None
    return 100.0 * (s["window_s"] - train_s) / s["window_s"]
