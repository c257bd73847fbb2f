"""The chunk trainer's share of its roofline: the least time a bunch could
take (the larger of its FLOP at the products' peak and its bytes at HBM
bandwidth, roofline.train_bound_s_per_bunch) over the trainer's time a
bunch (the device's copies of the "chunk_train" label in the traced
epoch's trace, over the bunches trained)."""

from portbench import roofline


def read(r):
    train_s = ((r.get("slice") or {}).get("device_label_s") or {}).get("chunk_train")
    if "bunches" not in r or not train_s:
        return None
    bound = roofline.train_bound_s_per_bunch(r["sizes"], r["bunch"])
    return 100.0 * bound * r["bunches"] / train_s
