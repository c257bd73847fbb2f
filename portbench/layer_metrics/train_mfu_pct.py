"""The training step's share of the chip's peak: the model FLOP of the bunches
the traced epoch trained (forward, weight gradients, input gradients of
every layer but the first) over the traced epoch's time (its permutation,
gathers and CV pass included) and the peak of the configuration's
products."""

from portbench import roofline


def read(r):
    s = r.get("slice") or {}
    if "bunches" not in r or s.get("window_s", 0) <= 0:
        return None
    peak = roofline.BF16_FLOPS if r["products"] == "bf16" else roofline.F32_FLOPS
    flop = r["bunches"] * roofline.train_flop_per_bunch(r["sizes"], r["bunch"])
    return 100.0 * flop / s["window_s"] / peak
