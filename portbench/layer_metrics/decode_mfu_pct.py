"""The decode's share of the chip's peak: the net's FLOP for every frame of
the timed requests over their time (host clock, each request synchronised)
and the float32 peak (the decode runs float32 products with TF32 off)."""

from portbench import roofline


def read(r):
    if "requests_s" not in r or r["requests_s"] <= 0:
        return None
    flop = r["frames"] * roofline.forward_flop_per_row(r["sizes"])
    return 100.0 * flop / r["requests_s"] / roofline.F32_FLOPS
