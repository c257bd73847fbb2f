"""The CRN decode's share of the chip's peak: the net's FLOP (crn_roofline:
encoder, LSTMs and decoder products) for every frame of the timed requests
over their time (host clock, each request synchronised) and the float32
peak (the decode runs float32 products with TF32 off)."""

from portbench import roofline


def read(r):
    if r.get("requests_s", 0) <= 0 or "flop_per_frame" not in r:
        return None
    return 100.0 * r["frames"] * r["flop_per_frame"] / r["requests_s"] / roofline.F32_FLOPS
