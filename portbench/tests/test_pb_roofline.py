"""The operation and byte counts and the peaks, pinned."""

import pytest

from portbench import roofline

NET_8K = (1548, 2048, 2048, 2048, 129)
NET_16K = (3084, 2048, 2048, 2048, 257)


@pytest.mark.parametrize("sizes, gflop", [(NET_8K, 8.269), (NET_16K, 10.08)])
def test_train_flop_per_bunch(sizes, gflop):
    assert roofline.train_flop_per_bunch(sizes, 128) / 1e9 == pytest.approx(gflop, abs=5e-3)


@pytest.mark.parametrize("sizes, mb", [(NET_8K, 190.1), (NET_16K, 245.5)])
def test_train_bytes_per_bunch(sizes, mb):
    assert roofline.train_bytes_per_bunch(sizes, 128) / 1e6 == pytest.approx(mb, abs=0.05)


@pytest.mark.parametrize("sizes, ms", [(NET_8K, 0.0568), (NET_16K, 0.0733)])
def test_train_bound_is_bytes(sizes, ms):
    bound = roofline.train_bound_s_per_bunch(sizes, 128)
    assert bound * 1e3 == pytest.approx(ms, abs=5e-5)
    assert bound == roofline.train_bytes_per_bunch(sizes, 128) / roofline.HBM_BYTES_S


@pytest.mark.parametrize("sizes, mflop", [(NET_8K, 23.65), (NET_16K, 30.46)])
def test_forward_flop_per_frame(sizes, mflop):
    assert roofline.forward_flop_per_row(sizes) / 1e6 == pytest.approx(mflop, abs=5e-3)


def test_peaks():
    assert (roofline.BF16_FLOPS, roofline.F32_FLOPS, roofline.HBM_BYTES_S) == (989e12, 67e12,
                                                                                3.35e12)
