"""Port's Rand48 and TrainFlags against the JAX package's: the drand48 /
lrand48 stream, the uniform draws and the Fisher-Yates shuffle bit for bit
(tolerance: none), the key=value parsing and the parameter echo text."""

import numpy as np
import pytest

from tpu_sednn.config import TrainFlags as JFlags
from tpu_sednn.data.rand48 import Rand48 as JRand48
from tpu_sednn_torch.config import TrainFlags
from tpu_sednn_torch.data.rand48 import Rand48


@pytest.mark.parametrize("seed", [0, 7, 27863875, 2**31 + 5])
def test_scalar_streams_bit_exact(seed):
    a, b = Rand48(seed), JRand48(seed)
    assert [a.drand48() for _ in range(50)] == [b.drand48() for _ in range(50)]
    assert [a.lrand48() for _ in range(50)] == [b.lrand48() for _ in range(50)]
    assert a.x == b.x


@pytest.mark.parametrize("n", [1, 17, 70000])  # 70000 crosses a jump-ahead block
def test_uniform_bit_exact(n):
    a, b = Rand48(11), JRand48(11)
    ua, ub = a.uniform(-0.1, 0.1, n), b.uniform(-0.1, 0.1, n)
    assert ua.dtype == np.float32
    np.testing.assert_array_equal(ua, ub)
    assert a.x == b.x and a.lrand48() == b.lrand48()


@pytest.mark.parametrize("n", [0, 1, 2, 33, 1000, 5000])  # 5000: the native route where built
def test_shuffle_bit_exact(n):
    a, b = Rand48(345), JRand48(345)
    np.testing.assert_array_equal(a.shuffle_indices(n), b.shuffle_indices(n))
    va, vb = np.arange(n, dtype=np.int64)[::-1].copy(), np.arange(n, dtype=np.int64)[::-1].copy()
    np.testing.assert_array_equal(a.shuffle_inplace(va), b.shuffle_inplace(vb))
    assert a.x == b.x
    if n > 1:
        assert sorted(va.tolist()) == list(range(n))


def test_shuffle_python_route_equals_native_route():
    from tpu_sednn_torch.io import native

    if not native.shuffle_available():
        pytest.skip("native/libsednn_native.so cannot be loaded here")
    a, b = Rand48(99), Rand48(99)
    vec = np.arange(6000, dtype=np.int64)
    via_native = a.shuffle_inplace(vec.copy())
    via_python = b.shuffle_inplace(vec.astype(np.int32))  # int32 takes the Python loop
    np.testing.assert_array_equal(via_native, via_python)
    assert a.x == b.x


ARGV = ["fea_file=a.pfile", "norm_file=a.norm", "targ_file=t.pfile", "outwts_file=o.wts",
        "train_sent_range=0-7", "cv_sent_range=8-9", "fea_dim=5", "fea_context=3",
        "targ_offset=1", "dropoutflag=1", "traincache=200", "bunchsize=16",
        "init_randem_seed=7", "momentum=0.54", "weightcost=1e-5", "lrate=0.3",
        "visible_omit=0.1", "hid_omit=0.2", "layersizes=20,32,5", "engine=xla",
        "device_splice=0", "cv_out_file=cv.txt", "weights_txt=w.txt"]


def test_flags_parse_and_echo_like_jax():
    got, want = TrainFlags.from_argv(ARGV), JFlags.from_argv(ARGV)
    for name in vars(want):
        assert getattr(got, name) == getattr(want, name), name
    assert got.device == "cuda"  # the port's one extra key, and its default
    assert got.echo() == want.echo() + "\ndevice: cuda"
    assert got.numlayers == 3 and got.sent_range("train") == (0, 7) and got.sent_range("cv") == (8, 9)
    got.validate()
    assert TrainFlags.from_argv(ARGV + ["device=cpu"]).device == "cpu"


@pytest.mark.parametrize("argv,exc,match", [
    (["nokey"], ValueError, "not key=value"),
    (["bogus=1"], ValueError, "unknown flag"),
])
def test_flags_reject_bad_arguments(argv, exc, match):
    with pytest.raises(exc, match=match):
        TrainFlags.from_argv(argv)
    with pytest.raises(exc, match=match):
        JFlags.from_argv(argv)


def test_flags_validate():
    with pytest.raises(ValueError, match="layersizes"):
        TrainFlags.from_argv(["layersizes=10,4,3", "fea_dim=5", "fea_context=3"]).validate()
    with pytest.raises(ValueError, match="format error"):
        TrainFlags.from_argv(["train_sent_range=5"]).sent_range("train")
    # data parallelism is ported: gpu_used > 1 validates (the command then
    # checks that as many processes run), as the JAX flags do
    TrainFlags.from_argv(["gpu_used=2"]).validate()
    JFlags.from_argv(["gpu_used=2"]).validate()
