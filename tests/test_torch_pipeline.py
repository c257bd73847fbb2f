"""Port's chunk input pipeline against the JAX package's on the same seeded
pfiles: the chunk plan, the parity chunk reader and the indexed reader +
on-device chunk construction give the JAX package's (X, T).  Exact, except the NAT
columns built on the device (a mean summed in another order: rtol 1e-6,
atol 1e-6)."""

import numpy as np
import pytest
import torch

import tpu_sednn.data.device_chunk as jdc
import tpu_sednn.data.pipeline as jpipe
from tpu_sednn.data.rand48 import Rand48 as JRand48
from tpu_sednn.io.pfile import read_pfile_info as j_info
import tpu_sednn_torch.data.device_chunk as tdc
import tpu_sednn_torch.data.pipeline as tpipe
from tpu_sednn_torch.data.prefetch import Prefetcher, prefetch_chunks
from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.io import compute_norm, read_pfile_info, write_pfile

D, D_OUT, CONTEXT, TO = 3, 4, 5, 2


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.default_rng(0)
    lens = list(rng.integers(3, 40, 14))  # some shorter than the context
    utts = [rng.standard_normal((n, D)).astype(np.float32) for n in lens]
    targs = [rng.standard_normal((n, D_OUT)).astype(np.float32) for n in lens]
    fp, tp = str(tmp_path / "f.pfile"), str(tmp_path / "t.pfile")
    write_pfile(fp, utts)
    write_pfile(tp, targs)
    mean, istd = compute_norm(np.concatenate(utts))
    return fp, tp, mean, istd, utts, targs


@pytest.mark.parametrize("traincache", [16, 50, 1000])
@pytest.mark.parametrize("sent_range", [(0, 13), (2, 9), (5, 5)])
def test_plan_chunks_equals_jax(corpus, traincache, sent_range):
    fp = corpus[0]
    fbs = read_pfile_info(fp, D).frames_before_sent
    got = tpipe.plan_chunks(fbs, sent_range, CONTEXT, traincache)
    want = jpipe.plan_chunks(j_info(fp, D).frames_before_sent, sent_range, CONTEXT, traincache)
    np.testing.assert_array_equal(got.chunk_frame_st, want.chunk_frame_st)
    assert (got.total_chunks, got.total_samples, got.sent_st, got.sent_en, got.traincache) == \
        (want.total_chunks, want.total_samples, want.sent_st, want.sent_en, want.traincache)


def test_plan_chunks_rejects_bad_range(corpus):
    fbs = read_pfile_info(corpus[0], D).frames_before_sent
    with pytest.raises(ValueError):
        tpipe.plan_chunks(fbs, (3, 99), CONTEXT, 50)


@pytest.mark.parametrize("shuffled", [True, False])
@pytest.mark.parametrize("nat", [True, False])
def test_read_chunk_parity_equals_jax(corpus, shuffled, nat):
    fp, tp, mean, istd, _, _ = corpus
    fi, ti = read_pfile_info(fp, D), read_pfile_info(tp, D_OUT)
    jfi, jti = j_info(fp, D), j_info(tp, D_OUT)
    plan = tpipe.plan_chunks(fi.frames_before_sent, (0, 13), CONTEXT, 40)
    jplan = jpipe.plan_chunks(jfi.frames_before_sent, (0, 13), CONTEXT, 40)
    ra, rb = (Rand48(5), JRand48(5)) if shuffled else (None, None)
    assert plan.total_chunks >= 3
    for ci in range(plan.total_chunks):
        x, t = tpipe.read_chunk_parity(fi, ti, plan, ci, CONTEXT, TO, mean, istd, ra, nat=nat)
        jx, jt = jpipe.read_chunk_parity(jfi, jti, jplan, ci, CONTEXT, TO, mean, istd, rb, nat=nat,
                                         use_native=False)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(t, jt)
        assert x.shape[1] == D * CONTEXT + (D if nat else 0)


def test_read_chunk_parity_native_route(corpus):
    from tpu_sednn_torch.io import native

    if not native.available():
        pytest.skip("native/libsednn_native.so cannot be loaded here")
    fp, tp, mean, istd, _, _ = corpus
    fi, ti = read_pfile_info(fp, D), read_pfile_info(tp, D_OUT)
    plan = tpipe.plan_chunks(fi.frames_before_sent, (0, 13), CONTEXT, 40)
    a = tpipe.read_chunk_parity(fi, ti, plan, 1, CONTEXT, TO, mean, istd, Rand48(5), use_native=True)
    b = tpipe.read_chunk_parity(fi, ti, plan, 1, CONTEXT, TO, mean, istd, Rand48(5))
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("shuffled", [True, False])
@pytest.mark.parametrize("padded", [True, False])
def test_indexed_reader_and_device_chunk_equal_jax(corpus, shuffled, padded):
    fp, tp, mean, istd, _, _ = corpus
    fi, ti = read_pfile_info(fp, D), read_pfile_info(tp, D_OUT)
    jfi, jti = j_info(fp, D), j_info(tp, D_OUT)
    plan = tpipe.plan_chunks(fi.frames_before_sent, (0, 13), CONTEXT, 40)
    jplan = jpipe.plan_chunks(jfi.frames_before_sent, (0, 13), CONTEXT, 40)
    caps = tdc.chunk_capacities(fi, plan, CONTEXT)
    assert caps == jdc.chunk_capacities(jfi, jplan, CONTEXT)
    kw = dict(frames_cap=caps[0], samples_cap=caps[1], seg_cap=caps[2]) if padded else {}
    ra, rb, rc = (Rand48(5), JRand48(5), Rand48(5)) if shuffled else (None, None, None)
    for ci in range(plan.total_chunks):
        item = tdc.read_chunk_indexed(fi, ti, plan, ci, CONTEXT, mean, istd, ra, **kw)
        jitem = jdc.read_chunk_indexed(jfi, jti, jplan, ci, CONTEXT, mean, istd, rb, **kw)
        for a, b in zip(item[:6], jitem[:6]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)  # native vs numpy normalize
        assert item[6] == jitem[6]
        x, t = tdc.build_chunk_on_device(*(torch.from_numpy(a) for a in item[:6]), CONTEXT, TO, True)
        jx, jt = jdc.build_chunk_on_device(*jitem[:6], context=CONTEXT, targ_offset=TO, nat=True)
        n = item[6]
        np.testing.assert_allclose(x.numpy()[:n], np.asarray(jx)[:n], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(t.numpy()[:n], np.asarray(jt)[:n])
        # and the parity reader's own (X, T): splice columns exact, NAT to rounding
        px, pt = tpipe.read_chunk_parity(fi, ti, plan, ci, CONTEXT, TO, mean, istd, rc)
        np.testing.assert_array_equal(x.numpy()[:n, : D * CONTEXT], px[:, : D * CONTEXT])
        np.testing.assert_allclose(x.numpy()[:n, D * CONTEXT:], px[:, D * CONTEXT:],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(t.numpy()[:n], pt)
        xn, _ = tdc.build_chunk_on_device(*(torch.from_numpy(a) for a in item[:6]), CONTEXT, TO, False)
        assert xn.shape[1] == D * CONTEXT


def test_splice_nat_and_training_arrays_equal_jax(corpus):
    _, _, mean, istd, utts, targs = corpus
    for u in utts[:4]:
        np.testing.assert_array_equal(tpipe.splice(u, CONTEXT), jpipe.splice(u, CONTEXT))
        np.testing.assert_array_equal(tpipe.nat_estimate(u), jpipe.nat_estimate(u))
    x, t = tpipe.build_training_arrays(utts, targs, CONTEXT, TO, True, mean, istd)
    jx, jt = jpipe.build_training_arrays(utts, targs, CONTEXT, TO, True, mean, istd)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(t, jt)
    with pytest.raises(ValueError):
        tpipe.build_training_arrays([utts[0][:2]], [targs[0][:2]], CONTEXT, TO)


def test_segments_in_chunk_equal_jax(corpus):
    fbs = read_pfile_info(corpus[0], D).frames_before_sent
    for start, n in [(0, int(fbs[-1])), (7, 50), (int(fbs[2]), 9)]:
        assert tpipe._segments_in_chunk(fbs, start, n) == jpipe._segments_in_chunk(fbs, start, n)


def test_prefetcher_keeps_order_and_raises():
    seen = []

    def produce(i):
        seen.append(i)
        return i * i

    assert list(Prefetcher(range(7), produce, depth=2)) == [i * i for i in range(7)]
    assert seen == list(range(7))  # one worker: items produced strictly in order
    assert list(prefetch_chunks([3, 1], produce)) == [9, 1]

    def boom(i):
        if i == 2:
            raise KeyError("chunk 2")
        return i

    with pytest.raises(KeyError):
        list(Prefetcher(range(4), boom))
