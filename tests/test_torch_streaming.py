"""The port's streaming enhancers (tpu_sednn_torch/enhance/streaming.py)
against the JAX package's (tpu_sednn/enhance/streaming.py) on the CPU: both
classes at block 1 and 8, lps and irm heads with a target norm, 8 and
16 kHz, on the same seeded chunkings, each below 5e-5 of the JAX class and
of the port's offline decode (the JAX tests' limit); scan_blocks equal to
push to 1e-6; the refusals, the short-stream case, int8 streaming and the
latency bound equal to JAX's."""

import jax
import numpy as np
import pytest

import tpu_sednn.model as jm
from tpu_sednn.dsp.stft import StftConfig as JStft
from tpu_sednn.enhance.decode import EnhanceConfig as JEnh
from tpu_sednn.enhance import streaming as js
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.dsp import StftConfig
from tpu_sednn_torch.enhance import streaming as ts
from tpu_sednn_torch.enhance.decode import EnhanceConfig, enhance_waveform

TOL = 5e-5
CLASSES = {"host": (js.StreamingEnhancer, ts.StreamingEnhancer),
           "device": (js.DeviceStreamingEnhancer, ts.DeviceStreamingEnhancer)}


def _model(sr, head="lps", seed=0, hidden=(256, 256)):
    d = StftConfig.for_rate(sr).n_bins
    kw = dict(layersizes=(d * 12,) + hidden + (d,), dropout_vis=0.1, dropout_hid=0.2,
              output="sigmoid" if head in ("irm", "ibm") else "linear")
    p = jm.init_params(jax.random.PRNGKey(seed), jm.ModelConfig(**kw))
    return p, jm.ModelConfig(**kw), _to_port(p), tm.ModelConfig(**kw)


def _to_port(p):
    return tm.params_from_jax({"w": [np.asarray(w) for w in p["w"]],
                               "b": [np.asarray(b) for b in p["b"]]}, device="cpu")


def _ecfgs(sr, **kw):
    return JEnh(stft=JStft.for_rate(sr), **kw), EnhanceConfig(stft=StftConfig.for_rate(sr), **kw)


def _wav(n, sr, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 440 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _norms(d):
    return np.zeros(d, np.float32), np.full(d, 0.2, np.float32)


def _chunks(x, sizes_seed):
    rng = np.random.default_rng(sizes_seed)
    chunks, i = [], 0
    while i < len(x):
        n = int(rng.integers(1, 900))
        chunks.append(x[i : i + n])
        i += n
    return chunks


def _run(se, chunks):
    return np.concatenate([se.push(c) for c in chunks] + [se.flush()])


HEADS = {"lps": dict(head="lps", min_gain_db=-10.0, max_gain_db=0.0),
         "irm": dict(head="irm", mask_floor=0.05)}


@pytest.mark.parametrize("block_frames", [1, 8])
@pytest.mark.parametrize("kind", ["host", "device"])
@pytest.mark.parametrize("head", ["lps", "irm"])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_streaming_matches_jax_and_offline(sr, head, kind, block_frames):
    p, jcfg, mlp, tcfg = _model(sr, head, seed=4 if head == "irm" else 0)
    je, te = _ecfgs(sr, **HEADS[head])
    d = te.stft.n_bins
    mean, istd = _norms(d)
    # a target norm: denormalizes the lps head's output; the mask heads ignore it
    tn = (np.full(d, 0.3, np.float32), np.full(d, 0.7, np.float32))
    wav = _wav(sr * 2 + 517 if sr == 8000 else sr + 333, sr, seed=9)
    chunks = _chunks(wav, 3 + block_frames)
    jcls, tcls = CLASSES[kind]
    want = _run(jcls(p, jcfg, je, mean, istd, target_norm=tn, block_frames=block_frames), chunks)
    got = _run(tcls(mlp, tcfg, te, mean, istd, target_norm=tn, block_frames=block_frames,
                    device="cpu"), chunks)
    offline = enhance_waveform(mlp, tcfg, te, wav, mean, istd, target_norm=tn, device="cpu")
    assert got.shape == want.shape == offline.shape == wav.shape
    assert float(np.max(np.abs(got - want))) < TOL
    assert float(np.max(np.abs(got - offline))) < TOL


@pytest.mark.parametrize("sr", [8000, 16000])
def test_scan_blocks_equals_push(sr):
    p, jcfg, mlp, tcfg = _model(sr, seed=2)
    _, te = _ecfgs(sr, head="lps")
    mean, istd = _norms(te.stft.n_bins)
    wav = _wav(sr * 2, sr, seed=13)
    B = 8
    step_in = B * te.stft.hop
    se1 = ts.DeviceStreamingEnhancer(mlp, tcfg, te, mean, istd, block_frames=B, device="cpu")
    se2 = ts.DeviceStreamingEnhancer(mlp, tcfg, te, mean, istd, block_frames=B, device="cpu")
    prime = se1._n_prime + 2 * step_in  # primes, then drains two whole blocks
    np.testing.assert_array_equal(se1.push(wav[:prime]), se2.push(wav[:prime]))
    rest = wav[prime:]
    n_blocks = rest.size // step_in
    assert n_blocks >= 5
    blocks = rest[: n_blocks * step_in].reshape(n_blocks, step_in)
    push_out = np.concatenate([se1.push(b) for b in blocks])
    scan_out = se2.scan_blocks(blocks)
    assert scan_out.shape == (n_blocks, step_in)
    np.testing.assert_allclose(scan_out.ravel(), push_out, rtol=0, atol=1e-6)
    tail = rest[n_blocks * step_in:]
    np.testing.assert_allclose(np.concatenate([se2.push(tail), se2.flush()]),
                               np.concatenate([se1.push(tail), se1.flush()]), rtol=0, atol=1e-6)


def test_device_state_without_nat_matches_jax():
    d = 129
    kw = dict(layersizes=(d * 11, 64, d), dropout_vis=0.1, dropout_hid=0.2)
    p = jm.init_params(jax.random.PRNGKey(5), jm.ModelConfig(**kw))
    mlp = _to_port(p)
    je, te = _ecfgs(8000, nat=False, targ_offset=3)
    mean, istd = _norms(d)
    wav = _wav(8000 + 77, 8000, seed=2)
    chunks = _chunks(wav, 8)
    want = _run(js.DeviceStreamingEnhancer(p, jm.ModelConfig(**kw), je, mean, istd,
                                           block_frames=4), chunks)
    got = _run(ts.DeviceStreamingEnhancer(mlp, tm.ModelConfig(**kw), te, mean, istd,
                                          block_frames=4, device="cpu"), chunks)
    assert float(np.max(np.abs(got - want))) < TOL


@pytest.mark.parametrize("n", [100, 700, 1200])
def test_short_stream(n):
    """A stream too short to prime: the device class hands it to the host
    class on its core, as the JAX one does; both equal JAX's output."""
    p, jcfg, mlp, tcfg = _model(8000)
    je, te = _ecfgs(8000)
    mean, istd = _norms(129)
    wav = _wav(n, 8000, seed=n)
    want = _run(js.DeviceStreamingEnhancer(p, jcfg, je, mean, istd), [wav])
    host = _run(ts.StreamingEnhancer(mlp, tcfg, te, mean, istd, device="cpu"), [wav])
    dev = _run(ts.DeviceStreamingEnhancer(mlp, tcfg, te, mean, istd, device="cpu"), [wav])
    assert want.shape == host.shape == dev.shape == (n,)
    np.testing.assert_allclose(host, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(dev, want, rtol=0, atol=TOL)


def test_int8_stream_matches_jax_and_stays_close_to_f32():
    p, jcfg, mlp, tcfg = _model(8000, seed=6)
    je, te = _ecfgs(8000, head="lps")
    mean, istd = _norms(129)
    wav = _wav(8000, 8000, seed=12)
    for kind in ("host", "device"):
        jcls, tcls = CLASSES[kind]
        q8 = _run(tcls(mlp, tcfg, te, mean, istd, quant="int8", device="cpu"), [wav])
        f32 = _run(tcls(mlp, tcfg, te, mean, istd, device="cpu"), [wav])
        jq8 = _run(jcls(p, jcfg, je, mean, istd, quant="int8"), [wav])
        err = np.linalg.norm(q8 - f32) / max(np.linalg.norm(f32), 1e-12)
        assert err < 0.05, err
        # the int32 products are exact in both packages; float32 order can
        # move a row's quantization across a rounding boundary
        np.testing.assert_allclose(q8, jq8, rtol=0, atol=1e-3 * float(np.abs(jq8).max()))


@pytest.mark.parametrize("kind", ["host", "device"])
def test_refusals(kind):
    _, _, mlp, tcfg = _model(8000)
    mean, istd = _norms(129)
    cls = CLASSES[kind][1]
    stft = StftConfig.for_rate(8000)
    for bad in (dict(gv_mode="global"), dict(mask_smooth=5)):
        with pytest.raises(ValueError):
            cls(mlp, tcfg, EnhanceConfig(stft=stft, **bad), mean, istd, device="cpu")
    with pytest.raises(ValueError, match="block_frames"):
        cls(mlp, tcfg, EnhanceConfig(stft=stft), mean, istd, block_frames=0, device="cpu")
    with pytest.raises(ValueError, match="quant mode"):
        cls(mlp, tcfg, EnhanceConfig(stft=stft), mean, istd, quant="int4", device="cpu")
    se = cls(mlp, tcfg, EnhanceConfig(stft=stft), mean, istd, device="cpu")
    se.push(np.zeros(50, np.float32))
    se.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        se.push(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError, match="flushed"):
        se.flush()


def test_device_class_refusals():
    _, _, mlp, tcfg = _model(8000)
    mean, istd = _norms(129)
    stft = StftConfig.for_rate(8000)
    with pytest.raises(ValueError, match="lookahead"):
        ts.DeviceStreamingEnhancer(mlp, tcfg, EnhanceConfig(stft=stft, fea_context=11,
                                                            targ_offset=10),
                                   mean, istd, device="cpu")
    se = ts.DeviceStreamingEnhancer(mlp, tcfg, EnhanceConfig(stft=stft), mean, istd,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="primed"):
        se.scan_blocks(np.zeros((2, 8 * stft.hop), np.float32))
    # priming takes the NAT frames' samples and keeps those past _n_prime
    fed = (EnhanceConfig(stft=stft).nat_frames - 1) * stft.hop + stft.win_len + 5
    se.push(np.zeros(fed, np.float32))
    with pytest.raises(RuntimeError, match="unconsumed"):
        se.scan_blocks(np.zeros((2, 8 * stft.hop), np.float32))
    se.push(np.zeros(8 * stft.hop - (fed - se._n_prime), np.float32))
    with pytest.raises(ValueError, match="blocks must be"):
        se.scan_blocks(np.zeros((2, 7), np.float32))


@pytest.mark.parametrize("sr,context,offset,block", [(8000, 11, 5, 8), (8000, 11, 5, 1),
                                                     (16000, 7, 2, 4), (8000, 3, 1, 16)])
def test_algorithmic_latency_equals_jax(sr, context, offset, block):
    je, te = _ecfgs(sr, fea_context=context, targ_offset=offset)
    d = te.stft.n_bins
    sizes = (d * (context + 1), 8, d)
    p = jm.init_params(jax.random.PRNGKey(0), jm.ModelConfig(layersizes=sizes))
    mlp = _to_port(p)
    mean, istd = _norms(d)
    for jcls, tcls in CLASSES.values():
        want = jcls(p, jm.ModelConfig(layersizes=sizes), je, mean, istd,
                    block_frames=block).algorithmic_latency_samples
        got = tcls(mlp, tm.ModelConfig(layersizes=sizes), te, mean, istd, block_frames=block,
                   device="cpu").algorithmic_latency_samples
        assert got == want == (context - 1 - offset + block - 1) * te.stft.hop + te.stft.win_len
    if (sr, context, offset, block) == (8000, 11, 5, 8):
        assert got == 1792  # 224 ms


def test_progressive_output_and_reset():
    """Output begins within the latency bound plus the NAT warm-up, and
    reset() rearms the instance."""
    _, _, mlp, tcfg = _model(8000)
    _, te = _ecfgs(8000, head="lps")
    mean, istd = _norms(129)
    se = ts.StreamingEnhancer(mlp, tcfg, te, mean, istd, block_frames=1, device="cpu")
    warmup = (te.nat_frames - 1) * te.stft.hop + te.stft.win_len
    wav = _wav(16000, 8000)
    first_at, fed, outs = None, 0, []
    for i in range(0, len(wav), 160):
        out = se.push(wav[i : i + 160])
        fed += len(wav[i : i + 160])
        outs.append(out)
        if first_at is None and out.size:
            first_at = fed
    assert first_at is not None and first_at <= se.algorithmic_latency_samples + warmup
    outs.append(se.flush())
    assert sum(o.size for o in outs) == len(wav)
    se.reset()
    ref = enhance_waveform(mlp, tcfg, te, wav, mean, istd, device="cpu")
    assert float(np.max(np.abs(_run(se, [wav]) - ref))) < TOL


def test_cuda_is_the_default_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without CUDA")
    _, _, mlp, tcfg = _model(8000, hidden=(8,))
    mean, istd = _norms(129)
    for cls in (ts.StreamingEnhancer, ts.DeviceStreamingEnhancer):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(mlp, tcfg, EnhanceConfig(stft=StftConfig.for_rate(8000)), mean, istd)
