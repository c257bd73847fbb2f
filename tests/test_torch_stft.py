"""Port DSP and the STFT-LPS wrapper against tpu_sednn on the CPU.

On a CPU tensor `stft_lps` runs its plain version; the CUDA kernel itself is
held against that plain version on the card by chip_smoke.py.  Tolerances:
re/im atol 1e-6 of the spectrum's peak magnitude (fp32 sums of up to 512
terms in another order, with partial sums as large as the tone's bin);
waveforms atol 1e-5; LPS, from dsp or stft_lps, atol/rtol 1e-4, as
tests/test_stft_pallas.py holds the Pallas kernel (the log magnifies the
rounding of deep-cancellation bins).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sednn.dsp import stft as jstft
from tpu_sednn.ops.stft_pallas import stft_lps_pallas
from tpu_sednn_torch.dsp import stft as tstft
from tpu_sednn_torch.ops import stft_lps, stft_lps_reference

GEOMS = [8000, 16000, 11025]


def _sig(n, sr=8000, seed=0):
    """A tone over a noise floor, so no bin sits at the 1e-12 power floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * 523 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _cfgs(sr):
    return jstft.StftConfig.for_rate(sr), tstft.StftConfig.for_rate(sr)


@pytest.mark.parametrize("sr", GEOMS)
def test_config_and_matrices_identical(sr):
    jc, tc = _cfgs(sr)
    assert (jc.win_len, jc.hop, jc.n_fft, jc.n_bins) == (tc.win_len, tc.hop, tc.n_fft, tc.n_bins)
    for a, b in zip(jstft._rdft_matrices(jc.win_len, jc.n_fft, jc.window),
                    tstft._rdft_matrices(tc.win_len, tc.n_fft, tc.window)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jstft._irdft_matrices(jc.win_len, jc.n_fft),
                    tstft._irdft_matrices(tc.win_len, tc.n_fft)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sr", GEOMS)
def test_dsp_matches_jax_batched(sr):
    jc, tc = _cfgs(sr)
    xs = np.stack([_sig(3 * sr + 77, sr, seed=s) for s in range(2)])
    xt = torch.from_numpy(xs)
    re_t, im_t = tstft.stft_real_imag(xt, tc)
    lps_t = tstft.stft_logpower(xt, tc)
    np.testing.assert_array_equal(tstft.frame_signal(xt, tc)[1].numpy(),
                                  np.asarray(jstft.frame_signal(jnp.asarray(xs[1]), jc)))
    for i in range(2):
        x = jnp.asarray(xs[i])
        re_j, im_j = jstft.stft_real_imag(x, jc)
        tol = 1e-6 * float(np.sqrt(np.max(np.asarray(re_j) ** 2 + np.asarray(im_j) ** 2)))
        np.testing.assert_allclose(re_t[i].numpy(), np.asarray(re_j), rtol=0, atol=tol)
        np.testing.assert_allclose(im_t[i].numpy(), np.asarray(im_j), rtol=0, atol=tol)
        np.testing.assert_allclose(lps_t[i].numpy(), np.asarray(jstft.stft_logpower(x, jc)),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sr", GEOMS)
@pytest.mark.parametrize("extra", [0, 1000])  # exact frames / zero-padded tail back
def test_istft_and_reconstruct_match_jax(sr, extra):
    jc, tc = _cfgs(sr)
    x = _sig(2 * sr + 33, sr, seed=5)
    re_j, im_j = jstft.stft_real_imag(jnp.asarray(x), jc)
    n = x.size + extra
    y_j = np.asarray(jstft.istft_overlap_add(re_j, im_j, jc, n_samples=n))
    re_t, im_t = torch.tensor(np.asarray(re_j)), torch.tensor(np.asarray(im_j))
    y_t = tstft.istft_overlap_add(re_t, im_t, tc, n_samples=n).numpy()
    assert y_t.shape == y_j.shape == (n,)
    np.testing.assert_allclose(y_t, y_j, atol=1e-5)
    lps = 0.5 * np.asarray(jstft.stft_logpower(jnp.asarray(x), jc)) - 1.0
    r_j = np.asarray(jstft.reconstruct_from_lps(jnp.asarray(lps), re_j, im_j, jc, n))
    r_t = tstft.reconstruct_from_lps(torch.from_numpy(lps), re_t, im_t, tc, n).numpy()
    np.testing.assert_allclose(r_t, r_j, atol=1e-5)
    # batched rows equal the single-row result
    both = tstft.istft_overlap_add(torch.stack([re_t, 2 * re_t]),
                                   torch.stack([im_t, 2 * im_t]), tc, n_samples=n)
    np.testing.assert_allclose(both[0].numpy(), y_t, atol=1e-6)
    np.testing.assert_allclose(both[1].numpy(), 2 * y_t, atol=1e-5)


@pytest.mark.parametrize("sr,n", [(8000, 4096), (8000, 16512), (16000, 50000)])
def test_stft_lps_matches_pallas_interpret(sr, n):
    jc, tc = _cfgs(sr)
    x = _sig(n, sr, seed=3)
    want = np.asarray(stft_lps_pallas(jnp.asarray(x), jc, interpret=True))
    got = stft_lps(torch.from_numpy(x), tc).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [353, 11025 * 2 + 100])  # one frame; ragged tail
def test_stft_lps_generic_geometry_matches_jax(n):
    jc, tc = _cfgs(11025)
    x = _sig(n, 11025, seed=4)
    want = np.asarray(jstft.stft_logpower(jnp.asarray(x), jc))
    got = stft_lps(torch.from_numpy(x), tc).numpy()
    assert got.shape == want.shape == (1 + (n - jc.win_len) // jc.hop, jc.n_bins)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_stft_lps_batch_equals_rows():
    cfg = tstft.StftConfig.for_rate(8000)
    xs = torch.from_numpy(np.stack([_sig(5000, seed=s) for s in range(3)]))
    out = stft_lps(xs, cfg)
    assert out.shape == (3, 1 + (5000 - 256) // 128, 129)
    for i in range(3):
        torch.testing.assert_close(out[i], stft_lps_reference(xs[i], cfg), rtol=0, atol=1e-5)


def test_stft_lps_rejects_bad_input():
    cfg = tstft.StftConfig.for_rate(8000)
    with pytest.raises(ValueError):
        stft_lps(torch.zeros(255), cfg)  # shorter than one window
    with pytest.raises(ValueError):
        stft_lps_reference(torch.zeros(100), cfg)
    with pytest.raises(TypeError):
        stft_lps(torch.zeros(1000, dtype=torch.float64), cfg)
    with pytest.raises(ValueError):
        stft_lps(torch.zeros(2, 2, 1000), cfg)
    assert stft_lps.launches == 0  # CPU tensors never launch the kernel


def test_cuda_requested_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from tpu_sednn_torch import resolve_device
    from tpu_sednn_torch.io import write_wav
    from tpu_sednn_torch.tools.make_pfile import build_pfile

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    wav = str(tmp_path / "a.wav")
    write_wav(wav, _sig(4000), 8000)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_pfile([wav], str(tmp_path / "a.pfile"), None)  # default device is cuda
    assert not (tmp_path / "a.pfile").exists()


# ---------------------------------------------------------------------------
# The kernel's FFT (csrc/stft_lps.cu) cannot run here; its arithmetic can.
# _fft_emulation repeats the kernel's steps in float32 torch, in the kernel's
# order, on the tables the wrapper hands it (ops/stft_lps.py:fft_tables): the
# n_fft real samples windowed into m = 32 r complex points, lane l holding
# z[l + 32 s], s < r; each lane's r-point FFT (radix-2 decimation in
# frequency, out in bit-reversed order); the twiddles W_m^(l k); the 32-point
# FFTs across the lanes (decimation in frequency, as the kernel's shuffles
# do it); the split step into n_fft/2 + 1 bins, Z[m - k] taken from the lane
# and slot where the kernel fetches it.
# ---------------------------------------------------------------------------


def _cmul(a, b):
    return torch.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                        a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], dim=-1)


def _minus_i(d):
    return torch.stack([d[..., 1], -d[..., 0]], dim=-1)


def _brev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _fft_emulation(x: torch.Tensor, cfg) -> torch.Tensor:
    """(n_samples,) float32 -> (n_frames, n_bins, 2) float32 spectrum, as the kernel forms it."""
    from tpu_sednn_torch.ops.stft_lps import fft_tables

    window, twiddle = (torch.from_numpy(a) for a in fft_tables(cfg))
    n_fft, m = cfg.n_fft, cfg.n_fft // 2
    r, lanes = m // 32, torch.arange(32)
    rb = r.bit_length() - 1
    w_r = twiddle[:r // 2]
    w_lk = twiddle[r // 2:r // 2 + 32 * (r - 1)].reshape(max(r - 1, 0), 32, 2)
    w_32 = twiddle[r // 2 + 32 * (r - 1):][:5 * 32].reshape(5, 32, 2)
    w_split = twiddle[r // 2 + 32 * (r - 1) + 5 * 32:]
    assert len(w_split) == 32 * r + 1, "the twiddle table holds more than the steps read"
    frames = torch.zeros(cfg.n_frames(x.shape[-1]), n_fft)
    frames[:, :cfg.win_len] = tstft.frame_signal(x, cfg) * window
    z = torch.stack([frames[:, 0::2], frames[:, 1::2]], dim=-1)  # z[m] = (x[2m], x[2m+1])
    a = [z[:, lanes + 32 * s] for s in range(r)]  # slot s: (frames, lane, 2)
    h = r // 2
    while h >= 1:  # 1. each lane's r-point FFT
        for i in range(r):
            if not i & h:
                u, v = a[i], a[i + h]
                a[i], a[i + h] = u + v, _cmul(u - v, w_r[(i & (h - 1)) * (r // (2 * h))])
        h //= 2
    for s in range(r):  # 2. the twiddles W_m^(l k1)
        if _brev(s, rb):
            a[s] = _cmul(a[s], w_lk[_brev(s, rb) - 1])
    for st in range(5):  # 3. the 32-point FFTs across the lanes
        h, lower = 16 >> st, (lanes & (16 >> st)) == 0
        for s in range(r):
            other = a[s][:, lanes ^ h]
            a[s] = torch.where(lower[None, :, None], a[s] + other,
                               _cmul(other - a[s], w_32[st]))
    spec = torch.zeros(frames.shape[0], m + 1, 2)
    k2 = torch.tensor([_brev(l, 5) for l in range(32)])
    for s in range(r):  # 4. the split step: slot s of lane l holds Z[brev(s) + r brev5(l)]
        k1 = _brev(s, rb)
        src = k2.new_tensor([_brev((32 - k2[l].item()) % 32, 5) if k1 == 0 else 31 - l
                             for l in range(32)])
        zk, zm = a[s], a[_brev((r - k1) % r, rb)][:, src]
        zc = torch.stack([zm[..., 0], -zm[..., 1]], dim=-1)
        spec[:, k1 + r * k2] = 0.5 * (zk + zc) + _cmul(0.5 * _minus_i(zk - zc),
                                                      w_split[s * 32:(s + 1) * 32])
        if k1 == 0:  # bin m, from Z[0] too (lane 0)
            zk0, zm0 = zk[:, 0], zm[:, 0]
            zc0 = torch.stack([zk0[..., 0], -zk0[..., 1]], dim=-1)
            spec[:, m] = 0.5 * (zm0 + zc0) + _cmul(0.5 * _minus_i(zm0 - zc0), w_split[32 * r])
    return spec


def _emulated_lps(x, cfg):
    spec = _fft_emulation(x, cfg)
    return torch.log(torch.clamp(spec[..., 0] ** 2 + spec[..., 1] ** 2, min=tstft.LPS_FLOOR))


FFT_GEOMS = [(8000, 8000 * 2 + 77), (16000, 16000 * 2 + 111), (11025, 11025 * 2 + 100),
             (22050, 22050 * 2 + 100)]
GEOM_2048 = (44100, 44100 + 300)  # n_fft 2048, the kernel's largest (r = 32 slots a lane)


@pytest.mark.parametrize("sr,n", FFT_GEOMS)
def test_fft_emulation_matches_jax(sr, n):
    """The kernel's float32 FFT arithmetic against the JAX package's Pallas
    kernel (interpret mode; XLA where its geometry falls back) and against
    the float64 plain version, at the tolerance tests/test_stft_pallas.py
    holds the Pallas kernel to (atol = rtol = 1e-4); against the JAX dsp LPS
    at that tolerance plus the dsp LPS's own distance from float64: its
    float32 sums of win_len products are themselves off by up to 0.8 of the
    tolerance in a bin at 22050 Hz (win_len 706)."""
    jc, tc = _cfgs(sr)
    x = _sig(n, sr, seed=sr)
    got = _emulated_lps(torch.from_numpy(x), tc).numpy()
    exact = stft_lps_reference(torch.from_numpy(x), tc).numpy()
    pallas = np.asarray(stft_lps_pallas(jnp.asarray(x), jc, interpret=True))
    dsp = np.asarray(jstft.stft_logpower(jnp.asarray(x), jc))
    assert got.shape == pallas.shape == dsp.shape == (tc.n_frames(n), tc.n_bins)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)
    excess = np.abs(got - dsp) - (1e-4 + 1e-4 * np.abs(dsp) + np.abs(dsp - exact))
    assert excess.max() <= 0, f"off the JAX dsp LPS by {excess.max()} more than allowed"


def test_fft_emulation_matches_jax_at_n_fft_2048():
    """44.1 kHz (win_len 1411, n_fft 2048): the emulation against the
    float64 plain version at atol = rtol = 1e-4, and against the JAX Pallas
    kernel and dsp LPS at that tolerance plus each one's own distance from
    float64: their float32 sums of 1411 products are off float64 by up to
    1.02 of the tolerance in a bin (the FFT's float32 error here is about
    0.35 of it)."""
    sr, n = GEOM_2048
    jc, tc = _cfgs(sr)
    x = _sig(n, sr, seed=sr)
    got = _emulated_lps(torch.from_numpy(x), tc).numpy()
    exact = stft_lps_reference(torch.from_numpy(x), tc).numpy()
    pallas = np.asarray(stft_lps_pallas(jnp.asarray(x), jc, interpret=True))
    dsp = np.asarray(jstft.stft_logpower(jnp.asarray(x), jc))
    assert got.shape == pallas.shape == dsp.shape == (tc.n_frames(n), tc.n_bins)
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4)
    for name, ref in (("Pallas kernel", pallas), ("dsp LPS", dsp)):
        excess = np.abs(got - ref) - (1e-4 + 1e-4 * np.abs(ref) + np.abs(ref - exact))
        assert excess.max() <= 0, f"off the JAX {name} by {excess.max()} more than allowed"


@pytest.mark.parametrize("sr,n", FFT_GEOMS + [GEOM_2048])
def test_fft_emulation_matches_numpy_rfft(sr, n):
    """Re/im against numpy's float64 rfft of the windowed, zero-padded frames
    at 1e-5 of the peak magnitude: an FFT's float32 error is O(log2(n_fft) u)
    of the frame's norm."""
    _, tc = _cfgs(sr)
    x = _sig(n, sr, seed=sr + 1)
    got = _fft_emulation(torch.from_numpy(x), tc).numpy()
    frames = tstft.frame_signal(torch.from_numpy(x), tc).numpy().astype(np.float64)
    want = np.fft.rfft(frames * tstft._window_np(tc).astype(np.float64), n=tc.n_fft, axis=-1)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got[..., 0], want.real, rtol=0, atol=tol)
    np.testing.assert_allclose(got[..., 1], want.imag, rtol=0, atol=tol)


def test_fft_tables_refuse_what_the_kernel_cannot_transform():
    from tpu_sednn_torch.ops.stft_lps import fft_tables

    window, twiddle = fft_tables(tstft.StftConfig.for_rate(8000))
    # r = 4: W_4 2, W_128^(l k) 32 x 3, the 32-point steps 5 x 32, the split 32 x 4 + 1
    assert window.dtype == twiddle.dtype == np.float32 and twiddle.shape == (387, 2)
    np.testing.assert_array_equal(twiddle[1], np.float32([np.cos(-np.pi / 2), -1.0]))  # W_4
    np.testing.assert_array_equal(twiddle[-1], np.float32([-1.0, np.sin(-np.pi)]))  # T[m]
    for cfg in (tstft.StftConfig(8000, 200, 80, 300),   # n_fft not a power of two
                tstft.StftConfig(8000, 32, 16, 32),     # too short for a warp's 32 lanes
                tstft.StftConfig(8000, 128, 64, 128),   # below 256: no rate gives it
                tstft.StftConfig(96000, 4096, 1024, 4096),  # above 2048 (for_rate over 64 kHz)
                tstft.StftConfig(8000, 300, 128, 256)):  # window longer than n_fft
        with pytest.raises(ValueError, match="n_fft"):
            fft_tables(cfg)
