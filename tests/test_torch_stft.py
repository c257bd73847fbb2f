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
