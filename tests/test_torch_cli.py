"""The port's commands against the JAX package's, on the CPU: the enhance
command on the same .wts/.norm/wav (within 2 int16 LSB: the wavs are
quantized to 16 bits after fp32 decodes that differ in summation order),
make_pfile (same header, frames within 1e-4), and the flags whose decode is
not ported yet (exit non-zero, never ignored)."""

import os

import numpy as np
import pytest

from tpu_sednn.data.mixing import mix_at_snr, synth_noise, synth_speech
from tpu_sednn.enhance.__main__ import main as j_enhance
from tpu_sednn.io import compute_norm, read_pfile_info, read_pfile_utterances, save_norm
from tpu_sednn.io import load_norm as j_load_norm
from tpu_sednn.io import read_wav, write_wav
from tpu_sednn.io.pfile import PFILE_HEADER_SIZE
from tpu_sednn.io.wts import save_wts
from tpu_sednn.tools import gen_rand_net
from tpu_sednn.tools.make_pfile import main as j_make_pfile
from tpu_sednn_torch.enhance.__main__ import main as t_enhance
from tpu_sednn_torch.tools.make_pfile import main as t_make_pfile

SR = 8000
LSB = 1.0 / 32768


def _noisy(seed, seconds=2.0):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    return mix_at_snr(synth_speech(rng, n, SR), synth_noise(rng, n, "white"), 5, rng)


@pytest.fixture
def model(tmp_path):
    """A small random net, its .norm and one noisy wav, written to tmp_path."""
    from tpu_sednn_torch.dsp import StftConfig, stft_logpower
    import torch

    d = StftConfig.for_rate(SR).n_bins
    context, to = 3, 1
    ws, bs = gen_rand_net([d * context + d, 64, d], seed=0)
    wts = str(tmp_path / "m.wts")
    save_wts(wts, ws, bs)
    noisy = _noisy(0)
    lps = stft_logpower(torch.from_numpy(noisy), StftConfig.for_rate(SR)).numpy()
    norm = str(tmp_path / "f.norm")
    save_norm(norm, *compute_norm(lps))
    wav = str(tmp_path / "in.wav")
    write_wav(wav, noisy, SR)
    return ["--wts", wts, "--norm", norm, "--context", str(context),
            "--targ-offset", str(to)], wav


@pytest.mark.parametrize("extra", [[], ["--head", "irm", "--mask-floor", "0.05"],
                                   ["--visible-omit", "0.1", "--hid-omit", "0.2",
                                    "--min-gain-db", "-12"]])
def test_enhance_cli_matches_jax(tmp_path, model, extra):
    flags, wav = model
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_enhance([out_j, wav] + flags + extra) == 0
    assert t_enhance([out_t, wav] + flags + extra + ["--device", "cpu"]) == 0
    yj, srj = read_wav(os.path.join(out_j, "in_enh.wav"))
    yt, srt = read_wav(os.path.join(out_t, "in_enh.wav"))
    assert srj == srt == SR and yj.shape == yt.shape
    np.testing.assert_allclose(yt, yj, rtol=0, atol=2 * LSB)


@pytest.mark.parametrize("flag", [["--stream", "4"], ["--stream", "4", "--stream-device"],
                                  ["--stream-device"], ["--quant", "int8"],
                                  ["--fuse-with", "run_b"]])
def test_enhance_cli_unported_flags_exit_nonzero(tmp_path, model, flag):
    flags, wav = model
    with pytest.raises(SystemExit, match="not yet ported") as exc:
        t_enhance([str(tmp_path / "t"), wav] + flags + flag + ["--device", "cpu"])
    assert exc.value.code not in (0, None)
    # the message names the module that will lift the rejection
    module = {"--stream": "enhance/streaming.py", "--stream-device": "enhance/streaming.py",
              "--quant": "model/quant.py", "--fuse-with": "enhance/fusion.py"}[flag[0]]
    assert f"tpu_sednn_torch/{module}" in str(exc.value.code)
    assert not (tmp_path / "t").exists()


def test_enhance_cli_rejects_wrong_rate_and_missing_cuda(tmp_path, model):
    import torch

    flags, _ = model
    wav16 = str(tmp_path / "in16.wav")
    write_wav(wav16, _noisy(1), 16000)
    with pytest.raises(SystemExit, match="bins"):
        t_enhance([str(tmp_path / "t"), wav16] + flags + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_enhance([str(tmp_path / "t"), wav16] + flags)  # default device is cuda


@pytest.mark.parametrize("extra", [[], ["--normalize", "--shuffle", "3"]])
def test_make_pfile_matches_jax(tmp_path, extra):
    wavs = []
    for i, secs in enumerate([1.0, 2.5, 1.7]):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, _noisy(10 + i, secs), SR)
        wavs.append(p)
    pj, nj = str(tmp_path / "j.pfile"), str(tmp_path / "j.norm")
    pt, nt = str(tmp_path / "t.pfile"), str(tmp_path / "t.norm")
    assert j_make_pfile([pj, nj] + wavs + extra) == 0
    assert t_make_pfile([pt, nt] + wavs + extra + ["--device", "cpu"]) == 0
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read(PFILE_HEADER_SIZE) == ft.read(PFILE_HEADER_SIZE)
    d = 129
    ij, it = read_pfile_info(pj, d), read_pfile_info(pt, d)
    np.testing.assert_array_equal(ij.frames_per_sent, it.frames_per_sent)
    for a, b in zip(read_pfile_utterances(pt, d), read_pfile_utterances(pj, d)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for a, b in zip(j_load_norm(nt, d), j_load_norm(nj, d)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
