"""The port's commands against the JAX package's, on the CPU: the enhance
command on the same .wts/.norm/wav (within 2 int16 LSB: the wavs are
quantized to 16 bits after fp32 decodes that differ in summation order),
make_pfile (same header, frames within 1e-4), the streaming, int8 and
fusion modes and the combinations both commands refuse, and the packages'
exports."""

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


@pytest.fixture
def run_b(tmp_path):
    """A second trained run dir (mlp.final.wts, fea.norm, run.json) for --fuse-with."""
    import json

    d = 129
    run = tmp_path / "run_b"
    run.mkdir()
    ws, bs = gen_rand_net([d * 3 + d, 32, d], seed=1)
    save_wts(str(run / "mlp.final.wts"), ws, bs)
    rng = np.random.default_rng(1)
    save_norm(str(run / "fea.norm"), rng.normal(size=d).astype(np.float32),
              rng.uniform(0.5, 2.0, d).astype(np.float32))
    (run / "run.json").write_text(json.dumps({"head": "psm", "sample_rate": SR, "fea_context": 3,
                                              "targ_offset": 1, "nat": True, "mask_floor": 0.05}))
    return str(run)


# the int8 decodes' int32 products are exact in both packages, but float32
# summation order can move a row's quantization across a rounding boundary
MODE_ATOL = {"--quant": 1e-3}


@pytest.mark.parametrize("flag", [["--stream", "4"], ["--stream", "4", "--stream-device"],
                                  ["--stream-device"], ["--quant", "int8"],
                                  ["--fuse-with", "run_b"]])
def test_enhance_cli_modes_equal_the_jax_command(tmp_path, model, run_b, flag):
    """The four decode modes (once refused here) run with --device cpu and
    write the JAX command's wavs: streaming (host and device state) and
    fusion within the offline decode's 2 LSB, int8 within 1e-3; a lone
    --stream-device is the offline decode, as in the JAX command."""
    flags, wav = model
    flag = [run_b if f == "run_b" else f for f in flag]
    out_j, out_t = str(tmp_path / "j"), str(tmp_path / "t")
    assert j_enhance([out_j, wav] + flags + flag) == 0
    assert t_enhance([out_t, wav] + flags + flag + ["--device", "cpu"]) == 0
    yj, srj = read_wav(os.path.join(out_j, "in_enh.wav"))
    yt, srt = read_wav(os.path.join(out_t, "in_enh.wav"))
    assert srj == srt == SR and yj.shape == yt.shape
    np.testing.assert_allclose(yt, yj, rtol=0, atol=MODE_ATOL.get(flag[0], 2 * LSB))
    if flag == ["--stream-device"]:
        assert t_enhance([str(tmp_path / "o"), wav] + flags + ["--device", "cpu"]) == 0
        np.testing.assert_array_equal(read_wav(os.path.join(str(tmp_path / "o"), "in_enh.wav"))[0],
                                      yt)


@pytest.mark.parametrize("flag,match", [(["--stream", "4"], "offline f32"),
                                        (["--quant", "int8"], "offline f32"),
                                        (["--fuse-alpha", "1.5"], "outside"),
                                        (["--fuse-alpha", "-0.1"], "outside")])
def test_enhance_cli_rejects_what_jax_rejects(tmp_path, model, run_b, flag, match):
    flags, wav = model
    argv = [wav] + flags + ["--fuse-with", run_b] + flag
    for cmd, extra in ((j_enhance, []), (t_enhance, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=match) as exc:
            cmd([str(tmp_path / "t")] + argv + extra)
        assert exc.value.code not in (0, None)
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("pkg", ["", "enhance", "model", "io", "tools", "parallel", "data", "dsp",
                                 "metrics", "ops", "recipes", "train", "utils"])
def test_port_exports_equal_jax(pkg):
    """Every public name of a JAX package's __init__ (every package that has
    one; "" the top level) is exported by the port's."""
    import importlib
    import inspect

    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    sub = f".{pkg}" if pkg else ""
    missing = (names(importlib.import_module(f"tpu_sednn{sub}"))
               - names(importlib.import_module(f"tpu_sednn_torch{sub}")))
    assert missing == set()


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
