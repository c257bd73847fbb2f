#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_sednn_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); build the port's
     CUDA kernel, csrc/stft_lps.cu, with nvcc (sm_90a).
  2. kernel vs plain: the STFT-LPS kernel against its plain torch version on
     the card at 8 kHz, 16 kHz and the generic 11025 and 22050 Hz geometries
     (hop % 4 == 0 and != 0, win % 4 != 0; ragged
     tails, exactly one window, batches; signals with a noise floor), LPS
     atol/rtol 1e-4; then kernel, plain and torch.stft (cuFFT, the yardstick
     only) times at the serving shapes 64 x 64 s / 8 kHz and 64 x 32 s /
     16 kHz, beside the kernel's bound on an H100 SXM.
  3. featurizer (main path): `tools.make_pfile` on 8 seeded noisy wavs with
     --device cuda, against build_pfile(device="cpu") on the same wavs.
  4. serving (main path): make_serving_decoder at full width,
     1548-2048x3-129 on 64 x 64 s at 8 kHz and 3084-2048x3-257 on
     64 x 32 s at 16 kHz, random glorot weights from a seed with parity
     dropout 0.1/0.2 folded in; output finite, of the right shape, its first
     two utterances equal to the same decoder on the CPU; audio-s/s.  Then
     the `python -m tpu_sednn_torch.enhance` command on a wav, with a .wts
     and .norm the port wrote.
  5. a `kernels` JSON line: every ported kernel with its launches on the
     main path, error and times.  Each path (phase 3, phase 4) is run with
     the counts zeroed just before it and read just after; `launches` is the
     total, `launches_by_path` the split.
The last line is {"ok": true, "device": {...}}.  Needs one CUDA card; exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
LPS_TOL = 1e-4  # atol and rtol, as tests/test_stft_pallas.py holds the Pallas kernel
WAV_TOL = 2e-4  # card vs CPU decode, times max(1, peak |wav|): fp32 sums in another order


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _lps_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, cfg) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / tol): `got` is a float32 LPS of
    signal(s) x, `want` the plain version's (stft_lps_reference, float64 sums).

    tol = LPS_TOL + LPS_TOL * |want| + the float32 rounding bound.  A float32
    sum of win products, in any order, is within gamma = win*u / (1 - win*u)
    (u = 2^-24) times the sum of the products' magnitudes of the exact sum;
    that bounds the error dp of the power p = re^2 + im^2, and the LPS then
    moves by at most ln(p) - ln(p - dp).  The bound is ~1e-3 in typical bins
    and large only where a strong tone's leakage cancels to a small p, where
    ln magnifies the rounding of any float32 summation order."""
    from tpu_sednn_torch.dsp.stft import LPS_FLOOR, frame_signal, rdft_on

    got, want = got.to(x.device), want.to(x.device, torch.float64)
    _check(got.shape == want.shape, f"LPS shape {tuple(got.shape)} vs {tuple(want.shape)}")
    _check(bool(torch.isfinite(got).all()), f"non-finite LPS at {cfg.sample_rate} Hz")
    frames = frame_signal(x, cfg).double()
    cos_m, sin_m = (m.double() for m in rdft_on(cfg, x.device))
    re, im = frames @ cos_m, frames @ sin_m
    u = 2.0 ** -24
    gamma = cfg.win_len * u / (1 - cfg.win_len * u)
    e_re, e_im = gamma * (frames.abs() @ cos_m.abs()), gamma * (frames.abs() @ sin_m.abs())
    p = re * re + im * im
    dp = (2 * re.abs() + e_re) * e_re + (2 * im.abs() + e_im) * e_im + 3 * u * p
    slack = torch.log(p.clamp(min=LPS_FLOOR)) - torch.log((p - dp).clamp(min=LPS_FLOOR))
    diff = (got.double() - want).abs()
    ratio = diff / (LPS_TOL + LPS_TOL * want.abs() + slack)
    return float(diff.max()), float(ratio.max())


def _signals(gen, batch, n, sr, device="cuda"):
    """Tones of random pitch and level over a white-noise floor, (batch, n)."""
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    f0 = 100 + 1500 * torch.rand(batch, 1, generator=gen, device=device, dtype=torch.float64)
    amp = 0.1 + 0.4 * torch.rand(batch, 1, generator=gen, device=device, dtype=torch.float64)
    tone = (amp * torch.sin(2 * np.pi * f0 * t)).float()
    return (tone + 0.05 * torch.randn(batch, n, generator=gen, device=device)).contiguous()


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from tpu_sednn_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build("stft_lps")
    print(f"[build] {path.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s", flush=True)
    log = path.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line:
            print(f"[build] stft_lps: {line.strip()}")
    return smi


def phase_kernel_vs_plain(gen) -> dict:
    from tpu_sednn_torch.dsp.stft import StftConfig, _window_np, stft_logpower
    from tpu_sednn_torch.ops.stft_lps import stft_lps, stft_lps_reference

    def against_plain(inp, cfg, label):
        """Kernel vs plain, and (for scale) float32 cuBLAS, dsp.stft_logpower,
        vs plain: -> (kernel err, kernel ratio, blas err, blas ratio)."""
        want = stft_lps_reference(inp, cfg)
        err, ratio = _lps_err(stft_lps(inp, cfg), want, inp, cfg)
        _check(ratio <= 1.0, f"kernel vs plain at {label}: max err {err}, {ratio} of the tolerance")
        return (err, ratio) + _lps_err(stft_logpower(inp, cfg), want, inp, cfg)

    max_err = worst = 0.0
    cases = [
        (8000, 4, 8000 * 3 + 77), (8000, 1, 256), (8000, 3, 8000 * 2 + 128 * 7),
        (16000, 3, 16000 * 2 + 111), (16000, 1, 512),
        (11025, 2, 11025 * 2 + 100), (11025, 1, 353), (11025, 5, 11025 + 1),
        (22050, 2, 22050 * 2 + 100), (22050, 1, 706), (22050, 3, 22050 + 1),
    ]
    for sr, batch, n in cases:
        cfg = StftConfig.for_rate(sr)
        x = _signals(gen, batch, n, sr)
        # batched and a single signal
        r = np.max([against_plain(inp, cfg, f"{sr} Hz, {tuple(inp.shape)}") for inp in (x, x[0])],
                   axis=0)
        max_err, worst = max(max_err, r[0]), max(worst, r[1])
        print(f"[kernel] stft_lps {sr} Hz (win {cfg.win_len}, hop {cfg.hop}) "
              f"x{tuple(x.shape)} -> {cfg.n_frames(n)} frames: max |kernel - plain| {r[0]:.3g}, "
              f"{r[1]:.3f} of the tolerance {LPS_TOL} + {LPS_TOL}*|plain| + fp32 rounding "
              f"bound (fp32 cuBLAS: {r[2]:.3g}, {r[3]:.3f})", flush=True)

    timings = {}
    for sr, batch, secs in [(8000, 64, 64.0), (16000, 64, 32.0)]:
        cfg = StftConfig.for_rate(sr)
        n = int(secs * sr)
        x = _signals(gen, batch, n, sr)
        err, ratio, blas_err, blas_ratio = against_plain(x, cfg, f"the {sr} Hz serving shape")
        max_err, worst = max(max_err, err), max(worst, ratio)
        torch.cuda.empty_cache()
        window = torch.from_numpy(_window_np(cfg)).cuda()

        def library():
            spec = torch.stft(x, n_fft=cfg.n_fft, hop_length=cfg.hop, win_length=cfg.win_len,
                              window=window, center=False, return_complex=True)
            return torch.log(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-12))

        lib_err = float((library().transpose(-1, -2) - stft_lps_reference(x, cfg)).abs().max())
        kernel_ms = _time_ms(lambda: stft_lps(x, cfg))
        plain_ms = _time_ms(lambda: stft_lps_reference(x, cfg))
        library_ms = _time_ms(library)
        n_frames = cfg.n_frames(n)
        flops = 4.0 * cfg.win_len * cfg.n_bins * batch * n_frames
        nbytes = 4.0 * (batch * n + batch * n_frames * cfg.n_bins + 2 * cfg.win_len * cfg.n_bins)
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        timings[sr] = dict(
            shape=f"{batch}x{n} @ {sr} Hz", max_abs_err=err, tol_ratio=ratio,
            blas_fp32_max_abs_err=blas_err, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", gflop=flops / 1e9,
            mbytes=nbytes / 1e6)
        print(f"[kernel] stft_lps {batch} x {secs:g} s @ {sr} Hz ({n_frames} frames each): "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.stft {library_ms:.4f} ms "
              f"(|stft - plain| {lib_err:.3g}), bound {max(t_ops, t_bytes):.4f} ms "
              f"({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.0f} MB), "
              f"{flops / kernel_ms / 1e9:.1f} TFLOP/s; max err {err:.3g}, {ratio:.3f} of the "
              f"tolerance (fp32 cuBLAS: {blas_err:.3g}, {blas_ratio:.3f})", flush=True)
        del x
    timings["max_abs_err"], timings["tol_ratio"] = max_err, worst
    return timings


def phase_featurizer(tmp: str, gen_np) -> tuple[list, str, int]:
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.io import (load_norm, read_pfile_info, read_pfile_utterances, read_wav,
                                    write_wav)
    from tpu_sednn_torch.ops.stft_lps import stft_lps
    from tpu_sednn_torch.tools import make_pfile

    sr, wavs = 8000, []
    for i in range(8):
        n = int(gen_np.uniform(2.0, 6.0) * sr)
        t = np.arange(n) / sr
        x = (0.3 * np.sin(2 * np.pi * gen_np.uniform(150, 1200) * t)
             + 0.05 * gen_np.standard_normal(n)).astype(np.float32)
        path = os.path.join(tmp, f"utt{i}.wav")
        write_wav(path, x, sr)
        wavs.append(path)
    stft_lps.launches = 0  # the featurizer path's run starts here
    pf, nf = os.path.join(tmp, "gpu.pfile"), os.path.join(tmp, "gpu.norm")
    rc = make_pfile.main([pf, nf] + wavs + ["--device", "cuda"])
    _check(rc == 0, f"make_pfile exited {rc}")
    launched = stft_lps.launches  # and ends here
    _check(launched == len(wavs), f"stft_lps launched {launched} times for {len(wavs)} wavs")
    pc, nc = os.path.join(tmp, "cpu.pfile"), os.path.join(tmp, "cpu.norm")
    make_pfile.build_pfile(wavs, pc, nc, device="cpu")
    d = 129
    info_g, info_c = read_pfile_info(pf, d), read_pfile_info(pc, d)
    _check(np.array_equal(info_g.frames_per_sent, info_c.frames_per_sent), "pfile frame counts")
    err = worst = 0.0
    for path, a, b in zip(wavs, read_pfile_utterances(pf, d), read_pfile_utterances(pc, d)):
        x = torch.from_numpy(read_wav(path)[0]).cuda()
        e, r = _lps_err(torch.from_numpy(a), torch.from_numpy(b), x, StftConfig.for_rate(sr))
        err, worst = max(err, e), max(worst, r)
    _check(worst <= 1.0, f"card vs CPU pfile frames: max err {err}, {worst} of the tolerance")
    for a, b in zip(load_norm(nf, d), load_norm(nc, d)):
        _check(np.allclose(a, b, rtol=1e-4, atol=1e-5), "card vs CPU .norm")
    print(f"[featurizer] make_pfile --device cuda: {len(wavs)} wavs, {info_g.num_frames} frames, "
          f"{launched} kernel launches; max |card - cpu| {err:.3g}, {worst:.3f} of the "
          f"tolerance", flush=True)
    return wavs, nf, launched


def _serving_model(sr: int, gen_seed: int):
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance import EnhanceConfig
    from tpu_sednn_torch.model import ModelConfig, init_params

    stft = StftConfig.for_rate(sr)
    d = stft.n_bins
    mcfg = ModelConfig(layersizes=(d * 11 + d, 2048, 2048, 2048, d), hidden="relu",
                       output="linear", dropout_vis=0.1, dropout_hid=0.2, dropout_mode="parity")
    ecfg = EnhanceConfig(stft=stft, fea_context=11, targ_offset=5, nat=True, head="lps")
    mlp = init_params(torch.Generator().manual_seed(gen_seed), mcfg, scheme="glorot",
                      device="cuda")
    return mlp, mcfg, ecfg


def phase_serving(gen, norm_8k: str, smi: str) -> tuple[dict, int]:
    from tpu_sednn_torch.enhance import make_serving_decoder
    from tpu_sednn_torch.io import compute_norm, load_norm
    from tpu_sednn_torch.ops.stft_lps import stft_lps, stft_lps_reference

    results, launched = {}, 0
    for sr, secs, seed in [(8000, 64.0, 0), (16000, 32.0, 1)]:
        mlp, mcfg, ecfg = _serving_model(sr, seed)
        batch, n = 64, int(secs * sr)
        wavs = _signals(gen, batch, n, sr)
        if sr == 8000:
            mean, istd = load_norm(norm_8k, ecfg.stft.n_bins)  # written by the featurizer
        else:
            lps = stft_lps_reference(wavs[:4], ecfg.stft)  # set-up, off the path
            mean, istd = compute_norm(lps.reshape(-1, ecfg.stft.n_bins).cpu().numpy())
        stft_lps.launches = 0  # the serving path's run starts here
        decode = make_serving_decoder(mlp, mcfg, ecfg, mean, istd, device="cuda")
        out = decode(wavs)
        torch.cuda.synchronize()
        launched += stft_lps.launches  # and ends here
        _check(out.shape == wavs.shape and out.is_cuda, f"decode output {tuple(out.shape)}")
        _check(bool(torch.isfinite(out).all()), f"non-finite enhanced wav at {sr} Hz")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = decode(wavs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        audio_s_per_s = batch * secs / dt
        cpu_dec = make_serving_decoder(mlp.on("cpu"), mcfg, ecfg, mean, istd, device="cpu")
        ref = cpu_dec(wavs[:2].cpu()).numpy()
        got = out[:2].cpu().numpy()
        err = float(np.abs(got - ref).max())
        tol = WAV_TOL * max(1.0, float(np.abs(ref).max()))
        _check(err <= tol, f"card vs CPU decode at {sr} Hz: max err {err} > {tol}")
        name = "-".join([str(mcfg.layersizes[0]), "2048x3", str(mcfg.layersizes[-1])])
        results[sr] = dict(net=name, batch=batch, seconds=secs, audio_s_per_s=audio_s_per_s,
                           ms_per_batch=[t * 1e3 for t in times], max_abs_err_vs_cpu=err,
                           tol=tol, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"[serving] {name} @ {sr} Hz, {batch} x {secs:g} s: {audio_s_per_s:.1f} audio-s/s "
              f"(median of 5 batches, {min(times) * 1e3:.1f}-{max(times) * 1e3:.1f} ms each) "
              f"on {smi}; first 2 utterances vs CPU max err {err:.3g} (tol {tol:.3g}); "
              f"peak |wav| {float(out.abs().max()):.3g}", flush=True)
        _profile(f"{name} @ {sr} Hz", decode, wavs)
        del out, wavs, decode
        torch.cuda.empty_cache()
    return results, launched


def _profile(label: str, fn, *args, top: int = 8) -> None:
    """One traced call of fn: device busy time against wall time, and the
    kernels that take the most device time.  The trace's own overhead is in
    the wall time; the throughput above is measured untraced."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    from torch.autograd import DeviceType

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                     key=lambda e: -dev_us(e))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    print(f"[profile] {label}: traced call {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), idle {max(wall_ms - busy_ms, 0):.1f} ms")
    for e in kernels[:top]:
        print(f"[profile]   {dev_us(e) / 1e3:8.2f} ms ({100 * dev_us(e) / 1e3 / busy_ms:4.1f}%) "
              f"x{e.count:<4d} {e.key[:90]}")


def phase_cli(tmp: str, wavs: list, norm_8k: str) -> None:
    from tpu_sednn_torch.enhance import make_serving_decoder
    from tpu_sednn_torch.io import load_norm, read_wav, save_wts
    from tpu_sednn_torch.model import params_to_wts

    mlp, mcfg, ecfg = _serving_model(8000, 0)
    wts = os.path.join(tmp, "flagship.wts")
    save_wts(wts, *params_to_wts(mlp))
    out_dir = os.path.join(tmp, "enh")
    cmd = [sys.executable, "-m", "tpu_sednn_torch.enhance", out_dir, wavs[0], "--wts", wts,
           "--norm", norm_8k, "--visible-omit", "0.1", "--hid-omit", "0.2", "--device", "cuda"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"enhance command failed:\n{proc.stdout}\n{proc.stderr}")
    y, sr = read_wav(os.path.join(out_dir, "utt0_enh.wav"))
    x, _ = read_wav(wavs[0])
    mean, istd = load_norm(norm_8k, ecfg.stft.n_bins)
    ref = make_serving_decoder(mlp, mcfg, ecfg, mean, istd, device="cuda")(x[None])[0]
    ref = np.clip(np.round(ref.cpu().numpy() * 32768.0), -32768, 32767) / 32768.0
    err = float(np.abs(y - ref).max())
    _check(sr == 8000 and y.shape == x.shape and err <= 2 / 32768,
           f"enhance command output vs serving decoder: max err {err} (tol 2 int16 LSB)")
    print(f"[cli] python -m tpu_sednn_torch.enhance --device cuda on {len(x) / sr:.1f} s: "
          f"{proc.stdout.strip()} ({time.perf_counter() - t0:.1f} s incl. start-up); "
          f"vs serving decoder max err {err:.3g}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    from tpu_sednn_torch import resolve_device

    resolve_device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    kern = phase_kernel_vs_plain(gen)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        wavs, norm_8k, n_featurizer = phase_featurizer(tmp, np.random.default_rng(7))
        serving, n_serving = phase_serving(gen, norm_8k, smi)
        phase_cli(tmp, wavs, norm_8k)
    # the serving decode computes re/im by matmul for the noisy phase, as the
    # JAX decode does, so only the featurizer's path runs this kernel
    _check(n_featurizer > 0, "the featurizer path never launched the stft_lps kernel")

    t8 = kern[8000]
    kernels = [dict(
        name="stft_lps", route="cuda", source="tpu_sednn_torch/csrc/stft_lps.cu",
        replaces="tpu_sednn/ops/stft_pallas.py:34", launches=n_featurizer + n_serving,
        launches_by_path={"make_pfile": n_featurizer, "serving": n_serving},
        max_abs_err=kern["max_abs_err"], tol_ratio=kern["tol_ratio"], ms=t8["ms"],
        plain_ms=t8["plain_ms"],
        bound_ms=t8["bound_ms"], bound_by=t8["bound_by"], library_ms=t8["library_ms"],
        shape=t8["shape"], at_16k=kern[16000])]
    print(f"[serving] summary {json.dumps(serving)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
