#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_sednn_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); build the port's
     CUDA kernels (csrc/stft_lps.cu, fused_mlp.cu, resident_chunk.cu) with
     nvcc (sm_90a), one nvcc per source, all started together.
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
  5. fused layer kernels (fused_linear_act, fused_bwd_update) against their
     float64 plain versions at the four flagship layer shapes and at ragged
     ones, with in-kernel and explicit dropout masks; their times, the plain
     versions' and torch.addmm's beside the bound.
  6. dropout stream: the device Philox against the Random123 known-answer
     vectors and, bit for bit, against its plain version; zero rate, stream
     distinctness and rank-slice identity of sample_resident_masks.
  7. chunk trainer at full width (1548-2048x3-129, bunch 128) against its
     float64 plain version: rules parity and clean, dropout off / parity /
     inverted, a sigmoid head, n_real below capacity, a partial bunch,
     hyperparameters changed between calls; a deliberately wrong
     hyperparameter is refused; ops/train_step's per-bunch step against it;
     ms per bunch.
  8. training (main path): a seeded speech-like corpus -> noisy and clean LPS
     pfiles with make_pfile on the card (> 120,000 frames), then
     `python -m tpu_sednn_torch.cli` twice (momentum 0.5, then 0.54 warm
     started), dropout on, engine=auto: "all finish!", the .wts reloads, CV
     MSE finite and falling, the chunk trainer launched once per chunk and
     the plain trainer never; engine=resident against engine=xla with
     dropout off; samples/s, ms per bunch, a profile of one full chunk.
  9. a `kernels` JSON line: every ported kernel with its launches on the
     main paths, error and times.  Each path (phases 3, 4, 8) is run with
     the counts zeroed just before it and read just after; `launches` is the
     total, `launches_by_path` the split.
`--only serve,kernels,train` runs a subset while developing: it prints no
`kernels` line and no final line and exits with code 2.  The last line is {"ok": true, "device": {...}}.  Needs one CUDA card; exits
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


_SPIN = {}  # cycles of torch.cuda._sleep per millisecond, measured once


def _device_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn(i), i = 0..reps-1, with the host's time per call
    left out: a spin kernel holds the card while all `reps` calls are
    enqueued, so their kernels then run back to back between two CUDA events.
    (_time_ms would time a call whose kernels are shorter than its Python
    wrapper, tens of microseconds, as the wrapper.)  The median of three such
    runs; a run whose spin ended before the enqueueing did is taken again with
    a longer spin.  A call with more launches than the CUDA launch queue holds
    cannot be held so and is timed as it runs, the host's share included."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start, end, held = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    if not _SPIN:
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 20_000_000 / start.elapsed_time(end)
    t0 = time.perf_counter()
    fn(warmup)
    hold_ms = 2.0 * reps * (time.perf_counter() - t0) * 1e3 + 1.0
    times, last = [], 0.0
    for _ in range(6):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(hold_ms * _SPIN["per_ms"]))
        held.record()
        start.record()
        for i in range(reps):
            fn(i)
        end.record()
        enqueued_in_time = not held.query()  # the spin still runs: nothing waited for the host
        end.synchronize()
        last = start.elapsed_time(end) / reps
        if enqueued_in_time:
            times.append(last)
            if len(times) == 3:
                break
        else:
            hold_ms *= 2.0
    return float(np.median(times)) if times else last


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

    from tpu_sednn_torch.ops import KERNEL_SOURCES

    t0 = time.perf_counter()
    paths = _build.build_all(KERNEL_SOURCES)
    print(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, together)", flush=True)
    for name, path in paths.items():
        log = path.with_suffix(".log")
        fn = ""
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else ""
            if "registers" in line or "spill" in line:
                print(f"[build] {name} {fn[:48]}: {line.strip()}")
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


# ---------------------------------------------------------------------------
# training slice: kernels 1-4 and the training path
# ---------------------------------------------------------------------------

FLAGSHIP = (1548, 2048, 2048, 2048, 129)
BUNCH = 128
# kernel vs float64 plain version, single launches: the error of a float32 sum
# of K <= 2048 products, in any order, against the exact sum
KERNEL_REL_MAX = 5e-5  # max |got - want| <= this * max(|want|)
KERNEL_REL_FRO = 1e-5  # ||got - want||_F <= this * ||want||_F
# chunk trainer vs float64 plain version, per tensor, on the UPDATE (W - W0,
# delta), as a relative Frobenius error.  Three limits, each for one
# comparison:
# * after ONE bunch every tensor is held to CHUNK_ONE_REL_FRO: float32
#   rounding of one forward and one backward (a sigmoid head's dedx =
#   (out - t) * out * (1 - out) magnifies the forward's rounding, hence above
#   KERNEL_REL_FRO; read: at most 1e-5).
# * after several bunches (3, or 2 x 3 with the hyperparameters changed) to
#   CHUNK_REL_FRO: at lrate 1.0 each bunch's rounding is carried into the next
#   bunch's weights and grows (read: at most 1.1e-4, the float32 plain version
#   the same against float64, printed beside).  The limit leaves room for one
#   ReLU flip: a hidden pre-activation within rounding of 0 has y > 0 in one
#   summation order and not in the other, the backward then differs by a
#   whole dedy element, and one such element changes a layer's gradient by
#   ~1/sqrt(128 * 1024) = 3e-3 of its norm, no fault of the kernel.
# * an epoch of ~98 bunches through the command, engine=resident against
#   engine=xla (two float32 trainers, each with its own summation order, so
#   flips and carried rounding on both sides; read: 0.016-0.020), to
#   ENGINE_REL_FRO.  A dropped weightcost or a mis-scaled momentum would show
#   in the first two; this one says the command wires the same trainer.
CHUNK_ONE_REL_FRO = 5e-5
CHUNK_REL_FRO = 5e-3
ENGINE_REL_FRO = 5e-2


def _err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max |want|, ||got - want||_F / ||want||_F), in float64."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    return (float(d.max() / w.abs().max().clamp(min=1e-30)),
            float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w).clamp(min=1e-30)))


def _hold(got, want, label: str, worst: dict) -> None:
    _check(bool(torch.isfinite(got).all()), f"{label}: non-finite values")
    _check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    rel_max, rel_fro = _err(got, want)
    _check(rel_max <= KERNEL_REL_MAX and rel_fro <= KERNEL_REL_FRO,
           f"{label}: max err {rel_max:.3g} of max|want| (tol {KERNEL_REL_MAX}), "
           f"Frobenius {rel_fro:.3g} (tol {KERNEL_REL_FRO})")
    worst["rel_max"] = max(worst.get("rel_max", 0.0), rel_max)
    worst["rel_fro"] = max(worst.get("rel_fro", 0.0), rel_fro)
    worst["abs"] = max(worst.get("abs", 0.0), float((got.double() - want.double()).abs().max()))


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).contiguous()


def phase_fused_kernels(gen) -> dict:
    from tpu_sednn_torch.ops.fused_mlp import (fused_bwd_update, fused_bwd_update_reference,
                                               fused_linear_act, fused_linear_act_reference)
    from tpu_sednn_torch.ops.philox import philox_mask

    f64 = torch.float64
    layer_shapes = [(BUNCH, FLAGSHIP[l], FLAGSHIP[l + 1]) for l in range(4)]
    ragged = [(8, 1548, 129), (136, 1548, 129), (136, 100, 37), (24, 2048, 2048)]
    fwd_worst, bwd_worst, plain_worst = {}, {}, {}
    for B, K, N in layer_shapes + ragged:
        x = _randn(gen, B, K)
        w = _randn(gen, K, N, scale=0.03)
        b = _randn(gen, N, scale=0.1)
        im = philox_mask(11, B, K, 0.1, device="cuda")
        om = philox_mask(12, B, N, 0.2, device="cuda")
        for act in ("relu", "sigmoid", "linear"):
            for kw in ({}, {"in_mask": (11, 0.1), "out_mask": (12, 0.2), "out_scale": 1.25},
                       {"in_mask": im, "in_scale": 1.0 / 0.9, "out_mask": om}):
                want = fused_linear_act_reference(x, w, b, act, dtype=f64, **kw)
                _hold(fused_linear_act(x, w, b, act, **kw), want,
                      f"fused_linear_act {B}x{K}x{N} {act} {sorted(kw)}", fwd_worst)
                _hold(fused_linear_act_reference(x, w, b, act, **kw), want,
                      f"float32 plain fused_linear_act {B}x{K}x{N}", plain_worst)
        dedx = _randn(gen, B, N, scale=0.02)
        y_prev = torch.relu(_randn(gen, B, K)) * philox_mask(13, B, K, 0.2, device="cuda")
        delta = _randn(gen, K, N, scale=0.003)
        db = _randn(gen, N, scale=0.003)
        hyp = dict(momentum=0.54, lrate=1.0, inv_n=1.0 / B, weightcost=1e-4)
        for kw in ({}, {"deriv": "relu"}, {"deriv": "sigmoid"},
                   {"in_mask": (11, 0.1), "in_scale": 1.0 / 0.9}, {"in_mask": im}):
            want = fused_bwd_update_reference(dedx, y_prev, w, delta, b, db, dtype=f64,
                                              **hyp, **kw)
            plain = fused_bwd_update_reference(dedx, y_prev, w, delta, b, db, **hyp, **kw)
            w2, d2, b2, db2 = w.clone(), delta.clone(), b.clone(), db.clone()
            got = fused_bwd_update(dedx, y_prev, w2, d2, b2, db2, **hyp, **kw)
            _check(got[0] is w2 and got[1] is d2 and got[3] is b2 and got[4] is db2,
                   "fused_bwd_update must update W, delta, b, delta_b in place")
            for name, g, wnt, pl in zip(("w", "delta", "dedy", "b", "delta_b"), got, want, plain):
                _hold(g, wnt, f"fused_bwd_update {B}x{K}x{N} {sorted(kw)} {name}", bwd_worst)
                _hold(pl, wnt, f"float32 plain fused_bwd_update {name}", plain_worst)
        torch.cuda.synchronize()
    print(f"[kernel] fused_linear_act vs float64 plain, {len(layer_shapes + ragged)} shapes x 3 "
          f"activations x 3 mask modes: max err {fwd_worst['rel_max']:.3g} of max|want| (tol "
          f"{KERNEL_REL_MAX}), Frobenius {fwd_worst['rel_fro']:.3g} (tol {KERNEL_REL_FRO}); "
          f"tolerance: a float32 sum of <= 2048 products against the exact sum", flush=True)
    print(f"[kernel] fused_bwd_update vs float64 plain (W, delta, b, delta_b after the in-place "
          f"update, dedy from the pre-update W): max err {bwd_worst['rel_max']:.3g}, Frobenius "
          f"{bwd_worst['rel_fro']:.3g}; the float32 plain versions' own: "
          f"{plain_worst['rel_max']:.3g}, {plain_worst['rel_fro']:.3g}", flush=True)

    # Device times at the four flagship layer shapes (one bunch's worth of each
    # kernel).  Each call takes the next of three weight sets, ~100 MB in all,
    # so that W and delta come from device memory and not from the 50 MB L2,
    # as they do in a chunk, where every launch touches another layer.
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0, by_shape={})
    bwd = dict(ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0, by_shape={})
    for l, (B, K, N) in enumerate(layer_shapes):
        x, b = _randn(gen, B, K), _randn(gen, N, scale=0.1)
        ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
        deltas = [torch.zeros(K, N, device="cuda") for _ in range(3)]
        act = "relu" if l < 3 else "linear"
        dedx, db = _randn(gen, B, N, scale=0.02), torch.zeros(N, device="cuda")
        hyp = dict(momentum=0.5, lrate=1e-3, inv_n=1.0 / B, weightcost=0.0)

        def library(i):
            y = torch.addmm(b, x, ws[i % 3])
            return torch.relu(y) if act == "relu" else y

        # masks as the training path gives them: in-kernel on the net's input
        # and on every hidden activation
        kw = dict(in_mask=(4, 0.1) if l == 0 else None, out_mask=(5, 0.2) if l < 3 else None)
        kw_t = {k: None if v is None else philox_mask(v[0], B, K if k == "in_mask" else N, v[1],
                                                      device="cuda") for k, v in kw.items()}
        t_f = _device_ms(lambda i: fused_linear_act(x, ws[i % 3], b, act, **kw))
        t_fp = _device_ms(lambda i: fused_linear_act_reference(x, ws[i % 3], b, act, **kw_t))
        t_fl = _device_ms(library)
        t_b = _device_ms(lambda i: fused_bwd_update(dedx, x, ws[i % 3], deltas[i % 3], b, db, **hyp))
        t_bp = _device_ms(lambda i: fused_bwd_update_reference(dedx, x, ws[i % 3], deltas[i % 3], b,
                                                               db, **hyp))
        f_flops, f_bytes = 2.0 * B * K * N, 4.0 * (B * K + K * N + N + B * N)
        b_flops = 4.0 * B * K * N + 4.0 * K * N
        b_bytes = 4.0 * (B * N + B * K + 4 * K * N + 4 * N + B * K)
        fwd["by_shape"][f"layer {l}, {B}x{K}x{N}"] = dict(ms=t_f, plain_ms=t_fp, library_ms=t_fl)
        bwd["by_shape"][f"layer {l}, {B}x{K}x{N}"] = dict(ms=t_b, plain_ms=t_bp)
        for acc, vals in ((fwd, dict(ms=t_f, plain_ms=t_fp, library_ms=t_fl, flops=f_flops,
                                     nbytes=f_bytes)),
                          (bwd, dict(ms=t_b, plain_ms=t_bp, flops=b_flops, nbytes=b_bytes))):
            for k, v in vals.items():
                acc[k] += v
        print(f"[kernel] layer {l} {B}x{K}x{N}: fused_linear_act {t_f:.4f} ms (plain {t_fp:.4f}, "
              f"torch.addmm+act {t_fl:.4f}), {f_flops / t_f / 1e9:.2f} TFLOP/s; fused_bwd_update "
              f"{t_b:.4f} ms (plain {t_bp:.4f}), {b_flops / t_b / 1e9:.2f} TFLOP/s", flush=True)
    for acc, worst in ((fwd, fwd_worst), (bwd, bwd_worst)):
        t_ops = acc["flops"] / PEAK_FP32_FLOPS * 1e3
        t_bytes = acc["nbytes"] / PEAK_BYTES_PER_S * 1e3
        acc.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                   max_abs_err=worst["abs"], rel_max_err=worst["rel_max"], rel_fro_err=worst["rel_fro"])
    print(f"[kernel] one bunch's four layers: fused_linear_act {fwd['ms']:.4f} ms (bound "
          f"{fwd['bound_ms']:.4f} by {fwd['bound_by']}), fused_bwd_update {bwd['ms']:.4f} ms (bound "
          f"{bwd['bound_ms']:.4f} by {bwd['bound_by']})", flush=True)
    return dict(fwd=fwd, bwd=bwd)


def phase_masks() -> dict:
    from tpu_sednn_torch.ops.philox import philox4x32_10
    from tpu_sednn_torch.ops.resident_chunk import (philox_words_on_device, sample_resident_masks,
                                                    sample_resident_masks_reference)

    # Random123 known-answer vectors of philox4x32_10
    f = 0xFFFFFFFF
    kat = [((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((f, f, f, f, f, f), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    inp = torch.tensor([k for k, _ in kat], dtype=torch.int64, device="cuda")
    got = philox_words_on_device(inp).cpu().tolist()
    for (ck, want), g in zip(kat, got):
        plain = tuple(int(v) for v in philox4x32_10(ck[:4], ck[4:]))
        _check(tuple(g) == want and plain == want,
               f"philox4x32_10 known answer: device {[hex(v) for v in g]}, plain "
               f"{[hex(v) for v in plain]}, want {[hex(v) for v in want]}")
    worst_dev, sigs, n_eq, mask_err = 0.0, set(), 0, 0.0
    grid = [(b, l) for b in (0, 1, 7, 255, 799) for l in range(4)]
    for b, l in grid:
        omit, width = (0.1, 1548) if l == 0 else (0.2, 2048)
        mask = sample_resident_masks(12345, b, l, (BUNCH, width), omit)
        ref = sample_resident_masks_reference(12345, b, l, (BUNCH, width), omit, device="cuda")
        mask_err = max(mask_err, float((mask - ref).abs().max()))
        _check(torch.equal(mask, ref), f"mask (bunch {b}, layer {l}) differs from the plain Philox")
        n_eq += mask.numel()
        zr = 1.0 - float(mask.mean())
        tol = 4.0 * np.sqrt(omit * (1 - omit) / mask.numel())
        _check(abs(zr - omit) <= tol, f"zero rate {zr} vs omit {omit} (4 sigma = {tol})")
        worst_dev = max(worst_dev, abs(zr - omit) / tol)
        sigs.add(mask[:4].cpu().numpy().tobytes())
    _check(len(sigs) == len(grid), "two (bunch, layer) streams gave the same mask rows")
    for b, l in ((0, 1), (7, 2), (255, 0)):
        omit, width = (0.1, 1548) if l == 0 else (0.2, 2048)
        full = sample_resident_masks(2024, b, l, (BUNCH, width), omit)
        for n_dev in (2, 4):
            rows = BUNCH // n_dev
            parts = [sample_resident_masks(2024, b, l, (BUNCH, width), omit, device_idx=d,
                                           n_dev=n_dev) for d in range(n_dev)]
            for d, part in enumerate(parts):
                _check(torch.equal(part, full[d * rows:(d + 1) * rows]),
                       f"rank {d} of {n_dev} is not its rows of the global mask")
            _check(len({p.cpu().numpy().tobytes() for p in parts}) == n_dev,
                   "two ranks drew the same rows")
    print(f"[kernel] philox mask: 3 known-answer vectors hold on the card and in the plain "
          f"version; {len(grid)} (bunch, layer) masks bit-equal to the plain Philox ({n_eq} "
          f"elements); zero rate within {worst_dev:.2f} of 4 sigma; streams distinct; rank slices "
          f"of n_dev 2 and 4 equal the global mask's rows", flush=True)

    shape, omit = (BUNCH, 2048), 0.2
    ms = _device_ms(lambda i: sample_resident_masks(1, 2, 3, shape, omit), reps=50)
    # one call of the plain version: more of its launches would fill the CUDA launch queue
    plain_ms = _device_ms(lambda i: sample_resident_masks_reference(1, 2, 3, shape, omit,
                                                                    device="cuda"), reps=1)
    library_ms = _device_ms(lambda i: (torch.rand(shape, device="cuda") >= omit).float(), reps=50)
    nbytes = 4.0 * shape[0] * shape[1]
    print(f"[kernel] philox mask {shape}: kernel {ms:.4f} ms, plain (int64 tensor arithmetic, more "
          f"launches than can be enqueued ahead: the host's share is in it) {plain_ms:.4f} ms, torch.rand >= omit {library_ms:.4f} ms, bound "
          f"{nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms (bytes: the mask written once)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes", max_abs_err=mask_err,
                shape=f"{shape[0]}x{shape[1]}",
                times_of="one standalone launch of sample_resident_masks at this shape; `launches` "
                         "counts the trainer's forward and backward launches that drew masks "
                         "in the kernel")


def _flagship_cfg(**kw):
    from tpu_sednn_torch.model.mlp import ModelConfig

    return ModelConfig(layersizes=FLAGSHIP, **kw)


def _state_tensors(state):
    return (list(state.params.w) + list(state.params.b)
            + list(state.deltas.w) + list(state.deltas.b))


def _update_errors(got, want, init) -> list:
    """Per state tensor: ||(got - init) - (want - init)||_F / ||want - init||_F."""
    out = []
    for g, w, i0 in zip(_state_tensors(got), _state_tensors(want), _state_tensors(init)):
        dw = w.double() - i0.double()
        err = torch.linalg.vector_norm(g.double() - w.double())
        out.append(float(err / torch.linalg.vector_norm(dw).clamp(min=1e-30)))
    return out


def _hold_chunk(got, want, init, label: str, worst: dict, tol: float = CHUNK_REL_FRO) -> list:
    """Chunk trainer vs plain version, per tensor, on the update (see the
    tolerances' comment at the top of this section); -> the errors."""
    names = [f"{k}[{l}]" for k in ("w", "b", "delta_w", "delta_b") for l in range(4)]
    errs = _update_errors(got, want, init)
    for name, g, w, e in zip(names, _state_tensors(got), _state_tensors(want), errs):
        _check(bool(torch.isfinite(g).all()), f"{label} {name}: non-finite")
        _check(e <= tol, f"{label} {name}: update off by {e:.3g} relative Frobenius (tol {tol})")
        worst["abs"] = max(worst.get("abs", 0.0), float((g.double() - w.double()).abs().max()))
    worst["rel_fro"] = max(worst.get("rel_fro", 0.0), max(errs))
    _check(got.step == want.step, f"{label}: step {got.step} vs {want.step}")
    return errs


def phase_resident(gen) -> dict:
    from tpu_sednn_torch.model.mlp import init_params
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.train_step import fused_train_step
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    mlp = init_params(torch.Generator().manual_seed(3), _flagship_cfg(), scheme="glorot",
                      device="cuda")
    opt = OptConfig(lrate=1.0, momentum=0.5, weightcost=1e-5, bunchsize=BUNCH)
    n_b = 3
    x = _randn(gen, n_b * BUNCH + 40, FLAGSHIP[0])  # 3 bunches and a partial one
    proj = _randn(gen, FLAGSHIP[0], FLAGSHIP[-1], scale=0.05)
    t_lin = (x @ proj).contiguous()
    t_sig = torch.sigmoid(t_lin).contiguous()
    f64, worst = torch.float64, {}
    hyp = (opt.lrate, opt.momentum, opt.weightcost)

    def both(cfg, rule, t, seed=17, hyp=hyp):
        run = rc.make_resident_train_chunk(cfg, opt, rule=rule)
        got = run(init_train_state(mlp), x, t, seed, *hyp)
        coefs = rc._scal_coefs(rule, BUNCH, FLAGSHIP[-1], *hyp)
        want = rc.resident_train_chunk_reference(init_train_state(mlp), x, t, cfg, BUNCH, coefs,
                                                 seed, dtype=f64)
        torch.cuda.synchronize()
        return run, got, want

    init = init_train_state(mlp)
    cases = [
        ("parity, dropout off", _flagship_cfg(), "parity", t_lin),
        ("clean, dropout off", _flagship_cfg(), "clean", t_lin),
        ("parity, dropout 0.1/0.2 (parity mode)",
         _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2), "parity", t_lin),
        ("clean, dropout 0.1/0.2 (inverted mode)",
         _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2, dropout_mode="inverted"), "clean", t_lin),
        ("parity, sigmoid head, dropout 0.1/0.2",
         _flagship_cfg(output="sigmoid", dropout_vis=0.1, dropout_hid=0.2), "parity", t_sig),
    ]
    held = {}
    for label, cfg, rule, t in cases:
        run, got, want = both(cfg, rule, t)
        _check(got.step == n_b, f"{label}: {got.step} bunches trained, the partial one not dropped")
        errs = _hold_chunk(got, want, init, label, worst)
        coefs = rc._scal_coefs(rule, BUNCH, FLAGSHIP[-1], *hyp)
        plain = rc.resident_train_chunk_reference(init_train_state(mlp), x, t, cfg, BUNCH, coefs, 17)
        p_errs = _update_errors(plain, want, init)
        # the first bunch alone, every tensor
        one = run(init_train_state(mlp), x[:BUNCH], t[:BUNCH], 17, *hyp)
        one_w = rc.resident_train_chunk_reference(init_train_state(mlp), x[:BUNCH], t[:BUNCH], cfg,
                                                  BUNCH, coefs, 17, dtype=f64)
        e1 = _hold_chunk(one, one_w, init, f"{label}, one bunch", {}, tol=CHUNK_ONE_REL_FRO)
        worst["one"] = max(worst.get("one", 0.0), max(e1))
        held.setdefault("first", (run, want, one_w))
        print(f"[kernel] chunk trainer, {label}: {n_b} bunches + a partial one vs float64 plain, "
              f"update error by layer W {' '.join(f'{e:.2g}' for e in errs[:4])}, delta_b "
              f"{' '.join(f'{e:.2g}' for e in errs[12:])} (float32 plain version's own: W "
              f"{' '.join(f'{e:.2g}' for e in p_errs[:4])}); after one bunch W "
              f"{' '.join(f'{e:.2g}' for e in e1[:4])}", flush=True)

    # the limits bite: the first case's trainer given a wrong hyperparameter
    # must be refused by the one-bunch or the three-bunch limit
    run, want, one_w = held["first"]
    for label, h in (("weightcost dropped", (opt.lrate, opt.momentum, 0.0)),
                     ("momentum x 1.03", (opt.lrate, 1.03 * opt.momentum, opt.weightcost)),
                     ("lrate x 1.001", (1.001 * opt.lrate, opt.momentum, opt.weightcost))):
        m1 = max(_update_errors(run(init_train_state(mlp), x[:BUNCH], t_lin[:BUNCH], 17, *h),
                                one_w, init))
        m3 = max(_update_errors(run(init_train_state(mlp), x, t_lin, 17, *h), want, init))
        _check(m1 > CHUNK_ONE_REL_FRO or m3 > CHUNK_REL_FRO,
               f"a chunk trainer with {label} passes the limits: {m1:.3g} after one bunch, "
               f"{m3:.3g} after three")
        print(f"[kernel] chunk trainer with {label} (a deliberate fault) is refused: update off by "
              f"{m1:.3g} after one bunch (tol {CHUNK_ONE_REL_FRO}), {m3:.3g} after three (tol "
              f"{CHUNK_REL_FRO})", flush=True)

    # n_real below capacity: rows past n_real * bunch are never read (they hold
    # NaN here), and the state equals the trimmed run bit for bit (the kernels
    # are deterministic: no atomics)
    cfg = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
    run = rc.make_resident_train_chunk(cfg, opt)
    xp = torch.cat([x[:n_b * BUNCH], torch.full((2 * BUNCH, FLAGSHIP[0]), float("nan"),
                                                device="cuda")]).contiguous()
    tp = torch.cat([t_lin[:n_b * BUNCH], torch.full((2 * BUNCH, FLAGSHIP[-1]), float("nan"),
                                                    device="cuda")]).contiguous()
    xp0, tp0 = xp.clone(), tp.clone()
    padded = run(init_train_state(mlp), xp, tp, 17, *hyp, n_real=n_b)
    trimmed = run(init_train_state(mlp), x[:n_b * BUNCH], t_lin[:n_b * BUNCH], 17, *hyp)
    partial = run(init_train_state(mlp), x, t_lin, 17, *hyp)
    torch.cuda.synchronize()
    for a, b, c in zip(_state_tensors(padded), _state_tensors(trimmed), _state_tensors(partial)):
        _check(torch.equal(a, b), "n_real-padded run differs from the trimmed run")
        _check(torch.equal(c, b), "run with a trailing partial bunch differs from the trimmed run")
    _check(padded.step == trimmed.step == partial.step == n_b, "step does not advance by n_real")
    _check(torch.equal(xp.nan_to_num(7.0), xp0.nan_to_num(7.0))
           and torch.equal(tp.nan_to_num(7.0), tp0.nan_to_num(7.0)), "the chunk was written to")
    # hyperparameters changed between two calls of one runner
    st_k, st_p = init_train_state(mlp), init_train_state(mlp)
    for seed, h in ((5, (1.0, 0.5, 1e-5)), (6, (0.7, 0.9, 0.0))):
        run(st_k, x, t_lin, seed, *h)
        rc.resident_train_chunk_reference(st_p, x, t_lin, cfg, BUNCH,
                                          rc._scal_coefs("parity", BUNCH, FLAGSHIP[-1], *h), seed,
                                          dtype=f64)
    _hold_chunk(st_k, st_p, init, "two calls, hyperparameters changed", worst)
    # the per-bunch step of ops/train_step.py launches the same kernels with
    # explicit masks: the same bits, so the same state bit for bit
    st_s = init_train_state(mlp)
    for i in range(n_b):
        masks = [rc.sample_resident_masks(17, i, l, (BUNCH, FLAGSHIP[l]), 0.1 if l == 0 else 0.2)
                 for l in range(4)]
        fused_train_step(st_s, x[i * BUNCH:(i + 1) * BUNCH], t_lin[i * BUNCH:(i + 1) * BUNCH],
                         cfg, opt, dropout_masks=masks)
    torch.cuda.synchronize()
    for a, b in zip(_state_tensors(st_s), _state_tensors(trimmed)):
        _check(torch.equal(a, b), "ops.train_step.fused_train_step differs from the chunk trainer")
    print(f"[kernel] chunk trainer: n_real below capacity (NaN rows beyond never read) and a "
          f"trailing partial bunch equal the trimmed run bit for bit; two calls with changed "
          f"hyperparameters hold; ops.train_step's per-bunch step gives the same bits; worst "
          f"update error of any tensor {worst['rel_fro']:.3g} relative Frobenius after 3 or 2 x 3 "
          f"bunches (tol {CHUNK_REL_FRO}: carried rounding, room for one ReLU flip), "
          f"{worst['one']:.3g} after one bunch (tol {CHUNK_ONE_REL_FRO})", flush=True)

    # ms per bunch: 100 bunches of dropout training in one call
    n_t = 100
    xt, tt = _randn(gen, n_t * BUNCH, FLAGSHIP[0]), _randn(gen, n_t * BUNCH, FLAGSHIP[-1])
    st = init_train_state(mlp)
    small = (1e-3, 0.5, 0.0)
    ms = _time_ms(lambda: run(st, xt, tt, 3, *small), reps=3, warmup=1) / n_t
    coefs = rc._scal_coefs("parity", BUNCH, FLAGSHIP[-1], *small)
    st = init_train_state(mlp)
    plain_ms = _time_ms(lambda: rc.resident_train_chunk_reference(
        st, xt[:10 * BUNCH], tt[:10 * BUNCH], cfg, BUNCH, coefs, 3), reps=2, warmup=1) / 10
    kn = sum(a * b for a, b in zip(FLAGSHIP[:-1], FLAGSHIP[1:]))
    # three products a layer (forward, gradient, dedy), two for the first: it
    # hands no dedy down; W read by the forward, W and delta read and written
    # by the backward; the bunch's x and t read once
    flops = 2.0 * BUNCH * (3 * kn - FLAGSHIP[0] * FLAGSHIP[1])
    nbytes = 4.0 * (5 * kn + BUNCH * (FLAGSHIP[0] + FLAGSHIP[-1]))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"[kernel] chunk trainer {n_t} bunches of {BUNCH}, dropout on: {ms:.4f} ms per bunch "
          f"({flops / ms / 1e9:.2f} TFLOP/s), plain float32 version {plain_ms:.4f} ms per bunch, "
          f"bound {max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP at 67 TFLOP/s: {t_ops:.4f}; "
          f"{nbytes / 1e6:.0f} MB at 3.35 TB/s: {t_bytes:.4f})", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=worst["abs"], rel_fro_err=worst["rel_fro"],
                rel_fro_err_one_bunch=worst["one"], shape=f"{BUNCH} x 1548-2048x3-129, per bunch")


def _speechlike(rng, n: int, sr: int) -> np.ndarray:
    """A voiced, amplitude-modulated harmonic signal with pauses: enough
    structure for the net to learn from."""
    t = np.arange(n) / sr
    f0 = rng.uniform(90, 250) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 3) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum(rng.uniform(0.2, 1.0) / h * np.sin(h * phase + rng.uniform(0, 6.28))
              for h in range(1, 12))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 4) * t + rng.uniform(0, 6.28)), 0, None) ** 2
    return (0.25 * sig * env / max(np.abs(sig).max(), 1e-9)).astype(np.float32)


def _train_args(tmp, corpus, out, init, train_range, extra):
    return [f"fea_file={corpus['fea']}", f"targ_file={corpus['targ']}",
            f"norm_file={corpus['norm']}", f"outwts_file={tmp}/{out}.wts",
            f"log_file={tmp}/{out}.log", f"train_sent_range={train_range}",
            f"cv_sent_range={corpus['cv_range']}", "fea_dim=129", "fea_context=11",
            "targ_offset=5", "traincache=102400", f"bunchsize={BUNCH}", "lrate=0.1",
            "weightcost=0", "visible_omit=0.1", "hid_omit=0.2",
            "init_randem_weight_min=-0.03", "init_randem_weight_max=0.03",
            "layersizes=" + ",".join(str(s) for s in FLAGSHIP)] \
        + ([f"initwts_file={init}"] if init else []) + extra


def _run_train_cli(tmp, args, label):
    """`python -m tpu_sednn_torch.cli args` -> (CV MSE from the log, launch
    counters the command reported, wall seconds, log text)."""
    report = os.path.join(tmp, f"launches_{label}.json")
    env = dict(os.environ, TPU_SEDNN_TORCH_LAUNCH_REPORT=report)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_sednn_torch.cli"] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"training command ({label}) failed:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
    _check(proc.stdout.strip().endswith("all finish!"), f"({label}) no 'all finish!'")
    log_path = next(a.split("=", 1)[1] for a in args if a.startswith("log_file="))
    log = open(log_path).read()
    cv = [float(l.rsplit(":", 1)[1]) for l in log.splitlines()
          if l.startswith("CV over. squared error:")]
    _check(len(cv) == 1 and np.isfinite(cv[0]), f"({label}) CV MSE not finite: {cv}")
    with open(report) as f:
        counts = json.load(f)
    return cv[0], counts, wall, log


def phase_train(tmp: str, smi: str) -> dict:
    from tpu_sednn_torch.io import load_wts, write_wav
    from tpu_sednn_torch.ops import launch_counts, reset_launch_counts
    from tpu_sednn_torch.tools import make_pfile

    # corpus: 200 utterances of 10.2 s at 8 kHz, speech-like + coloured noise at
    # 0-15 dB SNR -> ~127,000 frames; the first 190 train (> one full chunk of
    # 102400 samples = 800 bunches, then a ragged one), the last 10 are CV
    rng = np.random.default_rng(2024)
    sr, n_utt = 8000, 200
    noisy, clean = [], []
    for i in range(n_utt):
        n = int(rng.uniform(10.1, 10.4) * sr)
        s = _speechlike(rng, n, sr)
        noise = np.convolve(rng.standard_normal(n + 8), rng.uniform(-1, 1, 9), "valid")
        snr = rng.uniform(0, 15)
        noise *= np.sqrt(np.mean(s ** 2) / (np.mean(noise ** 2) * 10 ** (snr / 10)))
        for kind, sig, paths in (("clean", s, clean), ("noisy", s + noise, noisy)):
            path = os.path.join(tmp, f"{kind}{i}.wav")
            write_wav(path, np.clip(sig, -1, 1).astype(np.float32), sr)
            paths.append(path)
    corpus = dict(fea=f"{tmp}/noisy.pfile", targ=f"{tmp}/clean.pfile", norm=f"{tmp}/noisy.norm",
                  cv_range=f"{n_utt - 10}-{n_utt - 1}")
    reset_launch_counts()  # the training path's run starts here (corpus set-up included)
    t0 = time.perf_counter()
    n_frames = make_pfile.build_pfile(noisy, corpus["fea"], corpus["norm"], device="cuda")
    # targets normalized by the packer, as make_pfile's docstring says
    make_pfile.build_pfile(clean, corpus["targ"], f"{tmp}/clean.norm", normalize=True,
                           device="cuda")
    n_stft = launch_counts()["stft_lps"]
    _check(n_frames >= 120000 and n_stft == 2 * n_utt,
           f"corpus: {n_frames} frames, {n_stft} stft_lps launches")
    print(f"[train] corpus: {n_utt} noisy/clean utterance pairs, {n_frames} frames each, LPS "
          f"pfiles by make_pfile on the card in {time.perf_counter() - t0:.1f} s "
          f"({n_stft} stft_lps launches)", flush=True)

    do = ["dropoutflag=1", "engine=auto"]
    train_range = f"0-{n_utt - 11}"
    cv1, c1, wall1, log1 = _run_train_cli(
        tmp, _train_args(tmp, corpus, "mlp.1", "", train_range,
                         do + ["momentum=0.5", "init_randem_seed=27863875"]), "epoch1")
    cv2, c2, wall2, log2 = _run_train_cli(
        tmp, _train_args(tmp, corpus, "mlp.2", f"{tmp}/mlp.1.wts", train_range,
                         do + ["momentum=0.54", "init_randem_seed=27864220"]), "epoch2")
    ws, bs = load_wts(f"{tmp}/mlp.2.wts", layersizes=list(FLAGSHIP))
    _check([w.shape for w in ws] == [(a, b) for a, b in zip(FLAGSHIP[:-1], FLAGSHIP[1:])]
           and all(np.isfinite(w).all() for w in ws + bs), "mlp.2.wts does not reload")
    _check(cv2 < cv1, f"CV MSE did not fall: {cv1} -> {cv2}")
    header = next(l for l in log1.splitlines() if l.startswith("Training sentences have"))
    n_chunks, n_samples = int(header.split()[3]), int(header.split()[5])
    chunk_sizes = sorted(int(l.split()[-2]) for l in log1.splitlines()
                         if l.startswith("Starting chunk"))
    n_bunches = sum(c // BUNCH for c in chunk_sizes)
    _check(n_chunks >= 2 and chunk_sizes[-1] == 102400 and chunk_sizes[0] % BUNCH != 0,
           f"chunks {chunk_sizes}: want one full chunk of 102400 and a ragged one")
    for label, c in (("epoch 1", c1), ("epoch 2", c2)):
        k = c["resident_chunk_kernels"]
        _check(c["resident_chunk"] == n_chunks and c["plain_train_chunk"] == 0,
               f"{label}: chunk trainer launched {c['resident_chunk']} times for {n_chunks} "
               f"chunks, plain trainer {c['plain_train_chunk']} times")
        # per bunch: 4 fwd_kernel each with its fwd_sum_kernel (K is split at
        # every flagship layer), 4 bwd_kernel, 3 reduce_dedy_kernel (none
        # below the first layer); 3 forwards and the first layer's backward
        # and forward draw masks
        _check(k["fused_linear_act"] == 4 * n_bunches and k["fused_linear_act_sum"] == 4 * n_bunches
               and k["fused_bwd_update"] == 4 * n_bunches and k["reduce_dedy"] == 3 * n_bunches
               and k["philox_mask"] == 4 * n_bunches,
               f"{label}: kernel launches {k} for {n_bunches} bunches")
    times = [float(l.split()[3]) for l in (log1 + log2).splitlines()
             if l.startswith("Total cost time:")]
    print(f"[train] python -m tpu_sednn_torch.cli, 1548-2048x3-129, dropout 0.1/0.2, engine=auto "
          f"on {smi}: {n_chunks} chunks {chunk_sizes}, {n_samples} samples, {n_bunches} bunches "
          f"per epoch; CV MSE {cv1:.6f} -> {cv2:.6f}; epoch (read, train, CV) {times[0]:.1f} s and "
          f"{times[1]:.1f} s = {n_samples / times[0]:.0f} and {n_samples / times[1]:.0f} samples/s; "
          f"command wall {wall1:.1f} s and {wall2:.1f} s incl. start-up; chunk trainer launched "
          f"{c1['resident_chunk']} + {c2['resident_chunk']} times, plain trainer 0 times",
          flush=True)

    # dropout off, a shorter range, both engines from the same weights
    short = ["dropoutflag=0", "momentum=0.5", "init_randem_seed=11"]
    cv_r, c_r, _, _ = _run_train_cli(
        tmp, _train_args(tmp, corpus, "res", f"{tmp}/mlp.1.wts", "0-19", short + ["engine=resident"]),
        "resident")
    cv_x, c_x, _, _ = _run_train_cli(
        tmp, _train_args(tmp, corpus, "xla", f"{tmp}/mlp.1.wts", "0-19", short + ["engine=xla"]),
        "xla")
    _check(c_r["resident_chunk"] == 1 and c_r["plain_train_chunk"] == 0
           and c_x["resident_chunk"] == 0 and c_x["plain_train_chunk"] == 1,
           f"engines: resident run {c_r}, xla run {c_x}")
    w_r, b_r = load_wts(f"{tmp}/res.wts", layersizes=list(FLAGSHIP))
    w_x, b_x = load_wts(f"{tmp}/xla.wts", layersizes=list(FLAGSHIP))
    w_0, b_0 = load_wts(f"{tmp}/mlp.1.wts", layersizes=list(FLAGSHIP))
    # held on the update, as the chunk trainer is above (biases start near 0,
    # so a tolerance relative to the weights themselves would hide them)
    upd_fro = max(float(np.linalg.norm(a - b) / np.linalg.norm(b - c))
                  for a, b, c in zip(w_r + b_r, w_x + b_x, w_0 + b_0))
    _check(abs(cv_r - cv_x) <= 1e-3 * cv_x and upd_fro <= ENGINE_REL_FRO,
           f"engine=resident vs engine=xla: CV {cv_r} vs {cv_x}, update off by {upd_fro}")
    print(f"[train] dropout off, sentences 0-19: engine=resident CV MSE {cv_r:.6f}, engine=xla "
          f"(plain torch on the card) {cv_x:.6f} (tol 1e-3 relative); the epoch's update of every "
          f"tensor within {upd_fro:.3g} relative Frobenius (tol {ENGINE_REL_FRO}: two float32 "
          f"summation orders, ReLU flips and carried rounding over "
          f"{c_r['resident_chunk_kernels']['fused_bwd_update'] // 4} bunches)", flush=True)
    train_counts = {k: c1[k] + c2[k] + c_r[k] + c_x[k] for k in
                    ("resident_chunk", "fused_linear_act", "fused_linear_act_sum",
                     "fused_bwd_update", "fused_bwd_update_reduce", "plain_train_chunk")}
    kernel_counts = {k: sum(c["resident_chunk_kernels"][k] for c in (c1, c2, c_r, c_x))
                     for k in c1["resident_chunk_kernels"]}

    prof = _profile_chunk(corpus, train_range)
    return dict(cv=[cv1, cv2], samples_per_s=[n_samples / t for t in times[:2]],
                epoch_seconds=times[:2], n_samples=n_samples, n_bunches=n_bunches,
                stft_launches=n_stft, counts=train_counts, kernel_counts=kernel_counts, **prof)


def _profile_chunk(corpus: dict, train_range: str) -> dict:
    """One full chunk (800 bunches) in this process, as train_epoch_pfile
    runs it: host read, host->device copy, on-device splice, chunk trainer —
    timed, then the trainer traced by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_sednn_torch.data.device_chunk import (build_chunk_on_device, chunk_capacities,
                                                   read_chunk_indexed)
    from tpu_sednn_torch.data.pipeline import plan_chunks
    from tpu_sednn_torch.data.rand48 import Rand48
    from tpu_sednn_torch.io import load_norm, read_pfile_info
    from tpu_sednn_torch.model.mlp import init_params
    from tpu_sednn_torch.ops.resident_chunk import make_resident_train_chunk
    from tpu_sednn_torch.train.loop import _to_device
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    fea_info, targ_info = read_pfile_info(corpus["fea"], 129), read_pfile_info(corpus["targ"], 129)
    mean, istd = load_norm(corpus["norm"], 129)
    lo, hi = (int(v) for v in train_range.split("-"))
    plan = plan_chunks(fea_info.frames_before_sent, (lo, hi), 11, 102400)
    caps = chunk_capacities(fea_info, plan, 11)
    t0 = time.perf_counter()
    item = read_chunk_indexed(fea_info, targ_info, plan, 0, 11, mean, istd, Rand48(1),
                              frames_cap=caps[0], samples_cap=caps[1], seg_cap=caps[2])
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_item = [_to_device(a, torch.device("cuda", 0)) for a in item[:6]]
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    h2d_mb = sum(a.nbytes for a in item[:6]) / 1e6
    t0 = time.perf_counter()
    x, t = build_chunk_on_device(*dev_item, 11, 5, True)
    torch.cuda.synchronize()
    splice_ms = (time.perf_counter() - t0) * 1e3
    n_real = item[6] // BUNCH
    cfg = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
    opt = OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0, bunchsize=BUNCH)
    run = make_resident_train_chunk(cfg, opt)
    state = init_train_state(init_params(torch.Generator().manual_seed(0), cfg, device="cuda"))
    run(state, x, t, 1, opt.lrate, opt.momentum, opt.weightcost, n_real=8)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(state, x, t, 2, opt.lrate, opt.momentum, opt.weightcost, n_real=n_real)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # The tracer can lose records (a few at the end of a trace, at times most
    # of them), so a trace is kept when it holds 99.9% of the launches the
    # trainer tallied; else it is taken again, three times at most, and the
    # fullest is shown with what it lacks.  The trace is a measurement: the
    # times above stand without it.
    from tpu_sednn_torch.ops.resident_chunk import kernel_launches

    best = None
    for attempt in range(3):
        before = dict(kernel_launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(state, x, t, 3 + attempt, opt.lrate, opt.momentum, opt.weightcost, n_real=n_real)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        launched = sum(kernel_launches[k] - before[k] for k in kernel_launches if k != "philox_mask")
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                         key=lambda e: -dev_us(e))
        traced = sum(e.count for e in kernels)
        if best is None or traced > best[0]:
            best = (traced, kernels, traced_ms)
        if traced >= 0.999 * launched:
            break
    traced, kernels, traced_ms = best
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    total = host_ms + h2d_ms + splice_ms + train_ms
    print(f"[train] one full chunk in process ({item[6]} samples, {n_real} bunches): host read + "
          f"index tables {host_ms:.1f} ms, host->device {h2d_mb:.0f} MB in {h2d_ms:.1f} ms "
          f"({100 * h2d_ms / total:.2f}% of the chunk's {total:.0f} ms when nothing overlaps), "
          f"on-device splice {splice_ms:.1f} ms, chunk trainer {train_ms:.1f} ms = "
          f"{train_ms / n_real:.4f} ms per bunch, {n_real * BUNCH / train_ms * 1e3:.0f} samples/s "
          f"(its launches enqueued in {enqueue_ms:.1f} ms)", flush=True)
    complete = traced >= 0.999 * launched
    print(f"[train] profile of that chunk's trainer (trace {attempt + 1}, {traced} of {launched} "
          f"kernel launches in it{'' if complete else ': INCOMPLETE, idle share not measured'}): "
          f"traced {traced_ms:.1f} ms wall, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / traced_ms:.1f}%), idle {max(traced_ms - busy_ms, 0):.1f} ms "
          f"({100 * max(traced_ms - busy_ms, 0) / traced_ms:.1f}%)")
    shares = {}
    for e in kernels[:6] if busy_ms > 0 else []:
        shares[e.key[:60]] = dev_us(e) / 1e3 / busy_ms
        print(f"[train]   {dev_us(e) / 1e3:8.2f} ms ({100 * dev_us(e) / 1e3 / busy_ms:4.1f}%) "
              f"x{e.count:<5d} {e.key[:90]}")
    return dict(chunk_ms_per_bunch=train_ms / n_real, chunk_samples_per_s=n_real * BUNCH / train_ms * 1e3,
                h2d_ms=h2d_ms, h2d_share=h2d_ms / total, host_ms=host_ms, splice_ms=splice_ms,
                idle_share=max(traced_ms - busy_ms, 0) / traced_ms if complete else None,
                trace_launches=[traced, launched], kernel_shares=shares)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="", help="comma-separated subset of serve,kernels,train "
                    "(for development: prints no kernels line and no final line, exits with 2)")
    args = ap.parse_args(argv)
    groups = set(filter(None, args.only.split(","))) or {"serve", "kernels", "train"}
    if not groups <= {"serve", "kernels", "train"}:
        ap.error(f"unknown group in --only {args.only!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    from tpu_sednn_torch import resolve_device

    resolve_device("cuda")
    t_start = time.perf_counter()
    smi = phase_device()
    gen = torch.Generator(device="cuda").manual_seed(1234)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "serve" in groups:
            kern = phase_kernel_vs_plain(gen)
            wavs, norm_8k, n_featurizer = phase_featurizer(tmp, np.random.default_rng(7))
            serving, n_serving = phase_serving(gen, norm_8k, smi)
            phase_cli(tmp, wavs, norm_8k)
            # the serving decode computes re/im by matmul for the noisy phase, as
            # the JAX decode does, so only the featurizer's path runs this kernel
            _check(n_featurizer > 0, "the featurizer path never launched the stft_lps kernel")
            print(f"[serving] summary {json.dumps(serving)}")
        if "kernels" in groups:
            fused = phase_fused_kernels(gen)
            masks = phase_masks()
            resident = phase_resident(gen)
            torch.cuda.empty_cache()
        if "train" in groups:
            train = phase_train(tmp, smi)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    if groups != {"serve", "kernels", "train"}:
        print(f"partial run (--only {args.only}): no kernels line, no final line", file=sys.stderr)
        return 2

    kc, tc = train["kernel_counts"], train["counts"]
    for name, n in (("resident_chunk", tc["resident_chunk"]), ("fused_linear_act", kc["fused_linear_act"]),
                    ("fused_bwd_update", kc["fused_bwd_update"]), ("philox_mask", kc["philox_mask"]),
                    ("stft_lps", train["stft_launches"])):
        _check(n > 0, f"the training path never launched the {name} kernel")
    t8 = kern[8000]
    kernels = [
        dict(name="stft_lps", source="tpu_sednn_torch/csrc/stft_lps.cu",
             replaces="tpu_sednn/ops/stft_pallas.py:34",
             launches=n_featurizer + n_serving + train["stft_launches"],
             launches_by_path={"make_pfile": n_featurizer, "serving": n_serving,
                               "train": train["stft_launches"]},
             max_abs_err=kern["max_abs_err"], tol_ratio=kern["tol_ratio"], ms=t8["ms"],
             plain_ms=t8["plain_ms"], bound_ms=t8["bound_ms"], bound_by=t8["bound_by"],
             library_ms=t8["library_ms"], shape=t8["shape"], at_16k=kern[16000], route="cuda"),
        dict(name="fused_linear_act", source="tpu_sednn_torch/csrc/fused_mlp.cu",
             replaces="tpu_sednn/ops/fused_mlp.py:65",
             launches=kc["fused_linear_act"] + tc["fused_linear_act"],
             launches_by_path={"make_pfile": 0, "serving": 0,
                               "train": kc["fused_linear_act"] + tc["fused_linear_act"]},
             launches_of="fwd_kernel; its fwd_sum_kernel (K split over the grid) in sum_launches",
             sum_launches=kc["fused_linear_act_sum"] + tc["fused_linear_act_sum"],
             shape="one bunch of 128 through the four layers of 1548-2048x3-129",
             **{k: v for k, v in fused["fwd"].items() if k not in ("flops", "nbytes")}, route="cuda"),
        dict(name="fused_bwd_update", source="tpu_sednn_torch/csrc/fused_mlp.cu",
             replaces="tpu_sednn/ops/fused_mlp.py:108",
             launches=kc["fused_bwd_update"] + tc["fused_bwd_update"],
             launches_by_path={"make_pfile": 0, "serving": 0,
                               "train": kc["fused_bwd_update"] + tc["fused_bwd_update"]},
             launches_of="bwd_kernel; its reduce_dedy_kernel (no layer below the first) in "
                         "reduce_launches",
             reduce_launches=kc["reduce_dedy"] + tc["fused_bwd_update_reduce"],
             shape="one bunch of 128 through the four layers of 1548-2048x3-129",
             library_ms=None,
             **{k: v for k, v in fused["bwd"].items() if k not in ("flops", "nbytes")}, route="cuda"),
        dict(name="resident_chunk", source="tpu_sednn_torch/csrc/resident_chunk.cu",
             replaces="tpu_sednn/ops/resident_chunk.py:169", launches=tc["resident_chunk"],
             launches_by_path={"make_pfile": 0, "serving": 0, "train": tc["resident_chunk"]},
             ms_per_bunch_in_a_full_chunk=train["chunk_ms_per_bunch"], **resident, route="cuda"),
        dict(name="philox_mask", source="tpu_sednn_torch/csrc/philox.cuh",
             replaces="tpu_sednn/ops/resident_chunk.py:970", launches=kc["philox_mask"],
             launches_by_path={"make_pfile": 0, "serving": 0, "train": kc["philox_mask"]},
             **masks, route="cuda"),
    ]
    print(f"[train] summary {json.dumps(train)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
