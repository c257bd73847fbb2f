#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_sednn_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: the card's name and power limit (nvidia-smi); build the port's
     CUDA kernels (csrc/stft_lps.cu, fused_mlp.cu, resident_chunk.cu,
     sr_update.cu, dropout_mask.cu, rank_sum.cu) with nvcc (sm_90a), one nvcc
     per source, all started together.
  2. kernel vs plain: the STFT-LPS kernel (an FFT in each warp's registers)
     against its plain torch version on the card at 8 kHz, 16 kHz
     and the generic 11025, 22050, 44100 and 48000 Hz geometries (n_fft 512
     to 2048, hop % 4 == 0 and != 0, win % 4 != 0, win < n_fft; ragged
     tails, exactly one window, batches; signals with a noise floor), LPS atol/rtol 1e-4; then kernel, plain and
     torch.stft (cuFFT, the yardstick only) times at the serving shapes
     64 x 64 s / 8 kHz and 64 x 32 s / 16 kHz, beside the kernel's bound on
     an H100 SXM (bytes; the direct DFT's operations floor beside it).
  3. featurizer (main path): `tools.make_pfile` on 8 seeded noisy wavs with
     --device cuda, against build_pfile(device="cpu") on the same wavs.
  4. serving (main path): make_serving_decoder at full width,
     1548-2048x3-129 on 64 x 64 s at 8 kHz and 3084-2048x3-257 on
     64 x 32 s at 16 kHz, random glorot weights from a seed with parity
     dropout 0.1/0.2 folded in; output finite, of the right shape, its first
     two utterances equal to the same decoder on the CPU; audio-s/s.  Then
     the serving modes at the full width of both nets (8 kHz: the lps head,
     NAT, the featurizer's .norm; 16 kHz: a psm head with a target norm),
     each run with every launch count zeroed just before it and held to
     launch no kernel of the port, as the JAX decode reaches no Pallas kernel:
     [stream] StreamingEnhancer and DeviceStreamingEnhancer at block 1 and 8
     on seeded chunkings against the offline card decode (max err 5e-5),
     scan_blocks against push (1e-6), the step's time (CUDA events), push
     per block, scan_blocks audio-s/s, real-time factor, algorithmic latency;
     [quant] int8 weights and one layer's int32 accumulators (1 to 640 rows)
     bit-equal to the CPU plain version, the int8 forward within 1e-6 of the
     CPU's and under 2% of float32, the int8 decode under 0.5 dB LSD of
     float32, int8 device streams at blocks 1 and 8, int8 and float32
     serving audio-s/s and parameter bytes; [fusion] two full-width models:
     weights (1, 0) against the single model (1e-6), the fused serving
     decoder against the eager fused decode (rtol 1e-4, atol 1e-5), its
     audio-s/s.  Then the `python -m tpu_sednn_torch.enhance` command on a
     wav in its five modes (offline, --stream 8, --stream 8 --stream-device,
     --quant int8, --fuse-with a run dir), the five at once, with a .wts and
     .norm the port wrote, each against the in-process decode of its mode.
  5. fused layer kernels (fused_linear_act, fused_bwd_update) with float32
     products (bf16=False) against their float64 plain versions at the four
     flagship layer shapes and at ragged ones up to 512 rows (the backward's
     16-, 32- and 64-row stripes), with in-kernel and explicit dropout masks,
     the backward also on bfloat16 delta and bfloat16 W and delta; more
     rows than the backward takes refused in both forms; their times at 8
     and 16 kHz, the plain versions' and torch.addmm's beside the bound.  Then their tensor-core forms
     (bf16=True, the default) at the four 8 kHz and four 16 kHz layer shapes
     and ragged ones, float32 and bfloat16 W, against the float64 plain
     versions of the same rounded operands; the float32-FMA form and
     truncated operands refused; times beside the bytes bound and a bfloat16
     torch.addmm.  For both forms the backward's plan (split, stripes) and,
     layer by layer, its time by part (the fused update, the gradient alone,
     with dedy, reduce_dedy_kernel traced).
  6. dropout stream: the device Philox against the Random123 known-answer
     vectors and, bit for bit, against its plain version; zero rate, stream
     distinctness and rank-slice identity of sample_resident_masks.  The
     chunk trainer's input-mask table (input_mask_bits_kernel, one launch a
     call) bit-equal to its plain version at K 1548, 3084, 129 and 33, tiles
     of 128 and 64 rows, and on a whole 800-tile call; the layer-0 wrappers
     reading a table bit-equal to their Philox draw; a call with input
     dropout and no table refused; the draw's time beside its bound.
  7. chunk trainer at full width (1548-2048x3-129, bunch 128) against its
     float64 plain version, float32 products: rules parity and clean, dropout
     off / parity / inverted, a sigmoid head, n_real below capacity, a
     partial bunch, hyperparameters changed between calls; a deliberately
     wrong hyperparameter is refused; ops/train_step's per-bunch step against
     it.  The same cases with tensor-core products (TC_ONE_REL_FRO), faults
     refused; the chunk trainer's chain of programmatic dependent launches
     bit-equal to the standalone wrappers launched one by one (tensor cores
     with float32 state and sr_delta, and float32 products; the same masks
     and rounding streams) and its `pdl` tally at 2 L n_real - 1 a call, the
     input masks drawn by one launch a call and by no layer kernel; ms per
     bunch of both forms; SHA-256 digests of the state after an 800-bunch
     call in both forms (CHUNK_DIGEST_FORMS, for comparing two checkouts).
  8. training (main path): a seeded speech-like corpus -> noisy and clean LPS
     pfiles with make_pfile on the card (> 120,000 frames), then
     `python -m tpu_sednn_torch.cli` twice (momentum 0.5, then 0.54 warm
     started), dropout on, engine=auto (tensor-core products): "all
     finish!", the .wts reloads, CV MSE finite and falling, the chunk trainer
     launched once per chunk in its tensor-core form and the plain trainer
     never; the same two epochs with float32 products (run_epoch,
     bf16=False) end within TC_CV_FRACTION; engine=resident with float32
     products and with tensor cores against engine=xla with dropout off;
     samples/s, ms per bunch; one full chunk (800 bunches) trained twice
     from the same state, bit for bit equal (their state digests printed),
     the host's own cost a bunch
     (100 bunches enqueued behind a spin kernel), and a trace of 200 bunches
     with the device's busy time as the union of the kernels' intervals
     (with programmatic dependent launches they overlap).
  9. stochastic rounding and the two standalone kernels (kernels group): the
     rounding device function bit-equal to its plain version on zeros,
     denormals, Inf, NaN, exact bfloat16 values and their neighbours, and
     unbiased; sr_momentum_update (kernel 6) bit-equal to its plain version
     at the 16 kHz layer shapes, float32 and bfloat16 gradients;
     dropout_mask (kernel 5) bit-equal at four shapes, its zero rate, its
     seed + block identity; its batches (dropout_masks, one launch up to 64
     masks): mixed shapes, row0 > 0, omit 0 and 1 bit-equal to the plain
     version, a group of 8 16 kHz bunches' 32 masks equal to 32 single
     draws, more than 64 masks in launches of at most 64; one bunch's four
     masks and a group's in one launch beside their bounds; kernels 1 and 2
     on bfloat16 W / delta at the four 16 kHz layer shapes (N = 257: 2-byte
     aligned rows); times beside the bytes bounds.
 10. chunk trainer variants at 3084-2048x3-257 (kernels group): float32,
     sr_delta and sr_state under both rules, and row tiles, against the
     float64 plain version with the same Philox bits, at the limits of a
     draw of inputs without a ReLU flip: a seeded draw is passed over (up to
     eight) only if the float32 plain version misses the limits there too;
     tile_rows 32 and 64 against the untiled run; hbm_spill=1 bit-equal to
     the unspilled run; a wrong hyperparameter given to the sr_delta or the
     sr_state trainer is refused; the tensor-core float32-state, sr_delta and
     sr_state forms against the float64 plain version of the same rounding,
     faults refused; ms per bunch of each form beside its bound; state
     digests of the sr_delta, sr_state, hbm_spill and tile_rows=64 forms
     after a 100-bunch call.  Then
     chain_times: the tensor-core chunk trainer at 8 kHz and 16 kHz sr_delta
     and the float32 one at 8 kHz timed whole, with the device alone and the
     host's own cost a bunch.
 11. in-memory training (main path, train group): a seeded corpus featurized
     at 16 kHz on the STFT kernel -> build_training_arrays (> 16,384 x 3084)
     -> train_epochs_arrays at 3084-2048x3-257, recipe schedule, parity
     dropout: two epochs on engine=auto with sr_delta (tensor cores; CV MSE
     falling), on the float32 engine and on sr_delta with float32 products
     (final CVs within SR_CV_FRACTION); one epoch each of sr_state (both
     products), hbm_spill=1, clean-rule row tiles, and engine=xla
     with dropout_rng="tpu_prng" (kernel 5 on its path: one launch a group of
     8 bunches' masks, counted); sr_train_step at
     full width (kernel 6 on its path); kill and resume through a checkpoint
     equal to the straight run bit for bit.
 12. the multi-condition recipe (main path, recipe group):
     tpu_sednn_torch.recipes.multi_condition's non-small default on the
     card (1548-2048x3-129 at 8 kHz, PSM head, parity dropout 0.1/0.2, bunch
     128, 120 utterances x 6 SNRs x white/pink/babble, 15 epochs on the
     tensor-core chunk trainer), scored on those families and on factory and
     siren: the stage times (corpus, featurize, targets, train with
     samples/s, eval), CV falling, every eval number finite, the 0 dB clip's
     SNR and STOI above the noisy input's; run.json + mlp.final.wts reloaded
     by load_run_dir decode that clip bit for bit as the recipe's final state
     and score exactly the recipe's block.  Then the on-device sample builder
     (data/device_pipeline.py on the STFT kernel) on the corpus's first 16
     pairs against its CPU plain version (X rtol/atol 1e-4, T atol 2e-2 and
     rtol 1e-4, each plus the element's float32 rounding bound).
 13. data parallelism (main path, dp group): the DP forward, the
     gradient-out backward, the update kernel and rank_sum against their
     plain versions, with times; the DP chunk trainer on 4 and on 2 ranks of
     this script sharing the card (gloo for the rendezvous, the sums on the
     card through CUDA IPC) against the single-process trainer, replicas
     bit-equal, three faults refused, pfile epochs on 4 ranks; then
     `python -m torch.distributed.run --nproc_per_node=2 -m
     tpu_sednn_torch.cli ... gpu_used=2` against gpu_used=1.
 14. tensor parallelism (main path, dp group): make_auto_sharded_train_chunk
     on 4 ranks of this script sharing the card (gloo; the sums and the
     column gathers on the card, rank_sum), 1548-2048x3-128 (the 8 kHz net,
     head cut to a width 2 and 4 divide) on 1 x 2 and 2 x 2 sharded and
     1548-2048x3-129 on 2 x 2 whole, parity dropout: after 2 bunches against
     the single-process reference_train_chunk (rtol 1e-5 / atol 1e-6), the
     16-bunch drift, every rank's state bit-equal, a skipped "model" sum
     refused, the 129-wide head refused to shard; ms a bunch and the
     collectives' share.
 15. the recipe's data-parallel branch (main path, dp group): `python -m
     torch.distributed.run --nproc_per_node=2 -m
     tpu_sednn_torch.recipes.multi_condition --small --device cuda` against
     one rank on the plain trainer over the same bunches (CV history and
     weights at _hold_parity's limits), rank 0 alone writing the run dir,
     which reloads; the same command on one rank for its times.
 16. a `kernels` JSON line: every ported kernel and trainer form with its
     launches on the main paths, error and times.  Each path (phases 3, 4,
     8, 11, 12, 13, 14, 15) is run with the counts zeroed just before it and
     read just after; `launches` is the total, `launches_by_path` the split.
`--only serve,kernels,train,recipe,dp` runs a subset while developing: it prints no
`kernels` line and no final line and exits with code 2.  `--chain-times`
only times the chunk trainer's chain (chain_times), `--bwd-times` only the
backward (bwd_times), `--fwd-times` only the float32 forward (fwd_times, with
SHA-256 digests of its outputs), `--mask-times` only the input mask's share
of layer 0 and of the chains, with the chunk trainer's state digests, and
kernel 5's times with the tpu_prng plain trainer's time and state digest
(mask_times), with `--package-root DIR` the package of another checkout (A/B
runs in one call); all four exit with 2.
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
PEAK_BF16_FLOPS = 989e12  # tensor cores, dense
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


def _spin_per_ms() -> float:
    """Cycles of torch.cuda._sleep a millisecond on this card (measured once)."""
    if not _SPIN:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 20_000_000 / start.elapsed_time(end)
    return _SPIN["per_ms"]


def _host_ms(fn) -> float:
    """The host's own time of fn(), by the host clock, while a spin kernel
    holds the card: no launch waits for the device or for a free slot of
    CUDA's launch queue (fn must enqueue fewer launches than the queue holds,
    about 1,024).  A run whose spin ended first is taken again, spinning longer."""
    fn()
    torch.cuda.synchronize()
    held = torch.cuda.Event()
    spin_ms, host = 50.0, 0.0
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * _spin_per_ms()))
        held.record()
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        in_time = not held.query()
        torch.cuda.synchronize()
        if in_time:
            return host
        spin_ms *= 4.0
    _check(False, f"the host took longer than a {spin_ms / 4.0:.0f} ms spin to enqueue "
                  f"({host:.1f} ms)")


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
    _spin_per_ms()
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


def _lps_slack(x: torch.Tensor, cfg) -> torch.Tensor:
    """The float32 rounding bound of an LPS of signal(s) x, float64, shaped
    as the LPS.  A float32 sum of win products, in any order, is within
    gamma = win*u / (1 - win*u) (u = 2^-24) times the sum of the products'
    magnitudes of the exact sum; that bounds the error dp of the power p =
    re^2 + im^2, and the LPS then moves by at most ln(p) - ln(p - dp).  The
    bound is ~1e-3 in typical bins and large only where a strong tone's
    leakage cancels to a small p, where ln magnifies the rounding of any
    float32 summation order."""
    from tpu_sednn_torch.dsp.stft import LPS_FLOOR, frame_signal, rdft_on

    frames = frame_signal(x, cfg).double()
    cos_m, sin_m = (m.double() for m in rdft_on(cfg, x.device))
    re, im = frames @ cos_m, frames @ sin_m
    u = 2.0 ** -24
    gamma = cfg.win_len * u / (1 - cfg.win_len * u)
    e_re, e_im = gamma * (frames.abs() @ cos_m.abs()), gamma * (frames.abs() @ sin_m.abs())
    p = re * re + im * im
    dp = (2 * re.abs() + e_re) * e_re + (2 * im.abs() + e_im) * e_im + 3 * u * p
    return torch.log(p.clamp(min=LPS_FLOOR)) - torch.log((p - dp).clamp(min=LPS_FLOOR))


def _lps_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor, cfg) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / tol): `got` is a float32 LPS of
    signal(s) x, `want` the plain version's (stft_lps_reference, float64 sums);
    tol = LPS_TOL + LPS_TOL * |want| + the float32 rounding bound (_lps_slack)."""
    got, want = got.to(x.device), want.to(x.device, torch.float64)
    _check(got.shape == want.shape, f"LPS shape {tuple(got.shape)} vs {tuple(want.shape)}")
    _check(bool(torch.isfinite(got).all()), f"non-finite LPS at {cfg.sample_rate} Hz")
    slack = _lps_slack(x, cfg)
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
    from tpu_sednn_torch.ops.stft_lps import fft_tables, stft_lps, stft_lps_reference

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
        (44100, 2, 44100 * 2 + 100), (44100, 1, 1411), (48000, 3, 48000 + 1),
    ]
    for sr, batch, n in cases:
        cfg = StftConfig.for_rate(sr)
        # the n_fft 2048 cases draw from generators of their own: the later
        # phases' draws from `gen` stay what they were before these cases
        x = _signals(gen if cfg.n_fft < 2048 else torch.Generator(device="cuda").manual_seed(n),
                     batch, n, sr)
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
        # the kernel's work: an n_fft-point real FFT a frame (2.5 n log2 n, the usual
        # count), the window and the power; the direct DFT's 4 win n_bins beside it
        flops = ((2.5 * cfg.n_fft * np.log2(cfg.n_fft) + cfg.win_len + 3 * cfg.n_bins)
                 * batch * n_frames)
        dft_flops = 4.0 * cfg.win_len * cfg.n_bins * batch * n_frames
        nbytes = 4.0 * (batch * n + batch * n_frames * cfg.n_bins + cfg.win_len) \
            + fft_tables(cfg)[1].nbytes
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        dft_floor_ms = dft_flops / PEAK_FP32_FLOPS * 1e3
        timings[sr] = dict(
            shape=f"{batch}x{n} @ {sr} Hz", max_abs_err=err, tol_ratio=ratio,
            blas_fp32_max_abs_err=blas_err, ms=kernel_ms, plain_ms=plain_ms,
            library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", gflop=flops / 1e9,
            mbytes=nbytes / 1e6, dft_floor_ms=dft_floor_ms)
        print(f"[kernel] stft_lps {batch} x {secs:g} s @ {sr} Hz ({n_frames} frames each): "
              f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.stft {library_ms:.4f} ms "
              f"(|stft - plain| {lib_err:.3g}), bound {max(t_ops, t_bytes):.4f} ms by "
              f"{timings[sr]['bound_by']} ({nbytes / 1e6:.0f} MB; the FFT's {flops / 1e9:.2f} "
              f"GFLOP {t_ops:.4f} ms; a direct DFT's {dft_flops / 1e9:.1f} GFLOP "
              f"{dft_floor_ms:.4f} ms), {nbytes / kernel_ms / 1e9:.0f} GB/s; max err {err:.3g}, "
              f"{ratio:.3f} of the tolerance (fp32 cuBLAS: {blas_err:.3g}, {blas_ratio:.3f})",
              flush=True)
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


def _serving_model(sr: int, gen_seed: int, head: str = "lps"):
    """A full-width net (d*11 + d)-2048x3-d with random glorot weights from a
    seed, parity dropout 0.1/0.2, context 11, offset 5, NAT; the lps head, or
    a mask head (sigmoid output, mask floor 0.05)."""
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance import EnhanceConfig
    from tpu_sednn_torch.model import ModelConfig, init_params

    stft = StftConfig.for_rate(sr)
    d = stft.n_bins
    mask = head != "lps"
    mcfg = ModelConfig(layersizes=(d * 11 + d, 2048, 2048, 2048, d), hidden="relu",
                       output="sigmoid" if mask else "linear", dropout_vis=0.1, dropout_hid=0.2,
                       dropout_mode="parity")
    ecfg = EnhanceConfig(stft=stft, fea_context=11, targ_offset=5, nat=True, head=head,
                         mask_floor=0.05 if mask else 0.0)
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


# ---------------------------------------------------------------------------
# serving modes: streaming (host and device state), int8, head fusion.  No
# kernel of the port lies on these paths (the JAX decode computes its STFT,
# forward and int8 product in XLA); each is run with every launch count
# zeroed just before it and read just after, and must launch none.
# ---------------------------------------------------------------------------

STREAM_TOL = 5e-5  # streaming vs the offline card decode, max |diff| (tests/test_streaming.py)
SCAN_TOL = 1e-6  # scan_blocks vs push, max |diff|
QUANT_CARD_REL = 1e-6  # card int8 forward vs its CPU plain version, relative Frobenius
QUANT_F32_REL = 0.02  # int8 vs float32 forward, relative Frobenius (tests/test_quant.py)
QUANT_LSD_DB = 0.5  # int8 vs float32 decode of a 2 s clip, LSD (tests/test_quant.py)
QUANT_STREAM_REL = 0.05  # int8 vs float32 stream, relative (tests/test_streaming.py)
# int8 stream vs int8 decode, relative Frobenius: per-row scales make them equal but
# where float32 order (GEMMs of other shapes) moves a row's quantization across a
# rounding boundary; a quarter of the int8-vs-float32 difference (0.0036 on the card)
QUANT_STREAM_OF_INT8 = 1e-3
FUSION_SINGLE_TOL = 1e-6  # weights (1, 0) vs the single-model decode, max |diff|
FUSION_RTOL, FUSION_ATOL = 1e-4, 1e-5  # fused serving decoder vs the eager fused decode


def _launches_total() -> int:
    """Every launch counter of the port, summed (ops.launch_counts)."""
    from tpu_sednn_torch.ops import launch_counts

    counts = launch_counts()
    return sum(sum(v.values()) if isinstance(v, dict) else v for v in counts.values())


def _none_launched(path: str) -> int:
    """The launches since the counts were zeroed (checked to be 0)."""
    from tpu_sednn_torch.ops import launch_counts

    total = _launches_total()
    _check(total == 0, f"the {path} path launched a kernel of the port: {launch_counts()}")
    return total


def _serve_clip(sr: int, n: int, seed: int) -> np.ndarray:
    """n samples of a seeded speech-like signal over coloured noise, clipped
    to [-1, 1]."""
    rng = np.random.default_rng(seed)
    s = _speechlike(rng, n, sr)
    noise = np.convolve(rng.standard_normal(n + 8), rng.uniform(-1, 1, 9), "valid")
    noise *= 0.3 * np.sqrt(np.mean(s ** 2) / np.mean(noise ** 2))
    return np.clip(s + noise, -1, 1).astype(np.float32)


def _serve_mode_model(sr: int, norm_8k: str):
    """The modes' full-width model at sr -> (mlp, mcfg, ecfg, mean, inv_std,
    target_norm): at 8 kHz the lps head with NAT and the featurizer's .norm;
    at 16 kHz a psm head with a target norm (the mask heads take it and do not
    use it, as in the JAX package) and the .norm of a seeded clip."""
    from tpu_sednn_torch.dsp import stft_logpower
    from tpu_sednn_torch.io import compute_norm, load_norm

    if sr == 8000:
        mlp, mcfg, ecfg = _serving_model(8000, 0)
        mean, istd = load_norm(norm_8k, ecfg.stft.n_bins)
        return mlp, mcfg, ecfg, mean, istd, None
    mlp, mcfg, ecfg = _serving_model(16000, 1, head="psm")
    d = ecfg.stft.n_bins
    with torch.inference_mode():  # set-up, the STFT matmuls
        lps = stft_logpower(torch.from_numpy(_serve_clip(sr, 8 * sr, 71)).cuda(), ecfg.stft)
    mean, istd = compute_norm(lps.cpu().numpy())
    return mlp, mcfg, ecfg, mean, istd, (np.full(d, 0.3, np.float32), np.full(d, 0.7, np.float32))


def _chunked(x: np.ndarray, seed: int) -> list:
    """x cut into seeded chunks of 1-899 samples (tests/test_streaming.py)."""
    rng = np.random.default_rng(seed)
    out, i = [], 0
    while i < len(x):
        n = int(rng.integers(1, 900))
        out.append(x[i : i + n])
        i += n
    return out


def phase_stream(norm_8k: str, smi: str) -> dict:
    """StreamingEnhancer and DeviceStreamingEnhancer at block 1 and 8 on the
    card, at the full width of both nets, against the offline card decode;
    scan_blocks against push; step times, throughput, real-time factor and
    algorithmic latency."""
    from tpu_sednn_torch.enhance import (DeviceStreamingEnhancer, StreamingEnhancer,
                                         enhance_waveform)
    from tpu_sednn_torch.ops import reset_launch_counts

    res, launched = {}, 0
    for sr in (8000, 16000):
        mlp, mcfg, ecfg, mean, istd, tn = _serve_mode_model(sr, norm_8k)
        hop, ms_per_sample = ecfg.stft.hop, 1e3 / sr
        wav = _serve_clip(sr, 3 * sr + 517 if sr == 8000 else 2 * sr + 333, 80 + sr // 8000)
        ref = enhance_waveform(mlp, mcfg, ecfg, wav, mean, istd, target_norm=tn, device="cuda")
        out = res[sr] = {"net": f"{mcfg.layersizes[0]}-2048x3-{mcfg.layersizes[-1]}",
                         "head": ecfg.head}
        for B in (1, 8):
            for cls in (StreamingEnhancer, DeviceStreamingEnhancer):
                se = cls(mlp, mcfg, ecfg, mean, istd, target_norm=tn, block_frames=B,
                         device="cuda")
                reset_launch_counts()  # the streaming path's run starts here
                got = np.concatenate([se.push(c) for c in _chunked(wav, 5 + B)] + [se.flush()])
                torch.cuda.synchronize()
                # and ends here
                launched += _none_launched(f"streaming ({cls.__name__}, block {B})")
                err = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
                _check(err < STREAM_TOL, f"{cls.__name__} block {B} at {sr} Hz vs offline "
                                         f"decode: shape {got.shape} vs {ref.shape}, max err {err}")
                out[f"{cls.__name__}_b{B}_max_abs_err"] = err
            # device state: scan_blocks against push, then the timings
            n_blocks = 96
            step_in = B * hop
            long = _serve_clip(sr, (n_blocks + 16) * step_in + 4 * sr, 90 + B)
            se1, se2 = (DeviceStreamingEnhancer(mlp, mcfg, ecfg, mean, istd, target_norm=tn,
                                                block_frames=B, device="cuda") for _ in range(2))
            prime = se1._n_prime + 2 * step_in  # primes and leaves whole blocks only
            reset_launch_counts()
            _check(np.array_equal(se1.push(long[:prime]), se2.push(long[:prime])), "primed pushes")
            blocks = long[prime : prime + n_blocks * step_in].reshape(n_blocks, step_in)
            push_ms, pushed = [], []
            for b in blocks:
                t0 = time.perf_counter()
                pushed.append(se1.push(b))
                push_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            scanned = se2.scan_blocks(blocks)
            scan_s = time.perf_counter() - t0
            launched += _none_launched(f"device streaming (block {B})")
            serr = float(np.abs(scanned.ravel() - np.concatenate(pushed)).max())
            _check(serr <= SCAN_TOL, f"scan_blocks vs push at block {B}, {sr} Hz: max err {serr}")
            # the step alone, CUDA events around each of 64 steps of a primed carry
            steps = torch.from_numpy(blocks[:64].copy()).cuda()
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(len(steps))]
            with torch.inference_mode():
                carry = se2._carry
                for i, (a, b) in enumerate(events):
                    a.record()
                    carry, _ = se2._step(carry, steps[i])
                    b.record()
                torch.cuda.synchronize()
            step_ms = float(np.median([a.elapsed_time(b) for a, b in events]))
            block_ms = step_in * ms_per_sample
            out[f"b{B}"] = dict(
                scan_vs_push_max_abs_err=serr, step_ms=step_ms,
                push_ms_median=float(np.median(push_ms)), block_audio_ms=block_ms,
                rtf_step=step_ms / block_ms, rtf_push=float(np.median(push_ms)) / block_ms,
                scan_blocks=n_blocks, scan_audio_s_per_s=n_blocks * step_in / sr / scan_s,
                latency_samples=se1.algorithmic_latency_samples,
                latency_ms=se1.algorithmic_latency_samples * ms_per_sample)
            r = out[f"b{B}"]
            print(f"[stream] {out['net']} ({ecfg.head}) @ {sr} Hz, block {B}: host and device "
                  f"state vs offline decode max err {out[f'StreamingEnhancer_b{B}_max_abs_err']:.3g}"
                  f" / {out[f'DeviceStreamingEnhancer_b{B}_max_abs_err']:.3g} (tol {STREAM_TOL:g})"
                  f"; scan_blocks vs push {serr:.3g}; step {step_ms:.4f} ms (CUDA events, median "
                  f"of 64), push {r['push_ms_median']:.4f} ms a block (host clock, copies "
                  f"included), RTF {r['rtf_step']:.4f} (step) / {r['rtf_push']:.4f} (push) of a "
                  f"{block_ms:g} ms block; scan_blocks {r['scan_audio_s_per_s']:.1f} audio-s/s "
                  f"over {n_blocks} blocks; algorithmic latency {r['latency_samples']} samples "
                  f"= {r['latency_ms']:g} ms; on {smi}", flush=True)
        if sr == 8000:
            _check(out["b8"]["latency_samples"] == 1792, "8 kHz flagship latency at block 8")
        del mlp
        torch.cuda.empty_cache()
    res["launches"] = launched
    return res


def _param_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _serving_rate(decode, wavs, secs: float) -> tuple[float, list]:
    """(audio-s/s, ms of each of 5 batches): median of 5 timed batches after one."""
    decode(wavs)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode(wavs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return wavs.shape[0] * secs / float(np.median(times)), [t * 1e3 for t in times]


def phase_quant(norm_8k: str, smi: str) -> dict:
    """int8 serving on the card at both widths: the quantized weights and one
    layer's int32 accumulators bit-equal to the CPU plain version's, the
    int8 forward against the CPU's and against float32, the int8 decode's
    LSD from the float32 decode, and int8 beside float32 serving audio-s/s."""
    from tpu_sednn_torch.dsp import stft_logpower
    from tpu_sednn_torch.enhance import DeviceStreamingEnhancer, make_serving_decoder
    from tpu_sednn_torch.metrics.quality import lsd
    from tpu_sednn_torch.model import fold_eval_params, forward_eval
    from tpu_sednn_torch.model.quant import (_int8_matmul, _quantize_rows, forward_eval_int8,
                                             quantize_params_int8)
    from tpu_sednn_torch.ops import reset_launch_counts

    gen = torch.Generator(device="cuda").manual_seed(4321)
    res, launched = {}, 0
    for sr, secs in ((8000, 64.0), (16000, 32.0)):
        mlp, mcfg, ecfg, mean, istd, tn = _serve_mode_model(sr, norm_8k)
        folded, ecf = fold_eval_params(mlp, mcfg)
        reset_launch_counts()  # the int8 path's runs start here
        qg = quantize_params_int8(folded)
        qc = quantize_params_int8(folded.on("cpu"))
        for name in ("wq", "sw"):
            for l, (a, b) in enumerate(zip(getattr(qg, name), getattr(qc, name))):
                _check((a is None) == (b is None) and (a is None or torch.equal(a.cpu(), b)),
                       f"card vs CPU quantized {name}[{l}] at {sr} Hz")
        acc_rows = []
        for rows in (1, 8, 17, 640):
            for l in (0, 1):
                k = mcfg.layersizes[l]
                x = torch.randn(rows, k, generator=gen, device="cuda") * (3.0 if l == 0 else 1.0)
                xq, sx = _quantize_rows(x)
                xqc, sxc = _quantize_rows(x.cpu())
                _check(torch.equal(xq.cpu(), xqc) and torch.equal(sx.cpu(), sxc),
                       f"card vs CPU row quantization, {rows} rows, layer {l}")
                acc = _int8_matmul(xq, qg.wq[l])
                _check(acc.dtype == torch.int32 and acc.is_cuda
                       and torch.equal(acc.cpu(), _int8_matmul(xqc, qc.wq[l])),
                       f"card vs CPU int32 accumulators, {rows} rows, layer {l} at {sr} Hz")
            acc_rows.append(rows)
        x = torch.randn(256, mcfg.layersizes[0], generator=gen, device="cuda")
        with torch.inference_mode():
            out = forward_eval_int8(qg, x, ecf)
            out_cpu = forward_eval_int8(qc, x.cpu(), ecf)
            ref = forward_eval(mlp, x, mcfg)
        rel_cpu = float(torch.linalg.norm(out.cpu() - out_cpu) / torch.linalg.norm(out_cpu))
        rel_f32 = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        _check(rel_cpu <= QUANT_CARD_REL, f"card vs CPU int8 forward at {sr} Hz: {rel_cpu}")
        _check(rel_f32 < QUANT_F32_REL, f"int8 vs float32 forward at {sr} Hz: {rel_f32}")
        clip = _serve_clip(sr, 2 * sr, 60 + sr // 8000)[None]
        f32_dec = make_serving_decoder(mlp, mcfg, ecfg, mean, istd, target_norm=tn, device="cuda")
        q_dec = make_serving_decoder(mlp, mcfg, ecfg, mean, istd, target_norm=tn, quant="int8",
                                     device="cuda")
        with torch.inference_mode():
            a, b = f32_dec(clip)[0], q_dec(clip)[0]
            d_lsd = lsd(stft_logpower(a, ecfg.stft).cpu().numpy(),
                        stft_logpower(b, ecfg.stft).cpu().numpy())
        _check(bool(torch.isfinite(b).all()) and d_lsd < QUANT_LSD_DB,
               f"int8 vs float32 decode at {sr} Hz: LSD {d_lsd} dB")
        # int8 streaming, device state, blocks of 1 and 8 rows: against the int8 offline
        # decode (QUANT_STREAM_OF_INT8) and the float32 stream (QUANT_STREAM_REL)
        stream_err = {}
        for B in (1, 8):
            outs = []
            for quant in ("int8", "none"):
                se = DeviceStreamingEnhancer(mlp, mcfg, ecfg, mean, istd, target_norm=tn,
                                             block_frames=B, quant=quant, device="cuda")
                outs.append(np.concatenate([se.push(c) for c in _chunked(clip[0], B)]
                                           + [se.flush()]))
            q_off = b.cpu().numpy()
            off = float(np.linalg.norm(outs[0] - q_off) / np.linalg.norm(q_off))
            off_max = float(np.abs(outs[0] - q_off).max() / np.abs(q_off).max())
            rel = float(np.linalg.norm(outs[0] - outs[1]) / np.linalg.norm(outs[1]))
            _check(off <= QUANT_STREAM_OF_INT8 and rel < QUANT_STREAM_REL,
                   f"int8 stream, block {B}, at {sr} Hz: vs the int8 decode {off} "
                   f"(max {off_max} of its peak), vs the float32 stream {rel}")
            stream_err[B] = dict(vs_int8_decode_rel=off, vs_int8_decode_max_of_peak=off_max,
                                 vs_f32_stream_rel=rel)
        layout = None
        if sr == 8000:  # the int8 product of layer 1 for a batch's rows, W in both layouts
            rows = 64 * ecfg.stft.n_frames(int(secs * sr))
            xq = torch.randint(-127, 128, (rows, 2048), generator=gen, device="cuda",
                               dtype=torch.int8)
            w_cm, w_rm = qg.wq[1], qg.wq[1].contiguous()
            _check(w_cm.stride() == (1, 2048), f"int8 weights stored {w_cm.stride()}")
            ms_cm = _device_ms(lambda i: torch._int_mm(xq, w_cm), reps=5)
            ms_rm = _device_ms(lambda i: torch._int_mm(xq, w_rm), reps=5)
            ops = 2.0 * rows * 2048 * 2048
            layout = dict(rows=rows, col_major_ms=ms_cm, row_major_ms=ms_rm,
                          col_major_tops=ops / ms_cm / 1e9, row_major_tops=ops / ms_rm / 1e9)
            print(f"[quant] int8 product {rows} x 2048 x 2048 (torch._int_mm): W column-major "
                  f"{ms_cm:.3f} ms ({layout['col_major_tops']:.1f} TOP/s), row-major {ms_rm:.3f} "
                  f"ms ({layout['row_major_tops']:.1f} TOP/s); on {smi}", flush=True)
            del xq
        batch, n = 64, int(secs * sr)
        wavs = torch.from_numpy(np.stack([_serve_clip(sr, n, 200 + i) for i in range(4)]))
        wavs = wavs.repeat(batch // 4, 1).cuda()
        rate_q, ms_q = _serving_rate(q_dec, wavs, secs)
        rate_f, ms_f = _serving_rate(f32_dec, wavs, secs)
        torch.cuda.synchronize()
        launched += _none_launched(f"int8 serving ({sr} Hz)")  # and end here
        f32_bytes = _param_bytes(list(folded.w) + list(folded.b))
        q_bytes = _param_bytes(qg.wq + qg.sw + qg.w_f32 + qg.b)
        res[sr] = dict(net=f"{mcfg.layersizes[0]}-2048x3-{mcfg.layersizes[-1]}",
                       int32_rows_held=acc_rows, fwd_rel_vs_cpu=rel_cpu, fwd_rel_vs_f32=rel_f32,
                       decode_lsd_db=d_lsd, stream_int8=stream_err, int8_product=layout,
                       batch=batch, seconds=secs,
                       int8_audio_s_per_s=rate_q, f32_audio_s_per_s=rate_f,
                       int8_ms_per_batch=ms_q, f32_ms_per_batch=ms_f,
                       int8_param_bytes=q_bytes, f32_param_bytes=f32_bytes)
        print(f"[quant] {res[sr]['net']} @ {sr} Hz: int8 weights and int32 accumulators "
              f"(rows {acc_rows}, layers 0 and 1) bit-equal to the CPU plain version; int8 "
              f"forward vs CPU {rel_cpu:.3g} (tol {QUANT_CARD_REL:g}), vs float32 {rel_f32:.4f} "
              f"(tol {QUANT_F32_REL:g}); decode LSD vs float32 {d_lsd:.4f} dB (tol "
              f"{QUANT_LSD_DB:g}); int8 device stream, blocks 1 / 8, vs the int8 decode "
              f"{stream_err[1]['vs_int8_decode_rel']:.3g} / "
              f"{stream_err[8]['vs_int8_decode_rel']:.3g} (tol {QUANT_STREAM_OF_INT8:g}; max "
              f"{stream_err[1]['vs_int8_decode_max_of_peak']:.3g} / "
              f"{stream_err[8]['vs_int8_decode_max_of_peak']:.3g} of its peak), vs the float32 stream "
              f"{stream_err[1]['vs_f32_stream_rel']:.4f} / {stream_err[8]['vs_f32_stream_rel']:.4f}"
              f" (tol {QUANT_STREAM_REL:g}); serving {batch} x {secs:g} s: int8 {rate_q:.1f} audio-s/s, "
              f"float32 {rate_f:.1f} (medians of 5); params int8 {q_bytes / 1e6:.2f} MB, "
              f"float32 {f32_bytes / 1e6:.2f} MB; on {smi}", flush=True)
        _profile(f"int8 serving {res[sr]['net']} @ {sr} Hz", q_dec, wavs)
        del wavs, f32_dec, q_dec, mlp, folded, qg
        torch.cuda.empty_cache()
    res["launches"] = launched
    return res


def _fusion_models(norm_8k: str) -> tuple:
    """Two full-width 8 kHz models as load_run_dir gives them: the lps
    flagship and a psm head of other weights, the same .norm."""
    from tpu_sednn_torch.io import load_norm

    out = []
    for seed, head in ((0, "lps"), (2, "psm")):
        mlp, mcfg, ecfg = _serving_model(8000, seed, head=head)
        mean, istd = load_norm(norm_8k, ecfg.stft.n_bins)
        out.append((mlp, mcfg, ecfg, mean, istd, None, None))
    return tuple(out)


def phase_fusion(norm_8k: str, smi: str) -> dict:
    """Head fusion of two full-width 8 kHz models on the card: weights (1, 0)
    against the single-model decode, the fused serving decoder against the
    eager fused decode, and the fused decoder's audio-s/s."""
    from tpu_sednn_torch.enhance import (enhance_waveform, enhance_waveform_fused,
                                         make_fused_serving_decoder, make_serving_decoder)
    from tpu_sednn_torch.ops import reset_launch_counts

    a, b = _fusion_models(norm_8k)
    clip = _serve_clip(8000, 4 * 8000 + 77, 51)
    reset_launch_counts()  # the fusion path's run starts here
    single = enhance_waveform(a[0], a[1], a[2], clip, a[3], a[4], device="cuda")
    e10 = float(np.abs(enhance_waveform_fused((a, b), clip, (1.0, 0.0), device="cuda")
                       - single).max())
    s10 = float(np.abs(make_fused_serving_decoder((a, b), (1.0, 0.0), device="cuda")(clip[None])
                       .cpu().numpy()[0]
                       - make_serving_decoder(*a[:5], device="cuda")(clip[None]).cpu().numpy()[0])
                .max())
    _check(max(e10, s10) <= FUSION_SINGLE_TOL,
           f"fusion weights (1, 0) vs the single model: eager {e10}, serving {s10}")
    w = (0.65, 0.35)
    eager = enhance_waveform_fused((a, b), clip, w, device="cuda")
    dec = make_fused_serving_decoder((a, b), w, device="cuda")
    got = dec(clip[None]).cpu().numpy()[0]
    excess = float((np.abs(got - eager) - (FUSION_ATOL + FUSION_RTOL * np.abs(eager))).max())
    ferr = float(np.abs(got - eager).max())
    _check(excess <= 0 and np.isfinite(got).all(),
           f"fused serving decoder vs eager fused decode: max err {ferr}")
    batch, secs = 64, 64.0
    wavs = torch.from_numpy(np.stack([_serve_clip(8000, int(secs * 8000), 300 + i)
                                      for i in range(4)]))
    wavs = wavs.repeat(batch // 4, 1).cuda()
    rate, ms = _serving_rate(dec, wavs, secs)
    torch.cuda.synchronize()
    launched = _none_launched("fusion")  # and ends here
    res = dict(nets="1548-2048x3-129 (lps) + 1548-2048x3-129 (psm)", weights=list(w),
               endpoint_eager_max_abs_err=e10, endpoint_serving_max_abs_err=s10,
               serving_vs_eager_max_abs_err=ferr, batch=batch, seconds=secs,
               audio_s_per_s=rate, ms_per_batch=ms, launches=launched)
    print(f"[fusion] two full-width 8 kHz models (lps + psm), weights {w}: (1, 0) vs single "
          f"model eager {e10:.3g} / serving {s10:.3g} (tol {FUSION_SINGLE_TOL:g}); fused serving "
          f"decoder vs eager {ferr:.3g} (rtol {FUSION_RTOL:g}, atol {FUSION_ATOL:g}); "
          f"{batch} x {secs:g} s: {rate:.1f} audio-s/s (median of 5) on {smi}", flush=True)
    _profile("fused serving, two 1548-2048x3-129 @ 8000 Hz", dec, wavs)
    del wavs, dec
    torch.cuda.empty_cache()
    return res


def phase_cli(tmp: str, wavs: list, norm_8k: str, smi: str) -> dict:
    """`python -m tpu_sednn_torch.enhance --device cuda` on a wav in each of
    its five modes (offline, --stream 8, --stream 8 --stream-device, --quant
    int8, --fuse-with a run dir), the five commands at once; each output
    against the in-process decode of the same mode after the same 16-bit
    rounding, within 2 int16 LSB."""
    import shutil

    from tpu_sednn_torch.enhance import (DeviceStreamingEnhancer, StreamingEnhancer,
                                         enhance_waveform_fused, make_serving_decoder)
    from tpu_sednn_torch.io import read_wav, save_wts
    from tpu_sednn_torch.model import params_to_wts
    from tpu_sednn_torch.recipes import load_run_dir

    model_a, model_b = _fusion_models(norm_8k)
    mlp, mcfg, ecfg, mean, istd = model_a[:5]
    wts = os.path.join(tmp, "flagship.wts")
    save_wts(wts, *params_to_wts(mlp))
    run_b = os.path.join(tmp, "run_b")  # the fusion partner as a trained run dir
    os.makedirs(run_b, exist_ok=True)
    save_wts(os.path.join(run_b, "mlp.final.wts"), *params_to_wts(model_b[0]))
    shutil.copy(norm_8k, os.path.join(run_b, "fea.norm"))
    with open(os.path.join(run_b, "run.json"), "w") as f:
        json.dump({"head": "psm", "sample_rate": 8000, "fea_context": 11, "targ_offset": 5,
                   "nat": True, "dropout": [0.1, 0.2], "mask_floor": 0.05}, f)
    x, _ = read_wav(wavs[0])

    def serve(quant):
        dec = make_serving_decoder(mlp, mcfg, ecfg, mean, istd, quant=quant, device="cuda")
        return dec(x[None])[0].cpu().numpy()

    def stream(cls):
        se = cls(mlp, mcfg, ecfg, mean, istd, block_frames=8, device="cuda")
        return np.concatenate([se.push(x), se.flush()])

    modes = {
        "offline": ([], lambda: serve("none")),
        "stream": (["--stream", "8"], lambda: stream(StreamingEnhancer)),
        "stream_device": (["--stream", "8", "--stream-device"],
                          lambda: stream(DeviceStreamingEnhancer)),
        "int8": (["--quant", "int8"], lambda: serve("int8")),
        "fusion": (["--fuse-with", run_b], lambda: enhance_waveform_fused(
            (model_a, load_run_dir(run_b, device="cuda")), x, (0.65, 0.35), device="cuda")),
    }
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, (flags, _) in modes.items():
            cmd = [sys.executable, "-m", "tpu_sednn_torch.enhance", os.path.join(tmp, f"enh_{name}"),
                   wavs[0], "--wts", wts, "--norm", norm_8k, "--visible-omit", "0.1",
                   "--hid-omit", "0.2", "--device", "cuda"] + flags
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)
        outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    errs = {}
    for name, (_, decode) in modes.items():
        stdout, stderr = outs[name]
        _check(procs[name].returncode == 0, f"enhance command ({name}) failed:\n{stdout}\n{stderr}")
        y, sr = read_wav(os.path.join(tmp, f"enh_{name}", "utt0_enh.wav"))
        ref = np.clip(np.round(decode() * 32768.0), -32768, 32767) / 32768.0
        errs[name] = err = float(np.abs(y - ref).max()) if y.shape == x.shape else float("inf")
        _check(sr == 8000 and err <= 2 / 32768,
               f"enhance command ({name}) vs the in-process decode: max err {err} "
               f"(tol 2 int16 LSB)")
    print(f"[cli] python -m tpu_sednn_torch.enhance --device cuda on {len(x) / 8000:.1f} s, five "
          f"modes at once ({wall:.1f} s incl. start-up): {outs['offline'][0].strip()}; vs the "
          f"in-process decode of each mode, max err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f"; on {smi}", flush=True)
    return dict(wall_s=wall, max_abs_err=errs)


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
# The two-call check (hyperparameters changed between calls) reads this many
# seeded draws: whether a draw has a ReLU flip is chance (a draw of
# 1548-2048x3-129 read 6.0e-3 with two flips), so it is held per draw beside
# the float32 plain version's own distance from float64.
TWO_CALL_DRAWS = 4
# Every other fixed-limit hold of the chunk trainer (the cases after one and
# after three bunches, both product forms) reads up to RESIDENT_DRAWS draws of
# inputs seeded on their own (RESIDENT_SEED + draw), not the shared generator:
# a change of summation order elsewhere (a kernel's, or an earlier phase's
# draws) moves a bfloat16-product trainer's chaotic path, and one ReLU flip can
# then miss a fixed limit.  A draw is passed over only where the float32 plain
# version of the same rounding misses that limit against float64 too; the
# kernel missing it alone fails, and some draw must hold.
RESIDENT_DRAWS = 4
RESIDENT_SEED = 3100
ENGINE_REL_FRO = 5e-2
# The chunk trainer with tensor-core products (bf16=True) against the float64
# plain version of the same rounding.  Each launch multiplies the same rounded
# operands as the plain version (phase_tc_kernels holds every kernel to 1e-5),
# but the trainer's activations are float32 sums and the plain version's
# float64 ones; where the two round to different bfloat16 values (a share
# ~1e-4 of a hidden layer's elements at first) the next layer's operand
# differs by a whole ulp, 2^-8, and that difference grows layer by layer and
# bunch by bunch.  The float32 plain version of the same rounding drifts from
# float64 just so (read: 1e-3 to 3e-3 of the update after one bunch, 0.02 to
# 0.09 after three), as the kernel does.  So:
# * after ONE bunch every tensor's update is held to TC_ONE_REL_FRO (read:
#   the kernel 2.6e-3 to 1e-2); that refuses the float32-product trainer
#   (0.075-0.084) and an lrate or a momentum 10% off (0.1); sr_state's W,
#   itself rounded stochastically, to TC_SR_STATE_ONE_W_FRO (read 0.025-0.047,
#   the float32-product trainer 0.12-0.15);
# * after three bunches to TC_THREE_REL_FRO, a bound on the drift only (the
#   float32-product trainer reads 0.08-0.17 there too);
# * the trainer against ops/train_step's per-bunch step with the same masks,
#   which launches the same kernels one by one: bit for bit.
# Kernels 1 and 2 themselves are held launch by launch in phase_tc_kernels.
TC_ONE_REL_FRO = 3e-2
TC_SR_STATE_ONE_W_FRO = 0.1
TC_THREE_REL_FRO = 0.2
# engine=resident with tensor-core products against engine=xla (plain float32
# torch) over an epoch of ~20 sentences (98 bunches), dropout off: the same
# drift plus the products' own difference; CV MSE relative and the update's
# relative Frobenius error (read: 4.0e-4 and 0.047; the float32-product
# trainer 2.0e-4 and 0.022 against ENGINE_REL_FRO).
TC_ENGINE_CV = 5e-3
TC_ENGINE_REL_FRO = 0.15


def _err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want| / max |want|, ||got - want||_F / ||want||_F), in float64."""
    g, w = got.double(), want.double()
    d = (g - w).abs()
    return (float(d.max() / w.abs().max().clamp(min=1e-30)),
            float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(w).clamp(min=1e-30)))


def _hold(got, want, label: str, worst: dict, tol_max: float = KERNEL_REL_MAX,
          tol_fro: float = KERNEL_REL_FRO) -> None:
    _check(bool(torch.isfinite(got).all()), f"{label}: non-finite values")
    _check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    rel_max, rel_fro = _err(got, want)
    _check(rel_max <= tol_max and rel_fro <= tol_fro,
           f"{label}: max err {rel_max:.3g} of max|want| (tol {tol_max}), "
           f"Frobenius {rel_fro:.3g} (tol {tol_fro})")
    worst["rel_max"] = max(worst.get("rel_max", 0.0), rel_max)
    worst["rel_fro"] = max(worst.get("rel_fro", 0.0), rel_fro)
    worst["abs"] = max(worst.get("abs", 0.0), float((got.double() - want.double()).abs().max()))


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).contiguous()


def _traced_ms(fn, reps: int = 20) -> dict:
    """{kernel name: device ms per call of fn(i)} from one torch.profiler trace
    of `reps` calls (a share, not a time to report on its own: a trace can
    lose records, so every other time here is taken with CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3 / reps
    return out


def _bwd_breakdown(l: int, dedx, x, ws, deltas, b, db, hyp: dict) -> dict:
    """The backward of one layer, in the product form hyp["bf16"] names, split
    by what it does: the fused update (fused_bwd_update), the gradient alone
    (fused_bwd_grad_out without dedy: G and gb written, nothing updated) and
    with dedy, each timed with CUDA events; and the device time of
    reduce_dedy_kernel in a traced run of the fused update (0 where none
    launches).  update share = fused - gradient with dedy; dedy share =
    gradient with dedy - gradient alone."""
    from tpu_sednn_torch.ops.fused_mlp import fused_bwd_grad_out, fused_bwd_update

    B, N = dedx.shape
    K = x.shape[1]
    grad = torch.empty(K * N + N, device="cuda")
    dedy = torch.empty(B, K, device="cuda")
    deriv = "relu" if l > 0 else None
    tc = hyp["bf16"]
    upd = lambda i: fused_bwd_update(dedx, x, ws[i % 3], deltas[i % 3], b, db, **hyp)  # noqa: E731
    t_g0 = _device_ms(lambda i: fused_bwd_grad_out(dedx, x, ws[i % 3], with_dedy=False, grad=grad,
                                                   bf16=tc))
    t_g1 = _device_ms(lambda i: fused_bwd_grad_out(dedx, x, ws[i % 3], deriv="relu", grad=grad,
                                                   dedy=dedy, bf16=tc))
    traced = _traced_ms(upd)
    t_red = sum(v for k, v in traced.items() if "reduce_dedy" in k)
    return dict(grad_ms=t_g0, grad_dedy_ms=t_g1, reduce_ms_traced=t_red,
                traced={k[:60]: v for k, v in traced.items()}, deriv=deriv)


def _time_layers(gen, tc: bool, fwd_worst: dict, bwd_worst: dict,
                 net: tuple = FLAGSHIP) -> tuple[dict, dict]:
    """Device times of kernels 1 and 2 in one product form (tc: tensor cores,
    else float32) at the four layer shapes of `net`, one bunch's worth of
    each, beside the plain versions', a library call's and the bound; the
    holds' worst errors go into the results.  Each call takes the next of
    three weight sets, ~100 MB in all at 8 kHz, so that W and delta come from
    device memory and not from the 50 MB L2, as they do in a chunk, where
    every launch touches another layer."""
    from tpu_sednn_torch.ops.fused_mlp import (fused_bwd_update, fused_bwd_update_reference,
                                               fused_linear_act, fused_linear_act_reference)
    from tpu_sednn_torch.ops.philox import philox_mask

    form = "tensor cores" if tc else "float32"
    fwd = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, nbytes=0.0, by_shape={})
    bwd = dict(ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0, by_shape={})
    for l in range(4):
        B, K, N = BUNCH, net[l], net[l + 1]
        x, b = _randn(gen, B, K), _randn(gen, N, scale=0.1)
        ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
        deltas = [torch.zeros(K, N, device="cuda") for _ in range(3)]
        act = "relu" if l < 3 else "linear"
        dedx, db = _randn(gen, B, N, scale=0.02), torch.zeros(N, device="cuda")
        hyp = dict(momentum=0.5, lrate=1e-3, inv_n=1.0 / B, weightcost=0.0, bf16=tc)
        # the library call: one cuBLAS product on the operands as they are (float32), or on
        # bfloat16 copies with a bfloat16 output for the tensor-core form
        lx, lb, lws = (x, b, ws) if not tc else (x.bfloat16(), b.bfloat16(),
                                                 [w.bfloat16() for w in ws])

        def library(i):
            y = torch.addmm(lb, lx, lws[i % 3])
            return torch.relu(y) if act == "relu" else y

        # masks as the training path gives them: in-kernel on the net's input
        # and on every hidden activation
        kw = dict(in_mask=(4, 0.1) if l == 0 else None, out_mask=(5, 0.2) if l < 3 else None)
        kw_t = {k: None if v is None else philox_mask(v[0], B, K if k == "in_mask" else N, v[1],
                                                      device="cuda") for k, v in kw.items()}
        t_f = _device_ms(lambda i: fused_linear_act(x, ws[i % 3], b, act, bf16=tc, **kw))
        t_fp = _device_ms(lambda i: fused_linear_act_reference(x, ws[i % 3], b, act, bf16=tc,
                                                               **kw_t))
        t_fl = _device_ms(library)
        t_b = _device_ms(lambda i: fused_bwd_update(dedx, x, ws[i % 3], deltas[i % 3], b, db, **hyp))
        t_bp = _device_ms(lambda i: fused_bwd_update_reference(dedx, x, ws[i % 3], deltas[i % 3], b,
                                                               db, **hyp))
        f_flops, f_bytes = 2.0 * B * K * N, 4.0 * (B * K + K * N + N + B * N)
        b_flops = 4.0 * B * K * N + 4.0 * K * N
        b_bytes = 4.0 * (B * N + B * K + 4 * K * N + 4 * N + B * K)
        fwd["by_shape"][f"layer {l}, {B}x{K}x{N}"] = dict(
            ms=t_f, plain_ms=t_fp, library_ms=t_fl, bound_ms=f_bytes / PEAK_BYTES_PER_S * 1e3 if tc
            else max(f_flops / PEAK_FP32_FLOPS, f_bytes / PEAK_BYTES_PER_S) * 1e3)
        bwd["by_shape"][f"layer {l}, {B}x{K}x{N}"] = dict(ms=t_b, plain_ms=t_bp)
        parts = _bwd_breakdown(l, dedx, x, ws, deltas, b, db, hyp)
        bwd["by_shape"][f"layer {l}, {B}x{K}x{N}"].update(
            {k: v for k, v in parts.items() if k.endswith("_ms") or k.endswith("traced")})
        print(f"[kernel] layer {l} {B}x{K}x{N}, {form} backward by part: fused update "
              f"{t_b:.4f} ms; gradient alone (G, gb) {parts['grad_ms']:.4f}, with dedy "
              f"{parts['grad_dedy_ms']:.4f} (update share {t_b - parts['grad_dedy_ms']:.4f}, "
              f"dedy share {parts['grad_dedy_ms'] - parts['grad_ms']:.4f}); reduce_dedy_kernel "
              f"{parts['reduce_ms_traced']:.4f} ms in a traced run of the fused update "
              f"(kernels traced: {', '.join(f'{k} {v:.4f}' for k, v in parts['traced'].items())})",
              flush=True)
        for acc, vals in ((fwd, dict(ms=t_f, plain_ms=t_fp, library_ms=t_fl, flops=f_flops,
                                     nbytes=f_bytes)),
                          (bwd, dict(ms=t_b, plain_ms=t_bp, flops=b_flops, nbytes=b_bytes))):
            for k, v in vals.items():
                acc[k] += v
        print(f"[kernel] layer {l} {B}x{K}x{N}, {form}: fused_linear_act {t_f:.4f} ms (plain "
              f"{t_fp:.4f}, {'bfloat16 ' if tc else ''}torch.addmm+act {t_fl:.4f}), "
              f"{f_flops / t_f / 1e9:.2f} TFLOP/s; fused_bwd_update {t_b:.4f} ms (plain "
              f"{t_bp:.4f}), {b_flops / t_b / 1e9:.2f} TFLOP/s", flush=True)
    for acc, worst in ((fwd, fwd_worst), (bwd, bwd_worst)):
        t_ops = acc.pop("flops") / (PEAK_BF16_FLOPS if tc else PEAK_FP32_FLOPS) * 1e3
        t_bytes = acc.pop("nbytes") / PEAK_BYTES_PER_S * 1e3
        acc.update(bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", max_abs_err=worst["abs"],
                   rel_max_err=worst["rel_max"], rel_fro_err=worst["rel_fro"])
    if tc:
        fwd["library_is"] = ("torch.addmm on bfloat16 x, W and b (+ relu), output bfloat16: "
                             "cuBLAS's bfloat16 product, not the same function")
    sums = {k: sum(v[k] for v in bwd["by_shape"].values())
            for k in ("grad_ms", "grad_dedy_ms", "reduce_ms_traced")}
    bwd["parts_ms"] = dict(sums, update_share=bwd["ms"] - sums["grad_dedy_ms"],
                           dedy_share=sums["grad_dedy_ms"] - sums["grad_ms"])
    print(f"[kernel] one bunch's four layers of {'-'.join(map(str, net))}, {form} backward "
          f"by part: fused update {bwd['ms']:.4f} ms, gradient alone {sums['grad_ms']:.4f}, with "
          f"dedy {sums['grad_dedy_ms']:.4f}, reduce_dedy_kernel {sums['reduce_ms_traced']:.4f} "
          f"(traced); by layer "
          f"{' '.join('%.4f' % v['ms'] for v in bwd['by_shape'].values())}", flush=True)
    print(f"[kernel] one bunch's four layers of {'-'.join(map(str, net))}, {form}: "
          f"fused_linear_act {fwd['ms']:.4f} ms (bound {fwd['bound_ms']:.4f} by "
          f"{fwd['bound_by']}, {'bfloat16 ' if tc else ''}torch.addmm+act "
          f"{fwd['library_ms']:.4f}), "
          f"fused_bwd_update {bwd['ms']:.4f} ms (bound {bwd['bound_ms']:.4f} by "
          f"{bwd['bound_by']})", flush=True)
    return fwd, bwd


def bwd_times() -> dict:
    """Only the backward's device times, for comparing two checkouts in one call
    (--bwd-times, with --package-root for the other): fused_bwd_update of one
    bunch's four layers at 8 and 16 kHz in both product forms, and the float32
    gradient-out backward of a rank's 64 rows of the 8 kHz layers (dedy below
    the first), each call on the next of three weight sets, by CUDA events."""
    from tpu_sednn_torch.ops.fused_mlp import fused_bwd_grad_out, fused_bwd_update

    gen = torch.Generator(device="cuda").manual_seed(1313)
    out = {}
    for tag, net in (("8k", FLAGSHIP), ("16k", WIDE)):
        for tc in (False, True):
            by_layer = []
            for l in range(4):
                K, N = net[l], net[l + 1]
                x, dedx = _randn(gen, BUNCH, K), _randn(gen, BUNCH, N, scale=0.02)
                ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
                deltas = [torch.zeros(K, N, device="cuda") for _ in range(3)]
                b, db = _randn(gen, N, scale=0.1), torch.zeros(N, device="cuda")
                hyp = dict(momentum=0.5, lrate=1e-3, inv_n=1.0 / BUNCH, weightcost=0.0, bf16=tc)
                by_layer.append(_device_ms(lambda i: fused_bwd_update(
                    dedx, x, ws[i % 3], deltas[i % 3], b, db, **hyp)))
                del ws, deltas
            out[f"{tag}_{'tc' if tc else 'f32'}"] = dict(ms=sum(by_layer), by_layer=by_layer)
            torch.cuda.empty_cache()
    by_layer = []
    for l in range(4):
        K, N, M = FLAGSHIP[l], FLAGSHIP[l + 1], 64
        dedx, y = _randn(gen, M, N, scale=0.02), torch.relu(_randn(gen, M, K))
        ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
        grad, dedy = torch.empty(K * N + N, device="cuda"), torch.empty(M, K, device="cuda")
        kw = dict(deriv=None if l == 0 else "relu", with_dedy=l > 0, grad=grad,
                  dedy=None if l == 0 else dedy, bf16=False)
        by_layer.append(_device_ms(lambda i: fused_bwd_grad_out(dedx, y, ws[i % 3], **kw)))
    out["dp64_f32_grad_out"] = dict(ms=sum(by_layer), by_layer=by_layer)
    for k, v in out.items():
        print(f"[bwd-times] {k}: {v['ms']:.4f} ms (by layer "
              f"{' '.join('%.4f' % t for t in v['by_layer'])})", flush=True)
    return out


def _fwd_digests() -> dict:
    """SHA-256 digests of the float32 forward's outputs on seeded inputs, for
    holding two checkouts bit for bit (fwd_times): fused_linear_act's y (bf16=False)
    at every layer shape of the 8 and 16 kHz nets and at phase_fused_kernels' ragged
    shapes, three activations x no mask / Philox masks / explicit masks, float32 and
    bfloat16 W; and dp_tile_forward's activations and dedx (a rank's 64 rows at
    both offsets and the whole 128-row tile, both nets, a linear and a sigmoid
    head, dropout on).  -> {group: hex digest}, each group's inputs seeded on
    their own."""
    import ctypes
    import hashlib

    from tpu_sednn_torch.model.mlp import ModelConfig
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import fused_linear_act
    from tpu_sednn_torch.ops.philox import philox_mask

    def digest(tensors) -> str:
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    shapes = sorted({(BUNCH, net[l], net[l + 1]) for net in (FLAGSHIP, WIDE) for l in range(4)})
    shapes += [(8, 1548, 129), (136, 1548, 129), (136, 100, 37), (24, 2048, 2048),
               (256, 2048, 2048), (512, 1548, 129)]
    for n, (B, K, N) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(7100 + n)
        x, w, b = _randn(gen, B, K), _randn(gen, K, N, scale=0.03), _randn(gen, N, scale=0.1)
        im = philox_mask(11, B, K, 0.1, device="cuda")
        om = philox_mask(12, B, N, 0.2, device="cuda")
        ys = []
        for wt in (w, w.bfloat16()):
            for act in ("relu", "sigmoid", "linear"):
                for kw in ({}, {"in_mask": (11, 0.1), "out_mask": (12, 0.2), "out_scale": 1.25},
                           {"in_mask": im, "in_scale": 1.0 / 0.9, "out_mask": om}):
                    ys.append(fused_linear_act(x, wt, b, act, bf16=False, **kw))
        out[f"fused_linear_act {B}x{K}x{N}"] = digest(ys)
    for n, (sizes, head, tile) in enumerate((s, h, t) for s in (FLAGSHIP, WIDE)
                                            for h in ("linear", "sigmoid") for t in (64, 128)):
        cfg = ModelConfig(layersizes=sizes, output=head, dropout_vis=0.1, dropout_hid=0.2)
        gen = torch.Generator(device="cuda").manual_seed(7200 + n)
        ws = [_randn(gen, a, c, scale=0.03) for a, c in zip(sizes[:-1], sizes[1:])]
        bs = [_randn(gen, c, scale=0.1) for c in sizes[1:]]
        x, t = _randn(gen, BUNCH, sizes[0]), _randn(gen, BUNCH, sizes[-1])
        fwd = rc.dp_tile_forward(cfg, tile, BUNCH, False, torch.device("cuda"))
        tallies = (ctypes.c_longlong * len(rc.kernel_launches))()
        got = []
        for row0 in range(0, BUNCH, tile):
            ys, dedx = fwd(x[row0:row0 + tile].contiguous(), t[row0:row0 + tile].contiguous(),
                           ws, bs, 31 + n, row0, 2.0 / BUNCH, tallies,
                           *_dp_input_table(rc, 31 + n, tile, sizes[0], 0.1, row0))
            got += [y.clone() for y in ys] + [dedx[:tile * sizes[-1]].clone()]
        out[f"dp_tile_forward {'-'.join(map(str, sizes))} {head} head, {tile} of {BUNCH} rows"] = \
            digest(got)
    return out


def _dp_input_table(rc, key0: int, tile: int, K: int, omit: float, row0: int) -> tuple:
    """(the rank's rows of the input-mask table of one tile under key0, at
    row0) where the package's data-parallel forward reads the input's mask
    from a table (input_mask_bits takes row0), else () (it draws Philox in
    the kernel): the extra argument of dp_tile_forward's fwd, so that two
    checkouts run the same forward."""
    import inspect

    if "row0" not in inspect.signature(rc.input_mask_bits).parameters:
        return ()
    return (rc.input_mask_bits(key0, 1, tile, K, omit, row0=row0)[0],)


def _fwd_block_profile(gen) -> dict:
    """Where a float32 forward's blocks run and for how long, from a package
    whose fused_mlp library records it (a copy of the kernel that writes, for
    each block, its SM (%smid) and %globaltimer at its start, after its K
    loop and at its end into a device array that a C entry f32_fwd_prof(out,
    n) copies out and f32_fwd_prof_clear() zeroes): one launch of the 8 kHz
    2048-deep layer and of layer 0 with its input mask, each -> the blocks,
    the SMs used, how many hold 1, 2, 3 .. blocks, the most blocks an SM runs
    at once, and the K loop's and the rest's microseconds.  {} where the
    library records nothing (the shipped kernel)."""
    import ctypes

    from tpu_sednn_torch.ops import fused_mlp

    lib = fused_mlp._lib()
    if not hasattr(lib, "f32_fwd_prof"):
        return {}
    lib.f32_fwd_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {}
    for K, N, kw in ((2048, 2048, {}), (1548, 2048, dict(in_mask=(4, 0.1)))):
        x, w, b = _randn(gen, BUNCH, K), _randn(gen, K, N, scale=0.03), _randn(gen, N, scale=0.1)
        fused_mlp.fused_linear_act(x, w, b, "relu", bf16=False, **kw)
        torch.cuda.synchronize()
        lib.f32_fwd_prof_clear()
        fused_mlp.fused_linear_act(x, w, b, "relu", bf16=False, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (8192 * 4))()
        lib.f32_fwd_prof(ctypes.addressof(buf), 8192)
        a = np.array(buf, dtype=np.uint64).reshape(-1, 4)
        a = a[a[:, 1] > 0]
        sm, t = a[:, 0].astype(np.int64), (a[:, 1:] - a[:, 1].min()) / 1e3  # us
        most = 0
        for s in np.unique(sm):
            ev = sorted([(v, 1) for v in t[sm == s, 0]] + [(v, -1) for v in t[sm == s, 2]])
            most = max(most, int(max(np.cumsum([d for _, d in ev]))))
        per_sm = np.bincount(sm, minlength=torch.cuda.get_device_properties(0).multi_processor_count)
        out[f"{BUNCH}x{K}x{N}{' masked' if kw else ''}"] = dict(
            blocks=int(len(a)), sms=int((per_sm > 0).sum()), sms_holding=np.bincount(per_sm).tolist(),
            most_at_once=most, span_us=float(t[:, 2].max()), loop_us_mean=float((t[:, 1] - t[:, 0]).mean()),
            loop_us_max=float((t[:, 1] - t[:, 0]).max()), rest_us_mean=float((t[:, 2] - t[:, 1]).mean()),
            rest_us_max=float((t[:, 2] - t[:, 1]).max()))
        print(f"[fwd-times] blocks of {BUNCH}x{K}x{N}{' masked' if kw else ''}: "
              f"{json.dumps(out[list(out)[-1]])}", flush=True)
    return out


def fwd_times() -> dict:
    """Only the float32 forward, for comparing two checkouts in one call
    (--fwd-times, with --package-root for the other): fused_linear_act with
    float32 products (bf16=False) of one bunch at each layer of the 8 and 16 kHz
    nets with the training path's masks, each call on the next of three weight
    sets, by CUDA events, beside torch.addmm + act and the bound; the
    data-parallel forward of a rank's 64 rows planned for the global 128
    (dp_tile_forward, the whole 8 kHz net); the kernels of an 8 kHz bunch's
    forward by name in a traced run (_traced_ms: a share, not a time); and
    _fwd_digests; _fwd_block_profile where the package records one.  Public
    entry points only (and fused_mlp's library where it records a profile)."""
    import ctypes

    from tpu_sednn_torch.model.mlp import ModelConfig
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import fused_linear_act

    gen = torch.Generator(device="cuda").manual_seed(1414)
    out = {}
    for tag, net in (("8k", FLAGSHIP), ("16k", WIDE)):
        by_layer, lib, flops, layers = [], [], 0.0, []
        for l in range(4):
            K, N = net[l], net[l + 1]
            x, b = _randn(gen, BUNCH, K), _randn(gen, N, scale=0.1)
            ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
            act = "relu" if l < 3 else "linear"
            kw = dict(in_mask=(4, 0.1) if l == 0 else None, out_mask=(5, 0.2) if l < 3 else None)
            by_layer.append(_device_ms(lambda i: fused_linear_act(x, ws[i % 3], b, act, bf16=False,
                                                                  **kw)))
            if l == 0:  # what the input mask costs
                l0_nomask = _device_ms(lambda i: fused_linear_act(x, ws[i % 3], b, act, bf16=False))

            def library(i):
                y = torch.addmm(b, x, ws[i % 3])
                return torch.relu(y) if act == "relu" else y

            lib.append(_device_ms(library))
            flops += 2.0 * BUNCH * K * N
            layers.append((x, ws, b, act, kw))
        out[tag] = dict(ms=sum(by_layer), by_layer=by_layer, library_ms=sum(lib),
                        library_by_layer=lib, bound_ms=flops / PEAK_FP32_FLOPS * 1e3,
                        bound_by="operations", layer0_without_mask_ms=l0_nomask)
        if tag == "8k":
            def bunch(i):
                for x, ws, b, act, kw in layers:
                    fused_linear_act(x, ws[i % 3], b, act, bf16=False, **kw)

            out[tag]["traced"] = {k[:80]: v for k, v in _traced_ms(bunch).items()}
        del layers
        torch.cuda.empty_cache()
    cfg = ModelConfig(layersizes=FLAGSHIP, dropout_vis=0.1, dropout_hid=0.2)
    fwd = rc.dp_tile_forward(cfg, 64, BUNCH, False, torch.device("cuda"))
    ws = [[_randn(gen, a, c, scale=0.03) for a, c in zip(FLAGSHIP[:-1], FLAGSHIP[1:])]
          for _ in range(3)]
    bs = [_randn(gen, c, scale=0.1) for c in FLAGSHIP[1:]]
    x, t = _randn(gen, 64, FLAGSHIP[0]), _randn(gen, 64, FLAGSHIP[-1])
    tallies = (ctypes.c_longlong * len(rc.kernel_launches))()
    bits = _dp_input_table(rc, 9, 64, FLAGSHIP[0], 0.1, 64)
    out["dp64"] = dict(ms=_device_ms(lambda i: fwd(x, t, ws[i % 3], bs, 9, 64, 2.0 / BUNCH,
                                                     tallies, *bits)))
    del ws
    torch.cuda.empty_cache()
    for k in ("8k", "16k"):
        v = out[k]
        print(f"[fwd-times] {k} f32 fused_linear_act, one bunch's four layers: {v['ms']:.4f} ms "
              f"(by layer {' '.join('%.4f' % t for t in v['by_layer'])}; layer 0 without its mask "
              f"{v['layer0_without_mask_ms']:.4f}), {v['ms'] / v['bound_ms']:.2f}"
              f" x its bound {v['bound_ms']:.4f} ms (operations); torch.addmm+act "
              f"{v['library_ms']:.4f} (by layer {' '.join('%.4f' % t for t in v['library_by_layer'])})",
              flush=True)
    out["blocks"] = _fwd_block_profile(gen)
    print(f"[fwd-times] 8k kernels traced (ms a bunch): "
          f"{', '.join(f'{k} {v:.4f}' for k, v in out['8k']['traced'].items())}", flush=True)
    print(f"[fwd-times] dp_tile_forward, a rank's 64 rows of 128, 1548-2048x3-129: "
          f"{out['dp64']['ms']:.4f} ms", flush=True)
    out["digests"] = _fwd_digests()
    for k, v in out["digests"].items():
        print(f"[fwd-times] digest {k}: {v}", flush=True)
    return out


def phase_fused_kernels(gen) -> dict:
    from tpu_sednn_torch.ops.fused_mlp import (fused_bwd_update, fused_bwd_update_reference,
                                               fused_linear_act, fused_linear_act_reference)
    from tpu_sednn_torch.ops.philox import philox_mask

    f64 = torch.float64
    layer_shapes = [(BUNCH, FLAGSHIP[l], FLAGSHIP[l + 1]) for l in range(4)]
    # the backward's stripes narrow past 128 and 256 rows (64, 32, 16 rows of W): shapes at
    # each, held in every storage form too
    ragged = [(8, 1548, 129), (136, 1548, 129), (136, 100, 37), (24, 2048, 2048),
              (256, 2048, 2048), (512, 1548, 129)]
    fwd_worst, bwd_worst, plain_worst, sr_stats = {}, {}, {}, {}
    fwd_calls, fwd0 = 0, fused_linear_act.launches
    for B, K, N in layer_shapes + ragged:
        x = _randn(gen, B, K)
        w = _randn(gen, K, N, scale=0.03)
        b = _randn(gen, N, scale=0.1)
        im = philox_mask(11, B, K, 0.1, device="cuda")
        om = philox_mask(12, B, N, 0.2, device="cuda")
        for act in ("relu", "sigmoid", "linear"):
            for kw in ({}, {"in_mask": (11, 0.1), "out_mask": (12, 0.2), "out_scale": 1.25},
                       {"in_mask": im, "in_scale": 1.0 / 0.9, "out_mask": om}):
                want = fused_linear_act_reference(x, w, b, act, dtype=f64, bf16=False, **kw)
                _hold(fused_linear_act(x, w, b, act, bf16=False, **kw), want,
                      f"fused_linear_act {B}x{K}x{N} {act} {sorted(kw)}", fwd_worst)
                fwd_calls += 1
                _hold(fused_linear_act_reference(x, w, b, act, bf16=False, **kw), want,
                      f"float32 plain fused_linear_act {B}x{K}x{N}", plain_worst)
        dedx = _randn(gen, B, N, scale=0.02)
        y_prev = torch.relu(_randn(gen, B, K)) * philox_mask(13, B, K, 0.2, device="cuda")
        delta = _randn(gen, K, N, scale=0.003)
        db = _randn(gen, N, scale=0.003)
        hyp = dict(momentum=0.54, lrate=1.0, inv_n=1.0 / B, weightcost=1e-4, bf16=False)
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
        if B > BUNCH or N % 4:  # bfloat16 delta (sr_delta), bfloat16 W and delta (sr_state)
            for mode, w0 in (("bfloat16 delta", w), ("bfloat16 W and delta", w.bfloat16())):
                d0 = delta.bfloat16()
                kw = dict(hyp, deriv="relu", sr_seed=4343)
                want = fused_bwd_update_reference(dedx, y_prev, w0, d0, b, db, dtype=f64, **kw)
                got = fused_bwd_update(dedx, y_prev, w0.clone(), d0.clone(), b.clone(), db.clone(),
                                       **kw)
                label = f"fused_bwd_update {B}x{K}x{N} on {mode}"
                _hold_sr(got[1], want[1], f"{label}, delta", sr_stats)
                if w0.dtype == torch.bfloat16:
                    _hold_sr(got[0], want[0], f"{label}, W", sr_stats)
                else:
                    _hold(got[0], want[0], f"{label}, W", bwd_worst)
                for name, i in (("dedy", 2), ("b", 3), ("delta_b", 4)):
                    _hold(got[i], want[i], f"{label}, {name}", bwd_worst)
        torch.cuda.synchronize()
    # the float32 forward: one launch a call
    _check(fused_linear_act.launches - fwd0 == fwd_calls,
           f"the float32 forward launched {fused_linear_act.launches - fwd0} kernels in "
           f"{fwd_calls} calls")
    # above the rows its registers hold, the backward refuses a card tensor (either form)
    from tpu_sednn_torch.ops.fused_mlp import BWD_MAX_ROWS, fused_bwd_grad_out

    M, K, N = BWD_MAX_ROWS + 8, 64, 64
    big = [_randn(gen, *shape) for shape in ((M, N), (M, K), (K, N), (K, N), (N,), (N,))]
    for tc in (False, True):
        for call in (lambda: fused_bwd_update(*big, 0.5, 1.0, 1.0 / M, 0.0, bf16=tc),
                     lambda: fused_bwd_grad_out(big[0], big[1], big[2], bf16=tc)):
            try:
                call()
            except ValueError:
                continue
            raise RuntimeError(f"the backward took {M} rows (bf16={tc}); at most {BWD_MAX_ROWS}")
    print(f"[kernel] fused_linear_act vs float64 plain, {len(layer_shapes + ragged)} shapes x 3 "
          f"activations x 3 mask modes, one launch a call: max err {fwd_worst['rel_max']:.3g} of "
          f"max|want| (tol "
          f"{KERNEL_REL_MAX}), Frobenius {fwd_worst['rel_fro']:.3g} (tol {KERNEL_REL_FRO}); "
          f"tolerance: a float32 sum of <= 2048 products against the exact sum", flush=True)
    print(f"[kernel] fused_bwd_update vs float64 plain (W, delta, b, delta_b after the in-place "
          f"update, dedy from the pre-update W), up to {BWD_MAX_ROWS} rows (stripes of 64, 32 "
          f"and 16 rows): max err {bwd_worst['rel_max']:.3g}, Frobenius "
          f"{bwd_worst['rel_fro']:.3g}; the float32 plain versions' own: "
          f"{plain_worst['rel_max']:.3g}, {plain_worst['rel_fro']:.3g}; bfloat16 stores: "
          f"{sr_stats['n_diff']} of {sr_stats['n']} elements differ from the plain version "
          f"rounded with the same bits, worst share {sr_stats['share']:.3g} (limit "
          f"{SR_DIFF_SHARE}); {M} rows refused in both forms", flush=True)

    # the float32 forward's plan: fwd_k_chunk's chunks are a cluster's blocks (up to 16);
    # every cluster size the main path asks for must be placeable on the card
    import ctypes

    from tpu_sednn_torch.ops.fused_mlp import _lib as fused_lib

    plans = {}
    for B, K, N, rows in ([(BUNCH, FLAGSHIP[l], FLAGSHIP[l + 1], 0) for l in range(4)]
                          + [(BUNCH, WIDE[0], WIDE[1], 0), (BUNCH, WIDE[3], WIDE[4], 0),
                             (64, FLAGSHIP[0], FLAGSHIP[1], BUNCH), (64, FLAGSHIP[3], FLAGSHIP[4], BUNCH)]):
        out = (ctypes.c_int * 5)()
        _check(fused_lib().fused_f32_fwd_plan(B, K, N, rows, out) == 0 and out[4] >= 1,
               f"the float32 forward's plan at {B}x{K}x{N}: {list(out)}")
        plans[f"{B}x{K}x{N}" + (f" planned for {rows}" if rows else "")] = dict(
            chunk=out[0], chunks=out[1], blocks=out[2], resident_blocks=out[3],
            resident_clusters=out[4])
    print("[kernel] float32 forward plan (chunk of K, chunks = a cluster's blocks, the grid's "
          "blocks; the blocks and clusters the card holds at once): "
          + "; ".join(f"{k}: {v['chunks']} x {v['chunk']}, {v['blocks']} blocks ({v['resident_blocks']}"
                      f" / {v['resident_clusters']} clusters at once)" for k, v in plans.items()),
          flush=True)
    fwd, bwd = _time_layers(gen, False, fwd_worst, bwd_worst)
    fwd["plans"] = plans
    torch.cuda.empty_cache()
    # a generator of its own: the later phases draw the inputs they always drew
    fwd["at_16k"], bwd["at_16k"] = _time_layers(torch.Generator(device="cuda").manual_seed(16001),
                                                False, fwd_worst, bwd_worst, net=WIDE)
    return dict(fwd=fwd, bwd=bwd)


# Kernels 1 and 2 with tensor-core products (bf16=True) against their float64
# plain versions of the same rounded operands.  The products of bfloat16
# values are exact on both sides, so only the float32 sums differ, and the
# tensor cores' sums within a fragment are not IEEE round-to-nearest: held to
# TC_REL_MAX of max|want| and TC_REL_FRO in Frobenius norm (read: at most
# 1.7e-6, on W' - W, and 3.2e-7; the float32 forms read the same order).  The
# products W' - W, delta' and dedy are held on themselves (W' would hide them
# under W); b' and delta_b' have no product and keep the float32 limits.
# Two deliberate faults must miss the limits by TC_FAULT times at least: the
# float32-FMA form, and operands truncated to bfloat16 instead of rounded to
# nearest (both about 2^-9 relative a product; read: 121 and 291 times).
TC_REL_MAX = 1e-5
TC_REL_FRO = 2e-6
TC_FAULT = 10.0


def _trunc_bf16(a: torch.Tensor) -> torch.Tensor:
    """a cut to bfloat16 by dropping its low 16 bits (a fault: not rounded), as float32."""
    return (a.float().contiguous().view(torch.int32) & -65536).view(torch.float32)


def phase_tc_kernels(gen) -> dict:
    import ctypes

    from tpu_sednn_torch.ops.fused_mlp import _lib as fused_lib
    from tpu_sednn_torch.ops.fused_mlp import (fused_bwd_update, fused_bwd_update_reference,
                                               fused_linear_act, fused_linear_act_reference)
    from tpu_sednn_torch.ops.philox import philox_mask

    f64, bf = torch.float64, torch.bfloat16
    layers = ([(BUNCH, FLAGSHIP[l], FLAGSHIP[l + 1]) for l in range(4)]
              + [(BUNCH, WIDE[l], WIDE[l + 1]) for l in range(4)])
    ragged = [(8, 1548, 129), (136, 100, 37), (64, 3084, 2048), (32, 2048, 257)]
    worst, faults, sr_stats = {}, dict(fma=np.inf, trunc=np.inf), {}

    def fault(kind, got, want):
        rel_max, rel_fro = _err(got, want)
        faults[kind] = min(faults[kind], max(rel_max / TC_REL_MAX, rel_fro / TC_REL_FRO))

    for B, K, N in layers + ragged:
        x, b = _randn(gen, B, K), _randn(gen, N, scale=0.1)
        w32 = _randn(gen, K, N, scale=0.03)
        dedx = _randn(gen, B, N, scale=0.02)
        y_prev = torch.relu(_randn(gen, B, K)) * philox_mask(13, B, K, 0.2, device="cuda")
        db = _randn(gen, N, scale=0.003)
        for w in (w32, w32.to(bf)):
            store = "bfloat16 W" if w.dtype == bf else "float32 W"
            for act in ("relu", "sigmoid", "linear"):
                for kw in ({}, {"in_mask": (11, 0.1), "in_scale": 1.0 / 0.9, "out_mask": (12, 0.2),
                                "out_scale": 1.25}):
                    want = fused_linear_act_reference(x, w, b, act, dtype=f64, **kw)
                    got = fused_linear_act(x, w, b, act, **kw)
                    _hold(got, want, f"tensor-core fused_linear_act {B}x{K}x{N} {store} {act} "
                                     f"{sorted(kw)}", worst, TC_REL_MAX, TC_REL_FRO)
                    fault("fma", fused_linear_act(x, w, b, act, bf16=False, **kw), want)
                    if not kw:
                        fault("trunc", got, fused_linear_act_reference(
                            _trunc_bf16(x), _trunc_bf16(w), b, act, dtype=f64, bf16=False))
            d0 = _randn(gen, K, N, scale=0.003).to(w.dtype)
            hyp = dict(momentum=0.54, lrate=1.0, inv_n=1.0 / B, weightcost=1e-4, sr_seed=4242)
            for kw in ({}, {"deriv": "relu"}, {"in_mask": (11, 0.1), "in_scale": 1.0 / 0.9}):
                want = fused_bwd_update_reference(dedx, y_prev, w, d0, b, db, dtype=f64, **hyp, **kw)
                outs = {}
                for tc in (True, False):
                    w2, d2, b2, db2 = w.clone(), d0.clone(), b.clone(), db.clone()
                    outs[tc] = fused_bwd_update(dedx, y_prev, w2, d2, b2, db2, bf16=tc, **hyp, **kw)
                got = outs[True]
                label = f"tensor-core fused_bwd_update {B}x{K}x{N} {store} {sorted(kw)}"
                if w.dtype == bf:
                    _hold_sr(got[0], want[0], f"{label}, W", sr_stats)
                    _hold_sr(got[1], want[1], f"{label}, delta", sr_stats)
                else:
                    for name, g, wnt in (("W' - W", got[0] - w, want[0] - w),
                                         ("delta", got[1], want[1])):
                        _hold(g, wnt, f"{label}, {name}", worst, TC_REL_MAX, TC_REL_FRO)
                    fault("fma", outs[False][1], want[1])
                _hold(got[2], want[2], f"{label}, dedy", worst, TC_REL_MAX, TC_REL_FRO)
                fault("fma", outs[False][2], want[2])
                for name, i in (("b", 3), ("delta_b", 4)):
                    _hold(got[i], want[i], f"{label}, {name}", {})
        torch.cuda.synchronize()
    _check(min(faults.values()) >= TC_FAULT,
           f"tensor-core kernels: a deliberate fault passes within {TC_FAULT} x the limits: {faults}")
    print(f"[kernel] tensor-core fused_linear_act and fused_bwd_update (bf16=True) vs float64 plain "
          f"versions of the rounded operands, {len(layers)} layer shapes of 1548-2048x3-129 and "
          f"3084-2048x3-257 and {len(ragged)} ragged ones, float32 and bfloat16 W, 3 activations, "
          f"masks, derivatives: max err {worst['rel_max']:.3g} of max|want| (tol {TC_REL_MAX}), "
          f"Frobenius {worst['rel_fro']:.3g} (tol {TC_REL_FRO}); bfloat16 stores: "
          f"{sr_stats['n_diff']} of {sr_stats['n']} elements differ from the plain version rounded "
          f"with the same bits, worst share {sr_stats['share']:.3g} (limit {SR_DIFF_SHARE}); "
          f"deliberate faults miss the limits by {faults['fma']:.3g} x (float32 FMA products) and "
          f"{faults['trunc']:.3g} x (operands truncated, not rounded), at least {TC_FAULT} x "
          f"required", flush=True)

    # how the backward lays a layer out on this card, in either product form (bwd_split)
    plans = {}
    rank_rows = [(M, K, N) for M in (64, 32) for _, K, N in layers[:4]]
    for B, K, N in layers + rank_rows + [(256, 2048, 2048), (512, 1548, 129)]:
        for dedy in (1, 0):
            for tc in (1, 0):
                out = (ctypes.c_int * 3)()
                _check(fused_lib().fused_bwd_plan(B, K, N, dedy, tc, out) == 0,
                       "fused_bwd_plan failed")
                plans[f"{'tc' if tc else 'f32'} {B}x{K}x{N}{'' if dedy else ', no dedy'}"] = dict(
                    split=out[0], stripes=out[1], rows=out[2])
    print("[kernel] backward plan (split of N over a stripe's blocks: the cluster that sums dedy; "
          "stripes of W's rows; their rows), tensor cores with a row of bias blocks beside: "
          + "; ".join(f"{k}: {v['split']} x {v['stripes']} of {v['rows']}" for k, v in plans.items()),
          flush=True)
    # whether a block of the chunk trainer's next launch can start beside one of the
    # launch before it (programmatic dependent launches): by shared memory (each block
    # also reserves 1 KB)
    smem = (ctypes.c_int * 9)()
    fused_lib().fused_tc_smem_bytes(smem)
    per_sm = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_multiprocessor", 0)
    pairs = {f"{a} + {b}": smem[i] + smem[j] + 2048 <= per_sm
             for a, b, i, j in (("fwd", "fwd", 1, 1), ("fwd", "bwd", 1, 4), ("bwd", "bwd", 4, 4))}
    print(f"[kernel] dynamic shared memory a block: tc_fwd_kernel {smem[0]} / {smem[1]} bytes (128- "
          f"/ 64-column slices), stripe_bwd_kernel {smem[2]} / {smem[3]} / {smem[4]} bytes with "
          f"tensor cores, {smem[5]} / {smem[6]} / {smem[7]} with float32 products (stripes of 64 / "
          f"32 / 16 rows), f32_fwd_kernel {smem[8]}; an SM holds {per_sm}: the smallest of each "
          f"pair fit one SM together: {pairs}", flush=True)

    fwd, bwd = _time_layers(gen, True, worst, worst)
    bwd["plans"] = plans
    bwd["smem_bytes"] = dict(fwd_128=smem[0], fwd_64=smem[1], bwd_64=smem[2], bwd_32=smem[3],
                             bwd_16=smem[4], f32_bwd_64=smem[5], f32_bwd_32=smem[6],
                             f32_bwd_16=smem[7], f32_fwd=smem[8], per_sm=per_sm,
                             fit_together=pairs)
    torch.cuda.empty_cache()
    # a generator of its own: the later phases draw the inputs they always drew
    fwd["at_16k"], bwd["at_16k"] = _time_layers(torch.Generator(device="cuda").manual_seed(16000),
                                                True, worst, worst, net=WIDE)
    for acc in (fwd, bwd):
        acc["fault_margin"] = min(faults.values())
    return dict(fwd=fwd, bwd=bwd, sr=sr_stats)


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
    probe = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                 shape=f"{shape[0]}x{shape[1]}")
    return dict(_phase_mask_table(), max_abs_err=mask_err, probe=probe)


# the card's 32-bit integer multiply rate: 64 results a clock an SM, half its
# FP32 FMA rate (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0), at the clock of PEAK_FP32_FLOPS
PEAK_IMAD_PER_S = PEAK_FP32_FLOPS / 4.0
# a Philox4x32-10 call: ten rounds of two 32 x 32 -> 64-bit products, each
# two 32-bit multiply results
PHILOX_IMADS = 40


def _mask_table_bound(n_tiles: int, tile: int, K: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one draw of a call's input-mask
    table: the table written once, against the Philox calls the rows need
    (ceil(K / 4) a row) on the integer multipliers."""
    t_bytes = 4.0 * n_tiles * tile * ((K + 31) // 32) / PEAK_BYTES_PER_S * 1e3
    t_ops = PHILOX_IMADS * n_tiles * tile * ((K + 3) // 4) / PEAK_IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def _phase_mask_table() -> dict:
    """The chunk trainer's input-mask table (input_mask_bits_kernel): bit-equal
    to its plain version at K 1548, 3084, 129 and 33, tiles of 128 and 64
    rows (accum 1 and 2), omit 0.1 and 0.5, at the data-parallel ranks'
    rows (row0 > 0, 2 and 4 ranks; their tables stacked bit-equal to the
    single-device table), and on a whole 800-tile call of the 8 kHz net; the
    layer-0 wrappers reading a table bit-equal to the same wrappers drawing
    Philox, both product forms, at both nets' layer-0 shapes; a chunk-trainer
    call and a data-parallel forward with input dropout and no table
    refused; the draw's time on an 800-tile call at 8 and 16 kHz beside its
    plain version's, torch.rand >= omit (a yardstick: not the same bits)
    and the bound, and one rank of 2's draw beside its bound."""
    import ctypes

    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import fused_bwd_update, fused_linear_act
    from tpu_sednn_torch.ops.philox import mask_threshold, philox_mask_words

    seed, n_held = 2**31 - 5, 0
    for K in (1548, 3084, 129, 33):
        for accum in (1, 2):
            for omit in (0.1, 0.5):
                tile = BUNCH // accum
                got = rc.input_mask_bits(seed, 3 * accum, tile, K, omit)
                want = rc.input_mask_bits_reference(seed, 3 * accum, tile, K, omit, device="cuda")
                _check(torch.equal(got, want), f"input mask table K {K}, tiles of {tile}, omit "
                                               f"{omit}: the kernel differs from its plain version")
                n_held += got.numel()
    # a data-parallel rank's rows (row0 = rank * local tile): bit-equal to the plain version,
    # and the ranks' tables stacked are the single-device table of the global tile
    n_ranks_held = 0
    for K in (1548, 3084, 129):
        whole = rc.input_mask_bits(seed, 6, BUNCH, K, 0.1)
        for n_dev in (2, 4):
            tile = BUNCH // n_dev
            parts = [rc.input_mask_bits(seed, 6, tile, K, 0.1, row0=d * tile) for d in range(n_dev)]
            for d, part in enumerate(parts):
                want = rc.input_mask_bits_reference(seed, 6, tile, K, 0.1, device="cuda",
                                                    row0=d * tile)
                _check(torch.equal(part, want), f"input mask table K {K}, rank {d} of {n_dev} (row0 "
                                                f"{d * tile}): the kernel differs from its plain "
                                                f"version")
                n_held += part.numel()
            _check(torch.equal(torch.cat(parts, dim=1), whole),
                   f"input mask table K {K}: the {n_dev} ranks' tables stacked differ from the "
                   f"single-device table")
            n_ranks_held += 1
    n_tiles = 800
    got = rc.input_mask_bits(seed, n_tiles, BUNCH, FLAGSHIP[0], 0.1)
    want = rc.input_mask_bits_reference(seed, n_tiles, BUNCH, FLAGSHIP[0], 0.1, device="cuda")
    _check(torch.equal(got, want), "the 800-tile input mask table differs from its plain version")
    n_held += got.numel()
    del got, want
    # the layer-0 wrappers: a table read gives the bits a Philox draw gives
    gen = torch.Generator(device="cuda").manual_seed(1777)
    for K in (FLAGSHIP[0], 3084):
        N = 2048
        x, w, b = _randn(gen, BUNCH, K), _randn(gen, K, N, scale=0.03), _randn(gen, N, scale=0.1)
        dedx = _randn(gen, BUNCH, N, scale=0.02)
        table = philox_mask_words(4, BUNCH, K, 0.1, device="cuda")
        for tc in (True, False):
            ys = [fused_linear_act(x, w, b, "relu", in_mask=m, in_scale=1.25, out_mask=(5, 0.2),
                                   bf16=tc) for m in (table, (4, 0.1))]
            _check(torch.equal(ys[0], ys[1]), f"layer 0 {BUNCH}x{K}x{N} bf16={tc}: the forward "
                                              f"reading a table differs from the Philox draw")
            outs = []
            for m in (table, (4, 0.1)):
                st = [w.clone(), torch.zeros_like(w), b.clone(), torch.zeros_like(b)]
                outs.append(fused_bwd_update(dedx, x, *st, 0.5, 1e-3, 1.0 / BUNCH, 1e-5,
                                             in_mask=m, bf16=tc))
            _check(all(torch.equal(u, v) for u, v in zip(*outs)),
                   f"layer 0 {BUNCH}x{K}x{N} bf16={tc}: the backward reading a table differs "
                   f"from the Philox draw")
    # no fallback: a call with input dropout and no table is refused before it launches
    c_sizes = (ctypes.c_int * 2)(8, 8)
    nulls = (ctypes.c_void_p * 1)(None)
    plan = (ctypes.c_int * 4)(*rc.early_read_plan(1, 1))
    tallies = (ctypes.c_longlong * len(rc.kernel_launches))()
    err = rc._lib().resident_chunk_train(None, None, 1, 8, 1, c_sizes, 1, nulls, 0, nulls, 0, nulls,
                                         nulls, None, None, 1, 0, mask_threshold(0.1), 0, 1.0, 1.0,
                                         7, 0.5, 0.1, 0.0, 1, plan, tallies, None)
    _check(err != 0 and not any(tallies), f"a chunk-trainer call with input dropout and no table: "
                                          f"error {err}, tallies {list(tallies)}")
    # and so is a data-parallel forward with input dropout and no table
    err_dp = rc._lib().dp_chunk_forward(None, None, 8, 16, c_sizes, 1, nulls, nulls, nulls, None,
                                        1, 0, mask_threshold(0.1), 0, 1.0, 1.0, None, 7, 8, 0.1, 1,
                                        tallies, None)
    _check(err_dp != 0 and not any(tallies), f"a data-parallel forward with input dropout and no "
                                             f"table: error {err_dp}, tallies {list(tallies)}")
    out = {}
    for tag, K in (("8k", FLAGSHIP[0]), ("16k", 3084)):
        ms = _device_ms(lambda i: rc.input_mask_bits(seed + i, n_tiles, BUNCH, K, 0.1))
        plain_ms = _time_ms(lambda: rc.input_mask_bits_reference(seed, n_tiles, BUNCH, K, 0.1,
                                                                 device="cuda"), reps=1, warmup=0)
        library_ms = _device_ms(lambda i: torch.rand(n_tiles * BUNCH, K, device="cuda") >= 0.1)
        bound_ms, bound_by = _mask_table_bound(n_tiles, BUNCH, K)
        out[tag] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                        bound_by=bound_by, shape=f"{n_tiles} tiles x {BUNCH} x {K}")
        print(f"[kernel] input mask table, {n_tiles} tiles x {BUNCH} rows x {K} columns (one "
              f"call's draw): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (int64 tensor "
              f"arithmetic, a tile at a time, the host's share in it), torch.rand >= omit "
              f"{library_ms:.4f} ms (not the same bits), bound {bound_ms:.4f} ms ({bound_by}: "
              f"{PHILOX_IMADS} 32-bit multiplies a Philox call at {PEAK_IMAD_PER_S / 1e12:.2f} T/s, "
              f"the table's bytes at 3.35 TB/s)", flush=True)
    # one rank of 2's draw of an 800-tile call: its 64 rows of each tile, at row0 64
    ms = _device_ms(lambda i: rc.input_mask_bits(seed + i, n_tiles, BUNCH // 2, FLAGSHIP[0], 0.1,
                                                 row0=BUNCH // 2))
    bound_ms, bound_by = _mask_table_bound(n_tiles, BUNCH // 2, FLAGSHIP[0])
    out["dp2"] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                      shape=f"{n_tiles} tiles x {BUNCH // 2} x {FLAGSHIP[0]} (rank 1 of 2)")
    print(f"[kernel] input mask table, one rank of 2 ({n_tiles} tiles x {BUNCH // 2} rows at row0 "
          f"{BUNCH // 2} x {FLAGSHIP[0]} columns): kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})", flush=True)
    print(f"[kernel] input mask table: the draw kernel bit-equal to its plain version "
          f"({n_held} words: 16 shapes, 18 data-parallel ranks' rows at row0 > 0 and an 800-tile "
          f"call); {n_ranks_held} sets of 2 or 4 ranks' tables stacked bit-equal to the "
          f"single-device table; the layer-0 forward and backward reading a table bit-equal to "
          f"their Philox draw (both forms, both nets); a chunk-trainer call and a data-parallel "
          f"forward with input dropout and no table refused (errors {err}, {err_dp})", flush=True)
    return dict(out["8k"], at_16k=out["16k"], dp_rank_of_2=out["dp2"],
                times_of="one launch of input_mask_bits_kernel drawing the input masks of an "
                         "800-tile chunk-trainer call (8 kHz; at_16k: 16 kHz; dp_rank_of_2: one "
                         "data-parallel rank's 64 rows of each tile); probe: one standalone "
                         "launch of sample_resident_masks; `launches` counts the draw kernel's "
                         "launches and the layer kernels' launches that drew Philox masks in the "
                         "kernel (hidden layers)",
                library_is="torch.rand >= omit over the same elements: not the same bits")


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


def _sr_delta_steps(state, x, t, opt, seed: int, n_b: int):
    """n_b bunches of the sr_delta chunk trainer (1548-2048x3-129, relu, parity
    dropout 0.1/0.2, tensor cores) stepped through the standalone wrappers
    fused_linear_act and fused_bwd_update, which never take the programmatic
    dependent launch attribute: the trainer's masks (sample_resident_masks)
    and stochastic-rounding streams (resident_chunk.sr_key).  In place."""
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import fused_bwd_update, fused_linear_act

    rc._cast_state(state, torch.float32, torch.bfloat16)
    ws, bs, dws, dbs = state.params.w, state.params.b, state.deltas.w, state.deltas.b
    L = len(ws)
    for i in range(n_b):
        xi, ti = x[i * BUNCH:(i + 1) * BUNCH], t[i * BUNCH:(i + 1) * BUNCH]
        masks = [rc.sample_resident_masks(seed, i, l, (BUNCH, FLAGSHIP[l]), 0.1 if l == 0 else 0.2)
                 for l in range(L)]
        ys, h = [xi], xi
        for l in range(L):
            last = l == L - 1
            h = fused_linear_act(h, ws[l], bs[l], act="linear" if last else "relu",
                                 in_mask=masks[0] if l == 0 else None,
                                 out_mask=None if last else masks[l + 1])
            ys.append(h)
        dedx = (2.0 / BUNCH) * (h - ti)
        for l in range(L - 1, -1, -1):
            _, _, dedx, _, _ = fused_bwd_update(
                dedx.contiguous(), ys[l], ws[l], dws[l], bs[l], dbs[l], opt.momentum, opt.lrate,
                1.0 / BUNCH, opt.weightcost, in_mask=masks[0] if l == 0 else None,
                deriv="relu" if l > 0 else None, sr_seed=rc.sr_key(seed, i, l))
        state.step += 1
    return state


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
    f64, worst = torch.float64, {}
    hyp = (opt.lrate, opt.momentum, opt.weightcost)

    init = init_train_state(mlp)

    def draw(i):
        """Draw i of a fixed-limit hold's inputs, seeded on its own (3 bunches and a
        partial one): -> x, a linear target, a sigmoid one."""
        g = torch.Generator(device="cuda").manual_seed(RESIDENT_SEED + i)
        xd = _randn(g, n_b * BUNCH + 40, FLAGSHIP[0])
        td = (xd @ _randn(g, FLAGSHIP[0], FLAGSHIP[-1], scale=0.05)).contiguous()
        return xd, td, torch.sigmoid(td).contiguous()

    def held_on_draws(label, cfg, rule, sig, bf16, tol3, tol1, worst_d):
        """The chunk trainer of (cfg, rule) against its float64 plain version after
        three bunches (tol3) and after one (tol1), on RESIDENT_DRAWS draws of its own:
        the first draw that holds both is taken; a draw is passed over only where the
        float32 plain version of the same rounding misses there too, and one must
        hold.  -> (runner, x, t, want, one bunch's want, errors, the plain version's
        errors, errors after one bunch)."""
        run = rc.make_resident_train_chunk(cfg, opt, bf16=bf16, rule=rule)
        coefs = rc._scal_coefs(rule, BUNCH, FLAGSHIP[-1], *hyp)
        passed_over = []
        for i in range(RESIDENT_DRAWS):
            xd, tl, ts = draw(i)
            td = ts if sig else tl

            def ref(n, dt):
                return rc.resident_train_chunk_reference(init_train_state(mlp), xd[:n], td[:n], cfg,
                                                         BUNCH, coefs, 17, dtype=dt, bf16=bf16)

            got = run(init_train_state(mlp), xd, td, 17, *hyp)
            one = run(init_train_state(mlp), xd[:BUNCH], td[:BUNCH], 17, *hyp)
            want, plain = ref(len(xd), f64), ref(len(xd), None)
            one_w, one_p = ref(BUNCH, f64), ref(BUNCH, None)
            torch.cuda.synchronize()
            _check(got.step == n_b, f"{label}: {got.step} bunches trained, the partial one not dropped")
            for st in (got, one):
                _check(all(bool(torch.isfinite(a).all()) for a in _state_tensors(st)),
                       f"{label}, draw {i}: non-finite state")
            errs, p_errs = _update_errors(got, want, init), _update_errors(plain, want, init)
            e1, p1 = _update_errors(one, one_w, init), _update_errors(one_p, one_w, init)
            if max(errs) <= tol3 and max(e1) <= tol1:
                worst_d["rel_fro"] = max(worst_d.get("rel_fro", 0.0), max(errs))
                worst_d["one"] = max(worst_d.get("one", 0.0), max(e1))
                worst_d["abs"] = max([worst_d.get("abs", 0.0)] + [
                    float((a.double() - b.double()).abs().max())
                    for a, b in zip(_state_tensors(got), _state_tensors(want))])
                worst_d["passed_over"] = worst_d.get("passed_over", 0) + len(passed_over)
                if passed_over:
                    print(f"[kernel] chunk trainer, {label}: draws passed over where the float32 "
                          f"plain version misses too (draw, kernel / plain after 3 bunches, after "
                          f"one): {passed_over}", flush=True)
                return run, xd, td, want, one_w, errs, p_errs, e1
            _check(max(p_errs) > tol3 or max(p1) > tol1,
                   f"{label}, draw {i}: update off by {max(errs):.3g} after three bunches (tol "
                   f"{tol3}), {max(e1):.3g} after one (tol {tol1}), which the float32 plain "
                   f"version holds there ({max(p_errs):.3g}, {max(p1):.3g})")
            passed_over.append((i, f"{max(errs):.3g} / {max(p_errs):.3g}",
                                f"{max(e1):.3g} / {max(p1):.3g}"))
        _check(False, f"{label}: no draw of {RESIDENT_DRAWS} holds the limits: {passed_over}")

    cases = [
        ("parity, dropout off", _flagship_cfg(), "parity", False),
        ("clean, dropout off", _flagship_cfg(), "clean", False),
        ("parity, dropout 0.1/0.2 (parity mode)",
         _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2), "parity", False),
        ("clean, dropout 0.1/0.2 (inverted mode)",
         _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2, dropout_mode="inverted"), "clean", False),
        ("parity, sigmoid head, dropout 0.1/0.2",
         _flagship_cfg(output="sigmoid", dropout_vis=0.1, dropout_hid=0.2), "parity", True),
    ]
    held = {}
    for label, cfg, rule, sig in cases:
        run, xd, td, want, one_w, errs, p_errs, e1 = held_on_draws(
            label, cfg, rule, sig, False, CHUNK_REL_FRO, CHUNK_ONE_REL_FRO, worst)
        held.setdefault("first", (run, xd, td, want, one_w))
        print(f"[kernel] chunk trainer, {label}: {n_b} bunches + a partial one vs float64 plain, "
              f"update error by layer W {' '.join(f'{e:.2g}' for e in errs[:4])}, delta_b "
              f"{' '.join(f'{e:.2g}' for e in errs[12:])} (float32 plain version's own: W "
              f"{' '.join(f'{e:.2g}' for e in p_errs[:4])}); after one bunch W "
              f"{' '.join(f'{e:.2g}' for e in e1[:4])}", flush=True)

    # the limits bite: the first case's trainer given a wrong hyperparameter
    # must be refused by the one-bunch or the three-bunch limit (on its draw)
    run, xd, td, want, one_w = held["first"]
    for label, h in (("weightcost dropped", (opt.lrate, opt.momentum, 0.0)),
                     ("momentum x 1.03", (opt.lrate, 1.03 * opt.momentum, opt.weightcost)),
                     ("lrate x 1.001", (1.001 * opt.lrate, opt.momentum, opt.weightcost))):
        m1 = max(_update_errors(run(init_train_state(mlp), xd[:BUNCH], td[:BUNCH], 17, *h),
                                one_w, init))
        m3 = max(_update_errors(run(init_train_state(mlp), xd, td, 17, *h), want, init))
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
    run = rc.make_resident_train_chunk(cfg, opt, bf16=False)
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
    # hyperparameters changed between two calls of one runner, on TWO_CALL_DRAWS
    # seeded draws of their own, each read and printed: the kernel may miss
    # CHUNK_REL_FRO on a draw only where the float32 plain version misses it
    # against float64 there too (a ReLU flip of float32), and must hold it on one
    two_calls = []
    for i in range(TWO_CALL_DRAWS):
        g = torch.Generator(device="cuda").manual_seed(1022 + i)
        xs = _randn(g, n_b * BUNCH + 40, FLAGSHIP[0])
        ts = (xs @ _randn(g, FLAGSHIP[0], FLAGSHIP[-1], scale=0.05)).contiguous()
        st_k, st_p, st_32 = (init_train_state(mlp) for _ in range(3))
        for seed, h in ((5, (1.0, 0.5, 1e-5)), (6, (0.7, 0.9, 0.0))):
            run(st_k, xs, ts, seed, *h)
            coefs = rc._scal_coefs("parity", BUNCH, FLAGSHIP[-1], *h)
            rc.resident_train_chunk_reference(st_p, xs, ts, cfg, BUNCH, coefs, seed, dtype=f64,
                                              bf16=False)
            rc.resident_train_chunk_reference(st_32, xs, ts, cfg, BUNCH, coefs, seed, bf16=False)
        torch.cuda.synchronize()
        for g_ in _state_tensors(st_k):
            _check(bool(torch.isfinite(g_).all()), f"two calls, draw {i}: non-finite state")
        _check(st_k.step == st_p.step, f"two calls, draw {i}: step {st_k.step} vs {st_p.step}")
        e, e32 = max(_update_errors(st_k, st_p, init)), max(_update_errors(st_32, st_p, init))
        _check(e <= CHUNK_REL_FRO or e32 > CHUNK_REL_FRO,
               f"two calls, hyperparameters changed, draw {i}: update off by {e:.3g} relative "
               f"Frobenius (tol {CHUNK_REL_FRO}), which the float32 plain version holds there "
               f"({e32:.3g})")
        two_calls.append((e, e32))
    _check(any(e <= CHUNK_REL_FRO for e, _ in two_calls),
           f"two calls, hyperparameters changed: no draw holds {CHUNK_REL_FRO}: {two_calls}")
    worst["rel_fro"] = max(worst["rel_fro"], min(e for e, _ in two_calls))
    print(f"[kernel] chunk trainer, two calls with changed hyperparameters, {TWO_CALL_DRAWS} "
          f"draws: worst update error of any tensor "
          f"{' '.join(f'{e:.3g}' for e, _ in two_calls)} (the float32 plain version's own "
          f"against float64: {' '.join(f'{e32:.3g}' for _, e32 in two_calls)}; tol "
          f"{CHUNK_REL_FRO}, missed only where the plain version misses too)", flush=True)
    # the per-bunch step of ops/train_step.py launches the same kernels with
    # explicit masks: the same bits, so the same state bit for bit
    st_s = init_train_state(mlp)
    for i in range(n_b):
        masks = [rc.sample_resident_masks(17, i, l, (BUNCH, FLAGSHIP[l]), 0.1 if l == 0 else 0.2)
                 for l in range(4)]
        fused_train_step(st_s, x[i * BUNCH:(i + 1) * BUNCH], t_lin[i * BUNCH:(i + 1) * BUNCH],
                         cfg, opt, dropout_masks=masks, bf16=False)
    torch.cuda.synchronize()
    for a, b in zip(_state_tensors(st_s), _state_tensors(trimmed)):
        _check(torch.equal(a, b), "ops.train_step.fused_train_step differs from the chunk trainer")
    print(f"[kernel] chunk trainer: n_real below capacity (NaN rows beyond never read) and a "
          f"trailing partial bunch equal the trimmed run bit for bit; two calls with changed "
          f"hyperparameters hold; ops.train_step's per-bunch step gives the same bits; worst "
          f"update error of any tensor {worst['rel_fro']:.3g} relative Frobenius after 3 or 2 x 3 "
          f"bunches (tol {CHUNK_REL_FRO}: carried rounding, room for one ReLU flip), "
          f"{worst['one']:.3g} after one bunch (tol {CHUNK_ONE_REL_FRO})", flush=True)

    # tensor-core products (bf16=True, the factory's default): the same cases against the
    # float64 plain version of the same rounding (TC_ONE_REL_FRO, TC_THREE_REL_FRO), on
    # draws of their own
    tc_worst = {}
    for label, cfg_c, rule, sig in cases:
        run_tc, xd, td, want, one_w, errs, p_errs, e1 = held_on_draws(
            f"tensor cores, {label}", cfg_c, rule, sig, True, TC_THREE_REL_FRO, TC_ONE_REL_FRO,
            tc_worst)
        held.setdefault("tc", (run_tc, xd, td, one_w))
        print(f"[kernel] chunk trainer, tensor cores, {label}: {n_b} bunches + a partial one vs "
              f"float64 plain, update error by layer W {' '.join(f'{e:.2g}' for e in errs[:4])}, "
              f"delta_b {' '.join(f'{e:.2g}' for e in errs[12:])} (float32 plain version of the "
              f"same rounding: W {' '.join(f'{e:.2g}' for e in p_errs[:4])}); after one bunch W "
              f"{' '.join(f'{e:.2g}' for e in e1[:4])}", flush=True)
    # the limits bite: the first case's trainer with float32 products, or with an lrate or a
    # momentum 10% off, is refused by the one-bunch limit (on its draw)
    run_tc, xd, td, one_w = held["tc"]
    f32_run = rc.make_resident_train_chunk(cases[0][1], opt, bf16=False, rule=cases[0][2])
    for label, r, h in (("float32 products", f32_run, hyp),
                        ("lrate x 1.1", run_tc, (1.1 * opt.lrate, opt.momentum, opt.weightcost)),
                        ("momentum x 1.1", run_tc, (opt.lrate, 1.1 * opt.momentum, opt.weightcost))):
        m1 = max(_update_errors(r(init_train_state(mlp), xd[:BUNCH], td[:BUNCH], 17, *h), one_w,
                                init))
        _check(m1 > TC_ONE_REL_FRO, f"a tensor-core chunk trainer with {label} passes the one-bunch "
                                    f"limit: {m1:.3g}")
        print(f"[kernel] tensor-core chunk trainer with {label} (a deliberate fault) is refused: "
              f"update off by {m1:.3g} after one bunch (tol {TC_ONE_REL_FRO})", flush=True)
    # the chunk trainer's chain of programmatic dependent launches against the same
    # kernels launched one by one through the standalone wrappers, which never take the
    # attribute (ops.train_step's per-bunch step; for sr_delta the wrappers with the
    # trainer's rounding streams), with the trainer's masks: the same bits, so no launch
    # of the chain read an operand before it was written (a race would show here); and
    # the chain's dependent launches counted: every launch of a call but its first
    cfg_d = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
    # (and the float32-product chain, bf16=False, against the wrappers' float32 forms)
    for label, kw, steps in (("tensor cores, float32 state", {}, "ops.train_step"),
                             ("tensor cores, sr_delta", dict(sr_delta=True), "fused_linear_act and "
                              "fused_bwd_update with its rounding streams"),
                             ("float32 products", dict(bf16=False), "ops.train_step")):
        before = dict(rc.kernel_launches)
        chunk_tc = rc.make_resident_train_chunk(cfg_d, opt, **kw)(
            init_train_state(mlp), x[:n_b * BUNCH], t_lin[:n_b * BUNCH], 17, *hyp)
        n_pdl, n_table, n_in_philox = (rc.kernel_launches[k] - before[k] for k in
                                       ("pdl", "input_mask_table", "input_mask_philox"))
        _check(n_pdl == 2 * 4 * n_b - 1, f"{label}: {n_pdl} programmatic dependent launches in a "
                                          f"call of {n_b} bunches, not {8 * n_b - 1}")
        # the input masks drawn once, by the draw kernel, and read by layer 0's two kernels
        _check(n_table == 1 and n_in_philox == 0,
               f"{label}: {n_table} draw launches, {n_in_philox} layer-0 launches that drew the "
               f"input mask by Philox in a call (want 1 and 0)")
        st_s = init_train_state(mlp)
        if kw.get("sr_delta"):
            _sr_delta_steps(st_s, x, t_lin, opt, 17, n_b)
        else:
            for i in range(n_b):
                masks = [rc.sample_resident_masks(17, i, l, (BUNCH, FLAGSHIP[l]),
                                                  0.1 if l == 0 else 0.2) for l in range(4)]
                fused_train_step(st_s, x[i * BUNCH:(i + 1) * BUNCH],
                                 t_lin[i * BUNCH:(i + 1) * BUNCH], cfg_d, opt, dropout_masks=masks,
                                 bf16=kw.get("bf16", True))
        torch.cuda.synchronize()
        for a, b in zip(_state_tensors(st_s), _state_tensors(chunk_tc)):
            _check(torch.equal(a, b), f"{label}: the standalone wrappers' steps differ from the "
                                      f"chunk trainer")
        print(f"[kernel] chunk trainer, {label}: its chain ({n_pdl} programmatic "
              f"dependent launches in {n_b} bunches; the input masks drawn by {n_table} launch "
              f"into their bit table, which layer 0 reads) gives the same bits as the standalone "
              f"wrappers launched one by one ({steps}; explicit masks) over {n_b} bunches",
              flush=True)
    print(f"[kernel] chunk trainer, tensor cores: worst update error of any tensor "
          f"{tc_worst['rel_fro']:.3g} after 3 bunches (tol {TC_THREE_REL_FRO}), "
          f"{tc_worst['one']:.3g} after one (tol {TC_ONE_REL_FRO})", flush=True)

    # ms per bunch: 100 bunches of dropout training in one call
    n_t = 100
    xt, tt = _randn(gen, n_t * BUNCH, FLAGSHIP[0]), _randn(gen, n_t * BUNCH, FLAGSHIP[-1])
    small = (1e-3, 0.5, 0.0)
    coefs = rc._scal_coefs("parity", BUNCH, FLAGSHIP[-1], *small)
    kn = sum(a * b for a, b in zip(FLAGSHIP[:-1], FLAGSHIP[1:]))
    # three products a layer (forward, gradient, dedy), two for the first: it
    # hands no dedy down; W read by the forward, W and delta read and written
    # by the backward; the bunch's x and t read once
    flops = 2.0 * BUNCH * (3 * kn - FLAGSHIP[0] * FLAGSHIP[1])
    nbytes = 4.0 * (5 * kn + BUNCH * (FLAGSHIP[0] + FLAGSHIP[-1]))
    out = {}
    runs = {False: run, True: rc.make_resident_train_chunk(cfg, opt)}
    times = {False: [], True: []}
    for tc in (False, True, True, False):  # in turns
        st = init_train_state(mlp)
        times[tc].append(_time_ms(lambda: runs[tc](st, xt, tt, 3, *small), reps=3, warmup=1) / n_t)
    for tc, w in ((False, worst), (True, tc_worst)):
        st = init_train_state(mlp)
        plain_ms = _time_ms(lambda: rc.resident_train_chunk_reference(
            st, xt[:10 * BUNCH], tt[:10 * BUNCH], cfg, BUNCH, coefs, 3, bf16=tc), reps=2,
            warmup=1) / 10
        peak = PEAK_BF16_FLOPS if tc else PEAK_FP32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        ms = float(np.mean(times[tc]))
        print(f"[kernel] chunk trainer {n_t} bunches of {BUNCH}, dropout on, "
              f"{'tensor-core' if tc else 'float32'} products: {ms:.4f} ms per bunch "
              f"({' '.join(f'{v:.4f}' for v in times[tc])}; {flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"version {plain_ms:.4f} ms per bunch, bound {max(t_ops, t_bytes):.4f} ms "
              f"({flops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} TFLOP/s: {t_ops:.4f}; "
              f"{nbytes / 1e6:.0f} MB at 3.35 TB/s: {t_bytes:.4f})", flush=True)
        out[tc] = dict(ms=ms, ms_runs=times[tc], plain_ms=plain_ms, library_ms=None,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       max_abs_err=w["abs"], rel_fro_err=w["rel_fro"],
                       rel_fro_err_one_bunch=w["one"], shape=f"{BUNCH} x 1548-2048x3-129, per bunch")
    # digests of the state after an 800-bunch call, for holding two checkouts bit for bit
    digests = _chunk_digests(("8k_tc", "8k_f32"))
    for tc, name in ((True, "8k_tc"), (False, "8k_f32")):
        out[tc]["state_digest"] = digests[name]
        print(f"[kernel] chunk trainer state digest {name} (one call of 800 bunches, "
              f"CHUNK_DIGEST_FORMS): {digests[name]}", flush=True)
    return out



def chain_times(tag: str = "chain") -> dict:
    """The chunk trainer's chain of launches timed three ways: with tensor-core
    products at 8 kHz (1548-2048x3-129, parity dropout 0.1/0.2, 100 bunches a
    call) and at 16 kHz with sr_delta (3084-2048x3-257, 50 bunches), the two
    forms the command and the in-memory path run, and with float32 products
    (bf16=False) at 8 kHz (50 bunches: the two-launch forward's 12 launches a
    bunch must fit CUDA's launch queue for host_ms).  ms: CUDA events around whole calls,
    in turns with the other form (the trainer's time a bunch, as the kernels
    line gives it); device_ms: the same calls enqueued behind a spin kernel,
    so the host's share is hidden; host_ms: the host's own time a bunch to
    enqueue them, by the host clock, with the launch queue never full.  Uses
    the package's public entry points only, so that another checkout of it
    can be timed by this script (--chain-times --package-root DIR)."""
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    opt = OptConfig(lrate=1.0, momentum=0.5, weightcost=1e-5, bunchsize=BUNCH)
    small = (1e-3, 0.5, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(4242)
    forms = {}
    for name, sizes, n_t, kw in (("8k", FLAGSHIP, 100, {}),
                                 ("16k_sr_delta", WIDE, 50, dict(sr_delta=True)),
                                 ("8k_f32", FLAGSHIP, 50, dict(bf16=False))):
        cfg = ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
        mlp = init_params(torch.Generator().manual_seed(5), cfg, scheme="glorot", device="cuda")
        run = rc.make_resident_train_chunk(cfg, opt, **kw)
        xt, tt = _randn(gen, n_t * BUNCH, sizes[0]), _randn(gen, n_t * BUNCH, sizes[-1])
        forms[name] = (run, init_train_state(mlp), xt, tt, n_t)
    ms = {name: [] for name in forms}
    for name in list(forms) + list(reversed(forms)):  # in turns
        run, st, xt, tt, n_t = forms[name]
        ms[name].append(_time_ms(lambda: run(st, xt, tt, 3, *small), reps=3, warmup=1) / n_t)
    out = {}
    for name, (run, st, xt, tt, n_t) in forms.items():
        dev = _device_ms(lambda i: run(st, xt, tt, 3 + i, *small), reps=1, warmup=1) / n_t
        host = _host_ms(lambda: run(st, xt, tt, 7, *small)) / n_t
        out[name] = dict(ms=float(np.mean(ms[name])), ms_runs=ms[name], device_ms=dev,
                         host_ms=host, bunches=n_t)
        form = "float32 products" if name.endswith("f32") else "tensor cores"
        print(f"[{tag}] chunk trainer, {form}, {name}: {out[name]['ms']:.4f} ms a bunch "
              f"({' '.join(f'{v:.4f}' for v in ms[name])}; CUDA events around calls of {n_t} "
              f"bunches), device alone {dev:.4f} ms a bunch (the calls held behind a spin kernel), "
              f"the host's own cost {host:.4f} ms a bunch ({host / dev:.2f} of the device's)",
              flush=True)
    return out


def _state_digest(state) -> str:
    """SHA-256 of a trainer state's W, delta, b and delta_b, in that order, as
    float32 bytes (a bfloat16 tensor widens exactly)."""
    import hashlib

    torch.cuda.synchronize()
    h = hashlib.sha256()
    for group in (state.params.w, state.deltas.w, state.params.b, state.deltas.b):
        for a in group:
            h.update(a.detach().float().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _chunk_digests(names) -> dict:
    """{name: SHA-256 of the state} after ONE call of the chunk trainer in each
    form of CHUNK_DIGEST_FORMS named, on seeded inputs: glorot weights of seed
    5, parity dropout 0.1/0.2, bunches of 128 drawn from a card generator
    seeded per form, dropout seed 3.  Public entry points only, so that
    another checkout's package gives comparable digests (--mask-times
    --package-root)."""
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    opt = OptConfig(lrate=1e-3, momentum=0.5, weightcost=1e-5, bunchsize=BUNCH)
    out = {}
    for n, (name, sizes, n_b, kw) in enumerate(CHUNK_DIGEST_FORMS):
        if name not in names:
            continue
        cfg = ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
        st = init_train_state(init_params(torch.Generator().manual_seed(5), cfg, scheme="glorot",
                                          device="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(9100 + n)
        x, t = _randn(gen, n_b * BUNCH, sizes[0]), _randn(gen, n_b * BUNCH, sizes[-1])
        rc.make_resident_train_chunk(cfg, opt, **kw)(st, x, t, 3)
        _check(all(bool(torch.isfinite(a.float()).all()) for a in _state_tensors(st)),
               f"chunk digest {name}: the state is not finite")
        out[name] = _state_digest(st)
        del x, t, st
        torch.cuda.empty_cache()
    return out


def mask_times() -> dict:
    """The input mask's share of the chunk trainer, for comparing two checkouts
    in one call (--mask-times, with --package-root for the other).
    * layer 0 alone: fused_linear_act (with the hidden layer's out_mask) and
      fused_bwd_update at 128 x 1548 x 2048 and 128 x 3084 x 2048, tensor-core
      and float32 products, with no input mask, with the Philox input mask
      drawn in the kernel, and, where the package has the packed bit table
      (ops/philox.py:philox_mask_words), with the table's bits (its outputs
      held bit-equal to the Philox form's); each call on the next of three
      weight sets, by CUDA events (_device_ms);
    * the chains a bunch (CUDA events around whole calls, in turns): tensor
      cores at 8 kHz (100 bunches), float32 products at 8 kHz and tensor
      cores with sr_delta at 16 kHz (50 bunches), each with the input's
      dropout 0.1 and 0 (the hidden layers' 0.2 in both); layer 1 alone,
      which keeps its masks as they were;
    * the data-parallel trainer at one rank of 2's 64 rows: layer 0 alone
      (fused_linear_act and the gradient-out backward's first-layer form,
      1548 x 2048, both product forms) with no input mask, with the Philox
      mask at row 64 and with the rank's table; its whole forward
      (dp_tile_forward) with input dropout 0.1 and 0, the package's own way
      (a table where it takes one); one rank's trainer a bunch (the sum
      stubbed, 8 bunches a call);
    * kernel 5 and the plain trainer on its masks (_dropout_mask_times);
    * the state digests of every form of CHUNK_DIGEST_FORMS, of one call of
      the data-parallel trainer for each rank of 2 (the sum stubbed, 8
      bunches, parity dropout 0.1/0.2, both product forms), of the plain
      trainer on kernel 5's masks, and _fwd_digests."""
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.ops import philox
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import fused_bwd_update, fused_linear_act
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    has_bits = hasattr(philox, "philox_mask_words")
    gen = torch.Generator(device="cuda").manual_seed(1515)
    out = {"layer0": {}, "chains": {}, "has_bits": has_bits}
    for tag, net in (("8k", FLAGSHIP), ("16k", WIDE)):
        K, N = net[0], net[1]
        x, b = _randn(gen, BUNCH, K), _randn(gen, N, scale=0.1)
        ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
        deltas = [torch.zeros(K, N, device="cuda") for _ in range(3)]
        dedx, db = _randn(gen, BUNCH, N, scale=0.02), torch.zeros(N, device="cuda")
        masks = {"off": None, "philox": (4, 0.1)}
        if has_bits:
            masks["bits"] = philox.philox_mask_words(4, BUNCH, K, 0.1, device="cuda")
            for tc in (True, False):
                ys = [fused_linear_act(x, ws[0], b, "relu", in_mask=masks[k], out_mask=(5, 0.2),
                                       bf16=tc) for k in ("philox", "bits")]
                _check(torch.equal(ys[0], ys[1]), f"{tag} layer 0, bf16={tc}: the bit table's "
                                                  f"forward differs from the Philox one")
        for tc in (True, False):
            row = {}
            for name, m in masks.items():
                row[f"fwd_{name}"] = _device_ms(lambda i: fused_linear_act(
                    x, ws[i % 3], b, "relu", in_mask=m, out_mask=(5, 0.2), bf16=tc))
                row[f"bwd_{name}"] = _device_ms(lambda i: fused_bwd_update(
                    dedx, x, ws[i % 3], deltas[i % 3], b, db, 0.5, 1e-3, 1.0 / BUNCH, 0.0,
                    in_mask=m, bf16=tc))
            out["layer0"][f"{tag}_{'tc' if tc else 'f32'}"] = row
            print(f"[mask-times] layer 0 {BUNCH}x{K}x{N} {'tc' if tc else 'f32'}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + " ms", flush=True)
        del ws, deltas
        torch.cuda.empty_cache()
    # a layer without an input mask (layer 1: 2048 x 2048, the hidden mask in its epilogue),
    # which a change to layer 0's masking must leave as it was
    x, b = _randn(gen, BUNCH, 2048), _randn(gen, 2048, scale=0.1)
    ws = [_randn(gen, 2048, 2048, scale=0.03) for _ in range(3)]
    for tc in (True, False):
        out["layer0"][f"8k_{'tc' if tc else 'f32'}"]["fwd_layer1"] = _device_ms(
            lambda i: fused_linear_act(x, ws[i % 3], b, "relu", out_mask=(6, 0.2), bf16=tc))
    del ws
    if has_bits:  # the draw of an 800-tile call's tables
        out["draw_ms"] = {tag: _device_ms(lambda i: rc.input_mask_bits(9 + i, 800, BUNCH, K, 0.1))
                          for tag, K in (("8k", FLAGSHIP[0]), ("16k", WIDE[0]))}
    print(f"[mask-times] layer 1 {BUNCH}x2048x2048 forward: tc "
          f"{out['layer0']['8k_tc']['fwd_layer1']:.4f}, f32 "
          f"{out['layer0']['8k_f32']['fwd_layer1']:.4f} ms; the draw of an 800-tile call "
          f"{out.get('draw_ms')}", flush=True)
    out["dp2_layer0"], out["dp2_forward"], out["dp2"], out["dp_digests"] = {}, {}, {}, {}
    # one rank of 2's layer 0 (its 64 rows of 128): the forward (K split for the 64 rows, not
    # for the global tile as the trainer's) and the gradient-out backward's first-layer form
    from tpu_sednn_torch.ops.fused_mlp import fused_bwd_grad_out

    M, K, N = BUNCH // 2, FLAGSHIP[0], FLAGSHIP[1]
    x, b = _randn(gen, M, K), _randn(gen, N, scale=0.1)
    ws = [_randn(gen, K, N, scale=0.03) for _ in range(3)]
    dedx, grad = _randn(gen, M, N, scale=0.02), torch.empty(K * N + N, device="cuda")
    dp_masks = {"off": ({}, {}), "philox": ({"in_mask": (4, 0.1)},
                                            {"in_mask": (4, 0.1), "mask_row0": M}),
                "table": ({"in_mask": philox.philox_mask_words(4, M, K, 0.1, row0=M,
                                                               device="cuda")},) * 2}
    for tc in (True, False):
        row = {}
        for name, (fkw, bkw) in dp_masks.items():
            row[f"fwd_{name}"] = _device_ms(lambda i: fused_linear_act(
                x, ws[i % 3], b, "relu", out_mask=(5, 0.2), bf16=tc, **fkw))
            row[f"bwd_{name}"] = _device_ms(lambda i: fused_bwd_grad_out(
                dedx, x, ws[i % 3], with_dedy=False, grad=grad, bf16=tc, **bkw))
        out["dp2_layer0"]["tc" if tc else "f32"] = row
        print(f"[mask-times] data-parallel layer 0, a rank's {M}x{K}x{N} "
              f"{'tc' if tc else 'f32'}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + " ms", flush=True)
    del ws
    # one rank of 2's whole forward (dp_tile_forward, rank 1's rows at row0 64), input dropout
    # 0.1 (the package's own way of masking the input) and 0
    import ctypes

    dws = [[_randn(gen, a, c, scale=0.03) for a, c in zip(FLAGSHIP[:-1], FLAGSHIP[1:])]
           for _ in range(3)]
    dbs = [_randn(gen, c, scale=0.1) for c in FLAGSHIP[1:]]
    xt, tt = _randn(gen, M, FLAGSHIP[0]), _randn(gen, M, FLAGSHIP[-1])
    tallies = (ctypes.c_longlong * len(rc.kernel_launches))()
    for tc in (True, False):
        for vis in (0.1, 0.0):
            fcfg = ModelConfig(layersizes=FLAGSHIP, dropout_vis=vis, dropout_hid=0.2)
            fwd = rc.dp_tile_forward(fcfg, M, BUNCH, tc, torch.device("cuda"))
            bits = _dp_input_table(rc, 9, M, FLAGSHIP[0], vis, M) if vis > 0.0 else ()
            out["dp2_forward"][f"{'tc' if tc else 'f32'}_vis{vis}"] = _device_ms(
                lambda i: fwd(xt, tt, dws[i % 3], dbs, 9, M, 2.0 / BUNCH, tallies, *bits))
    print(f"[mask-times] data-parallel forward, a rank's {M} rows of {BUNCH}, "
          f"1548-2048x3-129: " + ", ".join(f"{k} {v:.4f}" for k, v in out["dp2_forward"].items())
          + " ms", flush=True)
    del dws
    # one rank of 2's data-parallel trainer (the sum stubbed): the state after one call of 8
    # bunches (ranks 0 and 1) and a bunch's time (rank 0)
    from tpu_sednn_torch.parallel import Mesh

    dcfg, dopt, dmlp, dx, dt = _dp_inputs()
    dx, dt = dx.repeat(3, 1)[:8 * BUNCH].contiguous(), dt.repeat(3, 1)[:8 * BUNCH].contiguous()
    plain_sum, rc._all_reduce = rc._all_reduce, lambda a, mesh: a
    try:
        for tc in (True, False):
            form = "tc" if tc else "f32"
            for rank in (1, 0):  # rank 0's run is timed below
                run = rc.make_dp_resident_train_chunk(
                    dcfg, dopt, Mesh(2, rank, torch.device("cuda", 0)), bf16=tc)
                st = init_train_state(dmlp)
                run(st, dx, dt, 3, 1e-3, 0.5, 0.0)
                out["dp_digests"][f"dp2_rank{rank}_{form}"] = _state_digest(st)
            st = init_train_state(dmlp)
            out["dp2"][form] = _device_ms(
                lambda i: run(st, dx, dt, 4 + i, 1e-3, 0.5, 0.0), reps=3) / 8
    finally:
        rc._all_reduce = plain_sum
    print(f"[mask-times] one rank of 2's data-parallel trainer a bunch (the sum stubbed): tc "
          f"{out['dp2']['tc']:.4f}, f32 {out['dp2']['f32']:.4f} ms", flush=True)
    opt = OptConfig(lrate=1.0, momentum=0.5, weightcost=1e-5, bunchsize=BUNCH)
    small = (1e-3, 0.5, 0.0)
    forms = {}
    for name, sizes, n_t, kw in (("8k_tc", FLAGSHIP, 100, {}),
                                 ("8k_f32", FLAGSHIP, 50, dict(bf16=False)),
                                 ("16k_tc_sr_delta", WIDE, 50, dict(sr_delta=True))):
        xt, tt = _randn(gen, n_t * BUNCH, sizes[0]), _randn(gen, n_t * BUNCH, sizes[-1])
        for vis in (0.1, 0.0):
            cfg = ModelConfig(layersizes=sizes, dropout_vis=vis, dropout_hid=0.2)
            mlp = init_params(torch.Generator().manual_seed(5), cfg, scheme="glorot",
                              device="cuda")
            forms[f"{name}_vis{vis}"] = (rc.make_resident_train_chunk(cfg, opt, **kw),
                                         init_train_state(mlp), xt, tt, n_t)
    ms = {name: [] for name in forms}
    for name in list(forms) + list(reversed(forms)):  # in turns
        run, st, xt, tt, n_t = forms[name]
        ms[name].append(_time_ms(lambda: run(st, xt, tt, 3, *small), reps=3, warmup=1) / n_t)
    for name in forms:
        out["chains"][name] = dict(ms=float(np.mean(ms[name])), ms_runs=ms[name])
        print(f"[mask-times] chain {name}: {out['chains'][name]['ms']:.4f} ms a bunch "
              f"({' '.join(f'{v:.4f}' for v in ms[name])})", flush=True)
    del forms
    torch.cuda.empty_cache()
    out.update(_dropout_mask_times())
    out["chunk_digests"] = _chunk_digests([f[0] for f in CHUNK_DIGEST_FORMS])
    out["fwd_digests"] = _fwd_digests()
    for group in ("chunk_digests", "dp_digests", "fwd_digests", "xla_digests"):
        for k, v in out[group].items():
            print(f"[mask-times] digest {k}: {v}", flush=True)
    return out


XLA_CHUNK_BUNCHES = 64  # a chunk of the in-memory path's 8192-sample traincache
XLA_RUNS = 5  # timed calls: the host-driven trainer's time a call spreads by 10-40%


def _dropout_mask_times() -> dict:
    """Kernel 5 for comparing two checkouts (mask_times): a 16 kHz bunch's four
    masks as four single launches (dropout_mask, either package) and, where
    the package draws batches (dropout_masks), in one launch, and a group of
    MASK_GROUP bunches' masks in one; the plain trainer on its masks
    (engine="xla", dropout_rng="tpu_prng") through one chunk of
    XLA_CHUNK_BUNCHES bunches at 3084-2048x3-257: ms a bunch and samples/s
    (CUDA events around whole calls, the host's share in them: the trainer is
    host-driven), its launches, and the SHA-256 digest of its state after the
    first call."""
    import importlib

    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.ops import launch_counts
    from tpu_sednn_torch.train.loop import make_chunk_runner
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    dm = importlib.import_module("tpu_sednn_torch.ops.dropout_mask")
    shapes, omits = [(BUNCH, w) for w in WIDE[:-1]], [0.1, 0.2, 0.2, 0.2]
    times = dict(four_launches=_device_ms(lambda i: [dm.dropout_mask(4 * i + l, sh, o) for l, (sh, o)
                                                     in enumerate(zip(shapes, omits))], reps=50))
    if hasattr(dm, "dropout_masks"):
        times["one_launch"] = _device_ms(lambda i: dm.dropout_masks(
            [4 * i + l for l in range(4)], shapes, omits), reps=50)
        times["group_one_launch"] = _device_ms(lambda i: dm.dropout_masks(*_group_batch(i)),
                                               reps=20)
    print("[mask-times] kernel 5, a 16 kHz bunch's four masks: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + " ms", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(1717)
    cfg = ModelConfig(layersizes=WIDE, dropout_vis=0.1, dropout_hid=0.2, dropout_mode="parity",
                      dropout_rng="tpu_prng")
    mlp = init_params(torch.Generator().manual_seed(16), cfg, scheme="uniform",
                      w_range=(-0.03, 0.03), device="cuda")
    n = XLA_CHUNK_BUNCHES * BUNCH
    x, t = _randn(gen, n, WIDE[0]), _randn(gen, n, WIDE[-1], scale=0.5)
    run = make_chunk_runner(cfg, OptConfig(lrate=0.1, momentum=0.5, bunchsize=BUNCH),
                            engine="xla", device="cuda")
    st = init_train_state(mlp)
    before = launch_counts()["dropout_mask"]
    run(st, x, t, torch.Generator().manual_seed(7), 0.1, 0.5, 0.0)
    torch.cuda.synchronize()
    launches = launch_counts()["dropout_mask"] - before
    _check(all(bool(torch.isfinite(a).all()) for a in _state_tensors(st)),
           "the plain trainer's state is not finite after a chunk")
    digest = _state_digest(st)
    runs = [_time_ms(lambda: run(st, x, t, torch.Generator().manual_seed(8), 0.1, 0.5, 0.0),
                     reps=1, warmup=0) / XLA_CHUNK_BUNCHES for _ in range(XLA_RUNS)]
    ms = float(np.median(runs))
    print(f"[mask-times] engine=xla, dropout_rng=tpu_prng, a chunk of {XLA_CHUNK_BUNCHES} bunches at "
          f"3084-2048x3-257: {ms:.4f} ms a bunch ({' '.join(f'{v:.4f}' for v in runs)}), "
          f"{BUNCH / ms * 1e3:.0f} samples/s, {launches} dropout_mask launches", flush=True)
    return dict(dropout_mask=times, xla_tpu_prng=dict(ms=ms, ms_runs=runs, launches=launches,
                                                      samples_per_s=BUNCH / ms * 1e3),
                xla_digests={"xla_tpu_prng_16k": digest})


# ---------------------------------------------------------------------------
# stochastic rounding, kernels 5 and 6, bfloat16 storage in kernels
# 1 and 2, the chunk trainer's variants at the 16 kHz width, and the
# in-memory training path
# ---------------------------------------------------------------------------

WIDE = (3084, 2048, 2048, 2048, 257)  # the 16 kHz net
# The chunk-trainer forms whose state digests two checkouts must share
# (_chunk_digests): (name, net, bunches in the call, make_resident_train_chunk's
# keywords)
CHUNK_DIGEST_FORMS = (("8k_tc", FLAGSHIP, 800, {}), ("8k_f32", FLAGSHIP, 800, dict(bf16=False)),
                      ("16k_sr_delta", WIDE, 100, dict(sr_delta=True)),
                      ("16k_sr_state", WIDE, 100, dict(sr_state=True)),
                      ("16k_hbm_spill", WIDE, 100, dict(bf16=False, hbm_spill=1)),
                      ("16k_tile_rows_64", WIDE, 100, dict(rule="clean", tile_rows=64)))
# A kernel that stores bfloat16 with stochastic rounding, against the float64
# plain version rounded with the same bits: the two float32 values that are
# rounded differ by float32 summation order (~1e-7 relative), so the rounding
# decision differs for about that share over a bfloat16 ulp (2^-8 relative) of
# the elements, and such an element is then off by one bfloat16 ulp.  Held: no
# element further than one ulp beyond the float32 kernels' own tolerance
# (|a - b| <= 2^-7 max(|a|, |b|) + KERNEL_REL_MAX max|want|: where m*delta and
# A*G cancel, the float32 value itself is off by more than the small result's
# ulp), and at most SR_DIFF_SHARE of the elements different at all.
SR_DIFF_SHARE = 2e-3


def _bits16(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16)


def _hold_sr(got: torch.Tensor, want: torch.Tensor, label: str, stats: dict) -> None:
    """bfloat16 `got` against bfloat16 `want` rounded with the same bits."""
    _check(got.dtype == torch.bfloat16 and want.dtype == torch.bfloat16 and got.shape == want.shape,
           f"{label}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    _check(bool(torch.isfinite(g).all()), f"{label}: non-finite values")
    differ = _bits16(got) != _bits16(want)
    share = float(differ.float().mean())
    far = (g - w).abs() > 2.0 ** -7 * torch.maximum(g.abs(), w.abs()) + KERNEL_REL_MAX * w.abs().max()
    _check(not bool(far.any()), f"{label}: {int(far.sum())} elements further than one bfloat16 ulp "
                                f"beyond the float32 tolerance")
    _check(share <= SR_DIFF_SHARE, f"{label}: {share:.3g} of the elements differ (limit "
                                   f"{SR_DIFF_SHARE})")
    stats["share"] = max(stats.get("share", 0.0), share)
    stats["n_diff"] = stats.get("n_diff", 0) + int(differ.sum())
    stats["n"] = stats.get("n", 0) + differ.numel()
    stats["abs"] = max(stats.get("abs", 0.0), float((g - w).abs().max()))


def phase_sr(gen) -> dict:
    """The rounding function, kernel 6 and kernel 5 against their plain versions."""
    from tpu_sednn_torch.ops.dropout_mask import dropout_mask, dropout_mask_reference
    from tpu_sednn_torch.ops.philox import (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT, sr_bits,
                                            sr_to_bf16_reference)
    from tpu_sednn_torch.ops.sr_update import (sr_momentum_update, sr_momentum_update_reference,
                                               sr_round_on_device)

    # (i) the rounding function
    exact = torch.tensor([0.0, -0.0, 1.0, -1.0, 1.5, -2.0, 0.0078125, 3.3895313892515355e38,
                          1e-40, -1e-40, float("inf"), -float("inf"), float("nan")], device="cuda")
    exact = sr_to_bf16_reference(exact, torch.zeros_like(exact, dtype=torch.int64)).float()
    one_ulp = torch.nextafter(exact[:8], torch.full_like(exact[:8], float("inf")))
    one_ulp = torch.cat([one_ulp, torch.nextafter(exact[:8], torch.full_like(exact[:8], -float("inf")))])
    special = torch.tensor([1e-40, -1e-40, 2.0 ** -126, 3.4e38, -3.4e38], device="cuda")
    vals = torch.cat([exact, one_ulp, special, _randn(gen, 4062).flatten() * 3.0,
                      _randn(gen, 4096).flatten() * 1e-6]).reshape(-1, 64).contiguous()
    n_exact = exact.numel()
    for name, bits in (("zero bits", torch.zeros_like(vals, dtype=torch.int64)),
                       ("all-ones bits", torch.full_like(vals, 0xFFFF, dtype=torch.int64)),
                       ("random bits", torch.randint(0, 2 ** 16, vals.shape, generator=gen,
                                                     device="cuda"))):
        got, want = sr_round_on_device(vals, bits), sr_to_bf16_reference(vals, bits)
        _check(torch.equal(_bits16(got), _bits16(want)), f"sr_bf16 with {name} differs from the plain "
                                                         f"version")
        # representable values come back unchanged whatever the bits (NaN stays NaN)
        back = got.flatten()[:n_exact].float()
        _check(torch.equal(back[:-1], exact[:-1]) and bool(torch.isnan(back[-1])),
               f"sr_bf16 with {name} moved a value bfloat16 holds exactly")
    for shift in (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT):
        got = sr_round_on_device(vals, key=99, shift=shift)
        want = sr_to_bf16_reference(vals, sr_bits(99, vals.shape[0], vals.shape[1], shift, "cuda"))
        _check(torch.equal(_bits16(got), _bits16(want)), f"sr_bf16 on the stream (shift {shift}) "
                                                         f"differs from the plain version")
    # unbiased: a constant 0.3 of an ulp above 1.0, 8192 draws.  One draw has
    # sd ulp * sqrt(0.3 * 0.7); nearest rounding would be 0.3 ulp off, 59 sigma
    ulp, p, n_draw = 2.0 ** -7, 0.3, 8192
    const = torch.full((64, 128), 1.0 + p * ulp, device="cuda")
    worst_sigma = 0.0
    for shift in (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT):
        mean = float(sr_round_on_device(const, key=7, shift=shift).double().mean())
        sigma = ulp * np.sqrt(p * (1 - p) / n_draw)
        dev = abs(mean - float(const[0, 0].double())) / sigma
        _check(dev <= 4.0, f"SR mean of {n_draw} draws off by {dev:.2f} sigma (shift {shift})")
        worst_sigma = max(worst_sigma, dev)
    print(f"[kernel] sr_bf16: {vals.numel()} values (zeros, denormals, +-Inf, NaN, exact bfloat16 "
          f"values and their float32 neighbours, normals at two scales) x zero / all-ones / random "
          f"/ stream bits bit-equal to the plain version; exact values unchanged; mean of "
          f"{n_draw} draws of 1 + 0.3 ulp within {worst_sigma:.2f} sigma (nearest rounding: "
          f"{p / np.sqrt(p * (1 - p) / n_draw):.0f} sigma)", flush=True)

    # (ii) kernel 6
    hyp = dict(momentum=0.9, lrate=0.02, weightcost=1e-4)
    k6 = dict(n_diff=0, n=0, by_shape={})
    for shape in ((3084, 2048), (2048, 2048), (2048, 257), (257,), (1300, 129)):
        w = (_randn(gen, *shape) * 0.05).to(torch.bfloat16)
        d = (_randn(gen, *shape) * 1e-4).to(torch.bfloat16)
        for g_dtype in (torch.float32, torch.bfloat16):
            g = (_randn(gen, *shape) * 0.01).to(g_dtype)
            w2, d2 = sr_momentum_update(w, d, g, 1234, **hyp)
            w_ref, d_ref = sr_momentum_update_reference(w, d, g, 1234, **hyp)
            n_diff = int((_bits16(w2) != _bits16(w_ref)).sum() + (_bits16(d2) != _bits16(d_ref)).sum())
            _check(n_diff == 0, f"sr_momentum_update {shape} g {g_dtype}: {n_diff} elements differ "
                                f"from the plain version")
            _check(w2.dtype == d2.dtype == torch.bfloat16 and w2.shape == w.shape, "kernel 6 outputs")
            k6["n"] += 2 * w.numel()
            k6["abs"] = max(k6.get("abs", 0.0), float((w2.float() - w_ref.float()).abs().max()))
        # rows 512.. of a tall matrix draw from stream seed + 7919, rows 0..
        if len(shape) == 2 and shape[0] > 512:
            w3, d3 = sr_momentum_update(w[512:1024].contiguous(), d[512:1024].contiguous(),
                                        g[512:1024].contiguous(), 1234 + 7919, **hyp)
            _check(torch.equal(_bits16(w3), _bits16(w2[512:1024])) and
                   torch.equal(_bits16(d3), _bits16(d2[512:1024])),
                   f"sr_momentum_update {shape}: the second row block is not stream seed + 7919")
    _check(not torch.equal(_bits16(sr_momentum_update(w, d, g, 1, **hyp)[1]),
                           _bits16(sr_momentum_update(w, d, g, 2, **hyp)[1])),
           "sr_momentum_update: two seeds gave the same rounding")
    # sr_train_step hands the kernel bfloat16 gradients (the parameters' type): 10 bytes an
    # element; a float32 gradient (12 bytes) is timed beside it
    ms = plain = ms32 = n_el = 0.0
    for l in range(4):
        shape = (WIDE[l], WIDE[l + 1])
        w = (_randn(gen, *shape) * 0.05).to(torch.bfloat16)
        d = (_randn(gen, *shape) * 1e-4).to(torch.bfloat16)
        g32 = _randn(gen, *shape) * 0.01
        g = g32.to(torch.bfloat16)
        t_k = _device_ms(lambda i: sr_momentum_update(w, d, g, i, **hyp))
        t_32 = _device_ms(lambda i: sr_momentum_update(w, d, g32, i, **hyp))
        t_p = _device_ms(lambda i: sr_momentum_update_reference(w, d, g, i, **hyp), reps=1)
        k6["by_shape"][f"{shape[0]}x{shape[1]}"] = dict(ms=t_k, plain_ms=t_p, ms_float32_gradient=t_32)
        ms, plain, ms32, n_el = ms + t_k, plain + t_p, ms32 + t_32, n_el + w.numel()
    k6.update(ms=ms, plain_ms=plain, library_ms=None, bound_ms=10.0 * n_el / PEAK_BYTES_PER_S * 1e3,
              bound_by="bytes", max_abs_err=k6.pop("abs"),
              float32_gradient=dict(ms=ms32, bound_ms=12.0 * n_el / PEAK_BYTES_PER_S * 1e3),
              shape="the four weight matrices of 3084-2048x3-257, bfloat16 gradient")
    print(f"[kernel] sr_momentum_update: 5 shapes x float32 / bfloat16 gradient, {k6['n']} elements, "
          f"{k6['n_diff']} differ from the plain version (bit-equal); row block 512.. is stream "
          f"seed + 7919; the 16 kHz net's four matrices with the bfloat16 gradient of "
          f"sr_train_step {ms:.4f} ms (plain {plain:.2f} ms with the host's share, no library "
          f"call computes it), bound {k6['bound_ms']:.4f} ms ({10.0 * n_el / 1e6:.0f} MB: W, delta, "
          f"g read, W, delta written, 2 bytes each); with a float32 gradient {ms32:.4f} ms, "
          f"bound {k6['float32_gradient']['bound_ms']:.4f} ms ({12.0 * n_el / 1e6:.0f} MB)",
          flush=True)

    # (iii) kernel 5
    k5 = dict(by_shape={})
    worst = k5_abs = 0.0
    for shape in ((128, 3084), (100, 1548), (1024, 2048), (1300, 257)):
        for omit in (0.1, 0.2, 0.5):
            m = dropout_mask(77, shape, omit)
            ref = dropout_mask_reference(77, shape, omit, device="cuda")
            _check(m.shape == shape and m.dtype == torch.float32 and torch.equal(m, ref),
                   f"dropout_mask {shape} omit {omit} differs from the plain version")
            k5_abs = max(k5_abs, float((m - ref).abs().max()))
            zr = 1.0 - float(m.mean())
            tol = 4.0 * np.sqrt(omit * (1 - omit) / m.numel())
            _check(abs(zr - omit) <= tol, f"dropout_mask {shape}: zero rate {zr} vs {omit}")
            worst = max(worst, abs(zr - omit) / tol)
    tall = dropout_mask(77, (1300, 257), 0.2)
    _check(torch.equal(tall[512:1024], dropout_mask(78, (512, 257), 0.2))
           and torch.equal(tall[1024:], dropout_mask(79, (276, 257), 0.2)),
           "dropout_mask: rows 512.. under seed s are not rows 0.. under s + 1")
    _check(torch.equal(dropout_mask(-5, (64, 100), 0.2), dropout_mask(2 ** 32 - 5, (64, 100), 0.2))
           and not torch.equal(dropout_mask(1, (64, 100), 0.2), dropout_mask(2, (64, 100), 0.2)),
           "dropout_mask: seeds")
    ms = plain = lib = nbytes = 0.0
    for shape, omit, times in (((BUNCH, WIDE[0]), 0.1, 1), ((BUNCH, 2048), 0.2, 3)):
        t_k = _device_ms(lambda i: dropout_mask(i, shape, omit), reps=50)
        t_p = _device_ms(lambda i: dropout_mask_reference(i, shape, omit, device="cuda"), reps=1)
        t_l = _device_ms(lambda i: (torch.rand(shape, device="cuda") >= omit).float(), reps=50)
        k5["by_shape"][f"{shape[0]}x{shape[1]}"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l)
        ms, plain, lib = ms + times * t_k, plain + times * t_p, lib + times * t_l
        nbytes += times * 4.0 * shape[0] * shape[1]
    k5["four_launches"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3)
    print(f"[kernel] dropout_mask: 4 shapes x omit 0.1 / 0.2 / 0.5 bit-equal to the plain version, "
          f"zero rate within {worst:.2f} of 4 sigma; rows 512.. under seed s = rows 0.. under "
          f"s + 1; one bunch's four masks as four launches {ms:.4f} ms (plain {plain:.2f} ms with "
          f"the host's share, torch.rand >= omit {lib:.4f} ms), bound "
          f"{k5['four_launches']['bound_ms']:.5f} ms (bytes written)", flush=True)
    k5.update(_phase_mask_batches(k5_abs))

    # (iv) kernels 1 and 2 on bfloat16 storage, the four 16 kHz layer shapes
    from tpu_sednn_torch.ops.fused_mlp import (fused_bwd_update, fused_bwd_update_reference,
                                               fused_linear_act, fused_linear_act_reference)

    f64, worst_f32, sr_stats = torch.float64, {}, {}
    for l in range(4):
        B, K, N = BUNCH, WIDE[l], WIDE[l + 1]
        x, b = _randn(gen, B, K), _randn(gen, N, scale=0.1)
        w16 = _randn(gen, K, N, scale=0.03).to(torch.bfloat16)
        act = "relu" if l < 3 else "linear"
        _hold(fused_linear_act(x, w16, b, act, bf16=False),
              fused_linear_act_reference(x, w16, b, act, dtype=f64, bf16=False),
              f"fused_linear_act {B}x{K}x{N} on bfloat16 W", worst_f32)
        dedx = _randn(gen, B, N, scale=0.02)
        y_prev = torch.relu(_randn(gen, B, K))
        db = _randn(gen, N, scale=0.003)
        hyp2 = dict(momentum=0.54, lrate=1.0, inv_n=1.0 / B, weightcost=1e-4, sr_seed=4242 + l,
                    bf16=False)
        for mode, w0 in (("bfloat16 delta", w16.float()), ("bfloat16 W and delta", w16)):
            d0 = _randn(gen, K, N, scale=0.003).to(torch.bfloat16)
            want = fused_bwd_update_reference(dedx, y_prev, w0, d0, b, db, dtype=f64, **hyp2)
            w2, d2, b2, db2 = w0.clone(), d0.clone(), b.clone(), db.clone()
            got = fused_bwd_update(dedx, y_prev, w2, d2, b2, db2, **hyp2)
            label = f"fused_bwd_update {B}x{K}x{N} on {mode}"
            _check(got[0] is w2 and got[1] is d2 and d2.dtype == torch.bfloat16
                   and w2.dtype == w0.dtype, f"{label}: not in place in its storage types")
            _hold_sr(got[1], want[1], f"{label}, delta", sr_stats)
            if w0.dtype == torch.bfloat16:
                _hold_sr(got[0], want[0], f"{label}, W", sr_stats)
            else:
                _hold(got[0], want[0], f"{label}, W", worst_f32)
            for name, i in (("dedy", 2), ("b", 3), ("delta_b", 4)):
                _hold(got[i], want[i], f"{label}, {name}", worst_f32)
    torch.cuda.synchronize()
    print(f"[kernel] kernels 1 and 2 on bfloat16 storage, the four layers of 3084-2048x3-257 "
          f"(N = 257: 2-byte aligned rows, scalar accesses): float32 outputs within "
          f"{worst_f32['rel_max']:.3g} of max|want| / {worst_f32['rel_fro']:.3g} Frobenius of the "
          f"float64 plain version; bfloat16 outputs: {sr_stats['n_diff']} of {sr_stats['n']} "
          f"elements differ from the plain version rounded with the same bits, none by more than "
          f"one bfloat16 ulp, worst share {sr_stats['share']:.3g} (limit {SR_DIFF_SHARE})",
          flush=True)
    return dict(k5=k5, k6=k6, bf16_storage=dict(share=sr_stats["share"], n_diff=sr_stats["n_diff"],
                                                n=sr_stats["n"], **worst_f32))


def _masks_bound(shapes) -> tuple:
    """(bound ms, "bytes" or "operations") of drawing float32 masks of these
    shapes: each written once, against their Philox calls (ceil(D / 4) a
    row) on the integer multipliers."""
    t_bytes = sum(4.0 * B * D for B, D in shapes) / PEAK_BYTES_PER_S * 1e3
    t_ops = PHILOX_IMADS * sum(B * ((D + 3) // 4) for B, D in shapes) / PEAK_IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def _group_batch(i: int = 0) -> tuple:
    """(seeds, shapes, omits) of MASK_GROUP bunches' masks of 3084-2048x3-257,
    parity dropout 0.1 / 0.2: what the in-memory path's plain trainer draws
    in one launch; seeds from 1000 + 64 i."""
    from tpu_sednn_torch.train.step import MASK_GROUP

    n = 4 * MASK_GROUP
    return ([1000 + 64 * i + j for j in range(n)], [(BUNCH, WIDE[j % 4]) for j in range(n)],
            [0.1 if j % 4 == 0 else 0.2 for j in range(n)])


def _phase_mask_batches(k5_abs: float) -> dict:
    """Kernel 5's batches (dropout_masks): bit-equal to the plain version for a
    batch of mixed shapes, row0 > 0, omit 0 and 1 and rows past 512; a group
    of MASK_GROUP 16 kHz bunches' masks in one launch equal to as many single
    draws; a batch of more than MAX_MASKS masks split into launches of at
    most MAX_MASKS; the times of one bunch's four masks and of a group in one
    launch beside their bounds."""
    from tpu_sednn_torch.ops.dropout_mask import (MAX_MASKS, dropout_mask, dropout_masks,
                                                  dropout_masks_reference)
    from tpu_sednn_torch.train.step import MASK_GROUP

    def batch_held(batch, label):
        seeds, shapes, omits, row0s = (list(c) for c in zip(*batch))
        n0 = dropout_mask.launches
        got = dropout_masks(seeds, shapes, omits, row0s)
        launches = dropout_mask.launches - n0
        want = dropout_masks_reference(seeds, shapes, omits, row0s, device="cuda")
        for g, w, (seed, shape, omit, row0) in zip(got, want, batch):
            _check(g.shape == shape and g.dtype == torch.float32 and torch.equal(g, w),
                   f"dropout_masks ({label}): mask {shape} at row0 {row0}, omit {omit}, differs "
                   f"from the plain version")
        return got, launches

    # mixed: the four shapes at row0 0 and > 0, omit 0 and 1, rows past 512, D % 4 != 0
    mixed = [(77, (128, 3084), 0.1, 0), (78, (100, 1548), 0.2, 300), (79, (1024, 2048), 0.5, 0),
             (80, (1300, 257), 0.2, 700), (81, (64, 2048), 0.0, 64), (82, (64, 3084), 1.0, 1000),
             (2 ** 32 - 1, (600, 37), 0.3, 511), (-7, (3, 5), 0.2, 509)]
    got, launches = batch_held(mixed, "mixed")
    _check(launches == 1 and bool(got[4].all()) and not got[5].any(),
           f"dropout_masks (mixed): {launches} launches; omit 0 / 1 not all kept / dropped")
    for g, (seed, shape, omit, row0) in zip(got, mixed):
        if row0:
            _check(torch.equal(g, dropout_mask(seed, (row0 + shape[0], shape[1]), omit)[row0:]),
                   f"dropout_masks: rows {row0}.. of a {shape} mask are not the full mask's rows")
    # a group of bunches: one launch, equal to the single draws the trainer made before
    seeds, shapes, omits = _group_batch()
    n0 = dropout_mask.launches
    group = dropout_masks(seeds, shapes, omits)
    _check(dropout_mask.launches == n0 + 1, "a group of bunches' masks took more than one launch")
    for g, seed, shape, omit in zip(group, seeds, shapes, omits):
        _check(torch.equal(g, dropout_mask(seed, shape, omit)),
               f"dropout_masks: a group's mask {shape} differs from its single draw")
    # batches of 1.6 and 5.6 million Philox calls, below and above eight full waves, so that
    # a thread makes two and eight of them on an H100, at widths not a multiple of 4 and of
    # fewer than 256 calls a row
    for k, widths in ((3, (1031,)), (8, (1031, 37, 257, 3084))):
        batch_held([(900 + i, (2000 + 500 * (k // 8) + 7 * i, widths[i % len(widths)]),
                     0.1 * (i % 5), 513 * i) for i in range(k)], f"{k} large masks")
    # more masks than a launch takes
    n_big = 2 * MAX_MASKS + 22
    big = [(5000 + i, (1 + (37 * i) % 700, 1 + (53 * i) % 300), (i % 11) / 10.0, (97 * i) % 900)
           for i in range(n_big)]
    _, launches = batch_held(big, f"{n_big} masks")
    _check(launches == -(-n_big // MAX_MASKS),
           f"dropout_masks: {n_big} masks took {launches} launches, not {-(-n_big // MAX_MASKS)}")
    print(f"[kernel] dropout_masks: a batch of {len(mixed)} (the four shapes, row0 up to 1000, "
          f"omit 0 and 1, rows past 512) bit-equal to the plain version in one launch, its row0 "
          f"masks the rows of the full masks; batches of 1.6 and 5.6 million Philox calls at "
          f"ragged widths bit-equal; {len(group)} masks of {MASK_GROUP} 16 kHz bunches in "
          f"one launch equal to {len(group)} single draws; {n_big} masks in {launches} launches "
          f"(at most {MAX_MASKS} a launch) bit-equal", flush=True)

    # times: a 16 kHz bunch's four masks and a group of bunches, one launch each
    b_seeds, b_shapes, b_omits = seeds[:4], shapes[:4], omits[:4]
    out = {}
    for name, (sh, fn, plain_fn, reps) in {
            "one_bunch": (b_shapes, lambda i: dropout_masks([s + 64 * i for s in b_seeds], b_shapes,
                                                            b_omits),
                          lambda i: dropout_masks_reference(b_seeds, b_shapes, b_omits,
                                                            device="cuda"), 50),
            "group": (shapes, lambda i: dropout_masks(*_group_batch(i)),
                      lambda i: dropout_masks_reference(*_group_batch(i), device="cuda"), 20)}.items():
        elems = sum(B * D for B, D in sh)
        bound, by = _masks_bound(sh)
        out[name] = dict(ms=_device_ms(fn, reps=reps), plain_ms=_device_ms(plain_fn, reps=1),
                         library_ms=_device_ms(lambda i: (torch.rand(elems, device="cuda")
                                                          >= 0.2).float(), reps=reps),
                         bound_ms=bound, bound_by=by, masks=len(sh), mbytes=4.0 * elems / 1e6)
    one, grp = out["one_bunch"], out["group"]
    print(f"[kernel] dropout_masks one launch: a 16 kHz bunch's 4 masks ({one['mbytes']:.2f} MB) "
          f"{one['ms']:.4f} ms, bound {one['bound_ms']:.5f} ms ({one['bound_by']}); "
          f"{MASK_GROUP} bunches' {grp['masks']} masks ({grp['mbytes']:.1f} MB) {grp['ms']:.4f} ms "
          f"= {grp['ms'] / MASK_GROUP:.5f} a bunch, bound {grp['bound_ms']:.5f} ms "
          f"({grp['bound_by']}, {grp['bound_ms'] / grp['ms']:.0%} reached); plain {one['plain_ms']:.2f}"
          f" / {grp['plain_ms']:.2f} ms with the host's share; torch.rand >= omit over the same "
          f"elements {one['library_ms']:.4f} / {grp['library_ms']:.4f} ms", flush=True)
    return dict(ms=grp["ms"], plain_ms=grp["plain_ms"], library_ms=grp["library_ms"],
                bound_ms=grp["bound_ms"], bound_by=grp["bound_by"], max_abs_err=k5_abs,
                ms_per_bunch=grp["ms"] / MASK_GROUP, one_bunch=one,
                shape=f"{MASK_GROUP} bunches' masks of 3084-2048x3-257 in one launch "
                      f"(128x3084 and 3 of 128x2048 a bunch), what the in-memory path's plain "
                      f"trainer draws at once")


# Chunk trainer variants at 3084-2048x3-257 against the float64 plain version
# with the same Philox bits, per tensor, relative Frobenius error of the
# update after 3 bunches.
#
# ReLU flips decide how this is held.  A hidden pre-activation within float32
# rounding of 0 is > 0 in one summation order and not in another; at this
# width (128 x 6144 hidden units a bunch) about one draw of inputs in four has
# such a unit in 3 bunches, and at lrate 1.0 the flipped dedy element changes
# W, hence every later bunch: the update is then 1e-4 to 5e-2 off, where a
# draw without a flip reads 2e-6.  The float32 plain version (plain torch)
# flips against float64 in the same way.  So each comparison draws seeded
# inputs up to WIDE_DRAWS times and must hold its limits on the first draw
# that the float32 plain version itself holds against float64 with the same
# limits: a draw is passed over only when the plain version fails them too
# (its errors are printed beside the kernel's), and a kernel that misses the
# limits where the plain version holds them fails the run.  The limits are
# those of a draw without a flip, far below a flip's effect (and below the
# deliberate faults'):
# * float32 storage (and row tiles): WIDE_REL_FRO on every tensor.
# * sr_delta: W, b and delta_b are float32 and W takes the unrounded step;
#   the stored bfloat16 delta differs where the two float32 values straddle a
#   rounding boundary (a share ~1e-4 of the elements, one ulp = 2^-8 relative
#   each), and the next bunch's W inherits m times that: SR_DELTA_W_FRO,
#   SR_DELTA_FRO.  After ONE bunch W, b and delta_b are the float32 trainer's
#   (CHUNK_ONE_REL_FRO) and delta is held to SR_DELTA_ONE_FRO.
# * sr_state: W itself is bfloat16.  Its 3-bunch update W - W0 is made of a
#   few whole ulps of W (4e-3 |W|) on some elements, far larger than the
#   float32 step, so one differing decision weighs much more against the
#   update's norm, and the other tensors see that W in bunches 2 and 3:
#   SR_STATE_W_FRO, SR_STATE_FRO (read 1.1e-2 and 5.6e-3 without a flip).
#   After ONE bunch the forward has read the same bfloat16 W on both sides,
#   so b and delta_b are the float32 trainer's and delta is sr_delta's; W is
#   held to SR_STATE_ONE_W_FRO.  Wrong hyperparameters are refused there.
WIDE_DRAWS = 8
WIDE_REL_FRO = 2e-5
SR_DELTA_W_FRO = 1e-4
SR_DELTA_FRO = 3e-4
SR_DELTA_ONE_FRO = 3e-4
SR_STATE_W_FRO = 5e-2
SR_STATE_FRO = 2e-2
SR_STATE_ONE_W_FRO = 2e-3


def phase_resident_wide() -> dict:
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    def cfg_of(**kw):
        return ModelConfig(layersizes=WIDE, **kw)

    mlp = init_params(torch.Generator().manual_seed(5), cfg_of(), scheme="glorot", device="cuda")
    opt = OptConfig(lrate=1.0, momentum=0.5, weightcost=1e-5, bunchsize=BUNCH)
    hyp = (opt.lrate, opt.momentum, opt.weightcost)
    n_b = 3
    f64 = torch.float64
    drop = dict(dropout_vis=0.1, dropout_hid=0.2)

    def draw(i):
        """Seeded inputs number i: 3 bunches and a partial one."""
        g = torch.Generator(device="cuda").manual_seed(3084 + i)
        x = _randn(g, n_b * BUNCH + 40, WIDE[0])
        return x, (x @ _randn(g, WIDE[0], WIDE[-1], scale=0.05)).contiguous()

    def state_for(kw):
        st = init_train_state(mlp)
        rc._cast_state(st, torch.bfloat16 if kw.get("sr_state") else torch.float32,
                       torch.bfloat16 if (kw.get("sr_state") or kw.get("sr_delta")) else torch.float32)
        return st

    def plain64(cfg, rule, kw, xs, ts, seed=17):
        coefs = rc._scal_coefs(rule, BUNCH, WIDE[-1], *hyp)
        ref_kw = {k: v for k, v in kw.items() if k in ("sr_state", "sr_delta", "tile_rows", "bf16")}
        return rc.resident_train_chunk_reference(state_for(kw), xs, ts, cfg, BUNCH, coefs, seed,
                                                 dtype=f64, **ref_kw)

    def plain32(cfg, rule, kw, xs, ts, seed=17, h=None):
        """The float32 plain version's errors by group against the float64 one."""
        coefs = rc._scal_coefs(rule, BUNCH, WIDE[-1], *(h or hyp))
        ref_kw = {k: v for k, v in kw.items() if k in ("sr_state", "sr_delta", "tile_rows", "bf16")}
        got = rc.resident_train_chunk_reference(state_for(kw), xs, ts, cfg, BUNCH, coefs, seed,
                                                **ref_kw)
        return errs_by_group(got, plain64(cfg, rule, kw, xs, ts, seed), kw)

    def errs_by_group(got, want, kw=None):
        """Worst update error of (W, b, delta_w, delta_b), the update taken
        from the state the variant starts from (W rounded to its storage)."""
        for g in _state_tensors(got):
            _check(bool(torch.isfinite(g.float()).all()), "non-finite state")
        e = _update_errors(got, want, state_for(kw or {}))
        return [max(e[4 * i:4 * i + 4]) for i in range(4)]

    def hold(label, limits, compare, plain):
        """compare(x, t) -> the kernel's errors by group; plain(x, t) -> the float32 plain
        version's errors against float64, held to the same `limits`.  -> (errors, draw index)
        of the first draw that holds.  A draw is passed over only if the plain version misses
        the limits there too (a ReLU flip of float32); a miss of the kernel alone fails."""
        def fmt(e):
            return " ".join(f"{v:.2g}" for v in e)

        def ok(e):
            return all(err <= lim for err, lim in zip(e, limits))

        seen = []
        for i in range(WIDE_DRAWS):
            e = compare(*draw(i))
            if ok(e):
                flips = "; ".join("draw %d read %s" % (j, s) for j, s in enumerate(seen))
                print(f"[kernel] chunk trainer at 3084-2048x3-257, {label}: {n_b} bunches + a "
                      f"partial one, worst update error W {e[0]:.3g} b {e[1]:.3g} delta_w {e[2]:.3g} "
                      f"delta_b {e[3]:.3g} (limits {' '.join(f'{l:g}' for l in limits)}) on draw {i}"
                      + (f" ({flips}: ReLU flips, the plain version misses the limits too)"
                         if seen else ""), flush=True)
                return e, i
            e32 = plain(*draw(i))
            _check(not ok(e32), f"{label}: draw {i} reads {fmt(e)} against the limits "
                                f"{' '.join(f'{l:g}' for l in limits)}, which the float32 plain "
                                f"version holds there ({fmt(e32)})")
            seen.append(f"{fmt(e)}, the float32 plain version {fmt(e32)}")
        _check(False, f"{label}: no draw of {WIDE_DRAWS} holds the limits {limits}: {seen}")

    out = {}
    f32_lim = (WIDE_REL_FRO,) * 4
    srd_lim = (SR_DELTA_W_FRO, SR_DELTA_W_FRO, SR_DELTA_FRO, SR_DELTA_W_FRO)
    srs_lim = (SR_STATE_W_FRO, SR_STATE_FRO, SR_STATE_FRO, SR_STATE_FRO)
    f32 = dict(bf16=False)  # float32 products
    tc = dict(bf16=True)  # tensor-core products
    tc_lim = (TC_THREE_REL_FRO,) * 4
    cases = [
        ("float32, parity, dropout 0.1/0.2", cfg_of(**drop), "parity", f32, f32_lim),
        ("sr_delta, parity, dropout 0.1/0.2", cfg_of(**drop), "parity", dict(sr_delta=True, **f32),
         srd_lim),
        ("sr_delta, clean", cfg_of(), "clean", dict(sr_delta=True, **f32), srd_lim),
        ("sr_state, parity, dropout 0.1/0.2", cfg_of(**drop), "parity", dict(sr_state=True, **f32),
         srs_lim),
        ("sr_state, clean", cfg_of(), "clean", dict(sr_state=True, **f32), srs_lim),
        ("tile_rows 64, clean, dropout 0.1/0.2 (inverted)",
         cfg_of(dropout_mode="inverted", **drop), "clean", dict(tile_rows=64, **f32), f32_lim),
        ("tensor cores, float32 state, parity, dropout 0.1/0.2", cfg_of(**drop), "parity", tc,
         tc_lim),
        ("tensor cores, sr_delta, parity, dropout 0.1/0.2", cfg_of(**drop), "parity",
         dict(sr_delta=True, **tc), tc_lim),
        ("tensor cores, sr_delta, clean", cfg_of(), "clean", dict(sr_delta=True, **tc), tc_lim),
        ("tensor cores, sr_state, parity, dropout 0.1/0.2", cfg_of(**drop), "parity",
         dict(sr_state=True, **tc), tc_lim),
    ]
    for label, cfg, rule, kw, limits in cases:
        run = rc.make_resident_train_chunk(cfg, opt, rule=rule, **kw)

        def compare(x, t):
            got = run(init_train_state(mlp), x, t, 17, *hyp)
            want = plain64(cfg, rule, kw, x, t)
            _check(got.step == want.step == n_b, f"{label}: steps {got.step}, {want.step}")
            want_w = torch.bfloat16 if kw.get("sr_state") else torch.float32
            want_d = torch.bfloat16 if (kw.get("sr_state") or kw.get("sr_delta")) else torch.float32
            _check(all(w.dtype == want_w for w in got.params.w)
                   and all(d.dtype == want_d for d in got.deltas.w)
                   and all(b.dtype == torch.float32
                           for b in list(got.params.b) + list(got.deltas.b)),
                   f"{label}: storage types of the returned state")
            return errs_by_group(got, want, kw)

        out[label], _ = hold(label + " vs float64 plain with the same bits", limits, compare,
                             lambda x, t: plain32(cfg, rule, kw, x, t))

    # a second call takes the bfloat16 state as it is, with other hyperparameters
    cfg = cfg_of(**drop)
    sr_kw = dict(sr_delta=True, **f32)
    run = rc.make_resident_train_chunk(cfg, opt, **sr_kw)

    def two_plain(x, t, dtype):
        st_p = state_for(sr_kw)
        for seed, h in ((5, hyp), (6, (0.7, 0.9, 0.0))):
            rc.resident_train_chunk_reference(st_p, x, t, cfg, BUNCH,
                                              rc._scal_coefs("parity", BUNCH, WIDE[-1], *h), seed,
                                              dtype=dtype, sr_delta=True, bf16=False)
        return st_p

    def two_calls(x, t):
        st_k = run(init_train_state(mlp), x, t, 5, *hyp)
        d_first = st_k.deltas.w[0]
        run(st_k, x, t, 6, 0.7, 0.9, 0.0)
        _check(st_k.deltas.w[0] is d_first and st_k.step == 2 * n_b,
               "sr_delta: a second call did not take the bfloat16 state in place")
        return errs_by_group(st_k, two_plain(x, t, f64), sr_kw)

    hold("sr_delta, two calls, hyperparameters changed", srd_lim, two_calls,
         lambda x, t: errs_by_group(two_plain(x, t, torch.float32), two_plain(x, t, f64), sr_kw))

    # the limits bite: an sr_delta and an sr_state trainer given a wrong hyperparameter are
    # refused by the one-bunch or the three-bunch limits, on a draw where the right ones pass both;
    # the tensor-core forms (see TC_ONE_REL_FRO) by the one-bunch limits, given faults the size
    # of those limits' room: float32 products, an lrate or a momentum 10% off
    small_faults = (("weightcost dropped", (opt.lrate, opt.momentum, 0.0), {}),
                    ("momentum x 1.03", (opt.lrate, 1.03 * opt.momentum, opt.weightcost), {}),
                    ("lrate x 1.001", (1.001 * opt.lrate, opt.momentum, opt.weightcost), {}))
    tc_faults = (("float32 products", hyp, dict(bf16=False)),
                 ("lrate x 1.1", (1.1 * opt.lrate, opt.momentum, opt.weightcost), {}),
                 ("momentum x 1.1", (opt.lrate, 1.1 * opt.momentum, opt.weightcost), {}))
    for name, kw_sr, one_limits, three_limits, faults in (
            ("sr_delta", sr_kw, (CHUNK_ONE_REL_FRO, CHUNK_ONE_REL_FRO, SR_DELTA_ONE_FRO,
                                 CHUNK_ONE_REL_FRO), srd_lim, small_faults),
            ("sr_state", dict(sr_state=True, **f32), (SR_STATE_ONE_W_FRO, CHUNK_ONE_REL_FRO,
                                                      SR_DELTA_ONE_FRO, CHUNK_ONE_REL_FRO), srs_lim,
             small_faults),
            ("tensor-core sr_delta", dict(sr_delta=True, **tc), (TC_ONE_REL_FRO,) * 4, tc_lim,
             tc_faults),
            ("tensor-core sr_state", dict(sr_state=True, **tc),
             (TC_SR_STATE_ONE_W_FRO,) + (TC_ONE_REL_FRO,) * 3, tc_lim, tc_faults)):
        limits = one_limits + three_limits

        def one_and_three(h, kw_run=kw_sr, kw_sr=kw_sr):
            run_sr = rc.make_resident_train_chunk(cfg_of(), opt, rule="parity", **kw_run)

            def compare(x, t):
                one = errs_by_group(run_sr(init_train_state(mlp), x[:BUNCH], t[:BUNCH], 17, *h),
                                    plain64(cfg_of(), "parity", kw_sr, x[:BUNCH], t[:BUNCH]), kw_sr)
                three = errs_by_group(run_sr(init_train_state(mlp), x, t, 17, *h),
                                      plain64(cfg_of(), "parity", kw_sr, x, t), kw_sr)
                return one + three
            return compare

        def one_and_three_plain(x, t, kw_sr=kw_sr):
            return (plain32(cfg_of(), "parity", kw_sr, x[:BUNCH], t[:BUNCH])
                    + plain32(cfg_of(), "parity", kw_sr, x, t))

        e, i_ok = hold(f"{name}, parity, after one bunch (first four) and after three", limits,
                       one_and_three(hyp), one_and_three_plain)
        out[f"{name}, parity, one bunch"] = e[:4]
        for label, h, kw_fault in faults:
            f = one_and_three(h, kw_run={**kw_sr, **kw_fault})(*draw(i_ok))
            _check(any(err > lim for err, lim in zip(f, limits)),
                   f"an {name} trainer with {label} passes the limits: {f}")
            print(f"[kernel] {name} trainer with {label} (a deliberate fault) is refused: after one "
                  f"bunch W {f[0]:.3g} (limit {one_limits[0]}) b {f[1]:.3g} (limit {one_limits[1]}) "
                  f"delta_w {f[2]:.3g} (limit {one_limits[2]}), after three W {f[4]:.3g} (limit "
                  f"{three_limits[0]}) delta_w {f[6]:.3g} (limit {three_limits[2]})", flush=True)

    # row tiles against the untiled clean run (two kernels, two summation orders)
    clean_run = rc.make_resident_train_chunk(cfg_of(), opt, rule="clean", **f32)
    for tile in (32, 64):
        tiled_run = rc.make_resident_train_chunk(cfg_of(), opt, rule="clean", tile_rows=tile, **f32)

        def tiled_vs_untiled(x, t):
            before = rc.kernel_launches["tiled_bwd_update"]
            tiled = tiled_run(init_train_state(mlp), x, t, 17, *hyp)
            n_tiled = rc.kernel_launches["tiled_bwd_update"] - before
            _check(n_tiled == 4 * n_b * (BUNCH // tile) and tiled.step == n_b,
                   f"tile_rows {tile}: {n_tiled} tiled backward launches, step {tiled.step}")
            return errs_by_group(tiled, clean_run(init_train_state(mlp), x, t, 17, *hyp))

        out[f"tile_rows {tile} vs untiled"], _ = hold(
            f"clean rule, tile_rows {tile} (bunch 128, {4 * n_b * (BUNCH // tile)} accumulating "
            f"backward launches) vs the untiled run", f32_lim, tiled_vs_untiled,
            lambda x, t, tile=tile: plain32(cfg_of(), "clean", dict(tile_rows=tile, **f32), x, t))

    # hbm_spill: the unspilled trainer bit for bit, with either product
    x, t = draw(0)
    spill_abs = 0.0
    for prod in (f32, tc):
        plain_run = rc.make_resident_train_chunk(cfg, opt, **prod)(init_train_state(mlp), x, t, 17,
                                                                    *hyp)
        spilled = rc.make_resident_train_chunk(cfg, opt, hbm_spill=1, **prod)(
            init_train_state(mlp), x, t, 17, *hyp)
        torch.cuda.synchronize()
        for a, b in zip(_state_tensors(spilled), _state_tensors(plain_run)):
            _check(torch.equal(a, b), f"hbm_spill=1 differs from the unspilled run ({prod})")
            spill_abs = max(spill_abs, float((a - b).abs().max()))
    print(f"[kernel] chunk trainer, hbm_spill=1 equals the unspilled run bit for bit with float32 "
          f"and with tensor-core products (largest difference {spill_abs}; the state is in device "
          f"memory either way)", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(257)
    # ms per bunch, 50 bunches of dropout training in one call, by variant,
    # in turns (f32, sr_delta, sr_state, spill, row tiles, then back)
    n_t = 50
    xt, tt = _randn(gen, n_t * BUNCH, WIDE[0]), _randn(gen, n_t * BUNCH, WIDE[-1])
    small = (1e-3, 0.5, 0.0)
    variants = [("f32", dict(f32)), ("sr_delta", dict(sr_delta=True, **f32)),
                ("sr_state", dict(sr_state=True, **f32)), ("hbm_spill", dict(hbm_spill=1, **f32)),
                ("tile_rows", dict(rule="clean", tile_rows=64, **f32)), ("tc_f32", dict(tc)),
                ("tc_sr_delta", dict(sr_delta=True, **tc)),
                ("tc_sr_state", dict(sr_state=True, **tc))]
    runs = {n: (rc.make_resident_train_chunk(cfg, opt, **kw), init_train_state(mlp))
            for n, kw in variants}
    times = {n: [] for n, _ in variants}
    for name in [n for n, _ in variants] + [n for n, _ in reversed(variants)]:
        r, st = runs[name]
        times[name].append(_time_ms(lambda: r(st, xt, tt, 3, *small), reps=3, warmup=1) / n_t)
    kn = sum(a * b for a, b in zip(WIDE[:-1], WIDE[1:]))
    flops = 2.0 * BUNCH * (3 * kn - WIDE[0] * WIDE[1])
    io = 4.0 * BUNCH * (WIDE[0] + WIDE[-1])
    # passes over the state: W read by the forward; W and delta read and written by the
    # backward (row tiles read it again for every tile; the bound counts each once)
    state_bytes = {"f32": 4.0 * 5 * kn, "hbm_spill": 4.0 * 5 * kn, "tile_rows": 4.0 * 5 * kn,
                   "sr_delta": 4.0 * 3 * kn + 2.0 * 2 * kn, "sr_state": 2.0 * 5 * kn}
    timing = {}
    for name, kw in variants:
        st = state_for(kw)
        t_ops = flops / (PEAK_BF16_FLOPS if kw["bf16"] else PEAK_FP32_FLOPS) * 1e3
        coefs = rc._scal_coefs(kw.get("rule", "parity"), BUNCH, WIDE[-1], *small)
        ref_kw = {k: v for k, v in kw.items() if k in ("sr_state", "sr_delta", "tile_rows", "bf16")}
        plain_ms = _time_ms(lambda: rc.resident_train_chunk_reference(
            st, xt[:4 * BUNCH], tt[:4 * BUNCH], cfg, BUNCH, coefs, 3, **ref_kw), reps=1, warmup=1) / 4
        t_bytes = (state_bytes[name.replace("tc_", "")] + io) / PEAK_BYTES_PER_S * 1e3
        ms = float(np.mean(times[name]))
        timing[name] = dict(ms=ms, ms_runs=times[name], plain_ms=plain_ms, library_ms=None,
                            bound_ms=max(t_ops, t_bytes),
                            bound_by="operations" if t_ops >= t_bytes else "bytes",
                            bytes_ms=t_bytes, ops_ms=t_ops)
        print(f"[kernel] chunk trainer at 3084-2048x3-257, {name}: {ms:.4f} ms per bunch "
              f"({' '.join(f'{v:.4f}' for v in times[name])}; {flops / ms / 1e9:.2f} TFLOP/s), plain "
              f"version {plain_ms:.2f} ms per bunch with the host's share, bound "
              f"{max(t_ops, t_bytes):.4f} ms ({flops / 1e9:.2f} GFLOP at "
              f"{'989' if kw['bf16'] else '67'} TFLOP/s: {t_ops:.4f}; "
              f"{t_bytes * PEAK_BYTES_PER_S / 1e9:.0f} MB at 3.35 TB/s: {t_bytes:.4f})", flush=True)
    digests = _chunk_digests(("16k_sr_delta", "16k_sr_state", "16k_hbm_spill",
                              "16k_tile_rows_64"))
    for name, d in digests.items():
        print(f"[kernel] chunk trainer state digest {name} (one call of 100 bunches, "
              f"CHUNK_DIGEST_FORMS): {d}", flush=True)
    return dict(errors=out, timing=timing, spill_max_abs=spill_abs, state_digests=digests)


# Two epochs of the 16 kHz net through train_epochs_arrays, sr_delta against
# the float32 engine from the same weights, data and seeds: final CV MSE
# within this fraction (the JAX package's own control of bf16 momentum against
# float32 held 2%).
SR_CV_FRACTION = 0.02


def phase_train_arrays(tmp: str, smi: str) -> dict:
    """The in-memory training path at 3084-2048x3-257: a corpus featurized at
    16 kHz on the STFT kernel -> build_training_arrays -> train_epochs_arrays."""
    from tpu_sednn_torch.data import build_training_arrays
    from tpu_sednn_torch.dsp.stft import StftConfig
    from tpu_sednn_torch.io import compute_norm
    from tpu_sednn_torch.model.mlp import MLP, ModelConfig, init_params
    from tpu_sednn_torch.ops import launch_counts, reset_launch_counts
    from tpu_sednn_torch.ops.sr_update import sr_train_step
    from tpu_sednn_torch.ops.stft_lps import stft_lps
    from tpu_sednn_torch.recipes import recipe_opt_schedule
    from tpu_sednn_torch.train.loop import train_epochs_arrays
    from tpu_sednn_torch.train.step import OptConfig, TrainState, init_train_state
    from tpu_sednn_torch.utils.logging import Logger

    reset_launch_counts()  # the path's run starts here (corpus set-up included)
    t0 = time.perf_counter()
    rng = np.random.default_rng(316)
    sr, n_utt, n_cv = 16000, 36, 4
    stft = StftConfig.for_rate(sr)
    noisy, clean = [], []
    for i in range(n_utt):
        n = int(rng.uniform(8.0, 9.0) * sr)
        sig = _speechlike(rng, n, sr)
        noise = np.convolve(rng.standard_normal(n + 8), rng.uniform(-1, 1, 9), "valid")
        noise *= np.sqrt(np.mean(sig ** 2) / (np.mean(noise ** 2) * 10 ** (rng.uniform(0, 15) / 10)))
        both = np.stack([np.clip(sig + noise, -1, 1), sig]).astype(np.float32)
        lps = stft_lps(torch.from_numpy(both).cuda(), stft).cpu().numpy()
        noisy.append(lps[0])
        clean.append(lps[1])
    mean, istd = compute_norm(np.concatenate(noisy[:-n_cv]))
    t_mean, t_istd = compute_norm(np.concatenate(clean[:-n_cv]))
    kw = dict(fea_context=11, targ_offset=5, nat=True, mean=mean, inv_std=istd, targ_mean=t_mean,
              targ_inv_std=t_istd)
    x, t = build_training_arrays(noisy[:-n_cv], clean[:-n_cv], **kw)
    x_cv, t_cv = build_training_arrays(noisy[-n_cv:], clean[-n_cv:], **kw)
    n_stft = launch_counts()["stft_lps"]
    _check(x.shape[1] == WIDE[0] and t.shape[1] == WIDE[-1] and x.shape[0] >= 16384
           and n_stft == n_utt, f"arrays {x.shape} {t.shape}, {n_stft} stft_lps launches")
    print(f"[arrays] corpus: {n_utt} noisy/clean pairs at 16 kHz featurized on the card "
          f"({n_stft} stft_lps launches), build_training_arrays -> x {x.shape}, t {t.shape}, CV "
          f"{x_cv.shape} in {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = ModelConfig(layersizes=WIDE, dropout_vis=0.1, dropout_hid=0.2, dropout_mode="parity")
    mlp = init_params(torch.Generator().manual_seed(16), cfg, scheme="uniform",
                      w_range=(-0.03, 0.03), device="cuda")
    traincache = 8192  # two full chunks and a partial one
    chunk_bunches = [min(traincache, x.shape[0] - st) // BUNCH
                     for st in range(0, x.shape[0], traincache)]
    n_bunches = sum(chunk_bunches)
    n_chunks = -(-x.shape[0] // traincache)

    def sched(e):
        return recipe_opt_schedule(e, 0.1, BUNCH)

    quiet = Logger(stream=None)

    def epochs(n_epochs, engine, engine_kwargs=None, cfg=cfg, state=None, sched=sched, **kw):
        """-> (state, CV history, launch counts of this run alone, seconds)."""
        before = launch_counts()
        t0 = time.perf_counter()
        st, res = train_epochs_arrays(state or init_train_state(mlp), cfg, sched, x, t, x_cv, t_cv,
                                      n_epochs, seed=3, traincache=traincache, engine=engine,
                                      engine_kwargs=engine_kwargs, logger=quiet, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = launch_counts()
        d = {k: after[k] - before[k] for k in after if isinstance(after[k], int)}
        d.update({k: after["resident_chunk_kernels"][k] - before["resident_chunk_kernels"][k]
                  for k in after["resident_chunk_kernels"]})
        _check(all(np.isfinite(r.cv_mse) for r in res), f"{engine} {engine_kwargs}: CV not finite")
        return st, [r.cv_mse for r in res], d, secs

    def resident_counts(d, n_ep, label, tiles=1):
        # every launch of a call but its first a programmatic dependent one, either form
        _check(d["resident_chunk"] == n_ep * n_chunks and d["plain_train_chunk"] == 0
               and d["fused_bwd_update"] == 4 * n_ep * n_bunches * tiles
               and d["pdl"] == d["fused_linear_act"] + d["fused_bwd_update"] - d["resident_chunk"]
               and d["input_mask_table"] == d["resident_chunk"] and d["input_mask_philox"] == 0,
               f"{label}: {d} for {n_ep} epochs of {n_chunks} chunks, {n_bunches} bunches")

    out = {}
    f32 = dict(bf16=False)  # the float32-product engine, pinned
    # the JAX package's 16 kHz production configuration: engine=auto with sr_delta, which on
    # the card is the chunk trainer with tensor-core products
    st_sr, cv_sr, d_sr, s_sr = epochs(2, "auto", dict(sr_delta=True))
    resident_counts(d_sr, 2, "sr_delta, tensor cores")
    _check(d_sr["sr_bwd_update"] == d_sr["tc_bwd_update"] == d_sr["fused_bwd_update"]
           and d_sr["tc_linear_act"] == d_sr["fused_linear_act"] and d_sr["bf16_linear_act"] == 0
           and st_sr.deltas.w[0].dtype == torch.bfloat16 and st_sr.params.w[0].dtype == torch.float32,
           f"engine=auto sr_delta epochs did not run the tensor-core bfloat16-momentum form: {d_sr}")
    _check(cv_sr[1] < cv_sr[0], f"sr_delta: CV MSE did not fall: {cv_sr}")
    st_f, cv_f, d_f, s_f = epochs(2, "resident", f32)
    resident_counts(d_f, 2, "float32")
    _check(d_f["sr_bwd_update"] == d_f["tc_bwd_update"] == 0 and cv_f[1] < cv_f[0],
           f"float32 engine: {cv_f} {d_f}")
    # sr_delta again, now that the path is warm (the first run above also paid for the
    # first pinned buffers and workspaces): the host's samples/s of the two forms in turns
    _, cv_sr2, d_sr2, s_sr2 = epochs(2, "auto", dict(sr_delta=True))
    _check(cv_sr2 == cv_sr, f"sr_delta run again gives another CV history: {cv_sr2} vs {cv_sr}")
    # the float32-product hold: sr_delta with float32 products against the float32 engine
    _, cv_srf, d_srf, _ = epochs(2, "resident", dict(sr_delta=True, **f32))
    _check(d_srf["sr_bwd_update"] == d_srf["fused_bwd_update"] and d_srf["tc_bwd_update"] == 0,
           f"sr_delta, float32 products: {d_srf}")
    frac = abs(cv_srf[1] - cv_f[1]) / cv_f[1]
    frac_tc = abs(cv_sr[1] - cv_f[1]) / cv_f[1]
    _check(frac <= SR_CV_FRACTION and frac_tc <= SR_CV_FRACTION,
           f"final CV: sr_delta {cv_srf[1]} (float32 products) and {cv_sr[1]} (tensor cores) vs "
           f"float32 {cv_f[1]}: {frac:.3g} and {frac_tc:.3g} apart (limit {SR_CV_FRACTION})")
    out.update(cv_sr_delta=cv_sr, cv_f32=cv_f, cv_sr_delta_f32=cv_srf, cv_fraction=frac,
               cv_fraction_tc=frac_tc,
               samples_per_s=dict(sr_delta_first=2 * x.shape[0] / s_sr, f32=2 * x.shape[0] / s_f,
                                  sr_delta_again=2 * x.shape[0] / s_sr2))
    print(f"[arrays] train_epochs_arrays, 3084-2048x3-257, bunch {BUNCH}, parity dropout 0.1/0.2, "
          f"recipe schedule, {x.shape[0]} samples, {n_chunks} chunks, {n_bunches} bunches an epoch, "
          f"on {smi}: engine=auto sr_delta (tensor cores) CV MSE {cv_sr[0]:.6f} -> {cv_sr[1]:.6f} "
          f"({2 * x.shape[0] / s_sr:.0f} samples/s by the host, CV included, the path's first run; "
          f"{2 * x.shape[0] / s_sr2:.0f} run again after the float32 one, same CV); float32 "
          f"products and state {cv_f[0]:.6f} -> {cv_f[1]:.6f} ({2 * x.shape[0] / s_f:.0f} "
          f"samples/s); sr_delta with float32 products {cv_srf[0]:.6f} -> {cv_srf[1]:.6f}; final "
          f"CV of the tensor-core run {frac_tc:.3g} and of float32-product sr_delta {frac:.3g} apart "
          f"from the float32 run's (limit {SR_CV_FRACTION})", flush=True)

    # the other forms, one epoch each
    _, cv_ss, d_ss, _ = epochs(1, "resident", dict(sr_state=True, **f32))
    resident_counts(d_ss, 1, "sr_state")
    _check(d_ss["bf16_linear_act"] == d_ss["fused_linear_act"] > 0, f"sr_state: {d_ss}")
    _, cv_sst, d_sst, _ = epochs(1, "resident", dict(sr_state=True))
    resident_counts(d_sst, 1, "sr_state, tensor cores")
    _check(d_sst["bf16_linear_act"] == d_sst["tc_linear_act"] == d_sst["fused_linear_act"] > 0
           and abs(cv_sst[0] - cv_ss[0]) <= SR_CV_FRACTION * cv_ss[0],
           f"sr_state, tensor cores: CV {cv_sst} vs {cv_ss} with float32 products, {d_sst}")
    _, cv_sp, d_sp, _ = epochs(1, "resident", dict(hbm_spill=1, **f32))
    resident_counts(d_sp, 1, "hbm_spill")
    _check(cv_sp[0] == cv_f[0], f"hbm_spill=1 epoch CV {cv_sp[0]} is not the float32 engine's {cv_f[0]}")
    clean_cfg = ModelConfig(layersizes=WIDE, dropout_vis=0.1, dropout_hid=0.2,
                            dropout_mode="inverted")
    _, cv_t, d_t, _ = epochs(1, "resident", dict(rule="clean", tile_rows=64, **f32), cfg=clean_cfg,
                             sched=lambda e: OptConfig(lrate=0.1, momentum=0.5, bunchsize=BUNCH))
    resident_counts(d_t, 1, "tile_rows", tiles=2)
    _check(d_t["tiled_bwd_update"] == d_t["fused_bwd_update"], f"tile_rows: {d_t}")
    # kernel 5 on its path: the plain trainer with masks from the Philox kernel
    cfg5 = ModelConfig(layersizes=WIDE, dropout_vis=0.1, dropout_hid=0.2, dropout_mode="parity",
                       dropout_rng="tpu_prng")
    _, cv_x, d_x, s_x = epochs(1, "xla", cfg=cfg5)
    # the plain trainer draws the masks of MASK_GROUP bunches (4 a bunch) with one launch
    from tpu_sednn_torch.train.step import MASK_GROUP

    mask_launches = sum(-(-nb // MASK_GROUP) for nb in chunk_bunches)
    _check(d_x["dropout_mask"] == mask_launches and d_x["dropout_mask_masks"] == 4 * n_bunches
           and d_x["resident_chunk"] == 0 and d_x["plain_train_chunk"] == n_chunks,
           f"engine=xla with dropout_rng=tpu_prng: {d_x} for {chunk_bunches} bunches a chunk "
           f"({mask_launches} dropout_mask launches of {4 * n_bunches} masks expected)")
    # the same trainer with torch.rand masks: only the generator of the masks differs.  After
    # one epoch of 129 bunches the CV error still moves by several percent with the masks'
    # realisation alone (the chunk trainer's epoch above reads 62.5 with its Philox stream,
    # this trainer 57.4-57.8 with its two), hence 15%
    _, cv_x3, d_x3, _ = epochs(1, "xla")
    _check(d_x3["dropout_mask"] == 0 and abs(cv_x[0] - cv_x3[0]) <= 0.15 * cv_x3[0],
           f"engine=xla epoch CV {cv_x[0]} with the Philox masks vs {cv_x3[0]} with torch.rand's")
    out.update(cv_sr_state=cv_ss, cv_sr_state_tc=cv_sst, cv_tile_rows=cv_t, cv_xla=cv_x,
               cv_xla_threefry=cv_x3,
               xla_tpu_prng=dict(dropout_mask=d_x["dropout_mask"], masks=d_x["dropout_mask_masks"],
                                 samples_per_s=x.shape[0] / s_x))
    print(f"[arrays] one epoch each: sr_state CV {cv_ss[0]:.6f} (tensor cores {cv_sst[0]:.6f}, "
          f"limit {SR_CV_FRACTION} apart); hbm_spill=1 {cv_sp[0]:.6f} (the "
          f"float32 engine's, exactly); clean rule tile_rows 64 {cv_t[0]:.6f}; engine=xla with "
          f"dropout_rng=tpu_prng {cv_x[0]:.6f} ({d_x['dropout_mask']} dropout_mask launches "
          f"for {d_x['dropout_mask_masks']} masks, "
          f"{x.shape[0] / s_x:.0f} samples/s), with torch.rand masks {cv_x3[0]:.6f} (limit: 15% "
          f"apart)", flush=True)

    # kernel 6 on its path: sr_train_step at full width, bfloat16 state
    cfg6 = ModelConfig(layersizes=WIDE, dropout_mode="inverted")
    st6 = init_train_state(mlp)
    st6 = TrainState(params=MLP([w.data.bfloat16() for w in st6.params.w],
                                [b.data.bfloat16() for b in st6.params.b]),
                     deltas=MLP([d.data.bfloat16() for d in st6.deltas.w],
                                [d.data.bfloat16() for d in st6.deltas.b]), step=0)
    # the clean rule's step is lrate / 257 on the gradient of (1/128) sum((out - t)^2), the
    # parity rule's (1 - m) * lrate / 128: lrate 0.05 is half the parity runs' step above
    # (0.2, four times it and without dropout, diverges on these correlated inputs)
    opt6 = OptConfig(lrate=0.05, momentum=0.5, weightcost=0.0, bunchsize=BUNCH)
    xd, td = torch.from_numpy(x[:8 * BUNCH]).cuda(), torch.from_numpy(t[:8 * BUNCH]).cuda()
    before = launch_counts()["sr_momentum_update"]
    losses = []
    for step in range(24):
        i = step % 8
        st6, loss = sr_train_step(st6, xd[i * BUNCH:(i + 1) * BUNCH], td[i * BUNCH:(i + 1) * BUNCH],
                                  cfg6, opt6, None, 100 * step)
        losses.append(float(loss))
    n_k6 = launch_counts()["sr_momentum_update"] - before
    first, last = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    _check(n_k6 == 24 * 8 and st6.params.w[0].dtype == torch.bfloat16 and np.isfinite(last)
           and last < 0.95 * first, f"sr_train_step: {n_k6} launches, loss {first} -> {last}")
    print(f"[arrays] sr_train_step at full width, bfloat16 state, 24 steps: mean loss of 8 steps "
          f"{first:.4f} -> {last:.4f}; {n_k6} sr_momentum_update launches", flush=True)

    # kill and resume: two epochs straight (st_f above) against one epoch,
    # checkpoint, a fresh call that restores and runs the second
    ck = os.path.join(tmp, "ckpt16k")
    _, _, d_k, _ = epochs(1, "resident", f32, ckpt_dir=ck)
    st_r, cv_r, d_r, _ = epochs(2, "resident", f32, ckpt_dir=ck)
    resident_counts(d_r, 1, "the resumed call")  # it trained the second epoch only
    _check(len(cv_r) == 2 and cv_r == cv_f, f"resumed CV history {cv_r} vs straight {cv_f}")
    for a, b in zip(_state_tensors(st_r), _state_tensors(st_f)):
        _check(torch.equal(a, b), "kill-and-resume differs from the straight run")
    _check(st_r.step == st_f.step == 2 * n_bunches, f"steps {st_r.step}, {st_f.step}")
    # a bfloat16 momentum survives the checkpoint
    from tpu_sednn_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    save_checkpoint(os.path.join(tmp, "ckpt_sr"), 2, st_sr)
    back, _, _ = restore_checkpoint(os.path.join(tmp, "ckpt_sr"), device="cuda")
    for a, b in zip(_state_tensors(back), _state_tensors(st_sr)):
        _check(a.dtype == b.dtype and torch.equal(a, b), "checkpoint changed the sr_delta state")
    print(f"[arrays] kill and resume on the float32 engine: one epoch + checkpoint + restore + one "
          f"epoch equals two epochs straight bit for bit (state and CV history); a bfloat16 "
          f"momentum comes back from its checkpoint unchanged", flush=True)

    total = launch_counts()
    out["counts"] = {k: v for k, v in total.items() if isinstance(v, int)}
    out["kernel_counts"] = total["resident_chunk_kernels"]
    out["by_form"] = dict(sr_delta=d_srf["resident_chunk"],
                          f32=d_f["resident_chunk"] + d_k["resident_chunk"] + d_r["resident_chunk"],
                          sr_state=d_ss["resident_chunk"], hbm_spill=d_sp["resident_chunk"],
                          tile_rows=d_t["resident_chunk"],
                          tc_sr_delta=d_sr["resident_chunk"] + d_sr2["resident_chunk"],
                          tc_sr_state=d_sst["resident_chunk"])
    out.update(n_samples=int(x.shape[0]), n_bunches=n_bunches, n_chunks=n_chunks)
    return out


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


def _corpus_wavs(tmp: str, n_utt: int) -> tuple[list, list]:
    """n_utt seeded speech-like utterances of ~10.2 s at 8 kHz with coloured
    noise at 0-15 dB SNR, as wavs in tmp -> (noisy paths, clean paths)."""
    from tpu_sednn_torch.io import write_wav

    rng = np.random.default_rng(2024)
    sr = 8000
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
    return noisy, clean


def _corpus_paths(tmp: str, n_utt: int) -> dict:
    return dict(fea=f"{tmp}/noisy.pfile", targ=f"{tmp}/clean.pfile", norm=f"{tmp}/noisy.norm",
                cv_range=f"{n_utt - 10}-{n_utt - 1}")


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


def _epoch_in_process(tmp, args, label, engine_kwargs=None):
    """One epoch of the training command's run_epoch in this process, with the
    chunk trainer pinned to float32 products unless engine_kwargs says
    otherwise (default {"bf16": False}: the command itself has no key for it)
    -> (CV MSE, launch counts of this run alone)."""
    from tpu_sednn_torch.cli import run_epoch
    from tpu_sednn_torch.config import TrainFlags
    from tpu_sednn_torch.ops import launch_counts
    from tpu_sednn_torch.utils.logging import Logger

    flags = TrainFlags.from_argv(args)
    before = launch_counts()
    cv = run_epoch(flags, logger=Logger(log_path=flags.log_file, stream=None),
                   engine_kwargs={"bf16": False} if engine_kwargs is None else engine_kwargs)
    torch.cuda.synchronize()
    after = launch_counts()
    d = {k: after[k] - before[k] for k in after if isinstance(after[k], int)}
    d["resident_chunk_kernels"] = {k: after["resident_chunk_kernels"][k]
                                   - before["resident_chunk_kernels"][k]
                                   for k in after["resident_chunk_kernels"]}
    _check(np.isfinite(cv), f"({label}) CV MSE not finite: {cv}")
    return cv, d


# The command's two tensor-core epochs against the same two epochs with float32
# products, from the same weights and seeds: final CV MSE within this fraction
# (SR_CV_FRACTION, the limit sr_delta is held to against float32; the JAX
# package's own control of bfloat16 momentum against float32 held 2%).
TC_CV_FRACTION = 0.02


def phase_train(tmp: str, smi: str) -> dict:
    from tpu_sednn_torch.io import load_wts
    from tpu_sednn_torch.ops import launch_counts, reset_launch_counts
    from tpu_sednn_torch.tools import make_pfile

    # corpus: 200 utterances of 10.2 s at 8 kHz, speech-like + coloured noise at
    # 0-15 dB SNR -> ~127,000 frames; the first 190 train (> one full chunk of
    # 102400 samples = 800 bunches, then a ragged one), the last 10 are CV
    n_utt = 200
    noisy, clean = _corpus_wavs(tmp, n_utt)
    corpus = _corpus_paths(tmp, n_utt)
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
    # the same two epochs with float32 products, from the same weights and seeds
    cv1_f, d1_f = _epoch_in_process(tmp, _train_args(
        tmp, corpus, "f32.1", "", train_range, do + ["momentum=0.5", "init_randem_seed=27863875"]),
        "float32 epoch 1")
    cv2_f, d2_f = _epoch_in_process(tmp, _train_args(
        tmp, corpus, "f32.2", f"{tmp}/f32.1.wts", train_range,
        do + ["momentum=0.54", "init_randem_seed=27864220"]), "float32 epoch 2")
    tc_frac = abs(cv2 - cv2_f) / cv2_f
    _check(cv2_f < cv1_f and tc_frac <= TC_CV_FRACTION,
           f"float32 products: CV {cv1_f} -> {cv2_f}; tensor cores {cv2}, {tc_frac:.3g} apart "
           f"(limit {TC_CV_FRACTION})")
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
        # per bunch: 4 tc_fwd_kernel (K split within a cluster: no fwd_sum_kernel)
        # and 4 stripe_bwd_kernel<true> (dedy summed within a cluster: no reduce_dedy_kernel),
        # 8 launches; the 3 forwards that write a hidden activation draw its mask by Philox;
        # each chunk's input masks are drawn by one input_mask_bits_kernel into their bit
        # table, which the first layer's forward and backward read (no Philox there)
        _check(k["fused_linear_act"] == 4 * n_bunches
               and k["fused_bwd_update"] == 4 * n_bunches
               and k["philox_mask"] == 3 * n_bunches and k["input_mask_table"] == n_chunks
               and k["input_mask_philox"] == 0,
               f"{label}: kernel launches {k} for {n_bunches} bunches")
        # engine=auto on the card: the tensor-core forms, every launch; each chunk's
        # launches but its first programmatic dependent ones
        _check(k["tc_linear_act"] == k["fused_linear_act"]
               and k["tc_bwd_update"] == k["fused_bwd_update"],
               f"{label}: engine=auto did not run the tensor-core forms: {k}")
        _check(k["pdl"] == 8 * n_bunches - n_chunks,
               f"{label}: {k['pdl']} programmatic dependent launches, not 8 x {n_bunches} bunches "
               f"- {n_chunks} chunks")
    for label, d in (("float32 epoch 1", d1_f), ("float32 epoch 2", d2_f)):
        # per bunch: 4 f32_fwd_kernel (K split within a cluster: no fwd_sum_kernel) and 4
        # stripe_bwd_kernel<false> (dedy summed within a cluster: no reduce_dedy_kernel), 8
        # launches; each chunk's launches but its first programmatic dependent ones
        k = d["resident_chunk_kernels"]
        _check(d["resident_chunk"] == n_chunks and k["fused_bwd_update"] == 4 * n_bunches
               and k["fused_linear_act"] == 4 * n_bunches
               and k["tc_linear_act"] == k["tc_bwd_update"] == 0
               and k["pdl"] == 8 * n_bunches - n_chunks and k["input_mask_table"] == n_chunks
               and k["input_mask_philox"] == 0,
               f"{label}: {d} for {n_chunks} chunks, {n_bunches} bunches")
    times = [float(l.split()[3]) for l in (log1 + log2).splitlines()
             if l.startswith("Total cost time:")]
    print(f"[train] python -m tpu_sednn_torch.cli, 1548-2048x3-129, dropout 0.1/0.2, engine=auto "
          f"on {smi}: {n_chunks} chunks {chunk_sizes}, {n_samples} samples, {n_bunches} bunches "
          f"per epoch, tensor-core products; CV MSE {cv1:.6f} -> {cv2:.6f}; epoch (read, train, CV) "
          f"{times[0]:.1f} s and {times[1]:.1f} s = {n_samples / times[0]:.0f} and "
          f"{n_samples / times[1]:.0f} samples/s; command wall {wall1:.1f} s and {wall2:.1f} s incl. "
          f"start-up; chunk trainer launched {c1['resident_chunk']} + {c2['resident_chunk']} times, "
          f"its kernels {c1['resident_chunk_kernels']['pdl']} + "
          f"{c2['resident_chunk_kernels']['pdl']} times as programmatic dependent launches, "
          f"plain trainer 0 times; the same two epochs with float32 products (run_epoch, "
          f"bf16=False): CV MSE {cv1_f:.6f} -> {cv2_f:.6f}, final CV {tc_frac:.3g} apart (limit "
          f"{TC_CV_FRACTION})", flush=True)

    # dropout off, a shorter range, the engines from the same weights: the float32 chunk
    # trainer (bf16=False, through run_epoch's engine_kwargs) and the tensor-core one (the
    # command, engine=resident) against engine=xla (plain float32 torch)
    short = ["dropoutflag=0", "momentum=0.5", "init_randem_seed=11"]
    cv_r, c_r = _epoch_in_process(
        tmp, _train_args(tmp, corpus, "res", f"{tmp}/mlp.1.wts", "0-19", short + ["engine=resident"]),
        "resident, float32 products")
    cv_t, c_t, _, _ = _run_train_cli(
        tmp, _train_args(tmp, corpus, "res_tc", f"{tmp}/mlp.1.wts", "0-19",
                         short + ["engine=resident"]), "resident, tensor cores")
    cv_x, c_x, _, _ = _run_train_cli(
        tmp, _train_args(tmp, corpus, "xla", f"{tmp}/mlp.1.wts", "0-19", short + ["engine=xla"]),
        "xla")
    k_r, k_t = c_r["resident_chunk_kernels"], c_t["resident_chunk_kernels"]
    _check(c_r["resident_chunk"] == c_t["resident_chunk"] == 1 and c_r["plain_train_chunk"] == 0
           and c_t["plain_train_chunk"] == 0 and k_r["tc_bwd_update"] == 0
           and k_r["pdl"] == k_r["fused_linear_act"] + k_r["fused_bwd_update"] - 1
           and k_t["tc_bwd_update"] == k_t["fused_bwd_update"] > 0
           and k_t["pdl"] == k_t["tc_linear_act"] + k_t["tc_bwd_update"] - 1
           and c_x["resident_chunk"] == 0 and c_x["plain_train_chunk"] == 1,
           f"engines: resident runs {c_r}, {c_t}, xla run {c_x}")
    w_x, b_x = load_wts(f"{tmp}/xla.wts", layersizes=list(FLAGSHIP))
    w_0, b_0 = load_wts(f"{tmp}/mlp.1.wts", layersizes=list(FLAGSHIP))

    def upd_off(name):
        """Worst relative Frobenius error of a tensor's update against engine=xla's: held
        on the update, as the chunk trainer is above (biases start near 0, so a
        tolerance relative to the weights themselves would hide them)."""
        w_r, b_r = load_wts(f"{tmp}/{name}.wts", layersizes=list(FLAGSHIP))
        return max(float(np.linalg.norm(a - b) / np.linalg.norm(b - c))
                   for a, b, c in zip(w_r + b_r, w_x + b_x, w_0 + b_0))

    upd_fro, upd_tc = upd_off("res"), upd_off("res_tc")
    _check(abs(cv_r - cv_x) <= 1e-3 * cv_x and upd_fro <= ENGINE_REL_FRO,
           f"engine=resident (float32) vs engine=xla: CV {cv_r} vs {cv_x}, update off by {upd_fro}")
    _check(abs(cv_t - cv_x) <= TC_ENGINE_CV * cv_x and upd_tc <= TC_ENGINE_REL_FRO,
           f"engine=resident (tensor cores) vs engine=xla: CV {cv_t} vs {cv_x}, update off by "
           f"{upd_tc}")
    print(f"[train] dropout off, sentences 0-19: engine=resident with float32 products CV MSE "
          f"{cv_r:.6f}, engine=xla (plain torch on the card) {cv_x:.6f} (tol 1e-3 relative); the "
          f"epoch's update of every tensor within {upd_fro:.3g} relative Frobenius (tol "
          f"{ENGINE_REL_FRO}: two float32 summation orders, ReLU flips and carried rounding over "
          f"{k_r['fused_bwd_update'] // 4} bunches); engine=resident with tensor-core products (the "
          f"command) CV MSE {cv_t:.6f} (tol {TC_ENGINE_CV} relative), update within {upd_tc:.3g} "
          f"(tol {TC_ENGINE_REL_FRO}: bfloat16 operands against float32 ones)", flush=True)
    runs = (c1, c2, c_t, c_x, d1_f, d2_f, c_r)
    train_counts = {k: sum(c[k] for c in runs) for k in
                    ("resident_chunk", "fused_linear_act", "fused_linear_act_tc",
                     "fused_bwd_update", "fused_bwd_update_tc", "plain_train_chunk",
                     "dropout_mask")}
    kernel_counts = {k: sum(c["resident_chunk_kernels"][k] for c in runs)
                     for k in c1["resident_chunk_kernels"]}
    # chunk-trainer calls by product form: tensor cores (the command's engine=auto and
    # engine=resident) and float32 (run_epoch with bf16=False)
    by_form = dict(tc=c1["resident_chunk"] + c2["resident_chunk"] + c_t["resident_chunk"],
                   f32=d1_f["resident_chunk"] + d2_f["resident_chunk"] + c_r["resident_chunk"])

    prof = _profile_chunk(corpus, train_range)
    return dict(cv=[cv1, cv2], cv_f32=[cv1_f, cv2_f], tc_cv_fraction=tc_frac,
                engine_update_off=dict(f32=upd_fro, tc=upd_tc),
                samples_per_s=[n_samples / t for t in times[:2]],
                epoch_seconds=times[:2], n_samples=n_samples, n_bunches=n_bunches,
                stft_launches=n_stft, counts=train_counts, kernel_counts=kernel_counts,
                by_form=by_form, **prof)


def _kernel_spans(prof) -> list:
    """(start, end) in microseconds of every kernel a torch.profiler trace holds,
    sorted: from its events, else from its Chrome trace."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start]
    if not spans:
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            with open(f"{tmp}/trace.json") as f:
                events = json.load(f).get("traceEvents", [])
        spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") == "kernel" and float(e.get("dur", 0)) > 0]
    return sorted(spans)


def _profile_chunk(corpus: dict, train_range: str) -> dict:
    """One full chunk (800 bunches) in this process, as train_epoch_pfile
    runs it: host read, host->device copy, on-device splice, chunk trainer —
    timed twice from the same state (bit for bit equal), the host's own cost a
    bunch, then 200 bunches of the trainer traced by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_sednn_torch.data.device_chunk import (build_chunk_on_device, chunk_capacities,
                                                   read_chunk_indexed)
    from tpu_sednn_torch.data.pipeline import plan_chunks
    from tpu_sednn_torch.data.rand48 import Rand48
    from tpu_sednn_torch.io import load_norm, read_pfile_info
    from tpu_sednn_torch.model.mlp import init_params
    from tpu_sednn_torch.ops.resident_chunk import kernel_launches, make_resident_train_chunk
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
    host_read_ms = (time.perf_counter() - t0) * 1e3
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
    run = make_resident_train_chunk(cfg, opt)  # tensor-core products, as engine=auto runs it

    def fresh():
        return init_train_state(init_params(torch.Generator().manual_seed(0), cfg, device="cuda"))

    def pdl_of(fn):
        """fn()'s programmatic dependent launches, by the trainer's tally."""
        before = kernel_launches["pdl"]
        fn()
        return kernel_launches["pdl"] - before

    state = fresh()
    run(state, x, t, 1, opt.lrate, opt.momentum, opt.weightcost, n_real=8)  # warm-up
    torch.cuda.synchronize()
    # the whole chunk twice from the same state: bit for bit the same (no launch of the
    # chain reads an operand before it is written, or the bits would vary from run to run)
    states, train_runs = [], []
    for _ in range(2):
        st = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_pdl = pdl_of(lambda: run(st, x, t, 2, opt.lrate, opt.momentum, opt.weightcost,
                                   n_real=n_real))
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        train_runs.append((time.perf_counter() - t0) * 1e3)
        _check(n_pdl == 8 * n_real - 1, f"a chunk of {n_real} bunches: {n_pdl} programmatic "
                                         f"dependent launches, not {8 * n_real - 1}")
        states.append(st)
    for a, b in zip(_state_tensors(states[0]), _state_tensors(states[1])):
        _check(torch.equal(a, b), f"two runs of a chunk of {n_real} bunches from the same state "
                                  f"differ")
    # the float32-product chain (bf16=False) alike: twice from the same state, bit for bit
    run_f32, f32_runs = make_resident_train_chunk(cfg, opt, bf16=False), []
    for _ in range(2):
        st = fresh()
        n_pdl_f32 = pdl_of(lambda: run_f32(st, x, t, 2, opt.lrate, opt.momentum, opt.weightcost,
                                           n_real=n_real))
        _check(n_pdl_f32 == 8 * n_real - 1, f"float32 products, a chunk of {n_real} bunches: "
                                             f"{n_pdl_f32} programmatic dependent launches")
        f32_runs.append(st)
    torch.cuda.synchronize()
    for a, b in zip(_state_tensors(f32_runs[0]), _state_tensors(f32_runs[1])):
        _check(torch.equal(a, b), f"two float32-product runs of a chunk of {n_real} bunches from "
                                  f"the same state differ")
    digests = dict(tc=_state_digest(states[0]), f32=_state_digest(f32_runs[0]))
    print(f"[train] state digests after the full chunk ({n_real} bunches of the corpus): tensor "
          f"cores {digests['tc']}, float32 products {digests['f32']}", flush=True)
    del f32_runs
    train_ms = min(train_runs)
    # the host's own cost a bunch: 100 bunches enqueued behind a spin kernel, by the host clock
    n_host = 100
    host_ms = _host_ms(lambda: run(state, x, t, 4, opt.lrate, opt.momentum, opt.weightcost,
                                   n_real=n_host)) / n_host

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # The trace: 200 bunches (1,600 launches).  The tracer can lose a few kernels'
    # records, so a trace is taken again, five times at most, until it holds every
    # launch, and the fullest is shown with what it lacks.  With programmatic dependent
    # launches kernels overlap (a launch's blocks start, and wait, while the launch
    # before it finishes), so the device is busy for the union of the kernels'
    # intervals, not for the sum of their times.  A lost record can only hide busy
    # time: from an incomplete trace the idle shares are upper bounds.
    n_trace, best = 200, None
    for attempt in range(5):
        before = dict(kernel_launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(state, x, t, 5 + attempt, opt.lrate, opt.momentum, opt.weightcost, n_real=n_trace)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        # the kernels launched: the two product kernels and the input masks' draw (the
        # other keys count subsets of these by form)
        launched = sum(kernel_launches[k] - before[k] for k in
                       ("fused_linear_act", "fused_bwd_update", "input_mask_table"))
        spans = _kernel_spans(prof)
        if best is None or len(spans) > len(best[0]):
            kernels = sorted((e for e in prof.key_averages()
                              if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                             key=lambda e: -dev_us(e))
            best = (spans, kernels, traced_ms, attempt)
        if len(spans) >= launched:
            break
    spans, kernels, traced_ms, attempt = best
    union_us, overlap_us, reach = 0.0, 0.0, None
    for a, b in spans:  # sorted by start
        if reach is None or a > reach:
            union_us += b - a
            reach = b
        else:
            union_us += max(b - reach, 0.0)
            overlap_us += min(b, reach) - a
            reach = max(reach, b)
    busy_ms, sum_ms = union_us / 1e3, sum(b - a for a, b in spans) / 1e3
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    complete = len(spans) >= launched
    total = host_read_ms + h2d_ms + splice_ms + train_ms
    print(f"[train] one full chunk in process ({item[6]} samples, {n_real} bunches): host read + "
          f"index tables {host_read_ms:.1f} ms, host->device {h2d_mb:.0f} MB in {h2d_ms:.1f} ms "
          f"({100 * h2d_ms / total:.2f}% of the chunk's {total:.0f} ms when nothing overlaps), "
          f"on-device splice {splice_ms:.1f} ms, chunk trainer {train_ms:.1f} ms = "
          f"{train_ms / n_real:.4f} ms per bunch ({' '.join(f'{v:.1f}' for v in train_runs)} ms, two "
          f"runs from the same state, bit for bit equal; {n_pdl} programmatic dependent launches "
          f"each; the float32-product chain's two runs bit for bit equal too, {n_pdl_f32} "
          f"dependent launches each), {n_real * BUNCH / train_ms * 1e3:.0f} samples/s; its "
          f"launches enqueued in "
          f"{enqueue_ms:.1f} ms ({enqueue_ms / n_real:.4f} ms a bunch, held back by CUDA's launch "
          f"queue), the host's own cost {host_ms:.4f} ms a bunch ({n_host} bunches enqueued behind "
          f"a spin kernel)", flush=True)
    print(f"[train] profile of {n_trace} bunches of that chunk's trainer (trace {attempt + 1}, "
          f"{len(spans)} of {launched} kernel launches in it"
          f"{'' if complete else ': records lost, so the idle shares are upper bounds'}): "
          f"traced {traced_ms:.1f} "
          f"ms wall, kernels from the first's start to the last's end {span_ms:.1f} ms, device "
          f"busy (the union of the kernels' intervals) {busy_ms:.1f} ms = "
          f"{100 * busy_ms / traced_ms:.1f}% of the wall ({100 * busy_ms / max(span_ms, 1e-9):.1f}% "
          f"of the span), idle {100 * max(traced_ms - busy_ms, 0) / traced_ms:.1f}% of the wall "
          f"({100 * max(span_ms - busy_ms, 0) / max(span_ms, 1e-9):.1f}% of the span); the "
          f"kernels' times sum to {sum_ms:.1f} ms, {overlap_us / 1e3:.1f} ms of it overlapping")
    shares = {}
    for e in kernels[:6] if sum_ms > 0 else []:
        shares[e.key[:60]] = dev_us(e) / 1e3 / sum_ms
        print(f"[train]   {dev_us(e) / 1e3:8.2f} ms ({100 * dev_us(e) / 1e3 / sum_ms:4.1f}% of the "
              f"sum) x{e.count:<5d} {e.key[:90]}")
    return dict(chunk_ms_per_bunch=train_ms / n_real, chunk_samples_per_s=n_real * BUNCH / train_ms * 1e3,
                chunk_runs_ms=train_runs, chunk_pdl_launches=n_pdl,
                enqueue_ms_per_bunch=enqueue_ms / n_real, host_ms_per_bunch=host_ms,
                h2d_ms=h2d_ms, h2d_share=h2d_ms / total, host_ms=host_read_ms, splice_ms=splice_ms,
                idle_share=max(traced_ms - busy_ms, 0) / traced_ms if spans else None,
                idle_share_of_span=max(span_ms - busy_ms, 0) / span_ms if spans else None,
                idle_shares_are_upper_bounds=not complete,
                overlap_ms=overlap_us / 1e3, trace_launches=[len(spans), launched],
                trace_bunches=n_trace, kernel_shares=shares, state_digests=digests)


# ---------------------------------------------------------------------------
# data parallelism: the gradient-out backward and the update kernel, the
# data-parallel chunk trainer on ranks that share the card (gloo), and the
# command with gpu_used=2 under torchrun
# ---------------------------------------------------------------------------

# The data-parallel chunk trainer against the single-process chunk trainer
# with the same seed, 1548-2048x3-129, parity dropout 0.1/0.2.  The forward is
# the same launches on the same rows with the same masks (Philox keyed on the
# global row, K split as for the global bunch), so a rank's activations are
# the single-device trainer's bit for bit and the two differ only in the
# order of G's float32 sums (a rank's rows, then the sum over the ranks).
# After ONE bunch every tensor's update is within DP_ONE_REL_MAX of its
# largest element; after three within DP_THREE_REL_FRO relative Frobenius,
# both product forms (an H100 read 5.6e-6 and 4.7e-7 to 1.3e-6: the limits keep
# about 20x and 80x).  sr_delta: delta_w one bfloat16 ulp apart where G's
# order decides a rounding (held as phase_sr holds it after one bunch; after
# three, where an ulp carried through m*delta can be several ulps of a small
# new delta, by the share of elements apart, SR_DIFF_SHARE, and the update of
# every tensor within SR_DELTA_FRO).  The three-bunch sr_delta run takes
# float32 products: with tensor cores, W moved by a delta one ulp apart moves
# activations across bfloat16 rounding boundaries from the second bunch on
# (0.8% of delta_w[0] more than an ulp apart after three on an H100),
# which would hide a wrong rounding stream.  The deliberately broken runs must miss
# the same limits: the all-reduce skipped, every rank's masks at row 0 (one
# bunch), every bunch's masks from bunch 0's stream, every bunch's
# stochastic rounding from bunch 0's stream (three bunches).
DP_ONE_REL_MAX = 1e-4
DP_THREE_REL_FRO = 1e-4
# the command with gpu_used=2 (torchrun, tensor cores, dropout on) against
# gpu_used=1 on the same sentences, weights and seeds: final CV within
# DP_CV_FRACTION, every tensor's update over the epoch within TC_ENGINE_REL_FRO
DP_CV_FRACTION = 5e-3
DP_CASES = ([(f"w{w}_{'tc' if tc else 'f32'}_{n}", w, tc, n, {}) for w in (2, 4)
             for tc in (True, False) for n in (1, 3)]
            + [(f"w{w}_{fault}", w, True, 1, {"fault": fault}) for w in (2, 4)
               for fault in ("no_allreduce", "row0")]
            + [(f"w{w}_mask_key", w, True, 3, {"fault": "mask_key"}) for w in (2, 4)]
            + [("w2_sr_delta_1", 2, True, 1, {"sr_delta": True}),
               ("w2_sr_delta_f32_3", 2, False, 3, {"sr_delta": True}),
               ("w2_sr_key", 2, False, 3, {"sr_delta": True, "fault": "sr_key"})])
DP_HYP = (1.0, 0.5, 1e-5)  # lrate, momentum, weightcost: phase_resident's


def _dp_inputs():
    """The DP holds' net, state and 3 bunches, the same in every process:
    1548-2048x3-129, parity dropout 0.1/0.2, glorot weights from seed 3,
    inputs and targets from numpy's seed 5."""
    from tpu_sednn_torch.model.mlp import init_params
    from tpu_sednn_torch.train.step import OptConfig

    cfg = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
    opt = OptConfig(lrate=DP_HYP[0], momentum=DP_HYP[1], weightcost=DP_HYP[2], bunchsize=BUNCH)
    mlp = init_params(torch.Generator().manual_seed(3), cfg, scheme="glorot", device="cuda")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3 * BUNCH, FLAGSHIP[0])).astype(np.float32)
    t = x @ (0.05 * rng.standard_normal((FLAGSHIP[0], FLAGSHIP[-1]))).astype(np.float32)
    return cfg, opt, mlp, torch.from_numpy(x).cuda(), torch.from_numpy(t).cuda()


def _state_bytes(state) -> list:
    import hashlib

    return [hashlib.sha256(a.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
            .hexdigest() for a in _state_tensors(state)]


def dp_worker(rank: int, world: int, workdir: str) -> int:
    """One rank of phase_dp's runs (python3 chip_smoke.py --dp-worker RANK
    WORLD DIR): the DP_CASES on the card, a timed run, and two pfile epochs
    on all ranks; rank 0 writes the states and what it measured into DIR."""
    import torch.distributed as dist

    from tpu_sednn_torch.data.rand48 import Rand48
    from tpu_sednn_torch.ops import launch_counts, reset_launch_counts
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.parallel import Mesh, all_reduce
    from tpu_sednn_torch.train.loop import train_epoch_pfile
    from tpu_sednn_torch.train.step import OptConfig, init_train_state

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", world_size=world,
                            rank=rank)
    groups = {world: None, 2: dist.new_group([0, 1])}
    dev = torch.device("cuda", 0)
    cfg, opt, mlp, x, t = _dp_inputs()
    with open(os.path.join(workdir, "job.json")) as f:
        job = {k: tuple(v) if isinstance(v, list) else v for k, v in json.load(f)["epoch"].items()}
    out = dict(hashes={}, timing={}, epochs={})
    plain = (rc._all_reduce, rc._mask_row0, rc.mask_key, rc.sr_key)
    for name, w, tc, n_b, extra in DP_CASES:
        if rank >= w:
            continue
        if extra.get("fault") == "no_allreduce":
            rc._all_reduce = lambda a, mesh: a
        elif extra.get("fault") == "row0":
            rc._mask_row0 = lambda mesh, tile: 0
        elif extra.get("fault") == "mask_key":  # every bunch draws bunch 0's masks
            rc.mask_key = lambda seed, bunch, layer: plain[2](seed, 0, layer)
        elif extra.get("fault") == "sr_key":  # every bunch rounds with bunch 0's bits
            rc.sr_key = lambda seed, bunch, layer: plain[3](seed, 0, layer)
        run = rc.make_dp_resident_train_chunk(cfg, opt, Mesh(w, rank, dev, groups[w]), bf16=tc,
                                              sr_delta=extra.get("sr_delta", False))
        st = run(init_train_state(mlp), x[:n_b * BUNCH], t[:n_b * BUNCH], 17, *DP_HYP)
        torch.cuda.synchronize()
        rc._all_reduce, rc._mask_row0, rc.mask_key, rc.sr_key = plain
        out["hashes"][name] = _state_bytes(st)
        if rank == 0:
            torch.save([a.cpu() for a in _state_tensors(st)] + [st.step],
                       os.path.join(workdir, f"{name}.pt"))
    # per bunch: wall time of a rank, and the sums on their own (host clock around each,
    # the card synchronised before and after: staging copy, barrier, rank_sum)
    n_t = 8
    xt, tt = x.repeat(3, 1)[:n_t * BUNCH].contiguous(), t.repeat(3, 1)[:n_t * BUNCH].contiguous()
    for w in (2, 4):
        if rank >= w:
            continue
        spent = []

        def timed(a, mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce(a, mesh)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return a

        run = rc.make_dp_resident_train_chunk(cfg, opt, Mesh(w, rank, dev, groups[w]))
        st = init_train_state(mlp)
        run(st, xt[:BUNCH], tt[:BUNCH], 3, 1e-3, 0.5, 0.0)  # warm-up
        rc._all_reduce = timed
        dist.barrier(groups[w])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(st, xt, tt, 4, 1e-3, 0.5, 0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_t
        rc._all_reduce = plain[0]
        out["timing"][w] = dict(bunch_ms=wall, allreduce_ms=sum(spent) * 1e3 / n_t,
                                allreduce_mb=4.0 * sum(a * b + b for a, b in
                                                       zip(FLAGSHIP[:-1], FLAGSHIP[1:])) / 1e6)
    dist.barrier()
    # the pfile epoch on all ranks (train_epoch_pfile, n_data_shards = world): float32
    # products, and sr_delta with tensor cores; counts zeroed just before each
    cfg_cmd = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
    opt_cmd = OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0, bunchsize=BUNCH)
    for label, kw in (("f32", {"bf16": False}), ("sr_delta", {"sr_delta": True})):
        from tpu_sednn_torch.model.mlp import init_params

        st = init_train_state(init_params(torch.Generator().manual_seed(11), cfg_cmd,
                                          scheme="glorot", device="cuda"))
        reset_launch_counts()
        _, res = train_epoch_pfile(st, cfg_cmd, opt_cmd, **job, rand=Rand48(11),
                                   n_data_shards=world, engine="resident", engine_kwargs=kw)
        torch.cuda.synchronize()
        out["epochs"][label] = dict(cv=res.cv_mse, counts=launch_counts(),
                                    samples=res.train_samples, seconds=res.seconds)
    dist.barrier()
    if rank == 0:
        with open(os.path.join(workdir, "rank0.json"), "w") as f:
            json.dump(out, f)
    else:
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(dict(hashes=out["hashes"]), f)
    dist.destroy_process_group()
    return 0


def _dp_kernels(gen) -> dict:
    """(a) the DP forward of a rank's rows (both product forms; the input's
    mask read from the rank's rows of its table) and the gradient-out
    backward against their float64 plain versions at the per-launch limits,
    the gradient-out backward reading the rank's table bit-equal to its
    Philox draw at the rank's rows, the update kernel (float32 and sr_delta
    delta) and rank_sum bit-equal to their plain versions; then times at a
    rank's rows of the flagship layers, beside the bounds."""
    import ctypes

    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.ops.fused_mlp import (dp_update, dp_update_reference, fused_bwd_grad_out,
                                               fused_bwd_grad_out_reference,
                                               fused_linear_act_reference)
    from tpu_sednn_torch.ops.philox import philox_mask
    from tpu_sednn_torch.ops.rank_sum import rank_sum, rank_sum_reference

    f64, bf = torch.float64, torch.bfloat16
    worst = {False: {}, True: {}}
    kn = [(FLAGSHIP[l], FLAGSHIP[l + 1]) for l in range(4)]
    cfg = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
    fwd_worst = {False: {}, True: {}}
    scratch_tallies = (ctypes.c_longlong * len(rc.kernel_launches))()  # not a path's launches
    # rank 1's rows of a bunch of 128 (of 2 ranks: 64, of 4: 32): its rows of the input's
    # mask table, drawn at row0 = M (tile 0 under seed 77: key 77)
    dp_bits = {M: rc.input_mask_bits(77, 1, M, FLAGSHIP[0], 0.1, row0=M)[0] for M in (64, 32)}
    for M in (64, 32):  # masks at rows M.. of the global bunch
        x, t = _randn(gen, M, FLAGSHIP[0]), _randn(gen, M, FLAGSHIP[-1])
        ws1 = [_randn(gen, K, N, scale=0.03) for K, N in kn]
        bs1 = [_randn(gen, N, scale=0.1) for _, N in kn]
        for tc in (False, True):
            tol = (TC_REL_MAX, TC_REL_FRO) if tc else (KERNEL_REL_MAX, KERNEL_REL_FRO)
            fwd = rc.dp_tile_forward(cfg, M, BUNCH, tc, torch.device("cuda", 0))
            ys, dedx = fwd(x, t, ws1, bs1, 77, M, 2.0 / BUNCH, scratch_tallies, dp_bits[M])
            h = x  # each layer on the kernel's own input
            for l, (K, N) in enumerate(kn):
                want = fused_linear_act_reference(
                    h, ws1[l], bs1[l], "relu" if l < 3 else "linear",
                    in_mask=philox_mask(77, M, K, 0.1, row0=M, device="cuda") if l == 0 else None,
                    out_mask=philox_mask(77 + (l + 1) * 104729, M, N, 0.2, row0=M, device="cuda")
                    if l < 3 else None, dtype=f64, bf16=tc)
                _hold(ys[l], want, f"DP forward {M} rows layer {l} {'tc' if tc else 'f32'}",
                      fwd_worst[tc], *tol)
                h = ys[l]
            _hold(dedx[:M * FLAGSHIP[-1]].view(M, FLAGSHIP[-1]),
                  (2.0 / BUNCH) * (ys[3].double() - t.double()), f"DP forward {M} rows dedx",
                  fwd_worst[tc])
    shapes = ([(M, FLAGSHIP[l], FLAGSHIP[l + 1]) for M in (64, 32) for l in range(4)]
              + [(BUNCH, 1548, 129), (8, 2048, 129), (40, 100, 37)])
    for M, K, N in shapes:
        dedx = _randn(gen, M, N, scale=0.02)
        y_prev = torch.relu(_randn(gen, M, K)) * philox_mask(13, M, K, 0.2, device="cuda")
        w = _randn(gen, K, N, scale=0.03)
        w0 = w.clone()
        table = rc.input_mask_bits(11, 1, M, K, 0.1, row0=M)[0]  # the rank's rows, row0 = M
        for tc in (False, True):
            tol = (TC_REL_MAX, TC_REL_FRO) if tc else (KERNEL_REL_MAX, KERNEL_REL_FRO)
            grads = {}
            for name, kw in (("plain", {}), ("relu", {"deriv": "relu"}),
                             ("sigmoid", {"deriv": "sigmoid"}),
                             ("philox", {"in_mask": (11, 0.1), "in_scale": 1.0 / 0.9,
                                         "mask_row0": M}),
                             ("table", {"in_mask": table, "in_scale": 1.0 / 0.9})):
                label = f"fused_bwd_grad_out {M}x{K}x{N} {'tc' if tc else 'f32'} {name}"
                g, dy = fused_bwd_grad_out(dedx, y_prev, w, bf16=tc, **kw)
                grads[name] = (g, dy)
                g_w, dy_w = fused_bwd_grad_out_reference(dedx, y_prev, w, dtype=f64, bf16=tc, **kw)
                _hold(g[:K * N], g_w[:K * N], f"{label}, G", worst[tc], *tol)
                _hold(g[K * N:], g_w[K * N:], f"{label}, gb", worst[tc])  # a float32 sum: no rounding
                _hold(dy, dy_w, f"{label}, dedy", worst[tc], *tol)
            _check(all(torch.equal(a, b) for a, b in zip(grads["table"], grads["philox"])),
                   f"fused_bwd_grad_out {M}x{K}x{N} bf16={tc}: reading the rank's table differs "
                   f"from the Philox draw at its rows")
            g1, none = fused_bwd_grad_out(dedx, y_prev, w, bf16=tc, with_dedy=False)
            _check(none is None and torch.equal(g1, grads["plain"][0]),
                   "the first layer's form (no dedy) differs")
        _check(torch.equal(w, w0), "the gradient-out backward wrote to W")
    torch.cuda.synchronize()
    n_eq, upd_abs = 0, {False: 0.0, True: 0.0}
    for K, N in [(FLAGSHIP[l], FLAGSHIP[l + 1]) for l in range(4)] + [(100, 37)]:
        w, d = _randn(gen, K, N, scale=0.03), _randn(gen, K, N, scale=0.003)
        b, db = _randn(gen, N, scale=0.1), _randn(gen, N, scale=0.003)
        g = _randn(gen, K * N + N, scale=0.05)
        for first, apply in ((True, True), (True, False), (False, True), (False, False)):
            for dd in (d, d.to(bf)):
                sr = 4242 if dd.dtype == bf else None
                want = dp_update_reference(w, dd, b, db, g, 0.54, 2e-3, 3e-5, sr, first, apply)
                got = dp_update(w.clone(), dd.clone(), b.clone(), db.clone(), g, 0.54, 2e-3, 3e-5,
                                sr_seed=sr, first=first, apply=apply)
                for name, a, e in zip(("w", "delta", "b", "delta_b"), got, want):
                    _check(a.dtype == e.dtype and torch.equal(a.contiguous().view(torch.uint8),
                                                              e.contiguous().view(torch.uint8)),
                           f"dp_update {K}x{N} first={first} apply={apply} {dd.dtype}: {name} is "
                           f"not bit-equal to the plain version")
                    upd_abs[dd.dtype == bf] = max(upd_abs[dd.dtype == bf],
                                                  float((a.double() - e.double()).abs().max()))
                    n_eq += a.numel()
    torch.cuda.synchronize()
    # rank_sum: 1 to 16 sources, float4 and unaligned pointers, ragged sizes, in place
    sum_abs, n_sum = 0.0, 0
    for n_src in (1, 2, 4, 16):
        for n in (FLAGSHIP[1] * FLAGSHIP[2] + FLAGSHIP[2], FLAGSHIP[3] * 129 + 129, 1001, 7):
            bufs = [_randn(gen, n + 1, scale=1e-3) for _ in range(n_src)]
            for off in (0, 1):
                srcs = [a[off:off + n] for a in bufs]
                want = rank_sum_reference(srcs, torch.empty(n, device="cuda"))
                got = rank_sum(srcs, torch.empty(n, device="cuda"))
                inplace = srcs[0].clone()
                rank_sum([inplace] + srcs[1:], inplace)
                for label, a in (("", got), (" in place", inplace)):
                    _check(torch.equal(a, want), f"rank_sum of {n_src} x {n} (offset {off}){label} "
                                                 "is not bit-equal to the plain version")
                    sum_abs = max(sum_abs, float((a.double() - want.double()).abs().max()))
                n_sum += 1
        del bufs
    torch.cuda.synchronize()
    print(f"[dp] fused_bwd_grad_out (the gradient-out backward) vs float64 plain, {len(shapes)} "
          f"shapes (a rank's 64 and 32 rows of the four flagship layers, ragged ones), 5 derivative "
          f"and mask forms (the rank's table read bit-equal to the Philox draw): float32 products max err {worst[False]['rel_max']:.3g} of max|want| "
          f"(tol {KERNEL_REL_MAX}), Frobenius {worst[False]['rel_fro']:.3g} (tol {KERNEL_REL_FRO}); "
          f"tensor cores {worst[True]['rel_max']:.3g} (tol {TC_REL_MAX}), "
          f"{worst[True]['rel_fro']:.3g} (tol {TC_REL_FRO}); W untouched; dp_update (float32 and "
          f"sr_delta delta, the four first/apply flags) bit-equal to its plain version ({n_eq} "
          f"elements); the DP forward of a rank's 64 and 32 rows (masks at its rows) layer by "
          f"layer vs float64 plain: float32 products {fwd_worst[False]['rel_max']:.3g} (tol "
          f"{KERNEL_REL_MAX}), tensor cores {fwd_worst[True]['rel_max']:.3g} (tol {TC_REL_MAX}); "
          f"rank_sum bit-equal to its plain version ({n_sum} cases, 1-16 sources)", flush=True)

    # times at a rank's rows (64 of 2 ranks, 32 of 4), each call on the next of three
    # weight sets (from device memory, not L2, as in a chunk)
    ws = [[_randn(gen, K, N, scale=0.03) for K, N in kn] for _ in range(3)]
    ds = [[torch.zeros(K, N, device="cuda") for K, N in kn] for _ in range(3)]
    ds_bf = [[torch.zeros(K, N, device="cuda", dtype=bf) for K, N in kn] for _ in range(3)]
    bs = [_randn(gen, N, scale=0.1) for _, N in kn]
    dbs = [torch.zeros(N, device="cuda") for _, N in kn]
    grads = [_randn(gen, K * N + N, scale=1e-3) for K, N in kn]
    coefs = rc._scal_coefs("parity", BUNCH, FLAGSHIP[-1], 1e-3, 0.5, 0.0)
    out = {}
    ws_bf = [[w.bfloat16() for w in wl] for wl in ws]
    bs_bf = [b.bfloat16() for b in bs]
    for M in (64, 32):
        res = {key: dict(ms=0.0, plain_ms=0.0, flops=0.0, nbytes=0.0) for key in
               ("fwd", "fwd_f32", "grad_f32", "grad_tc", "update", "update_sr")}
        x, t = _randn(gen, M, FLAGSHIP[0]), _randn(gen, M, FLAGSHIP[-1])
        for key, tc in (("fwd", True), ("fwd_f32", False)):
            fwd = rc.dp_tile_forward(cfg, M, BUNCH, tc, torch.device("cuda", 0))
            res[key]["ms"] = _device_ms(lambda i: fwd(x, t, ws[i % 3], bs, 77, M, 2.0 / BUNCH,
                                                      scratch_tallies, dp_bits[M]))

        def library_fwd(i, x_in, wl, bl):
            """The four layers as torch.addmm + act (the yardstick of row 1)."""
            h = x_in
            for l in range(4):
                h = torch.addmm(bl[l], h, wl[i % 3][l])
                h = torch.relu(h) if l < 3 else h
            return h

        x_bf = x.bfloat16()
        lib_ms = {"fwd": _device_ms(lambda i: library_fwd(i, x_bf, ws_bf, bs_bf)),
                  "fwd_f32": _device_ms(lambda i: library_fwd(i, x, ws, bs))}
        for l, (K, N) in enumerate(kn):
            dedx = _randn(gen, M, N, scale=0.02)
            y = torch.relu(_randn(gen, M, K))
            dedy = torch.empty(M, K, device="cuda")
            first = l == 0
            kw = dict(deriv=None if first else "relu", with_dedy=not first, grad=grads[l],
                      dedy=None if first else dedy)
            for tc in (False, True):
                key = "grad_tc" if tc else "grad_f32"
                res[key]["ms"] += _device_ms(lambda i: fused_bwd_grad_out(
                    dedx, y, ws[i % 3][l], bf16=tc, **kw))
                res[key]["plain_ms"] += _device_ms(lambda i: fused_bwd_grad_out_reference(
                    dedx, y, ws[i % 3][l], deriv=kw["deriv"], with_dedy=not first, bf16=tc))
                res[key]["flops"] += 2.0 * M * K * N * (1 if first else 2)
                res[key]["nbytes"] += 4.0 * (M * N + M * K + (K * N if not first else 0) + K * N
                                             + N + (M * K if not first else 0))
            for key, dl in (("update", ds), ("update_sr", ds_bf)):
                sr = 99 if key == "update_sr" else None
                res[key]["ms"] += _device_ms(lambda i: dp_update(
                    ws[i % 3][l], dl[i % 3][l], bs[l], dbs[l], grads[l], *coefs, sr_seed=sr))
                # the sr_delta plain version draws its bits in int64 tensor arithmetic: one
                # call's launches are as many as the CUDA launch queue holds
                res[key]["plain_ms"] += _device_ms(lambda i: dp_update_reference(
                    ws[i % 3][l], dl[i % 3][l], bs[l], dbs[l], grads[l], *coefs, sr),
                    reps=1 if sr else 5)
                per = 20.0 if key == "update" else 16.0  # G, W, delta read, W, delta written
                res[key]["nbytes"] += per * K * N + 20.0 * N
                res[key]["flops"] += 6.0 * K * N
            for key in ("fwd", "fwd_f32"):
                res[key]["flops"] += 2.0 * M * K * N
                res[key]["nbytes"] += 4.0 * (M * K + K * N + N + M * N)
        for key in ("fwd", "fwd_f32"):
            res[key]["nbytes"] += 4.0 * 2 * M * FLAGSHIP[-1]  # the targets read, dedx written
        for key, r in res.items():
            peak = PEAK_FP32_FLOPS if key in ("grad_f32", "fwd_f32") else PEAK_BF16_FLOPS
            t_ops, t_bytes = r["flops"] / peak * 1e3, r["nbytes"] / PEAK_BYTES_PER_S * 1e3
            r.update(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                     else "bytes", library_ms=lib_ms.get(key))
        res["fwd"]["library_is"] = ("four torch.addmm + act on bfloat16 x, W and b, output "
                                    "bfloat16 (cuBLAS's bfloat16 product, half the bytes of W)")
        res["fwd_f32"]["library_is"] = "four float32 torch.addmm + act"
        # the plain forward: the DP trainer's plain version of one tile's forward is the
        # chunk trainer's; timed as fused_linear_act_reference through the four layers
        from tpu_sednn_torch.ops.fused_mlp import fused_linear_act_reference

        def plain_fwd(i):
            h = x
            for l in range(4):
                h = fused_linear_act_reference(h, ws[i % 3][l], bs[l], "relu" if l < 3 else "linear",
                                               in_mask=(77, 0.1) if l == 0 else None,
                                               out_mask=(77 + (l + 1) * 104729, 0.2) if l < 3
                                               else None)
            return h

        # its Philox masks too: one call at a time
        res["fwd"]["plain_ms"] = res["fwd_f32"]["plain_ms"] = _device_ms(plain_fwd, reps=1)
        print(f"[dp] a rank's {M} rows of a bunch of {BUNCH} ({BUNCH // M} ranks), the four layers: "
              f"forward {res['fwd']['ms']:.4f} ms (bound {res['fwd']['bound_ms']:.4f}, bfloat16 "
              f"torch.addmm+act {res['fwd']['library_ms']:.4f}; float32 products "
              f"{res['fwd_f32']['ms']:.4f}, float32 torch.addmm+act "
              f"{res['fwd_f32']['library_ms']:.4f}), "
              f"gradient-out backward tensor cores {res['grad_tc']['ms']:.4f} ms (bound "
              f"{res['grad_tc']['bound_ms']:.4f} by {res['grad_tc']['bound_by']}, plain "
              f"{res['grad_tc']['plain_ms']:.4f}), float32 {res['grad_f32']['ms']:.4f} ms (bound "
              f"{res['grad_f32']['bound_ms']:.4f} by {res['grad_f32']['bound_by']}), update "
              f"{res['update']['ms']:.4f} ms (bound {res['update']['bound_ms']:.4f} by bytes, plain "
              f"{res['update']['plain_ms']:.4f}), sr_delta update {res['update_sr']['ms']:.4f} ms "
              f"(bound {res['update_sr']['bound_ms']:.4f})", flush=True)
        out[M] = res
    for tc in (False, True):
        key = "grad_tc" if tc else "grad_f32"
        for M in (64, 32):
            out[M][key].update(max_abs_err=worst[tc]["abs"], rel_max_err=worst[tc]["rel_max"],
                               rel_fro_err=worst[tc]["rel_fro"])
    for M in (64, 32):
        out[M]["update"]["max_abs_err"] = upd_abs[False]
        out[M]["update_sr"]["max_abs_err"] = upd_abs[True]
        out[M]["fwd"]["max_abs_err"] = fwd_worst[True]["abs"]
        out[M]["fwd_f32"]["max_abs_err"] = fwd_worst[False]["abs"]
    # rank_sum per bunch: the four layers' gradients (K*N + N floats) of 2 and 4 ranks
    sums = {}
    for n_src in (2, 4):
        r = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, nbytes=0.0)
        for K, N in kn:
            n = K * N + N
            stacked = _randn(gen, n_src, n, scale=1e-3)
            srcs, dst = list(stacked.unbind(0)), torch.empty(n, device="cuda")
            r["ms"] += _device_ms(lambda i: rank_sum(srcs, dst))
            r["plain_ms"] += _device_ms(lambda i: rank_sum_reference(srcs, dst))
            r["library_ms"] += _device_ms(lambda i: torch.sum(stacked, 0))
            r["nbytes"] += 4.0 * (n_src + 1) * n
        r.update(bound_ms=r["nbytes"] / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                 max_abs_err=sum_abs)
        sums[n_src] = r
    out["rank_sum"] = sums
    print(f"[dp] rank_sum of a bunch's four gradients: 2 ranks {sums[2]['ms']:.4f} ms (bound "
          f"{sums[2]['bound_ms']:.4f} by bytes, plain {sums[2]['plain_ms']:.4f}, torch.sum "
          f"{sums[2]['library_ms']:.4f}), 4 ranks {sums[4]['ms']:.4f} ms (bound "
          f"{sums[4]['bound_ms']:.4f})", flush=True)
    return out


def _dp_trainer_times() -> dict:
    """One rank's data-parallel chunk trainer per bunch (2 ranks: 64 rows, 4:
    32), both product forms: CUDA events around run() over 8 bunches in this
    process, the sum stubbed (a rank alone: its forward, gradient-out
    backward and update launches, nothing else); its plain version over 2
    bunches as it runs, the host's share included.  The sums are timed in the
    ranks' own run (phase_dp)."""
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.parallel import Mesh, local_rows
    from tpu_sednn_torch.train.step import init_train_state

    cfg, opt, mlp, x, t = _dp_inputs()
    n_t, n_p = 8, 2
    xt, tt = x.repeat(3, 1)[:n_t * BUNCH].contiguous(), t.repeat(3, 1)[:n_t * BUNCH].contiguous()
    coefs = rc._scal_coefs("parity", BUNCH, FLAGSHIP[-1], 1e-3, 0.5, 0.0)
    plain_sum, out = rc._all_reduce, {}
    rc._all_reduce = lambda a, mesh: a
    try:
        for w in (2, 4):
            mesh = Mesh(w, 0, torch.device("cuda", 0))
            xl, tl = (local_rows(a[:n_p * BUNCH], BUNCH, mesh) for a in (xt, tt))
            for tc in (True, False):
                run = rc.make_dp_resident_train_chunk(cfg, opt, mesh, bf16=tc)
                st = init_train_state(mlp)
                ms = _device_ms(lambda i: run(st, xt, tt, 4 + i, 1e-3, 0.5, 0.0), reps=3) / n_t
                sp = init_train_state(mlp)  # host-bound: timed as it runs, the host's share in
                plain = _time_ms(lambda: rc.dp_resident_train_chunk_reference(
                    sp, xl, tl, cfg, BUNCH, coefs, 4, mesh, bf16=tc), reps=1, warmup=1) / n_p
                out[(w, tc)] = dict(ms=ms, plain_ms=plain)
    finally:
        rc._all_reduce = plain_sum
    print("[dp] one rank's DP chunk trainer per bunch, alone (CUDA events around run(), the sum "
          "stubbed): " + ", ".join(f"{w} ranks {'tc' if tc else 'f32'} {v['ms']:.4f} ms (plain "
                                   f"{v['plain_ms']:.3f})" for (w, tc), v in out.items()),
          flush=True)
    return out


def _dp_update_off(got: list, want, init) -> tuple[float, float, float]:
    """(worst max|got - want| / max|want - init|, worst relative Frobenius
    error of the update, largest |got - want|) over the state tensors."""
    rel_max, rel_fro, abs_max = 0.0, 0.0, 0.0
    for g, w, i0 in zip(got, _state_tensors(want), _state_tensors(init)):
        g, w, upd = g.double().cuda(), w.double(), w.double() - i0.double()
        rel_max = max(rel_max, float((g - w).abs().max() / upd.abs().max().clamp(min=1e-30)))
        rel_fro = max(rel_fro, float(torch.linalg.vector_norm(g - w)
                                     / torch.linalg.vector_norm(upd).clamp(min=1e-30)))
        abs_max = max(abs_max, float((g - w).abs().max()))
    return rel_max, rel_fro, abs_max


# ---------------------------------------------------------------------------
# the multi-condition recipe (main path), at its non-small default
# ---------------------------------------------------------------------------

RECIPE_EVAL_KINDS = ("factory", "siren")  # unseen families beside the three trained on
RECIPE_BUILDER_PAIRS = 16  # corpus pairs the on-device sample builder is held on
# The sample builder against its CPU plain version: X at atol 1e-4 + rtol 1e-4
# and T (raw clean LPS) at atol 2e-2 + rtol 1e-4, tests/test_device_pipeline.py
# :43-47's limits, each plus the element's float32 rounding bound (_lps_slack;
# times inv_std in X, whose NAT columns average the first 6 frames' bounds):
# in a bin far below its frame's energy ln magnifies the rounding of any
# float32 summation order (on an H100 11 of 224,460 X elements read up to
# 0.0019, and a T element 0.0229, each within its bound)
RECIPE_X_TOL, RECIPE_T_TOL = (1e-4, 1e-4), (2e-2, 1e-4)  # (atol, rtol)


def _hold_builder(card: list, plain: list, pairs: list, cfg, inv_std, mc) -> dict:
    """Hold the sample builder's (X, T) blocks on the card against its plain
    version's: -> for X and T the largest difference, the largest ratio to
    the limit (must be <= 1) and the elements beyond the fixed limit alone."""
    from tpu_sednn_torch.data.device_pipeline import splice_device

    istd = torch.as_tensor(inv_std, dtype=torch.float64, device="cuda")
    out = {k: dict(err=0.0, ratio=0.0, beyond_fixed=0) for k in ("x", "t")}
    for (xc, tc), (xp, tp), (noisy, clean) in zip(card, plain, pairs):
        _check(xc.shape == xp.shape and tc.shape == tp.shape and xc.is_cuda,
               f"sample shapes {tuple(xc.shape)} / {tuple(xp.shape)}")
        n = xc.shape[0]
        s_n = _lps_slack(torch.from_numpy(noisy).cuda(), cfg) * istd
        s_x = splice_device(s_n, mc.fea_context)[:n]
        s_x = torch.cat([s_x, s_n[:6].mean(dim=0).expand(n, -1)], dim=1)
        s_t = _lps_slack(torch.from_numpy(clean).cuda(), cfg)[mc.targ_offset: mc.targ_offset + n]
        for key, got, want, slack, (atol, rtol) in (("x", xc, xp, s_x, RECIPE_X_TOL),
                                                   ("t", tc, tp, s_t, RECIPE_T_TOL)):
            want = want.cuda().double()
            diff, fixed = (got.double() - want).abs(), atol + rtol * want.abs()
            o = out[key]
            o["err"] = max(o["err"], float(diff.max()))
            o["ratio"] = max(o["ratio"], float((diff / (fixed + slack)).max()))
            o["beyond_fixed"] += int((diff > fixed).sum())
    for key, o in out.items():
        _check(o["ratio"] <= 1.0, f"sample builder {key.upper()} off its plain version by "
                                  f"{o['ratio']:.3g} of the limit")
    return out


def _finite_numbers(tree, path="eval") -> list:
    """[(path, value)] of every number in a nested dict of results that is not finite."""
    if isinstance(tree, dict):
        return [bad for k, v in tree.items() for bad in _finite_numbers(v, f"{path}.{k}")]
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return [] if np.isfinite(tree) else [(path, tree)]
    return []


def phase_recipe(tmp: str, smi: str) -> dict:
    """The multi-condition recipe (main path): python -m
    tpu_sednn_torch.recipes.multi_condition's non-small default run on the
    card, 1548-2048x3-129 at 8 kHz, PSM head, parity dropout 0.1/0.2, bunch
    128, 120 utterances x 6 SNRs x white/pink/babble, 15 epochs, scored on
    the trained families and on factory and siren; then the on-device sample
    builder (data/device_pipeline.py, the STFT kernel) on the recipe's first
    corpus pairs.  Launch counts run from just before the recipe to just after
    the builder."""
    from tpu_sednn_torch.data.device_pipeline import streaming_sample_batches
    from tpu_sednn_torch.data.mixing import synth_corpus
    from tpu_sednn_torch.enhance import enhance_waveform
    from tpu_sednn_torch.model import ModelConfig
    from tpu_sednn_torch.ops import launch_counts, reset_launch_counts
    from tpu_sednn_torch.recipes import load_run_dir
    from tpu_sednn_torch.recipes import multi_condition as tmc
    from tpu_sednn_torch.utils.checkpoint import restore_checkpoint
    from tpu_sednn_torch.utils.logging import Logger

    out_dir = os.path.join(tmp, "recipe")
    metrics = os.path.join(tmp, "recipe_metrics.jsonl")
    mc = tmc.MultiConditionConfig(out_dir=out_dir, eval_noise_kinds=RECIPE_EVAL_KINDS)
    _check(mc.device == "cuda" and mc.hidden == (2048,) * 3 and mc.head == "psm"
           and mc.sample_rate == 8000 and mc.n_epochs == 15 and mc.n_utts == 120,
           f"the recipe's non-small default changed: {mc}")
    reset_launch_counts()  # the path's run starts here
    t0 = time.perf_counter()
    res = tmc.run_multi_condition(mc, logger=Logger(stream=sys.stdout, metrics_path=metrics))
    wall = time.perf_counter() - t0
    after_recipe = launch_counts()
    stages = {r["stage"]: r["seconds"] for r in map(json.loads, open(metrics))
              if r.get("event") == "stage"}
    _check(list(stages) == ["corpus", "featurize", "targets", "train", "eval"],
           f"recipe stages {list(stages)}")
    print(f"[recipe] {wall:.1f} s: " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items())
          + f"; training {res['train_samples_per_sec']:.0f} samples/s (the epoch loop by the "
          f"host clock, CV included); {smi}", flush=True)

    cv = res["cv_hist"]
    _check(len(cv) == mc.n_epochs and cv[-1] < cv[0], f"recipe CV did not fall: {cv}")
    bad = _finite_numbers(res["eval"])
    _check(not bad, f"recipe eval numbers not finite: {bad}")
    s0 = res["eval"]["synthetic_0dB"]
    _check(s0["snr_enh"] > s0["snr_noisy"] and s0["stoi_enh"] > s0["stoi_noisy"],
           f"recipe did not improve the 0 dB clip: {s0}")
    gen = res["eval"]["noise_generalization"]
    _check(set(gen["per_kind"]) == set(mc.noise_kinds) | set(RECIPE_EVAL_KINDS),
           f"noise families scored: {sorted(gen['per_kind'])}")
    print(f"[recipe] CV {cv[0]:.4f} -> {cv[-1]:.4f}; synthetic 0 dB SNR {s0['snr_noisy']:.2f} -> "
          f"{s0['snr_enh']:.2f} dB, STOI {s0['stoi_noisy']:.4f} -> {s0['stoi_enh']:.4f}, PESQ(est) "
          f"{s0['pesq_noisy']:.3f} -> {s0['pesq_enh']:.3f}, CSIG/CBAK/COVL {s0['csig_enh']:.3f} / "
          f"{s0['cbak_enh']:.3f} / {s0['covl_enh']:.3f}; LSD gain seen {gen['seen']['lsd_gain']:+.3f}"
          f" dB, unseen {gen['unseen']['lsd_gain']:+.3f} dB", flush=True)

    # the run dir decodes as the recipe did: run.json + mlp.final.wts + fea.norm through
    # load_run_dir against the recipe's final state (its last checkpoint) and config
    params, mcfg, ecfg, mean, istd, tn, gv = load_run_dir(out_dir, device="cuda")
    state, extra, _ = restore_checkpoint(os.path.join(out_dir, "ckpt"), device="cuda")
    want_mcfg = ModelConfig(layersizes=tuple(extra["layersizes"]), dropout_vis=mc.dropout[0],
                            dropout_hid=mc.dropout[1], dropout_mode="parity", output="sigmoid")
    _check(extra["cv_hist"] == cv and ecfg == tmc._enhance_config(mc) and mcfg == want_mcfg
           and mcfg.layersizes == FLAGSHIP and tn is None and gv is None,
           f"the run dir's decode config differs from the recipe's: {mcfg}, {ecfg}")
    _check(all(torch.equal(a, b) for a, b in zip(list(params.w) + list(params.b),
                                                 list(state.params.w) + list(state.params.b))),
           "mlp.final.wts differs from the recipe's final state")
    _, cl, nz = tmc.synthetic_eval_clips(mc)[0]
    again = enhance_waveform(params, mcfg, ecfg, nz, mean, istd, device="cuda")
    own = enhance_waveform(state.params, mcfg, ecfg, nz, mean, istd, device="cuda")
    _check(np.array_equal(again, own), "the reloaded decoder's 0 dB clip differs from the recipe's")
    rescored = tmc.score_synthetic(cl, nz, again, mc.sample_rate)
    _check(rescored == s0, f"the reloaded decoder scores {rescored}, the recipe {s0}")
    print("[recipe] run.json + mlp.final.wts + fea.norm reload through load_run_dir into the "
          "recipe's decode config; the 0 dB clip decodes bit for bit as the recipe's final state "
          "does and scores exactly the recipe's synthetic_0dB block", flush=True)

    # module 7: the recipe corpus's first pairs -> samples on the card (the STFT kernel)
    n_pairs = RECIPE_BUILDER_PAIRS
    cleans, noisys = synth_corpus(mc.seed, n_pairs, sr=mc.sample_rate, snrs=mc.snrs,
                                  noise_kinds=mc.noise_kinds)
    pairs = list(zip(noisys, cleans))
    kw = dict(cfg=ecfg.stft, fea_context=mc.fea_context, targ_offset=mc.targ_offset, nat=True)
    stft_before = launch_counts()["stft_lps"]
    t1 = time.perf_counter()
    card = [(x, t) for x, t in streaming_sample_batches(pairs, mean, istd, device="cuda", **kw)]
    torch.cuda.synchronize()
    builder_s = time.perf_counter() - t1
    n_stft_builder = launch_counts()["stft_lps"] - stft_before
    counts = launch_counts()
    t1 = time.perf_counter()
    plain = list(streaming_sample_batches(pairs, mean, istd, device="cpu", **kw))
    plain_s = time.perf_counter() - t1
    _check(len(card) == len(plain) == n_pairs and n_stft_builder == 2 * n_pairs,
           f"{len(card)} / {len(plain)} sample blocks, {n_stft_builder} stft_lps launches")
    held = _hold_builder(card, plain, pairs, ecfg.stft, istd, mc)
    hx, ht = held["x"], held["t"]
    n_samples = sum(x.shape[0] for x, _ in card)
    print(f"[recipe] on-device sample builder: {n_pairs} corpus pairs -> {n_samples} samples of "
          f"{card[0][0].shape[1]} + {card[0][1].shape[1]} on the card ({n_stft_builder} stft_lps "
          f"launches, {builder_s * 1e3:.1f} ms by the host clock; the CPU plain version "
          f"{plain_s * 1e3:.1f} ms); max |x - plain| {hx['err']:.3g}, {hx['ratio']:.3f} of atol "
          f"1e-4 + rtol 1e-4 + the float32 rounding bound ({hx['beyond_fixed']} elements beyond "
          f"the fixed part alone); max |t - plain| {ht['err']:.3g}, {ht['ratio']:.3f} of atol 2e-2 "
          f"+ rtol 1e-4 + the bound ({ht['beyond_fixed']} beyond the fixed part)", flush=True)

    kc = counts["resident_chunk_kernels"]
    _check(counts["resident_chunk"] > 0 and kc["tc_linear_act"] > 0 and kc["tc_bwd_update"] > 0
           and kc["philox_mask"] > 0 and counts["plain_train_chunk"] == 0
           and kc["input_mask_table"] == counts["resident_chunk"] and kc["input_mask_philox"] == 0
           and after_recipe["stft_lps"] == 0,
           f"recipe path launches {counts}")
    print(f"[recipe] launches: chunk trainer {counts['resident_chunk']} calls (tensor cores; the "
          f"plain trainer {counts['plain_train_chunk']}), {kc['tc_linear_act']} tc_fwd, "
          f"{kc['tc_bwd_update']} tc_bwd, {kc['philox_mask']} with masks, {kc['pdl']} dependent; "
          f"stft_lps {counts['stft_lps']}", flush=True)
    return dict(counts={k: v for k, v in counts.items() if isinstance(v, int)}, kernel_counts=kc,
                stages=stages, wall_s=wall, cv_hist=cv, synthetic_0dB=s0,
                synthetic_5dB=res["eval"]["synthetic_5dB"],
                noise_generalization={k: gen[k] for k in ("seen", "unseen", "gap")},
                train_samples_per_sec=res["train_samples_per_sec"],
                builder=dict(pairs=n_pairs, samples=n_samples, ms=builder_s * 1e3,
                             plain_ms=plain_s * 1e3, held=held))


def _dp_mask_counts(c: dict, label: str) -> None:
    """A data-parallel run with input dropout (rank 0's launch_counts, zeroed
    just before it) draws its rows of a call's input masks once a call into
    their table (input_mask_table one a call) and no layer-0 launch draws
    them by Philox: not the forward, not the gradient-out backward
    (input_mask_philox, fused_bwd_grad_out_philox 0)."""
    k = c["resident_chunk_kernels"]
    _check(k["input_mask_table"] == c["dp_resident_chunk"] == c["input_mask_bits"] > 0
           and k["input_mask_philox"] == 0 and c["fused_bwd_grad_out_philox"] == 0,
           f"{label}: {k['input_mask_table']} input-mask draws, {c['input_mask_bits']} launches "
           f"of the draw, in {c['dp_resident_chunk']} calls; layer-0 launches that drew Philox "
           f"{k['input_mask_philox']} (the gradient-out backward's "
           f"{c['fused_bwd_grad_out_philox']})")


def phase_dp(tmp: str, smi: str, train_ran: bool) -> dict:
    """(a) kernel holds and times, (b) the DP chunk trainer on 2 and 4 ranks
    sharing the card (gloo) against the single-process trainer, (c) the
    command with gpu_used=2 under torchrun against gpu_used=1."""
    from tpu_sednn_torch.io import load_wts, save_wts
    from tpu_sednn_torch.model.mlp import init_params, params_to_wts
    from tpu_sednn_torch.ops import resident_chunk as rc
    from tpu_sednn_torch.tools import make_pfile
    from tpu_sednn_torch.train.step import init_train_state

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    kern = _dp_kernels(gen)
    torch.cuda.empty_cache()
    alone = _dp_trainer_times()
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    # the corpus of phase_train, or a small one of the same kind
    n_utt = 200 if train_ran else 40
    corpus = _corpus_paths(tmp, n_utt)
    if not train_ran:
        noisy, clean = _corpus_wavs(tmp, n_utt)
        make_pfile.build_pfile(noisy, corpus["fea"], corpus["norm"], device="cuda")
        make_pfile.build_pfile(clean, corpus["targ"], f"{tmp}/clean.norm", normalize=True,
                               device="cuda")
    lo, hi = (int(v) for v in corpus["cv_range"].split("-"))

    # (b) four ranks on the card, gloo; two of them again in a group of two
    t0 = time.perf_counter()
    workdir = os.path.join(tmp, "dp")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump({"epoch": dict(fea_file=corpus["fea"], targ_file=corpus["targ"],
                                 norm_file=corpus["norm"], fea_dim=129, fea_context=11,
                                 targ_offset=5, train_sent_range=[0, 1], cv_sent_range=[lo, hi],
                                 traincache=102400, seed=11)}, f)
    world = 4
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-worker", str(r),
                               str(world), workdir], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        _check(p.returncode == 0, f"DP rank {r} of {world} failed (rc {p.returncode}):\n{o[-4000:]}")
    t_spawn = time.perf_counter() - t0
    with open(os.path.join(workdir, "rank0.json")) as f:
        r0 = json.load(f)
    hashes = [r0["hashes"]] + [json.load(open(os.path.join(workdir, f"rank{r}.json")))["hashes"]
                                for r in range(1, world)]
    cfg, opt, mlp, x, t = _dp_inputs()
    init = init_train_state(mlp)
    singles = {}
    held = {}
    for name, w, tc, n_b, extra in DP_CASES:
        key = (tc, n_b, bool(extra.get("sr_delta")))
        if key not in singles:
            singles[key] = rc.make_resident_train_chunk(cfg, opt, bf16=tc,
                                                        sr_delta=key[2])(
                init_train_state(mlp), x[:n_b * BUNCH], t[:n_b * BUNCH], 17, *DP_HYP)
            torch.cuda.synchronize()
        single = singles[key]
        saved = torch.load(os.path.join(workdir, f"{name}.pt"))
        got, step = saved[:-1], saved[-1]
        equal = all(hashes[r][name] == hashes[0][name] for r in range(w))
        rel_max, rel_fro, abs_max = _dp_update_off(got, single, init)
        held[name] = dict(rel_max=rel_max, rel_fro=rel_fro, abs=abs_max, replicas_equal=equal)
        sr = bool(extra.get("sr_delta"))
        three_tol = SR_DELTA_FRO if sr else DP_THREE_REL_FRO
        if sr:  # the share of delta_w's bfloat16 values apart from the single-process run's
            held[name]["sr_share"] = max(float((_bits16(got[8 + l].cuda())
                                                != _bits16(single.deltas.w[l])).float().mean())
                                         for l in range(4))
        if "fault" in extra:
            off, tol = (rel_max, DP_ONE_REL_MAX) if n_b == 1 else (rel_fro, three_tol)
            _check(off > tol or (sr and held[name]["sr_share"] > SR_DIFF_SHARE),
                   f"DP {name} (a deliberate fault) passes: update off by {off:.3g} (tol {tol})")
            continue
        _check(equal, f"DP {name}: the {w} replicas are not bit-equal")
        _check(step == single.step == n_b, f"DP {name}: step {step}, single {single.step}")
        if sr and n_b == 1:  # delta_w rounded stochastically: one ulp where G's order decides
            sr_stats = {}
            for l in range(4):
                _hold_sr(got[8 + l].cuda(), single.deltas.w[l], f"DP {name} delta_w[{l}]", sr_stats)
            rel_max, _, _ = _dp_update_off(got[:8], single, init)
            held[name]["rel_max"] = rel_max
        elif sr:
            _check(held[name]["sr_share"] <= SR_DIFF_SHARE,
                   f"DP {name}: {held[name]['sr_share']:.3g} of delta_w apart after {n_b} bunches "
                   f"(limit {SR_DIFF_SHARE})")
        if n_b == 1:
            _check(rel_max <= DP_ONE_REL_MAX, f"DP {name}: update off the single-process trainer by "
                                              f"{rel_max:.3g} of max|update| (tol {DP_ONE_REL_MAX})")
        else:
            _check(rel_fro <= three_tol, f"DP {name}: update off by {rel_fro:.3g} relative "
                                         f"Frobenius after {n_b} bunches (tol {three_tol})")
    print(f"[dp] chunk trainer on 2 and 4 ranks sharing the card (gloo), 1548-2048x3-129, parity "
          f"dropout 0.1/0.2, against the single-process trainer with the same seed: after one "
          f"bunch max|update| off by " + ", ".join(
              f"{n} {held[n]['rel_max']:.2g}" for n in held if n.endswith("_1"))
          + f" (tol {DP_ONE_REL_MAX}); after three, relative Frobenius " + ", ".join(
              f"{n} {held[n]['rel_fro']:.2g}" for n in held if n.endswith("_3"))
          + f" (tol {DP_THREE_REL_FRO}; sr_delta {SR_DELTA_FRO}); sr_delta one bunch "
          f"{held['w2_sr_delta_1']['rel_max']:.2g}, delta_w bit-equal but a "
          f"{held['w2_sr_delta_1']['sr_share']:.2g} share "
          f"({held['w2_sr_delta_f32_3']['sr_share']:.2g} after three, float32 products); replicas bit-equal in every run; refused: "
          + ", ".join(f"{n} {held[n]['rel_max']:.3g}" for n in held
                      if "no_allreduce" in n or "row0" in n)
          + " of max|update|, " + ", ".join(f"{n} {held[n]['rel_fro']:.3g}" for n in held
                                              if "mask_key" in n or "sr_key" in n)
          + f" relative Frobenius after three (w2_sr_key: {held['w2_sr_key']['sr_share']:.3g} of "
            f"delta_w apart)", flush=True)
    timing = {int(k): v for k, v in r0["timing"].items()}
    for w, v in sorted(timing.items()):
        print(f"[dp] {w} ranks sharing {smi}: {v['bunch_ms']:.3f} ms per bunch of {BUNCH} by the "
              f"host clock, of which the sums on the card ({v['allreduce_mb']:.1f} MB a bunch from "
              f"each rank: staging copy, synchronise, gloo barrier, rank_sum kernel "
              f"{kern['rank_sum'][w]['ms']:.4f} ms) {v['allreduce_ms']:.3f} ms; one rank's "
              f"trainer alone {alone[(w, True)]['ms']:.4f} ms (forward "
              f"{kern[BUNCH // w]['fwd']['ms']:.4f}, gradient-out backward "
              f"{kern[BUNCH // w]['grad_tc']['ms']:.4f}, update "
              f"{kern[BUNCH // w]['update']['ms']:.4f} ms, each timed alone)", flush=True)
    # the in-process epochs of the ranks: float32 products and sr_delta, against one process
    from tpu_sednn_torch.data.rand48 import Rand48
    from tpu_sednn_torch.train.loop import train_epoch_pfile
    from tpu_sednn_torch.train.step import OptConfig
    from tpu_sednn_torch.utils.logging import Logger

    job = json.load(open(os.path.join(workdir, "job.json")))["epoch"]
    job = {k: tuple(v) if isinstance(v, list) else v for k, v in job.items()}
    epochs = {}
    for label, kw, frac in (("f32", {"bf16": False}, 1e-3), ("sr_delta", {"sr_delta": True},
                                                              SR_CV_FRACTION)):
        cfg_cmd = _flagship_cfg(dropout_vis=0.1, dropout_hid=0.2)
        st = init_train_state(init_params(torch.Generator().manual_seed(11), cfg_cmd,
                                          scheme="glorot", device="cuda"))
        _, res = train_epoch_pfile(st, cfg_cmd, OptConfig(lrate=0.1, momentum=0.5, weightcost=0.0,
                                                          bunchsize=BUNCH), **job, rand=Rand48(11),
                                   engine="resident", engine_kwargs=kw,
                                   logger=Logger(stream=None))
        dp = r0["epochs"][label]
        off = abs(dp["cv"] - res.cv_mse) / res.cv_mse
        c = dp["counts"]
        n_bunches = c["dp_update"] // 4
        _check(np.isfinite(dp["cv"]) and off <= frac and c["dp_resident_chunk"] >= 1
               and n_bunches > 0 and c["fused_bwd_grad_out"] == 4 * n_bunches
               and c["rank_sum"] == 4 * n_bunches
               and c["resident_chunk"] == 0 and c["plain_train_chunk"] == 0,
               f"DP pfile epoch ({label}) on {world} ranks: CV {dp['cv']} vs one process "
               f"{res.cv_mse} ({off:.3g} apart, tol {frac}); counts {c}")
        _dp_mask_counts(c, f"DP pfile epoch ({label}) on {world} ranks")
        epochs[label] = dict(cv=dp["cv"], cv_one=res.cv_mse, off=off, counts=c)
        print(f"[dp] train_epoch_pfile on {world} ranks (sentences 0-1, {n_bunches} bunches), "
              f"{label}: CV {dp['cv']:.6f}, one process {res.cv_mse:.6f} ({off:.3g} apart, tol "
              f"{frac}); rank 0 launched {c['fused_bwd_grad_out']} gradient-out backwards "
              f"({c['fused_bwd_grad_out_tc']} tensor-core), {c['dp_update']} updates "
              f"({c['dp_update_sr']} sr_delta), {c['rank_sum']} sums on the card", flush=True)
    t_b = time.perf_counter() - t0

    # (c) the command: torchrun, 2 ranks, gpu_used=2, tensor cores, dropout on, against
    # gpu_used=1 on the same sentences from the same weights
    t0 = time.perf_counter()
    init_wts = f"{tmp}/mlp.1.wts"
    if not os.path.exists(init_wts):
        init_wts = f"{tmp}/dp_init.wts"
        save_wts(init_wts, *params_to_wts(init_params(torch.Generator().manual_seed(5),
                                                      _flagship_cfg(), device="cpu")))
    common = ["dropoutflag=1", "momentum=0.5", "init_randem_seed=11", "engine=auto"]
    report = os.path.join(tmp, "launches_dp2.json")
    args2 = _train_args(tmp, corpus, "dp2", init_wts, "0-19", common + ["gpu_used=2"])
    t_cmd = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", "-m", "tpu_sednn_torch.cli"] + args2, cwd=ROOT,
                          env=dict(os.environ, TPU_SEDNN_TORCH_LAUNCH_REPORT=report),
                          capture_output=True, text=True, timeout=900)
    wall2 = time.perf_counter() - t_cmd
    _check(proc.returncode == 0, f"torchrun gpu_used=2 failed:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
    _check(proc.stdout.count("all finish!") == 1 and "backend gloo" in proc.stderr,
           "torchrun gpu_used=2: not one 'all finish!' or no gloo backend line")
    log2 = open(f"{tmp}/dp2.log").read()
    cv2 = [float(l.rsplit(":", 1)[1]) for l in log2.splitlines() if l.startswith("CV over.")]
    _check(len(cv2) == 1 and np.isfinite(cv2[0]), f"gpu_used=2: CV lines {cv2}")
    cv1, c1 = _epoch_in_process(tmp, _train_args(tmp, corpus, "dp1", init_wts, "0-19", common),
                                "gpu_used=1 twin", engine_kwargs={})
    c2 = json.load(open(report))
    chunk_sizes = [int(l.split()[-2]) for l in log2.splitlines() if l.startswith("Starting chunk")]
    n_bunches = sum(c // BUNCH for c in chunk_sizes)
    k2 = c2["resident_chunk_kernels"]
    _check(c2["dp_resident_chunk"] == len(chunk_sizes) and c2["resident_chunk"] == 0
           and c2["plain_train_chunk"] == 0 and c2["fused_bwd_grad_out_tc"] == 4 * n_bunches
           and c2["fused_bwd_grad_out"] == 4 * n_bunches and c2["dp_update"] == 4 * n_bunches
           and c2["rank_sum"] == 4 * n_bunches
           and k2["tc_linear_act"] == k2["fused_linear_act"] == 4 * n_bunches
           and k2["fused_bwd_update"] == 0 and c1["resident_chunk"] == len(chunk_sizes),
           f"gpu_used=2 launches {c2} for {n_bunches} bunches; gpu_used=1 {c1}")
    _dp_mask_counts(c2, "torchrun gpu_used=2")
    (w2, b2), (w1, b1), (w0, b0) = (load_wts(f, layersizes=list(FLAGSHIP)) for f in
                                    (f"{tmp}/dp2.wts", f"{tmp}/dp1.wts", init_wts))
    upd = max(float(np.linalg.norm(a - b) / np.linalg.norm(b - c))
              for a, b, c in zip(w2 + b2, w1 + b1, w0 + b0))
    cv_off = abs(cv2[0] - cv1) / cv1
    _check(cv_off <= DP_CV_FRACTION and upd <= TC_ENGINE_REL_FRO,
           f"gpu_used=2 vs gpu_used=1: CV {cv2[0]} vs {cv1} ({cv_off:.3g} apart, tol "
           f"{DP_CV_FRACTION}), update off by {upd:.3g} (tol {TC_ENGINE_REL_FRO})")
    secs = [float(l.split()[3]) for l in log2.splitlines() if l.startswith("Total cost time:")]
    n_samples = int(next(l for l in log2.splitlines()
                         if l.startswith("Training sentences have")).split()[5])
    t_c = time.perf_counter() - t0
    print(f"[dp] python -m torch.distributed.run --nproc_per_node=2 -m tpu_sednn_torch.cli ... "
          f"gpu_used=2 (2 ranks sharing {smi}, gloo, tensor cores, parity dropout 0.1/0.2, "
          f"sentences 0-19: {n_bunches} bunches): CV MSE {cv2[0]:.6f}, gpu_used=1 {cv1:.6f} "
          f"({cv_off:.3g} apart, tol {DP_CV_FRACTION}); the epoch's update within {upd:.3g} "
          f"relative Frobenius (tol {TC_ENGINE_REL_FRO}); epoch {secs[0]:.1f} s by rank 0's clock "
          f"= {n_samples / secs[0]:.0f} samples/s, command wall {wall2:.1f} s; rank 0 launched "
          f"{c2['fused_bwd_grad_out_tc']} tensor-core gradient-out backwards, {c2['dp_update']} "
          f"updates, {c2['rank_sum']} sums on the card, {k2['tc_linear_act']} tensor-core "
          f"forwards; [dp] phase (a) {t_a:.1f} s, "
          f"(b) {t_b:.1f} s (the ranks' spawn and runs {t_spawn:.1f} s), (c) {t_c:.1f} s",
          flush=True)
    return dict(kern=kern, alone={f"{w}_{'tc' if tc else 'f32'}": v for (w, tc), v in alone.items()},
                held=held, timing=timing, epochs=epochs,
                cmd=dict(cv=cv2[0], cv_one=cv1, cv_off=cv_off, update_off=upd, counts=c2,
                         n_bunches=n_bunches, epoch_s=secs[0], wall_s=wall2),
                seconds=dict(a=t_a, b=t_b, c=t_c))


# ---------------------------------------------------------------------------
# tensor parallelism and the recipe's data-parallel branch (main paths, dp group)
# ---------------------------------------------------------------------------

# the 8 kHz net with its head cut to 128 outputs, the nearest width that
# n_model 2 and 4 divide: the JAX package refuses to model-shard the 129-wide
# head (and the 257-wide one), and so does the port
TP_SIZES = FLAGSHIP[:-1] + (128,)
TP_BUNCHES = 16
TP_HYP = (0.1, 0.5, 0.0)  # lrate, momentum, weightcost
# after 2 bunches against the single-process plain trainer on the card:
# tests/test_parallel.py's limits for the JAX trainer (rtol, atol), each
# element within them of the plain trainer's float32 run or of its float64
# one.  At these widths a pre-activation within float32 rounding of 0 takes
# its sign from the order of a sum: on an H100 the 1 x 2 run read 1.18e-5 off
# the float32 plain run, 1,423 of its elements within the limit of the
# float64 run alone, while the 2 x 2 run read 7.5e-9 off the float32 run, so
# neither run alone is the reference; a missing sum misses both by far
TP_TOL = (1e-5, 1e-6)
# (name, layer sizes, mesh (n_data, n_model), shard_model_axis)
TP_RUNS = (("1x2", TP_SIZES, (1, 2), True), ("2x2", TP_SIZES, (2, 2), True),
           ("2x2_whole", FLAGSHIP, (2, 2), False))
TP_SEED = 17  # the dropout generator's seed


def _tp_inputs(sizes):
    """The net, state and 16 bunches of a [tp] run, the same in every
    process: parity dropout 0.1/0.2, glorot weights from seed 3, inputs and
    targets from numpy's seed 5."""
    from tpu_sednn_torch.model.mlp import ModelConfig, init_params
    from tpu_sednn_torch.train.step import OptConfig

    cfg = ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
    opt = OptConfig(lrate=TP_HYP[0], momentum=TP_HYP[1], weightcost=TP_HYP[2], bunchsize=BUNCH)
    mlp = init_params(torch.Generator().manual_seed(3), cfg, scheme="glorot", device="cuda")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((TP_BUNCHES * BUNCH, sizes[0])).astype(np.float32)
    t = x @ (0.05 * rng.standard_normal((sizes[0], sizes[-1]))).astype(np.float32)
    return cfg, opt, mlp, torch.from_numpy(x).cuda(), torch.from_numpy(t).cuda()


def _tp_sums_a_chunk(n_layers: int, n_bunches: int, n_data: int, sharded: bool) -> int:
    """rank_sum launches of one rank's tensor-parallel chunk on a shared
    card: per bunch a gather of each layer's columns and a sum of dedy below
    each layer but the first over "model", one sum of the gradients over
    "data"; at the chunk's end a gather of each of the 4 L state tensors."""
    per_bunch = (2 * n_layers - 1 if sharded else 0) + (n_data > 1)
    return n_bunches * per_bunch + (4 * n_layers if sharded else 0)


def tp_worker(rank: int, world: int, workdir: str) -> int:
    """One rank of phase_tp's runs (python3 chip_smoke.py --tp-worker RANK
    WORLD DIR): each TP_RUNS run for 2 bunches and then for 16 (timed, the
    collectives timed on their own), a run with the "model" sum of dedy
    skipped, and the full 129-wide net asked to shard its head; rank 0
    writes the states and what it measured into DIR."""
    import torch.distributed as dist

    import tpu_sednn_torch.parallel.mesh as pm
    from tpu_sednn_torch.ops import launch_counts, reset_launch_counts
    from tpu_sednn_torch.parallel import Mesh, make_auto_sharded_train_chunk, make_mesh
    from tpu_sednn_torch.train.step import init_train_state

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", world_size=world,
                            rank=rank)
    dev = torch.device("cuda", 0)
    pair = dist.new_group([0, 1])  # the 1 x 2 mesh of ranks 0 and 1
    meshes = {"1x2": (Mesh(1, 0, dev, n_model=2, model_index=rank, model_group=pair), pair),
              "2x2": (make_mesh(2, 2, devices=[dev]), None)}
    plain_sum, plain_gather = pm.all_reduce, pm.all_gather_cols
    out = dict(hashes={}, timing={})

    def save(st, name):
        out["hashes"][name] = _state_bytes(st)
        if rank == 0:
            torch.save([a.cpu() for a in _state_tensors(st)] + [st.step],
                       os.path.join(workdir, f"{name}.pt"))

    reset_launch_counts()  # the path's runs start here
    for name, sizes, shape, shard in TP_RUNS:
        mesh, barrier_group = meshes[f"{shape[0]}x{shape[1]}"]
        if rank >= shape[0] * shape[1]:
            continue
        cfg, opt, mlp, x, t = _tp_inputs(sizes)
        run = make_auto_sharded_train_chunk(cfg, opt, mesh, shard_model_axis=shard)
        st = run(init_train_state(mlp), x[:2 * BUNCH], t[:2 * BUNCH],
                 torch.Generator().manual_seed(TP_SEED), *TP_HYP)
        torch.cuda.synchronize()
        save(st, f"{name}_2")
        spent = []

        def timed(fn):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*args, **kwargs)
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t0)
                return r
            return call

        st = init_train_state(mlp)
        pm.all_reduce, pm.all_gather_cols = timed(plain_sum), timed(plain_gather)
        dist.barrier(group=barrier_group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(st, x, t, torch.Generator().manual_seed(TP_SEED), *TP_HYP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pm.all_reduce, pm.all_gather_cols = plain_sum, plain_gather
        save(st, f"{name}_{TP_BUNCHES}")
        out["timing"][name] = dict(bunch_ms=wall * 1e3 / TP_BUNCHES,
                                   collectives_ms=sum(spent) * 1e3 / TP_BUNCHES)
    out["counts"] = launch_counts()
    # the deliberately broken run: dedy not summed over "model" (1 x 2, 2 bunches)
    if rank < 2:
        cfg, opt, mlp, x, t = _tp_inputs(TP_SIZES)
        pm.all_reduce = lambda a, m, axis="data": a if axis == "model" else plain_sum(a, m, axis)
        st = make_auto_sharded_train_chunk(cfg, opt, meshes["1x2"][0])(
            init_train_state(mlp), x[:2 * BUNCH], t[:2 * BUNCH],
            torch.Generator().manual_seed(TP_SEED), *TP_HYP)
        torch.cuda.synchronize()
        pm.all_reduce = plain_sum
        save(st, "fault_no_model_sum")
    # the 129-wide head cannot be sharded over 2 model ranks, as in JAX
    cfg, opt, mlp, x, t = _tp_inputs(FLAGSHIP)
    try:
        make_auto_sharded_train_chunk(cfg, opt, meshes["2x2"][0])(
            init_train_state(mlp), x[:BUNCH], t[:BUNCH], torch.Generator(), *TP_HYP)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    dist.barrier()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out if rank == 0 else dict(hashes=out["hashes"]), f)
    dist.destroy_process_group()
    return 0


def _other_launches(counts: dict) -> dict:
    """Every launch counter but rank_sum's that is not 0: the tensor-parallel
    and the recipe's data-parallel paths launch no other kernel (the recipe
    featurizes by matmuls, as the JAX recipe does with its XLA STFT)."""
    flat = dict(counts, **{f"resident_chunk_kernels.{k}": v
                           for k, v in counts.get("resident_chunk_kernels", {}).items()})
    return {k: v for k, v in flat.items() if isinstance(v, int) and v and k != "rank_sum"}


def _tp_hold(got: list, want, want64) -> dict:
    """assert_allclose's hold of the state tensors against two references,
    the plain trainer's float32 run and its float64 one: per element
    |got - want| / (atol + rtol |want|) for each, the smaller of the two
    must be <= 1.  -> the largest |got - want| (float32), the largest ratio
    to the float32 run alone, the largest held ratio, and the elements held
    by the float64 run alone."""
    rtol, atol = TP_TOL
    out = dict(max_abs_err=0.0, ratio_f32=0.0, tol_ratio=0.0, by_f64_alone=0)
    for g, w, w64 in zip(got, _state_tensors(want), _state_tensors(want64)):
        g = g.cuda().double()
        r32, r64 = ((g - a.double()).abs() / (atol + rtol * a.double().abs()) for a in (w, w64))
        out["max_abs_err"] = max(out["max_abs_err"], float((g - w.double()).abs().max()))
        out["ratio_f32"] = max(out["ratio_f32"], float(r32.max()))
        out["tol_ratio"] = max(out["tol_ratio"], float(torch.minimum(r32, r64).max()))
        out["by_f64_alone"] += int(((r32 > 1.0) & (r64 <= 1.0)).sum())
    return out


def phase_tp(tmp: str, smi: str) -> dict:
    """The tensor-parallel trainer (parallel.make_auto_sharded_train_chunk) on
    4 ranks of this script sharing the card (gloo; the sums and the column
    gathers on the card through CUDA IPC, rank_sum): 1548-2048x3-128 on 1 x 2
    and on 2 x 2 with the model axis sharded, 1548-2048x3-129 on 2 x 2
    unsharded, parity dropout 0.1/0.2, bunch 128, lrate 0.1, momentum 0.5;
    each after 2 bunches against the single-process reference_train_chunk on
    the card (rtol 1e-5 / atol 1e-6) and after 16 (the drift printed), every
    rank's state bit-equal, a skipped "model" sum refused, the 129-wide head
    refused to shard; ms a bunch, the collectives' share, rank_sum launches.
    Each element is held against the plain trainer's float32 run or its
    float64 run (TP_TOL's comment says why)."""
    from tpu_sednn_torch.train.step import OptConfig, init_train_state, reference_train_chunk

    t0 = time.perf_counter()
    workdir = os.path.join(tmp, "tp")
    os.makedirs(workdir, exist_ok=True)
    world = 4
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker", str(r),
                               str(world), workdir], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        _check(p.returncode == 0, f"TP rank {r} of {world} failed (rc {p.returncode}):\n{o[-4000:]}")
    t_spawn = time.perf_counter() - t0
    r0 = json.load(open(os.path.join(workdir, "rank0.json")))
    hashes = [r0["hashes"]] + [json.load(open(os.path.join(workdir, f"rank{r}.json")))["hashes"]
                               for r in range(1, world)]
    held, refs, single_ms = {}, {}, {}
    for name, sizes, (n_data, n_model), shard in TP_RUNS:
        cfg, opt, mlp, x, t = _tp_inputs(sizes)
        ranks = n_data * n_model
        for n_b in (2, TP_BUNCHES):
            key = f"{name}_{n_b}"
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            want = reference_train_chunk(init_train_state(mlp), x[:n_b * BUNCH], t[:n_b * BUNCH],
                                         cfg, opt, generator=torch.Generator().manual_seed(TP_SEED))
            torch.cuda.synchronize()
            single_ms[sizes] = (time.perf_counter() - t1) * 1e3 / n_b  # the 16-bunch run's stays
            want64 = reference_train_chunk(init_train_state(mlp), x[:n_b * BUNCH],
                                           t[:n_b * BUNCH], cfg, opt,
                                           generator=torch.Generator().manual_seed(TP_SEED),
                                           dtype=torch.float64)
            refs[(sizes, n_b)] = want, want64
            saved = torch.load(os.path.join(workdir, f"{key}.pt"))
            got, step = saved[:-1], saved[-1]
            equal = all(hashes[r][key] == hashes[0][key] for r in range(ranks))
            _check(equal, f"TP {key}: the {ranks} ranks' states are not bit-equal")
            _check(step == want.step == n_b, f"TP {key}: step {step}, single {want.step}")
            held[key] = _tp_hold(got, want, want64)
            held[key]["update_rel_fro"] = _dp_update_off(got, want, init_train_state(mlp))[1]
            held[key]["update_rel_fro_f64"] = _dp_update_off(got, want64, init_train_state(mlp))[1]
            if n_b == 2:
                h = held[key]
                _check(h["tol_ratio"] <= 1.0,
                       f"TP {key}: off the single-process trainer by {h['max_abs_err']:.3g}: "
                       f"{h['tol_ratio']:.3g} of rtol {TP_TOL[0]} / atol {TP_TOL[1]} against its "
                       f"float32 and float64 runs")
    fault = torch.load(os.path.join(workdir, "fault_no_model_sum.pt"))[:-1]
    f_ratio = _tp_hold(fault, *refs[(TP_SIZES, 2)])["tol_ratio"]
    _check(f_ratio > 1.0, f"TP with the model sum of dedy skipped passes the hold ({f_ratio:.3g})")
    _check(r0["refused"] is not None and "not divisible by mesh model=2" in r0["refused"],
           f"the 129-wide head on 2 model ranks was not refused: {r0['refused']}")
    counts = r0["counts"]
    want_sums = sum(_tp_sums_a_chunk(len(s) - 1, n_b, n_data, shard)
                    for _, s, (n_data, _), shard in TP_RUNS for n_b in (2, TP_BUNCHES))
    _check(counts["rank_sum"] == want_sums and not _other_launches(counts),
           f"TP launches on rank 0: rank_sum {counts['rank_sum']}, expected {want_sums}; {counts}")
    timing = r0["timing"]
    print(f"[tp] make_auto_sharded_train_chunk on ranks sharing {smi} (gloo; sums and column "
          f"gathers on the card), parity dropout 0.1/0.2, bunch {BUNCH}: after 2 bunches against "
          f"the single-process plain trainer (float32 run; each element held against it or "
          f"its float64 run) " + ", ".join(
              f"{n} {held[n + '_2']['max_abs_err']:.3g} ({held[n + '_2']['ratio_f32']:.3g} of "
              f"rtol/atol against float32 alone, {held[n + '_2']['tol_ratio']:.3g} held, "
              f"{held[n + '_2']['by_f64_alone']} elements by float64 alone)" for n, *_ in TP_RUNS)
          + f"; after {TP_BUNCHES} bunches the update's relative Frobenius drift from float32 / "
            f"float64 " + ", ".join(
              f"{n} {held[f'{n}_{TP_BUNCHES}']['update_rel_fro']:.3g} / "
              f"{held[f'{n}_{TP_BUNCHES}']['update_rel_fro_f64']:.3g}" for n, *_ in TP_RUNS)
          + f"; every rank's state bit-equal; refused: the model sum skipped ({f_ratio:.3g} of "
            f"the limit), the 129-wide head on 2 model ranks", flush=True)
    for n, sizes, (n_data, n_model), shard in TP_RUNS:
        v = timing[n]
        print(f"[tp] {n} ({'-'.join(map(str, sizes))}, {'sharded' if shard else 'whole'}): "
              f"{v['bunch_ms']:.3f} ms a bunch by the host clock, the collectives "
              f"{v['collectives_ms']:.3f} ms of it ({v['collectives_ms'] / v['bunch_ms']:.1%}; "
              f"staging copy, synchronise, gloo barrier, rank_sum); the single-process plain "
              f"trainer {single_ms[sizes]:.3f} ms a bunch", flush=True)
    print(f"[tp] rank 0 launched rank_sum {counts['rank_sum']} times ({want_sums} expected), no "
          f"other kernel of the port; "
          f"phase {time.perf_counter() - t0:.1f} s (the ranks' spawn and runs {t_spawn:.1f} s)",
          flush=True)
    return dict(held=held, fault_tol_ratio=f_ratio, timing=timing,
                single_ms={"-".join(map(str, k)): v for k, v in single_ms.items()},
                counts={k: v for k, v in counts.items() if isinstance(v, int)},
                refused=r0["refused"], seconds=time.perf_counter() - t0)


# the recipe on 2 ranks against one rank on the plain trainer over the same
# bunches: _hold_parity's limits (tests/test_torch_multi_condition.py), CV
# history rtol and each weight's relative Frobenius error; the CPU test of the
# same comparison (tests/test_torch_recipe_dp.py) reads 8.4e-8 and 3.3e-7 and
# holds 1e-5
RECIPE_DP_CV_RTOL = 1e-4
RECIPE_DP_WTS_FRO = 1e-4


def _recipe_command(work: str, sub: str, nproc: int) -> dict:
    """python -m tpu_sednn_torch.recipes.multi_condition --small --device
    cuda, under torchrun with nproc ranks (or alone for 1), in work/sub:
    -> its wall time, output, stage times, results and launch report."""
    d = os.path.join(work, sub)
    os.makedirs(d)
    report = os.path.join(d, "launches.json")
    pre = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={nproc}"] if nproc > 1 else [sys.executable])
    env = dict(os.environ, TPU_SEDNN_TORCH_LAUNCH_REPORT=report,
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    t0 = time.perf_counter()
    proc = subprocess.run(pre + ["-m", "tpu_sednn_torch.recipes.multi_condition", "--small",
                                 "--device", "cuda", "--metrics", "m.jsonl"],
                          cwd=d, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    _check(proc.returncode == 0, f"the recipe on {nproc} rank(s) failed:\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
    stages = {r["stage"]: r["seconds"] for r in map(json.loads, open(os.path.join(d, "m.jsonl")))
              if r.get("event") == "stage"}
    _check(list(stages) == ["corpus", "featurize", "targets", "train", "eval"],
           f"recipe stages on {nproc} rank(s): {list(stages)}")
    log = proc.stderr.splitlines()
    n_train = int(next(l for l in log if " train / " in l).split()[1])
    return dict(dir=os.path.join(d, "mc_run_small"), wall_s=wall, log=log, stages=stages,
                n_train=n_train, counts=json.load(open(report)),
                results=json.load(open(os.path.join(d, "mc_run_small", "results.json"))))


def phase_recipe_dp(tmp: str, smi: str) -> dict:
    """The recipe's data-parallel branch (main path): python -m
    torch.distributed.run --nproc_per_node=2 -m
    tpu_sednn_torch.recipes.multi_condition --small --device cuda (2 ranks
    sharing the card, gloo, the plain data-parallel trainer, the sums on the
    card) against the same configuration on one rank on the plain trainer
    over the same bunches (in process: the samples beyond the last whole
    bunch put last in each epoch's order), CV history and weights at
    RECIPE_DP_CV_RTOL / RECIPE_DP_WTS_FRO; rank 0 alone logged and wrote the
    run dir, which reloads; then the same command on one rank (the
    tensor-core chunk trainer) for its times.  Stage times and samples/s."""
    from dataclasses import replace

    from tpu_sednn_torch.enhance import enhance_waveform
    from tpu_sednn_torch.io import load_wts
    from tpu_sednn_torch.recipes import load_run_dir
    from tpu_sednn_torch.recipes import multi_condition as tmc
    from tpu_sednn_torch.utils.checkpoint import restore_checkpoint
    from tpu_sednn_torch.utils.logging import Logger

    t0 = time.perf_counter()
    work = os.path.join(tmp, "recipe_dp")
    two = _recipe_command(work, "two", 2)
    mc = tmc.command_config(small=True, device="cuda")
    log = two["log"]
    _check(any("backend gloo" in l for l in log)
           and any("[mc] data-parallel over 2 ranks" in l for l in log)
           and sum("[mc] done" in l for l in log) == 1,
           "torchrun 2 ranks: no gloo line, no data-parallel line, or not one '[mc] done'")
    n_whole = two["n_train"] - two["n_train"] % mc.bunchsize
    n_bunches = mc.n_epochs * n_whole // mc.bunchsize
    c2 = two["counts"]
    _check(c2["rank_sum"] == n_bunches and not _other_launches(c2),
           f"recipe on 2 ranks: {n_bunches} bunches, launches {c2}")
    files = sorted(os.listdir(two["dir"]))
    _check({"ckpt", "fea.norm", "gv.txt", "mlp.final.wts", "results.json", "run.json"}
           <= set(files), f"the 2-rank run dir holds {files}")
    params, mcfg, ecfg, mean, istd, tn, gv = load_run_dir(two["dir"], device="cuda")
    state, extra, _ = restore_checkpoint(os.path.join(two["dir"], "ckpt"), device="cuda")
    _check(all(torch.equal(a, b) for a, b in zip(list(params.w) + list(params.b),
                                                 list(state.params.w) + list(state.params.b)))
           and extra["cv_hist"] == two["results"]["cv_hist"],
           "the 2-rank run's mlp.final.wts or CV history differs from its last checkpoint")
    _, _, nz = tmc.synthetic_eval_clips(mc)[0]
    _check(np.isfinite(enhance_waveform(params, mcfg, ecfg, nz, mean, istd, device="cuda")).all(),
           "the 2-rank run dir decodes to non-finite samples")

    # one rank on the plain trainer over the same bunches, in process
    real = tmc._epoch_permutation

    def tail_last(seed, epoch, n, device):
        whole = n - n % mc.bunchsize
        return torch.cat([real(seed, epoch, whole, "cpu"), torch.arange(whole, n)]).to(device)

    tmc._epoch_permutation = tail_last
    try:
        t1 = time.perf_counter()
        one = tmc.run_multi_condition(replace(mc, out_dir=os.path.join(work, "one_plain"),
                                              engine="xla"), Logger(stream=None))
        one_s = time.perf_counter() - t1
    finally:
        tmc._epoch_permutation = real
    cv2, cv1 = np.array(two["results"]["cv_hist"]), np.array(one["cv_hist"])
    cv_off = float(np.max(np.abs(cv2 - cv1) / np.abs(cv1)))
    (w2, b2), (w1, b1) = (load_wts(os.path.join(d, "mlp.final.wts"))
                          for d in (two["dir"], os.path.join(work, "one_plain")))
    wts_off = max(float(np.linalg.norm(a - b) / np.linalg.norm(b)) for a, b in zip(w2 + b2, w1 + b1))
    _check(cv_off <= RECIPE_DP_CV_RTOL and wts_off <= RECIPE_DP_WTS_FRO,
           f"recipe on 2 ranks vs one rank: CV {cv2} vs {cv1} ({cv_off:.3g} apart, tol "
           f"{RECIPE_DP_CV_RTOL}), weights {wts_off:.3g} apart (tol {RECIPE_DP_WTS_FRO})")
    _check(cv2[-1] < cv2[0], f"recipe on 2 ranks: CV did not fall: {cv2}")

    # the same command on one rank: the tensor-core chunk trainer, for its times
    cmd1 = _recipe_command(work, "one", 1)
    cv_cmd1 = cmd1["results"]["cv_hist"]
    _check(cv_cmd1[-1] < cv_cmd1[0] and np.isfinite(cv_cmd1).all(),
           f"the recipe on one rank: CV did not fall: {cv_cmd1}")
    for label, r in (("2 ranks (torchrun, gloo, plain data-parallel trainer)", two),
                     ("1 rank (the command alone, tensor-core chunk trainer)", cmd1)):
        print(f"[recipe-dp] --small on {label}: wall {r['wall_s']:.1f} s; "
              + ", ".join(f"{k} {v:.2f} s" for k, v in r["stages"].items())
              + f"; training {r['results']['train_samples_per_sec']:.0f} samples/s; CV "
              f"{r['results']['cv_hist'][0]:.4f} -> {r['results']['cv_hist'][-1]:.4f}; {smi}",
              flush=True)
    print(f"[recipe-dp] 2 ranks against one rank on the plain trainer over the same bunches (in "
          f"process, {one_s:.1f} s): CV history {cv_off:.3g} apart (tol {RECIPE_DP_CV_RTOL}), "
          f"mlp.final.wts {wts_off:.3g} relative Frobenius (tol {RECIPE_DP_WTS_FRO}); rank 0 alone "
          f"logged and wrote the run dir, which reloads through load_run_dir as the last "
          f"checkpoint; rank 0 launched rank_sum {c2['rank_sum']} times ({n_bunches} bunches) and "
          f"no other kernel of the port; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(counts={k: v for k, v in c2.items() if isinstance(v, int)}, n_bunches=n_bunches,
                cv_hist=cv2.tolist(), cv_one=cv1.tolist(), cv_off=cv_off, wts_off=wts_off,
                two=dict(wall_s=two["wall_s"], stages=two["stages"],
                         train_samples_per_sec=two["results"]["train_samples_per_sec"]),
                one_cmd=dict(wall_s=cmd1["wall_s"], stages=cmd1["stages"], cv_hist=cv_cmd1,
                             train_samples_per_sec=cmd1["results"]["train_samples_per_sec"]),
                seconds=time.perf_counter() - t0)


def _dp_rows(dp: dict, dw: dict, tc_runs: int, f32_runs: int, by_path, tp_sums: int,
             recipe_dp_sums: int) -> list:
    """The `kernels` line's rows of the data-parallel forms: the gradient-out
    backward and the update kernel (times at a rank's 64 rows, 2 ranks, with
    the 32 rows of 4 beside), rank_sum (a bunch's four sums, 2 ranks, 4
    beside; its launches on the tensor-parallel path and on the recipe's
    data-parallel branch beside the DP trainer's) and the DP chunk trainer per
    bunch and rank."""
    k64, k32, held, timing = dp["kern"][64], dp["kern"][32], dp["held"], dp["timing"]
    replaces = "tpu_sednn/ops/resident_chunk.py:169"
    shape = "a rank's 64 rows of a bunch of 128 (2 ranks) through the four layers of 1548-2048x3-129"

    def row(name, source, launches, timing_of, at32, **more):
        return dict(name=name, source=source, replaces=replaces, route="cuda", launches=launches,
                    launches_by_path=by_path(0, 0, train_dp=launches), shape=shape,
                    at_32_rows=at32, **more, **timing_of)

    def trainer(tc: bool) -> dict:
        """One rank's trainer per bunch, timed as a whole with the sum stubbed; the
        bound of its forward, gradient-out backward and update."""
        form = "tc" if tc else "f32"
        parts = [k64["fwd" if tc else "fwd_f32"], k64["grad_tc" if tc else "grad_f32"],
                 k64["update"]]
        peak = PEAK_BF16_FLOPS if tc else PEAK_FP32_FLOPS
        t_ops = sum(p["flops"] for p in parts) / peak * 1e3
        t_bytes = sum(p["nbytes"] for p in parts) / PEAK_BYTES_PER_S * 1e3
        one = [h for n, h in held.items() if n.endswith(f"{form}_1")]
        a2, a4 = dp["alone"][f"2_{form}"], dp["alone"][f"4_{form}"]
        return dict(ms=a2["ms"], plain_ms=a2["plain_ms"], at_32_rows_ms=a4["ms"],
                    bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                    else "bytes", library_ms=None, max_abs_err=max(h["abs"] for h in one),
                    max_abs_err_is="largest absolute difference of a state tensor from the "
                                   "single-process trainer after one bunch (2 and 4 ranks)",
                    parts_ms={"forward": parts[0]["ms"], "grad_out": parts[1]["ms"],
                              "update": parts[2]["ms"]},
                    sums_ms_by_ranks={w: v["allreduce_ms"] for w, v in timing.items()},
                    bunch_ms_by_ranks={w: v["bunch_ms"] for w, v in timing.items()},
                    times_of="ms / plain_ms: one rank's run per bunch (2 ranks), CUDA events "
                             "around run() with the sum stubbed; parts_ms each part alone; "
                             "sums_ms and bunch_ms by the host clock in the ranks' own run "
                             "(the sums on the card: staging copy, barrier, rank_sum)")

    grad_f32 = dw["fused_bwd_grad_out"] - dw["fused_bwd_grad_out_tc"]
    upd_f32 = dw["dp_update"] - dw["dp_update_sr"]
    s2, s4 = dp["kern"]["rank_sum"][2], dp["kern"]["rank_sum"][4]
    return [
        row("fused_bwd_grad_out_tc", "tpu_sednn_torch/csrc/fused_mlp.cuh",
            dw["fused_bwd_grad_out_tc"], k64["grad_tc"], k32["grad_tc"],
            launches_of="stripe_bwd_kernel<true, ...> (tensor-core products) in its gradient-out "
                        "form (G and gb written, nothing updated; dedy summed in the kernel)"),
        row("fused_bwd_grad_out", "tpu_sednn_torch/csrc/fused_mlp.cuh", grad_f32,
            k64["grad_f32"], k32["grad_f32"],
            launches_of="stripe_bwd_kernel<false, ...> (float32 FMA products) in its "
                        "gradient-out form, one launch a layer (redesigned PR 13)"),
        row("dp_update", "tpu_sednn_torch/csrc/fused_mlp.cuh", upd_f32, k64["update"],
            k32["update"], launches_of="update_kernel on float32 W and delta",
            max_abs_err_is="largest difference read from the plain version (bit-equal held)"),
        row("dp_update_sr", "tpu_sednn_torch/csrc/fused_mlp.cuh", dw["dp_update_sr"],
            k64["update_sr"], k32["update_sr"],
            launches_of="update_kernel on bfloat16 delta (sr_delta), stochastic rounding",
            max_abs_err_is="largest difference read from the plain version with the same bits "
                           "(bit-equal held)"),
        dict(name="rank_sum", source="tpu_sednn_torch/csrc/rank_sum.cu",
             replaces="tpu_sednn/ops/resident_chunk.py:223", route="cuda",
             launches=dw["rank_sum"] + tp_sums + recipe_dp_sums,
             launches_by_path=by_path(0, 0, train_dp=dw["rank_sum"], train_tp=tp_sums,
                                      recipe_dp=recipe_dp_sums),
             shape="the four gradients of 1548-2048x3-129 (K*N + N floats each) of 2 ranks, per "
                   "bunch", launches_of="sums over ranks sharing the card: a layer's gradient "
                                        "(train_dp), the gradients, dedy and the column gathers "
                                        "of the tensor-parallel trainer (train_tp), the plain "
                                        "data-parallel trainer's gradients (recipe_dp)",
             max_abs_err_is="largest difference read from the plain version (bit-equal held)",
             library_is="torch.sum over the ranks' gradients stacked (n_ranks, K*N + N)",
             at_4_ranks={k: s4[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
             **{k: s2[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                   "max_abs_err")}),
        row("resident_chunk_dp_tc", "tpu_sednn_torch/csrc/resident_chunk.cu", tc_runs,
            trainer(True), None,
            launches_of="data-parallel chunk-trainer runs with tensor-core products (the "
                        "command's gpu_used=2 and the ranks' sr_delta epoch), rank 0's"),
        row("resident_chunk_dp", "tpu_sednn_torch/csrc/resident_chunk.cu", f32_runs,
            trainer(False), None,
            launches_of="data-parallel chunk-trainer runs with float32 products, rank 0's"),
    ]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="", help="comma-separated subset of serve,kernels,train,"
                    "recipe,dp (for development: prints no kernels line and no final line, "
                    "exits with 2)")
    ap.add_argument("--dp-worker", nargs=3, metavar=("RANK", "WORLD", "DIR"),
                    help="one rank of the dp phase's runs (started by the dp phase itself)")
    ap.add_argument("--tp-worker", nargs=3, metavar=("RANK", "WORLD", "DIR"),
                    help="one rank of the tp phase's runs (started by the tp phase itself)")
    ap.add_argument("--chain-times", action="store_true",
                    help="only build and time the tensor-core chunk trainer's chain (chain_times; "
                         "prints no final line, exits with 2)")
    ap.add_argument("--bwd-times", action="store_true",
                    help="only build and time the backward (bwd_times; prints no final line, "
                         "exits with 2)")
    ap.add_argument("--fwd-times", action="store_true",
                    help="only build, time and digest the float32 forward (fwd_times; prints no "
                         "final line, exits with 2)")
    ap.add_argument("--mask-times", action="store_true",
                    help="only build and time the input mask's share of layer 0 and of the "
                         "chains, with the chunk trainer's state digests, and the standalone "
                         "dropout mask with the tpu_prng plain trainer (mask_times; prints no "
                         "final line, exits with 2)")
    ap.add_argument("--package-root", default="",
                    help="import tpu_sednn_torch from this directory, e.g. an unpacked checkout "
                         "of another commit, to time it with --chain-times beside this one")
    args = ap.parse_args(argv)
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    everything = {"serve", "kernels", "train", "recipe", "dp"}
    groups = set(filter(None, args.only.split(","))) or everything
    if not groups <= everything:
        ap.error(f"unknown group in --only {args.only!r}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 1
    from tpu_sednn_torch import resolve_device

    resolve_device("cuda")
    if args.dp_worker:
        return dp_worker(int(args.dp_worker[0]), int(args.dp_worker[1]), args.dp_worker[2])
    if args.tp_worker:
        return tp_worker(int(args.tp_worker[0]), int(args.tp_worker[1]), args.tp_worker[2])
    t_start = time.perf_counter()
    smi = phase_device()
    if args.chain_times:
        import tpu_sednn_torch

        times = chain_times()
        print(smi)
        print(json.dumps({"chain_times": times,
                          "package": os.path.dirname(tpu_sednn_torch.__file__)}))
        return 2
    if args.bwd_times:
        import tpu_sednn_torch

        times = bwd_times()
        print(smi)
        print(json.dumps({"bwd_times": times,
                          "package": os.path.dirname(tpu_sednn_torch.__file__)}))
        return 2
    if args.fwd_times:
        import tpu_sednn_torch

        times = fwd_times()
        print(smi)
        print(json.dumps({"fwd_times": times,
                          "package": os.path.dirname(tpu_sednn_torch.__file__)}))
        return 2
    if args.mask_times:
        import tpu_sednn_torch

        times = mask_times()
        print(smi)
        print(json.dumps({"mask_times": times,
                          "package": os.path.dirname(tpu_sednn_torch.__file__)}))
        return 2
    gen = torch.Generator(device="cuda").manual_seed(1234)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if "serve" in groups:
            kern = phase_kernel_vs_plain(gen)
            wavs, norm_8k, n_featurizer = phase_featurizer(tmp, np.random.default_rng(7))
            serving, n_serving = phase_serving(gen, norm_8k, smi)
            modes = dict(stream=phase_stream(norm_8k, smi), quant=phase_quant(norm_8k, smi),
                         fusion=phase_fusion(norm_8k, smi))
            cli = phase_cli(tmp, wavs, norm_8k, smi)
            # the serving decode computes re/im by matmul for the noisy phase, as
            # the JAX decode does, so only the featurizer's path runs this kernel
            _check(n_featurizer > 0, "the featurizer path never launched the stft_lps kernel")
            print(f"[serving] summary {json.dumps(serving)}")
            print(f"[modes] summary {json.dumps(dict(modes, cli=cli))}")
        if "kernels" in groups:
            fused = phase_fused_kernels(gen)
            masks = phase_masks()
            tcres = phase_tc_kernels(gen)
            resident = phase_resident(gen)
            torch.cuda.empty_cache()
            sr = phase_sr(gen)
            wide = phase_resident_wide()
            torch.cuda.empty_cache()
            chains = chain_times()
            torch.cuda.empty_cache()
        if "train" in groups:
            train = phase_train(tmp, smi)
            arrays = phase_train_arrays(tmp, smi)
        if "recipe" in groups:
            torch.cuda.empty_cache()
            recipe = phase_recipe(tmp, smi)
        if "dp" in groups:
            torch.cuda.empty_cache()
            dp = phase_dp(tmp, smi, train_ran="train" in groups)
            torch.cuda.empty_cache()
            tp = phase_tp(tmp, smi)
            recipe_dp = phase_recipe_dp(tmp, smi)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    if groups != everything:
        print(f"partial run (--only {args.only}): no kernels line, no final line", file=sys.stderr)
        return 2

    kc, tw, tforms = train["kernel_counts"], train["counts"], train["by_form"]
    for name, n in (("resident_chunk (tensor cores)", tforms["tc"]),
                    ("resident_chunk (float32 products)", tforms["f32"]),
                    ("fused_linear_act", kc["fused_linear_act"]),
                    ("fused_linear_act (tensor cores)", kc["tc_linear_act"]),
                    ("fused_bwd_update", kc["fused_bwd_update"]),
                    ("fused_bwd_update (tensor cores)", kc["tc_bwd_update"]),
                    ("philox_mask", kc["philox_mask"]), ("input_mask_bits", kc["input_mask_table"]),
                    ("stft_lps", train["stft_launches"])):
        _check(n > 0, f"the training path never launched the {name} kernel")
    ac, akc, forms = arrays["counts"], arrays["kernel_counts"], arrays["by_form"]
    for name, n in (("dropout_mask", ac["dropout_mask"]), ("sr_momentum_update", ac["sr_momentum_update"]),
                    ("resident_chunk (sr_delta)", forms["sr_delta"]),
                    ("resident_chunk (sr_state)", forms["sr_state"]),
                    ("resident_chunk (tile_rows)", forms["tile_rows"]),
                    ("resident_chunk (hbm_spill)", forms["hbm_spill"]),
                    ("resident_chunk (float32)", forms["f32"]),
                    ("resident_chunk (sr_delta, tensor cores)", forms["tc_sr_delta"]),
                    ("resident_chunk (sr_state, tensor cores)", forms["tc_sr_state"]),
                    ("fused_linear_act", akc["fused_linear_act"]),
                    ("fused_linear_act (tensor cores)", akc["tc_linear_act"]),
                    ("fused_bwd_update", akc["fused_bwd_update"]),
                    ("fused_bwd_update (tensor cores)", akc["tc_bwd_update"]),
                    ("philox_mask", akc["philox_mask"]), ("input_mask_bits", akc["input_mask_table"]),
                    ("stft_lps", ac["stft_lps"])):
        _check(n > 0, f"the in-memory training path never launched the {name} kernel")
    # kernel 5 runs on the in-memory path's tpu_prng epoch alone
    _check(ac["dropout_mask"] == arrays["xla_tpu_prng"]["dropout_mask"]
           and ac["dropout_mask_masks"] == arrays["xla_tpu_prng"]["masks"] and tw["dropout_mask"] == 0,
           f"dropout_mask launches: {ac['dropout_mask']} on the in-memory path (its tpu_prng epoch "
           f"{arrays['xla_tpu_prng']['dropout_mask']}), {tw['dropout_mask']} on the command's")
    # every launch of a call but its first is a programmatic dependent one, either form
    calls = sum(forms.values())
    _check(0 < akc["pdl"] <= akc["fused_linear_act"] + akc["fused_bwd_update"] - calls,
           f"the in-memory path's programmatic dependent launches: {akc['pdl']} of "
           f"{akc['fused_linear_act'] + akc['fused_bwd_update']} launches in {calls} calls")
    # the data-parallel path: the command on 2 ranks and the ranks' pfile epochs (rank 0's
    # counts, each run's zeroed just before it)
    dp_runs = dict(cmd=dp["cmd"]["counts"], **{k: e["counts"] for k, e in dp["epochs"].items()})
    dw = {k: sum(c[k] for c in dp_runs.values()) for k in
          ("fused_bwd_grad_out", "fused_bwd_grad_out_tc", "dp_update", "dp_update_sr",
           "rank_sum")}
    dkc = {k: sum(c["resident_chunk_kernels"][k] for c in dp_runs.values()) for k in kc}
    dp_tc_runs = dp_runs["cmd"]["dp_resident_chunk"] + dp_runs["sr_delta"]["dp_resident_chunk"]
    dp_f32_runs = dp_runs["f32"]["dp_resident_chunk"]
    for name, n in (("fused_bwd_grad_out (tensor cores)", dw["fused_bwd_grad_out_tc"]),
                    ("fused_bwd_grad_out (float32)",
                     dw["fused_bwd_grad_out"] - dw["fused_bwd_grad_out_tc"]),
                    ("dp_update", dw["dp_update"] - dw["dp_update_sr"]),
                    ("dp_update (sr_delta)", dw["dp_update_sr"]),
                    ("rank_sum", dw["rank_sum"]),
                    ("the DP chunk trainer (tensor cores)", dp_tc_runs),
                    ("the DP chunk trainer (float32 products)", dp_f32_runs),
                    ("fused_linear_act (tensor cores)", dkc["tc_linear_act"]),
                    ("fused_linear_act", dkc["fused_linear_act"] - dkc["tc_linear_act"]),
                    ("philox_mask", dkc["philox_mask"]),
                    ("input_mask_bits", dkc["input_mask_table"])):
        _check(n > 0, f"the data-parallel training path never launched the {name} kernel")

    # the recipe's path: the chunk trainer in its tensor-core form and the STFT kernel
    rc, rkc = recipe["counts"], recipe["kernel_counts"]
    _check(rc["dropout_mask"] == 0 and all(c["dropout_mask"] == 0 for c in dp_runs.values()),
           "the recipe's or the data-parallel path launched dropout_mask")
    for name, n in (("resident_chunk (tensor cores)", rc["resident_chunk"]),
                    ("fused_linear_act (tensor cores)", rkc["tc_linear_act"]),
                    ("fused_bwd_update (tensor cores)", rkc["tc_bwd_update"]),
                    ("philox_mask", rkc["philox_mask"]), ("input_mask_bits", rkc["input_mask_table"]),
                    ("stft_lps", rc["stft_lps"])):
        _check(n > 0, f"the recipe path never launched the {name} kernel")
    _check(rkc["fused_linear_act"] == rkc["tc_linear_act"]
           and rkc["fused_bwd_update"] == rkc["tc_bwd_update"],
           f"the recipe path launched float32-product layer kernels: {rkc}")

    # the tensor-parallel and the recipe's data-parallel paths: the sums (and the
    # tensor-parallel column gathers) on the card, and no other kernel
    tp_n, rdp = tp["counts"], recipe_dp["counts"]
    for name, n in (("tensor-parallel training", tp_n["rank_sum"]),
                    ("the recipe's data-parallel branch", rdp["rank_sum"])):
        _check(n > 0, f"{name} never launched the rank_sum kernel")

    def by_path(train_n, arrays_n, make_pfile=0, serving=0, train_dp=0, recipe=0, train_tp=0,
                recipe_dp=0):
        # the streaming, int8 and fusion paths launch no kernel (checked in their phases)
        return {"make_pfile": make_pfile, "serving": serving, "train": train_n,
                "train_arrays": arrays_n, "train_dp": train_dp, "recipe": recipe,
                "train_tp": train_tp, "recipe_dp": recipe_dp,
                **{f"serving_{k}": m["launches"] for k, m in modes.items()}}

    def variant(name, form, timing_key, what):
        return dict(name=f"resident_chunk_{name}", source="tpu_sednn_torch/csrc/resident_chunk.cu",
                    replaces="tpu_sednn/ops/resident_chunk.py:169", route="cuda",
                    launches=forms[form], launches_by_path=by_path(0, forms[form]),
                    max_abs_err=None if what is None else max(wide["errors"][what]),
                    max_abs_err_is="worst relative Frobenius error of a state tensor's update "
                                   "against its comparison (3 bunches at 3084-2048x3-257)",
                    shape=f"{BUNCH} x 3084-2048x3-257, per bunch", **wide["timing"][timing_key])

    def layer_launches(kernel, wrapper, form):
        """(train, arrays, train_dp, recipe) launches of kernel 1 or 2 in one product
        form: the chunk trainers' tallies plus the wrapper's own counts; form "tc" or
        "f32"."""
        tc_key = {"fused_linear_act": "tc_linear_act", "fused_bwd_update": "tc_bwd_update"}[kernel]
        tr_tc, ar_tc = kc[tc_key] + tw[wrapper + "_tc"], akc[tc_key] + ac[wrapper + "_tc"]
        if form == "tc":
            return tr_tc, ar_tc, dkc[tc_key], rkc[tc_key]
        return (kc[kernel] + tw[wrapper] - tr_tc, akc[kernel] + ac[wrapper] - ar_tc,
                dkc[kernel] - dkc[tc_key], rkc[kernel] - rkc[tc_key])

    def layer_row(name, kernel, form, source, replaces, timing, **more):
        tr, ar, dpn, rcn = layer_launches(kernel, kernel, form)
        return dict(name=name, source=source, replaces=replaces, launches=tr + ar + dpn + rcn,
                    launches_by_path=by_path(tr, ar, train_dp=dpn, recipe=rcn), route="cuda",
                    shape="one bunch of 128 through the four layers of 1548-2048x3-129",
                    **more, **timing)

    t8 = kern[8000]
    kernels = [
        dict(name="stft_lps", source="tpu_sednn_torch/csrc/stft_lps.cu",
             replaces="tpu_sednn/ops/stft_pallas.py:34",
             launches=n_featurizer + n_serving + train["stft_launches"] + ac["stft_lps"]
             + rc["stft_lps"],
             launches_by_path=by_path(train["stft_launches"], ac["stft_lps"], n_featurizer,
                                      n_serving, recipe=rc["stft_lps"]),
             max_abs_err=kern["max_abs_err"], tol_ratio=kern["tol_ratio"], ms=t8["ms"],
             plain_ms=t8["plain_ms"], bound_ms=t8["bound_ms"], bound_by=t8["bound_by"],
             library_ms=t8["library_ms"], dft_floor_ms=t8["dft_floor_ms"], shape=t8["shape"],
             at_16k=kern[16000], route="cuda"),
        layer_row("fused_linear_act", "fused_linear_act", "f32", "tpu_sednn_torch/csrc/fused_mlp.cu",
                  "tpu_sednn/ops/fused_mlp.py:65", fused["fwd"],
                  launches_of="f32_fwd_kernel (float32 FMA products, bf16=False; on the "
                              "tensor-core forward's cluster split: one launch a layer, "
                              "fwd_k_chunk's chunks summed through distributed shared memory in "
                              "order, bit-equal to the two-launch form); bf16_launches read "
                              "bfloat16 weights (sr_state, either form)",
                  dp_forward={M: {k: dp["kern"][M]["fwd_f32"][k] for k in
                                  ("ms", "plain_ms", "bound_ms", "library_ms")} for M in (64, 32)},
                  bf16_launches=akc["bf16_linear_act"], bf16_storage=sr["bf16_storage"]),
        layer_row("fused_linear_act_tc", "fused_linear_act", "tc",
                  "tpu_sednn_torch/csrc/fused_mlp.cuh", "tpu_sednn/ops/fused_mlp.py:65",
                  tcres["fwd"],
                  launches_of="tc_fwd_kernel (tensor-core products, bf16=True, mma.sync "
                              "m16n8k16; K split within a thread-block cluster and summed through "
                              "distributed shared memory: one launch a layer)",
                  dp_forward={M: {k: dp["kern"][M]["fwd"][k] for k in
                                  ("ms", "plain_ms", "bound_ms", "library_ms")} for M in (64, 32)}),
        layer_row("fused_bwd_update", "fused_bwd_update", "f32", "tpu_sednn_torch/csrc/fused_mlp.cu",
                  "tpu_sednn/ops/fused_mlp.py:108", fused["bwd"],
                  launches_of="stripe_bwd_kernel<false, ...> (float32 FMA products, bf16=False; "
                              "redesigned PR 13 on the tensor-core form's stripes and cluster: one "
                              "launch a layer, dedy summed in the kernel); sr_launches stored "
                              "bfloat16 with stochastic rounding, tiled_launches accumulated a row "
                              "tile (either form)",
                  sr_launches=akc["sr_bwd_update"], tiled_launches=akc["tiled_bwd_update"],
                  library_ms=None),
        layer_row("fused_bwd_update_tc", "fused_bwd_update", "tc",
                  "tpu_sednn_torch/csrc/fused_mlp.cuh", "tpu_sednn/ops/fused_mlp.py:108",
                  tcres["bwd"], library_ms=None,
                  launches_of="stripe_bwd_kernel<true, ...> (tensor-core products, bf16=True, mma.sync "
                              "m16n8k16; a block streams a stripe of W's rows over a range of N "
                              "through a TMA ring fed by a producer warp, applies the update on "
                              "the unrounded W a chunk at a time, and dedy is summed within a "
                              "thread-block cluster through distributed shared memory: one "
                              "launch a layer, no reduce_dedy_kernel)"),
        dict(name="resident_chunk", source="tpu_sednn_torch/csrc/resident_chunk.cu",
             replaces="tpu_sednn/ops/resident_chunk.py:169",
             launches=tforms["f32"] + forms["f32"],
             launches_by_path=by_path(tforms["f32"], forms["f32"]),
             launches_of="chunk-trainer calls with float32 products and state (bf16=False)",
             at_16k=wide["timing"]["f32"], **resident[False], route="cuda"),
        dict(name="resident_chunk_tc", source="tpu_sednn_torch/csrc/resident_chunk.cu",
             replaces="tpu_sednn/ops/resident_chunk.py:169",
             launches=tforms["tc"] + rc["resident_chunk"],
             launches_by_path=by_path(tforms["tc"], 0, recipe=rc["resident_chunk"]),
             launches_of="chunk-trainer calls with tensor-core products and float32 state "
                         "(bf16=True: engine=auto on the card)",
             at_16k=wide["timing"]["tc_f32"],
             ms_per_bunch_in_a_full_chunk=train["chunk_ms_per_bunch"],
             pdl_launches=kc["pdl"] + akc["pdl"] + rkc["pdl"],
             pdl_launches_of="the chain's programmatic dependent launches on the training paths "
                             "(every launch of a call but its first, either product form)",
             host_ms_per_bunch=train["host_ms_per_bunch"], chain_times=chains, **resident[True],
             route="cuda"),
        dict(name="philox_mask", source="tpu_sednn_torch/csrc/philox.cuh",
             replaces="tpu_sednn/ops/resident_chunk.py:970",
             launches=sum(c[k] for c in (kc, akc, dkc, rkc)
                          for k in ("philox_mask", "input_mask_table")),
             launches_by_path=by_path(*(c["philox_mask"] + c["input_mask_table"] for c in (kc, akc)),
                                      train_dp=dkc["philox_mask"] + dkc["input_mask_table"],
                                      recipe=rkc["philox_mask"] + rkc["input_mask_table"]),
             draw_source="tpu_sednn_torch/csrc/resident_chunk.cu:input_mask_bits_kernel",
             draw_launches_by_path=by_path(kc["input_mask_table"], akc["input_mask_table"],
                                           train_dp=dkc["input_mask_table"],
                                           recipe=rkc["input_mask_table"]),
             input_mask_philox_by_path=by_path(kc["input_mask_philox"], akc["input_mask_philox"],
                                               train_dp=dkc["input_mask_philox"],
                                               recipe=rkc["input_mask_philox"]),
             **masks, route="cuda"),
        variant("sr_delta", "sr_delta", "sr_delta", "sr_delta, parity, dropout 0.1/0.2"),
        variant("sr_state", "sr_state", "sr_state", "sr_state, parity, dropout 0.1/0.2"),
        variant("tile_rows", "tile_rows", "tile_rows", "tile_rows 64 vs untiled"),
        variant("hbm_spill", "hbm_spill", "hbm_spill", None),
        variant("sr_delta_tc", "tc_sr_delta", "tc_sr_delta",
                "tensor cores, sr_delta, parity, dropout 0.1/0.2"),
        variant("sr_state_tc", "tc_sr_state", "tc_sr_state",
                "tensor cores, sr_state, parity, dropout 0.1/0.2"),
        dict(name="dropout_mask", source="tpu_sednn_torch/csrc/dropout_mask.cu",
             replaces="tpu_sednn/ops/dropout_pallas.py:29", route="cuda",
             launches=ac["dropout_mask"], launches_by_path=by_path(0, ac["dropout_mask"]),
             launches_of="dropout_mask_kernel launches, each a batch of up to 64 masks: on the "
                         "in-memory path the plain trainer (engine=xla, dropout_rng=tpu_prng) "
                         "draws 8 bunches' masks a launch",
             masks_by_path=by_path(0, ac["dropout_mask_masks"]), **sr["k5"]),
        dict(name="sr_momentum_update", source="tpu_sednn_torch/csrc/sr_update.cu",
             replaces="tpu_sednn/ops/sr_update.py:29", route="cuda",
             launches=ac["sr_momentum_update"],
             launches_by_path=by_path(0, ac["sr_momentum_update"]), **sr["k6"]),
    ]
    kernels += _dp_rows(dp, dw, dp_tc_runs, dp_f32_runs, by_path, tp_n["rank_sum"],
                        rdp["rank_sum"])
    spill = next(k for k in kernels if k["name"] == "resident_chunk_hbm_spill")
    spill.update(max_abs_err=wide["spill_max_abs"],
                 max_abs_err_is="largest absolute difference of a state tensor from the unspilled "
                                "run, float32 and tensor-core products (3 bunches at "
                                "3084-2048x3-257)")
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    for k in kernels:
        _check(keys <= set(k), f"kernels line: {k['name']} lacks {keys - set(k)}")
    print(f"[arrays] summary {json.dumps(arrays)}")
    print(f"[recipe] summary {json.dumps(recipe)}")
    print(f"[dp] summary {json.dumps(dp)}")
    print(f"[tp] summary {json.dumps(tp)}")
    print(f"[recipe-dp] summary {json.dumps(recipe_dp)}")
    print(f"[train] summary {json.dumps(train)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
