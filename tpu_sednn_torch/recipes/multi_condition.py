"""End-to-end multi-condition training pipeline — counterpart of
tpu_sednn/recipes/multi_condition.py, the framework analog of the
reference's full recipe (TIMIT x noise-types x SNRs -> pfiles -> BPtrain
epochs -> external decode), collapsed into one program on the card:

  synth/mix corpus -> STFT/LPS -> targets (PSM/IRM/IBM/LPS) -> splice+NAT ->
  chunk trainer with the recipe schedule -> checkpoint + .wts export ->
  enhance held-out clips (incl. the reference demo wavs, where present) ->
  SNR/SegSNR/STOI/PESQ/composite, seen vs unseen noise.

Runnable:  python -m tpu_sednn_torch.recipes.multi_condition [--small | --psm-full]
           [--device cuda|cpu] [--metrics FILE]
           (device cuda by default; raises without one)
Data-parallel: python -m torch.distributed.run --nproc_per_node=N
           -m tpu_sednn_torch.recipes.multi_condition ...

Under a process group of more than one rank (use_dp_mesh, N dividing the
bunch size) the recipe takes the JAX recipe's data-parallel branch: the
samples are trimmed to whole bunches before the epoch permutations, the
state is broadcast from rank 0, and the plain data-parallel trainer
(parallel.make_dp_train_chunk) trains every rank's rows of each bunch.
Every rank builds the corpus and the features itself; rank 0 alone writes
the run dir (norms, checkpoints, mlp.final.wts, run.json, results.json)
and scores it, and the other ranks wait for it at a barrier.  A resumed run
restores the checkpoint onto every rank.

The corpus, the targets and the scores are host numpy, as in the JAX
package; features, training and decode run on `device`.  On a CUDA device
`engine="auto"` trains with the hand-written chunk trainer
(ops/resident_chunk.py: tensor-core products, in-kernel Philox dropout).
Every random draw of the run sits in one small function of this module
(`_init_params`, `_epoch_permutation`, `_chunk_rng`), seeded from mc.seed.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_sednn_torch.utils.logging import Logger


@dataclass
class MultiConditionConfig:
    out_dir: str = "mc_run"
    sample_rate: int = 8000
    n_utts: int = 120
    variants: int = 1  # noisy mixes per clean utterance (noise x SNR draws)
    snrs: Tuple[float, ...] = (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0)
    noise_kinds: Tuple[str, ...] = ("white", "pink", "babble")
    fea_context: int = 11
    targ_offset: int = 5
    hidden: Tuple[int, ...] = (2048, 2048, 2048)
    n_epochs: int = 15
    bunchsize: int = 128
    lrate: float = 1.0
    dropout: Tuple[float, float] = (0.1, 0.2)
    seed: int = 0
    ckpt_every: int = 5  # checkpoint (params+momentum) every N epochs
    # the JAX recipe's data-parallel branch: under a torch.distributed group
    # of more than one rank whose size divides bunchsize, the plain
    # data-parallel trainer (parallel.make_dp_train_chunk) on the samples
    # trimmed to whole bunches, whatever `engine` says
    use_dp_mesh: bool = True
    # samples per trainer call (the reference's traincache, finetune_...pl:
    # 65): bounds the transient device footprint of each chunk's gather.
    # 102400 is a multiple of every bunchsize used, so chunking does not
    # change the update math.  On the chunk trainer the FINAL partial chunk
    # is padded to traincache rows with an n_real bunch count, as the JAX
    # recipe pads it.
    traincache: int = 102400
    # chunk-runner engine ("auto" = the hand-written chunk trainer on a
    # CUDA device, the plain trainer on the CPU; train.loop._auto_engine) +
    # extra factory kwargs (e.g. {"bf16": False} pins float32 products)
    engine: str = "auto"
    engine_kwargs: Dict = None  # type: ignore[assignment]
    # training head: "psm" phase-sensitive mask (Erdogan'15; the flagship),
    # "irm", "ibm", or "lps" regression
    head: str = "psm"
    ibm_lc_db: float = 5.0  # IBM local criterion (the reference's LC5dB)
    target_norm: bool = True  # normalize targets (clean-mode stabilizer)
    gv_mode: str = "off"  # decode-time GV equalization in eval: off|global|per-dim
    # decode-time spectral gain window and mask floor, frozen from a sweep on
    # held-out synthetic validation clips (recipes/val_sweep.py); None
    # disables
    min_gain_db: Optional[float] = -10.0
    max_gain_db: Optional[float] = 0.0
    mask_floor: float = 0.05
    # per-utterance probability of convolving the speech with a synthetic
    # RIR before mixing (data.mixing.synth_rir; RT60 0.1-0.5 s)
    reverb_prob: float = 0.0
    # unseen-noise generalization protocol: extra noise families to EVALUATE
    # on beyond the training kinds; results["eval"]["noise_generalization"].
    # Empty = skip.
    eval_noise_kinds: Tuple[str, ...] = ()
    device: str = "cuda"  # where features, training and decode run: cuda | cpu


def _stream_seed(*keys: int) -> int:
    """A 63-bit seed for a torch.Generator from a tuple of ints (numpy's
    SeedSequence: distinct tuples give independent streams)."""
    return int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _init_params(mcfg, seed: int, device):
    """Glorot init of the model from `seed` (drawn on the host, then moved)."""
    from tpu_sednn_torch.model import init_params

    return init_params(torch.Generator().manual_seed(_stream_seed(seed)), mcfg,
                       scheme="glorot", device=device)


def _epoch_permutation(seed: int, epoch: int, n: int, device) -> torch.Tensor:
    """The epoch's sample order, an int64 tensor on `device`: a stream of its
    own per epoch, so a resumed run continues it exactly."""
    gen = torch.Generator().manual_seed(_stream_seed(seed + 1, epoch))
    return torch.randperm(n, generator=gen).to(device)


def _chunk_rng(seed: int, epoch: int, chunk: int) -> torch.Generator:
    """The generator a chunk's dropout draws from (the chunk trainer takes
    one integer seed from it, the plain trainer its masks)."""
    return torch.Generator().manual_seed(_stream_seed(seed + 2, epoch, chunk))


def host_lps(wav, cfg_stft, device) -> np.ndarray:
    """LPS of a waveform, computed on `device`, as a host float32 array."""
    from tpu_sednn_torch.dsp import stft_logpower

    with torch.inference_mode():
        x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
        return stft_logpower(x, cfg_stft).cpu().numpy()


def _enhance_config(mc: MultiConditionConfig):
    from tpu_sednn_torch.dsp import StftConfig
    from tpu_sednn_torch.enhance import EnhanceConfig

    mask_head = mc.head in ("irm", "ibm", "psm")
    return EnhanceConfig(stft=StftConfig.for_rate(mc.sample_rate), fea_context=mc.fea_context,
                         targ_offset=mc.targ_offset, nat=True, head=mc.head, gv_mode=mc.gv_mode,
                         mask_floor=mc.mask_floor if mask_head else 0.0,
                         min_gain_db=mc.min_gain_db, max_gain_db=mc.max_gain_db)


def synthetic_eval_clips(mc: MultiConditionConfig) -> List[Tuple[float, np.ndarray, np.ndarray]]:
    """[(snr_db, clean, noisy)]: the held-out white-noise clips at 0 and 5 dB
    that results["eval"]["synthetic_*dB"] scores (seed mc.seed + 99)."""
    from tpu_sednn_torch.data.mixing import mix_at_snr, synth_noise, synth_speech

    sr = mc.sample_rate
    rng = np.random.default_rng(mc.seed + 99)
    out = []
    for snr_db in (0.0, 5.0):
        cl = synth_speech(rng, 4 * sr, sr)
        out.append((snr_db, cl, mix_at_snr(cl, synth_noise(rng, 4 * sr, "white"), snr_db, rng)))
    return out


def score_synthetic(cl: np.ndarray, nz: np.ndarray, enh: np.ndarray, sr: int) -> Dict:
    """The synthetic-clip block of results["eval"]: SNR, SegSNR, STOI and
    PESQ of the noisy and the enhanced clip, and CSIG/CBAK/COVL of the
    enhanced one, all against the clean clip."""
    from tpu_sednn_torch.metrics import pesq, seg_snr, snr, stoi
    from tpu_sednn_torch.metrics.composite import composite

    m = {
        "snr_noisy": snr(cl, nz), "snr_enh": snr(cl, enh),
        "segsnr_noisy": seg_snr(cl, nz, sr), "segsnr_enh": seg_snr(cl, enh, sr),
        "stoi_noisy": stoi(cl, nz, sr), "stoi_enh": stoi(cl, enh, sr),
        "pesq_noisy": pesq(cl, nz, sr), "pesq_enh": pesq(cl, enh, sr),
    }
    # composite MOS estimates (CSIG/CBAK/COVL, Hu & Loizou) — clean truth
    # exists for the synthetic eval, unlike the demo-clip proxy gate
    comp = composite(cl, enh, sr)
    m.update({f"{k}_enh": comp[k] for k in ("csig", "cbak", "covl")})
    return m


def run_multi_condition(mc: MultiConditionConfig, logger: Optional[Logger] = None) -> Dict:
    """Run the recipe on mc.device; writes mlp.final.wts, fea.norm,
    [targ.norm,] gv.txt, run.json, results.json (and demo_gate.json where
    the demo clips exist) under mc.out_dir and returns the results.  Stage
    times go to the logger's metrics stream as {"event": "stage", "stage",
    "seconds"} records."""
    import torch.distributed as dist

    from tpu_sednn_torch._device import resolve_device
    from tpu_sednn_torch.data import build_training_arrays
    from tpu_sednn_torch.data.mixing import synth_corpus
    from tpu_sednn_torch.enhance import enhance_waveform
    from tpu_sednn_torch.io import compute_norm, save_norm, save_wts
    from tpu_sednn_torch.model import ModelConfig, params_to_wts
    from tpu_sednn_torch.recipes.finetune_nat import recipe_opt_schedule
    from tpu_sednn_torch.train import init_train_state
    from tpu_sednn_torch.train.loop import _auto_engine, make_chunk_runner
    from tpu_sednn_torch.train.step import cv_squared_error
    from tpu_sednn_torch.utils.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint,
    )

    log = logger or Logger()
    dev = resolve_device(mc.device)
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank0 = not grouped or dist.get_rank() == 0  # the one rank that writes files
    os.makedirs(mc.out_dir, exist_ok=True)
    t_start = t_stage = time.time()
    enh_cfg = _enhance_config(mc)
    cfg_stft = enh_cfg.stft
    d = cfg_stft.n_bins

    def stage(name: str) -> None:
        nonlocal t_stage
        now = time.time()
        log.metrics(event="stage", stage=name, seconds=now - t_stage)
        t_stage = now

    # 1. corpus + features
    log.info(f"[mc] synthesizing {mc.n_utts} utts x {len(mc.snrs)} SNRs x "
             f"{len(mc.noise_kinds)} noises at {mc.sample_rate} Hz")
    cleans, noisys = synth_corpus(mc.seed, mc.n_utts, sr=mc.sample_rate,
                                  snrs=mc.snrs, noise_kinds=mc.noise_kinds,
                                  variants=mc.variants,
                                  reverb_prob=mc.reverb_prob)
    stage("corpus")
    clean_lps = _featurize(cleans, cfg_stft, dev)
    noisy_lps = _featurize(noisys, cfg_stft, dev)
    audio_seconds = sum(len(c) for c in cleans) / mc.sample_rate
    stage("featurize")

    mask_head = mc.head in ("irm", "ibm", "psm")
    target_norm = mc.target_norm and not mask_head  # masks are already [0,1]

    # train/CV split at CLEAN-UTTERANCE granularity: hold out whole
    # utterances INCLUDING all their noise/SNR variants, so no clean target
    # appears on both sides
    v = max(mc.variants, 1)
    n_hold = max(1, mc.n_utts // 20)
    split = (mc.n_utts - n_hold) * v
    tr_noisy, cv_noisy = noisy_lps[:split], noisy_lps[split:]
    tr_clean, cv_clean = clean_lps[:split], clean_lps[split:]

    # normalization / GV statistics come from the TRAIN split only
    mean, inv_std = compute_norm(np.concatenate(tr_noisy))
    t_mean, t_inv_std = (compute_norm(np.concatenate(tr_clean))
                         if target_norm else (None, None))
    # clean-corpus global variance for decode-time GV equalization (TASLP'15)
    gv_ref = np.concatenate(tr_clean).var(axis=0)
    if rank0:
        save_norm(os.path.join(mc.out_dir, "fea.norm"), mean, inv_std)
        if target_norm:
            # needed to denormalize at decode (demo_gate / enhance CLI)
            save_norm(os.path.join(mc.out_dir, "targ.norm"), t_mean, t_inv_std)
        np.savetxt(os.path.join(mc.out_dir, "gv.txt"), gv_ref)

    if mc.head == "psm":
        targets_all = _psm_targets(cleans, noisys, cfg_stft)
    elif mask_head:
        from tpu_sednn_torch.data.masks import ibm_from_lps, irm_from_lps

        targets_all = [
            irm_from_lps(c, n) if mc.head == "irm"
            else ibm_from_lps(c, n, mc.ibm_lc_db)
            for c, n in zip(clean_lps, noisy_lps)
        ]
    else:
        targets_all = clean_lps
    tr_tgt, cv_tgt = targets_all[:split], targets_all[split:]
    x, t = build_training_arrays(
        tr_noisy, tr_tgt, mc.fea_context, mc.targ_offset, nat=True,
        mean=mean, inv_std=inv_std, targ_mean=t_mean, targ_inv_std=t_inv_std,
    )
    x_cv, t_cv = build_training_arrays(
        cv_noisy, cv_tgt, mc.fea_context, mc.targ_offset, nat=True,
        mean=mean, inv_std=inv_std, targ_mean=t_mean, targ_inv_std=t_inv_std,
    )
    log.info(f"[mc] {len(x)} train / {len(x_cv)} cv samples "
             f"({n_hold} held-out utts x {v} variants; "
             f"{audio_seconds:.0f} audio-seconds), input dim {x.shape[1]}, "
             f"head {mc.head}")
    stage("targets")

    # 2. model + trainer: data-parallel over the process group's ranks, or
    #    the single-device chunk trainer
    sizes = (d * mc.fea_context + d, *mc.hidden, d)
    mcfg = ModelConfig(layersizes=sizes, dropout_vis=mc.dropout[0],
                       dropout_hid=mc.dropout[1], dropout_mode="parity",
                       output="sigmoid" if mask_head else "linear")
    params = _init_params(mcfg, mc.seed, dev)
    opt0 = recipe_opt_schedule(0, mc.lrate, mc.bunchsize)
    use_dp = (mc.use_dp_mesh and world > 1 and mc.bunchsize % world == 0
              and len(x) >= mc.bunchsize)
    if use_dp:
        from tpu_sednn_torch.parallel import make_dp_train_chunk, make_mesh, replicate

        # the trainer drops the partial bunch regardless (BP_GPU.cu:315-318
        # semantics), so trim to whole bunches up front, as the JAX recipe
        # does: the epoch permutations run over the trimmed samples
        n_whole = (len(x) // mc.bunchsize) * mc.bunchsize
        x, t = x[:n_whole], t[:n_whole]
        mesh = make_mesh(n_data=world, devices=[dev])
        state = init_train_state(replicate(params, mesh))
        run = make_dp_train_chunk(mcfg, opt0, mesh)
        pad_chunks = False
        log.info(f"[mc] data-parallel over {world} ranks on {dev}")
    else:
        state = init_train_state(params)
        ekw = dict(mc.engine_kwargs or {})
        resolved = mc.engine
        if resolved == "auto":
            resolved, extra = _auto_engine(mcfg, opt0, ekw, dev)
            ekw.update(extra)
        run = make_chunk_runner(mcfg, opt0, resolved, device=dev, **ekw)
        # the chunk trainer: pad the final partial chunk to traincache rows and
        # pass n_real, as the JAX recipe does for its one compiled shape
        pad_chunks = resolved == "resident"
        log.info(f"[mc] single-device training on {dev} (engine={resolved} {ekw if ekw else ''})")

    # samples stay on the device; each chunk is gathered there
    xj = torch.from_numpy(x).to(dev)
    tj = torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(dev)
    xcj = torch.from_numpy(x_cv).to(dev)
    tcj = torch.from_numpy(np.ascontiguousarray(t_cv, np.float32)).to(dev)
    n = xj.shape[0]

    # 3. epoch loop with the recipe schedule, checkpointing every
    #    mc.ckpt_every epochs and auto-resuming from the newest checkpoint
    ckpt_dir = os.path.join(mc.out_dir, "ckpt")
    cv_hist: List[float] = []
    start_epoch = 0
    if world > 1:
        dist.barrier()  # rank 0's files of a run before are all written
    if latest_step(ckpt_dir) is not None:
        state, extra, _ = restore_checkpoint(ckpt_dir, device=dev)
        start_epoch = int(extra.get("epoch", -1)) + 1
        cv_hist = [float(c) for c in extra.get("cv_hist", [])]
        log.info(f"[mc] resumed from {ckpt_dir} at epoch {start_epoch}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_train = time.time()
    for epoch in range(start_epoch, mc.n_epochs):
        opt = recipe_opt_schedule(epoch, mc.lrate, mc.bunchsize)
        perm = _epoch_permutation(mc.seed, epoch, n, dev)
        for ci, st_i in enumerate(range(0, n, mc.traincache)):
            idx = perm[st_i: st_i + mc.traincache]
            if idx.shape[0] < mc.bunchsize:
                continue  # partial bunch dropped (BP_GPU.cu:315-318 semantics)
            rng = _chunk_rng(mc.seed, epoch, ci)
            if pad_chunks and n > mc.traincache:
                # fixed-capacity chunk + n_real: bunches beyond the real ones
                # are skipped, so the padded rows (index 0 repeats) are never read
                n_real = idx.shape[0] // mc.bunchsize
                if idx.shape[0] < mc.traincache:
                    idx = torch.cat([idx, idx.new_zeros(mc.traincache - idx.shape[0])])
                state = run(state, xj.index_select(0, idx), tj.index_select(0, idx), rng,
                            opt.lrate, opt.momentum, opt.weightcost, n_real=n_real)
                continue
            state = run(state, xj.index_select(0, idx), tj.index_select(0, idx), rng,
                        opt.lrate, opt.momentum, opt.weightcost)
        cv = float(cv_squared_error(state.params, xcj, tcj, mcfg)) / len(x_cv)
        if not np.isfinite(cv):
            raise FloatingPointError(f"[mc] diverged at epoch {epoch} (cv={cv})")
        cv_hist.append(cv)
        log.info(f"[mc] epoch {epoch}: cv_mse={cv:.4f} momentum={opt.momentum}")
        if rank0 and ((epoch + 1) % mc.ckpt_every == 0 or epoch == mc.n_epochs - 1):
            save_checkpoint(ckpt_dir, epoch + 1, state,
                            extra={"epoch": epoch, "cv_hist": cv_hist,
                                   "layersizes": list(sizes)})
    train_seconds = time.time() - t_train
    n_run_epochs = mc.n_epochs - start_epoch
    steps = n_run_epochs * (len(x) // mc.bunchsize)
    # a fully-resumed run trains zero epochs: report 0, not a fabricated rate
    samples_per_sec = (steps * mc.bunchsize / max(train_seconds, 1e-9)
                       if n_run_epochs > 0 else 0.0)
    del xj, tj, xcj, tcj
    stage("train")

    if not rank0:  # rank 0 alone writes the run dir and scores it: wait for it
        dist.barrier()
        return {"cv_hist": cv_hist, "train_samples_per_sec": samples_per_sec,
                "audio_seconds": audio_seconds, "eval": {}}

    # 4. export weights + a run manifest so standalone re-scoring
    #    (recipes/demo_gate.py CLI, enhance CLI) reconstructs the exact
    #    decode configuration
    ws, bs = params_to_wts(state.params)
    save_wts(os.path.join(mc.out_dir, "mlp.final.wts"), ws, bs)
    with open(os.path.join(mc.out_dir, "run.json"), "w") as f:
        json.dump({
            "head": mc.head, "sample_rate": mc.sample_rate,
            "fea_context": mc.fea_context, "targ_offset": mc.targ_offset,
            "dropout": list(mc.dropout), "gv_mode": mc.gv_mode,
            "layersizes": list(sizes), "nat": True,
            "mask_floor": mc.mask_floor if mask_head else 0.0,
            "target_norm": bool(target_norm),
            "min_gain_db": mc.min_gain_db, "max_gain_db": mc.max_gain_db,
        }, f, indent=2)

    # 5. evaluate: held-out synthetic + the reference demo clips
    tn = (t_mean, t_inv_std) if target_norm else None
    gv_arg = gv_ref if mc.gv_mode != "off" else None
    results: Dict = {"cv_hist": cv_hist, "train_samples_per_sec": samples_per_sec,
                     "audio_seconds": audio_seconds, "eval": {}}
    for snr_db, cl, nz in synthetic_eval_clips(mc):
        enh = enhance_waveform(state.params, mcfg, enh_cfg, nz, mean, inv_std,
                               target_norm=tn, gv_ref=gv_arg, device=dev)
        m = score_synthetic(cl, nz, enh, mc.sample_rate)
        results["eval"][f"synthetic_{snr_db:g}dB"] = m
        log.info(f"[mc] synth {snr_db:g} dB: SNR {m['snr_noisy']:.1f}->{m['snr_enh']:.1f}, "
                 f"STOI {m['stoi_noisy']:.3f}->{m['stoi_enh']:.3f}")

    # unseen-noise generalization protocol: score held-out synthetic clips
    # under EVERY requested noise family — training kinds ("seen") plus
    # eval_noise_kinds ("unseen") — with clean ground truth
    if mc.eval_noise_kinds:
        gen = _noise_generalization_eval(
            state.params, mcfg, enh_cfg, mean, inv_std, tn, gv_arg, mc, log, dev)
        results["eval"]["noise_generalization"] = gen

    # quantitative gate on the reference's only e2e fixture, where present
    from tpu_sednn_torch.recipes.demo_gate import DEMO_DIR, evaluate_demo_clips

    if os.path.isdir(DEMO_DIR):
        demo = evaluate_demo_clips(state.params, mcfg, enh_cfg, mean, inv_std,
                                   target_norm=tn, gv_ref=gv_arg,
                                   out_dir=mc.out_dir, device=dev)
        results["eval"]["demo_clips"] = demo
        with open(os.path.join(mc.out_dir, "demo_gate.json"), "w") as f:
            json.dump(demo, f, indent=2)
        for name, m in demo.items():
            if isinstance(m, dict):
                log.info(f"[mc] demo {name}: lsd_gain={m['lsd_gain']:+.3f} dB "
                         f"stoi_gain={m['stoi_gain']:+.4f} "
                         f"segsnr_gain={m['segsnr_gain']:+.2f} dB")
    stage("eval")

    results["total_seconds"] = time.time() - t_start
    with open(os.path.join(mc.out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)
    log.info(f"[mc] done in {results['total_seconds']:.0f}s; "
             f"{samples_per_sec:.0f} samples/s during training")
    if world > 1:
        dist.barrier()
    return results


def _psm_targets(cleans, noisys, cfg_stft) -> List[np.ndarray]:
    """Phase-sensitive-mask targets (Erdogan et al. 2015) for pairwise
    (clean, noisy) waveform lists.

    PSM needs clean/noisy PHASE, so targets come from the waveforms' STFTs,
    not the LPS pair.  Host numpy, as in the JAX package, batched by length
    bucket: all frames of a bucket go through four BLAS matmuls, and clean
    utterances repeated per noise variant are transformed once.
    """
    from tpu_sednn_torch.data.masks import psm_from_stft
    from tpu_sednn_torch.dsp.stft import _rdft_matrices

    win, hop = cfg_stft.win_len, cfg_stft.hop
    cos_m, sin_m = _rdft_matrices(win, cfg_stft.n_fft, cfg_stft.window)

    def _frames(wav):
        n_frames = 1 + (len(wav) - win) // hop
        idx = (np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :])
        return np.asarray(wav, np.float32)[idx]

    by_len: Dict[int, List[int]] = {}
    for i, c in enumerate(cleans):
        by_len.setdefault(len(c), []).append(i)
    out: List[np.ndarray] = [None] * len(cleans)
    for _length, idxs in sorted(by_len.items()):
        # clean STFTs deduped by ndarray identity (variants share the clean)
        cpos: Dict[int, int] = {}
        cstack = []
        for i in idxs:
            k = id(cleans[i])
            if k not in cpos:
                cpos[k] = len(cstack)
                cstack.append(_frames(cleans[i]))
        cfr = np.stack(cstack)  # (U, F, win)
        nfr = np.stack([_frames(noisys[i]) for i in idxs])  # (B, F, win)
        u, f = cfr.shape[0], cfr.shape[1]
        b = nfr.shape[0]
        cre = (cfr.reshape(u * f, win) @ cos_m).reshape(u, f, -1)
        cim = (cfr.reshape(u * f, win) @ sin_m).reshape(u, f, -1)
        yre = (nfr.reshape(b * f, win) @ cos_m).reshape(b, f, -1)
        yim = (nfr.reshape(b * f, win) @ sin_m).reshape(b, f, -1)
        for r, i in enumerate(idxs):
            j = cpos[id(cleans[i])]
            out[i] = psm_from_stft(cre[j], cim[j], yre[r], yim[r])
    return out


def _featurize(wavs, cfg_stft, device, batch: int = 64) -> List[np.ndarray]:
    """LPS features (host float32 arrays) for a list of utterances, computed
    on `device` by dsp.stft_logpower, as the JAX recipe uses its XLA STFT
    here.  Utterances are bucketed by length (synth_corpus snaps lengths to
    a 0.5 s grid, so only a handful of buckets exist) and stacked `batch` at
    a time; clean utterances repeated per noise variant (the same ndarray
    object) are featurized once."""
    from tpu_sednn_torch.dsp import stft_logpower

    uniq: Dict[int, np.ndarray] = {}
    for w in wavs:
        uniq.setdefault(id(w), w)
    by_len: Dict[int, List[int]] = {}
    for key, w in uniq.items():
        by_len.setdefault(len(w), []).append(key)
    out: Dict[int, np.ndarray] = {}
    with torch.inference_mode():
        for _length, keys in sorted(by_len.items()):
            for j in range(0, len(keys), batch):
                grp = keys[j: j + batch]
                block = torch.from_numpy(np.stack([uniq[k] for k in grp]).astype(np.float32))
                res = stft_logpower(block.to(device), cfg_stft).cpu().numpy()
                for r, k in enumerate(grp):
                    out[k] = res[r]
    return [out[id(w)] for w in wavs]


def _noise_generalization_eval(params, mcfg, enh_cfg, mean, inv_std,
                               target_norm, gv_ref, mc: MultiConditionConfig,
                               log, device, n_clips: int = 3,
                               snrs: Tuple[float, ...] = (0.0, 5.0)) -> Dict:
    """Seen-vs-unseen noise-family evaluation.

    The reference's eval protocol is TIMIT test x 15 UNSEEN noise types —
    generalization to noise the model never trained on is the papers'
    central claim.  This scores fresh synthetic clips (clean ground truth
    exists) under every family in noise_kinds + eval_noise_kinds at the given
    SNRs and aggregates per family and per seen/unseen group:

        {"per_kind": {kind: {stoi_gain, segsnr_gain, pesq_gain, lsd_gain,
                             seen}},
         "seen": {...mean gains...}, "unseen": {...}, "gap": {seen - unseen}}
    """
    from tpu_sednn_torch.data.mixing import mix_at_snr, synth_noise, synth_speech
    from tpu_sednn_torch.enhance import enhance_waveform
    from tpu_sednn_torch.metrics import lsd, pesq, seg_snr, stoi

    sr = mc.sample_rate

    def _lps(w):
        return host_lps(w, enh_cfg.stft, device)

    kinds = list(dict.fromkeys(tuple(mc.noise_kinds) + tuple(mc.eval_noise_kinds)))
    rng = np.random.default_rng(mc.seed + 777)
    clips = [synth_speech(rng, 3 * sr, sr) for _ in range(n_clips)]
    clip_lps = [_lps(c) for c in clips]
    out: Dict = {"per_kind": {}, "seen": {}, "unseen": {}, "gap": {}}
    agg: Dict[bool, List[Dict]] = {True: [], False: []}
    for kind in kinds:
        gains: List[Dict] = []
        for cl, cl_lps in zip(clips, clip_lps):
            for snr_db in snrs:
                nz = mix_at_snr(cl, synth_noise(rng, len(cl), kind), snr_db, rng)
                enh = enhance_waveform(params, mcfg, enh_cfg, nz, mean,
                                       inv_std, target_norm=target_norm,
                                       gv_ref=gv_ref, device=device)
                gains.append({
                    "stoi_gain": stoi(cl, enh, sr) - stoi(cl, nz, sr),
                    "segsnr_gain": seg_snr(cl, enh, sr) - seg_snr(cl, nz, sr),
                    "pesq_gain": pesq(cl, enh, sr) - pesq(cl, nz, sr),
                    "lsd_gain": lsd(cl_lps, _lps(nz)) - lsd(cl_lps, _lps(enh)),
                })
        means = {k: float(np.mean([g[k] for g in gains])) for k in gains[0]}
        seen = kind in mc.noise_kinds
        out["per_kind"][kind] = {**means, "seen": seen}
        agg[seen].append(means)
        log.info(f"[mc] noise-gen {kind} ({'seen' if seen else 'UNSEEN'}): "
                 f"lsd {means['lsd_gain']:+.2f} dB stoi {means['stoi_gain']:+.3f} "
                 f"segsnr {means['segsnr_gain']:+.2f} dB "
                 f"pesq(est) {means['pesq_gain']:+.2f}")
    for label, seen in (("seen", True), ("unseen", False)):
        if agg[seen]:
            out[label] = {k: float(np.mean([m[k] for m in agg[seen]]))
                          for k in agg[seen][0]}
    if out["seen"] and out["unseen"]:
        out["gap"] = {k: out["seen"][k] - out["unseen"][k] for k in out["seen"]}
        log.info("[mc] noise-gen gap (seen - unseen): "
                 + " ".join(f"{k}={v:+.3f}" for k, v in out["gap"].items()))
    return out


def command_config(small: bool = False, psm_full: bool = False,
                   device: str = "cuda") -> MultiConditionConfig:
    """The configuration the command runs for --small / --psm-full."""
    mc = MultiConditionConfig(
        out_dir="mc_run_small" if small else "mc_run",
        n_utts=24 if small else 120,
        hidden=(512, 512) if small else (2048, 2048, 2048),
        n_epochs=6 if small else 15,
        snrs=(0.0, 5.0) if small else (-5.0, 0.0, 5.0, 10.0, 15.0, 20.0),
        noise_kinds=("white",) if small else ("white", "pink", "babble"),
        device=device,
    )
    if psm_full:
        from tpu_sednn_torch.data.mixing import NOISE_KINDS

        mc = replace(mc, out_dir="mc_psm_full", head="psm", n_utts=2000, variants=2, n_epochs=22,
                     hidden=(2048, 2048, 2048), noise_kinds=NOISE_KINDS, ckpt_every=8)
    return mc


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="the multi-condition recipe on the port")
    ap.add_argument("--small", action="store_true",
                    help="24 utterances, 512x2 hidden, 6 epochs, 2 SNRs, white noise")
    ap.add_argument("--psm-full", action="store_true",
                    help="the flagship of benchmarks/run_psm_full.py: PSM, 2000 utterances x 2 "
                         "variants, 22 epochs, the 7 training noise families, ckpt_every 8")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--metrics", default=None,
                    help="append the stage times as JSON lines to this file")
    args = ap.parse_args(argv)
    mc = command_config(args.small, args.psm_full, args.device)
    import torch.distributed as dist

    from tpu_sednn_torch.parallel import initialize_distributed

    initialize_distributed(device=args.device)  # WORLD_SIZE > 1: torchrun's ranks
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    run_multi_condition(mc, Logger(metrics_path=args.metrics, is_host0=rank0))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
