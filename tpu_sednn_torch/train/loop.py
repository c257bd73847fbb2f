"""Epoch-level training loop — counterpart of tpu_sednn/train/loop.py: the
in-process equivalent of the reference's `BPtrain main` plus the Perl epoch
loop.

Params and momentum stay on the device across chunks; each chunk goes
through one chunk trainer ("engine"), which updates the state in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_sednn_torch.data.pipeline import plan_chunks, read_chunk_parity
from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.io.norm import load_norm
from tpu_sednn_torch.io.pfile import read_pfile_info
from tpu_sednn_torch.model.mlp import ModelConfig
from tpu_sednn_torch.train.step import (
    OptConfig,
    TrainState,
    cv_squared_error,
    make_jit_train_chunk,
)
from tpu_sednn_torch.utils.logging import Logger


_RUNNER_MEMO: Dict = {}


def _auto_engine(cfg: ModelConfig, opt: OptConfig, engine_kwargs: Optional[Dict] = None,
                 device: str | torch.device = "cuda") -> Tuple[str, Dict]:
    """engine="auto" resolution -> (engine, extra_engine_kwargs): "resident"
    (the hand-written CUDA chunk trainer) when the state lives on a CUDA
    device, "xla" (the plain float32 torch trainer) on the CPU, as the JAX
    package resolves it on its chip and on the CPU.  "resident" takes the
    factory's defaults, so on the card it trains with tensor-core products
    (bf16=True, the JAX kernels' default and what the JAX package trains
    with on its chip); engine_kwargs={"bf16": False} pins float32 products.

    The JAX package degrades here by a ladder of variants (bf16 momentum,
    one layer's state outside on-chip memory) when the float32 state does
    not fit the TPU's on-chip memory.  The port keeps its state in device
    memory at every model size, so there is no ladder: the extra kwargs are
    always empty.  The variants the ladder picks (sr_delta, hbm_spill) are
    ported and can be asked for through engine_kwargs."""
    return ("resident" if torch.device(device).type == "cuda" else "xla"), {}


def make_chunk_runner(cfg: ModelConfig, opt: OptConfig, engine: str = "xla",
                      n_data_shards: int = 1, pre_grouped: bool = False,
                      device: str | torch.device = "cuda", **engine_kwargs):
    """Chunk-trainer factory shared by the epoch loops.

    Memoized on (cfg, opt.bunchsize, engine, device type, kwargs): repeated
    calls (one per epoch in the recipe) return the SAME runner.

    engine (the JAX package's names, so recipes carry over):
      * "xla"      — the plain torch parity chunk (make_jit_train_chunk);
      * "resident" — the whole-chunk trainer on the hand-written CUDA kernels
        (ops/resident_chunk.py; CUDA states only, a CPU state runs its plain
        version);
      * "auto"     — "resident" for a CUDA `device` (with the factory's
        defaults: bf16=True, tensor-core products), "xla" for the CPU.
    n_data_shards > 1 takes the data-parallel form of the engine over the
    process group's ("data",) mesh (parallel.make_mesh; one rank per process,
    n_data_shards ranks): the resident trainer's gradient-out backward,
    all-reduce and update kernels (make_dp_resident_train_chunk), or the
    plain trainer's autograd + all-reduce (parallel.make_dp_train_chunk).
    pre_grouped marks chunk rows as already this rank's rows of the
    bunch_part-regrouped chunk (the multi-process input pipeline).
    engine_kwargs are forwarded to the resident factory (bf16, sr_delta,
    sr_state, tile_rows, hbm_spill, rule); the plain engine ignores them.
    All runners share the signature
      run(state, x, t, rng, lrate, momentum, weightcost[, n_real]) -> state
    with `rng` a torch.Generator and the hyperparameters REQUIRED (the memo
    ignores opt's dynamic fields, so defaults would silently come from
    whichever opt created the runner first).  Runners update `state` in place.
    """
    dev_type = torch.device(device).type
    if engine == "auto":
        engine, extra = _auto_engine(cfg, opt, engine_kwargs, device)
        engine_kwargs = {**engine_kwargs, **extra}
    memo_key = (cfg, opt.bunchsize, engine, n_data_shards, pre_grouped, dev_type,
                tuple(sorted(engine_kwargs.items())))
    if memo_key in _RUNNER_MEMO:
        return _RUNNER_MEMO[memo_key]
    if n_data_shards > 1:
        from tpu_sednn_torch.parallel import make_mesh

        mesh = make_mesh(n_data=n_data_shards, devices=[device])
        if engine == "resident":
            from tpu_sednn_torch.ops.resident_chunk import make_dp_resident_train_chunk

            run_dp = make_dp_resident_train_chunk(cfg, opt, mesh, pre_grouped=pre_grouped,
                                                  **engine_kwargs)

            def run(state, x, t, rng, lrate, momentum, weightcost, n_real=None):
                seed = int(torch.randint(0, 2**31 - 1, (), generator=rng))
                return run_dp(state, x, t, seed, lrate, momentum, weightcost, n_real=n_real)

        elif engine == "xla":
            from tpu_sednn_torch.parallel import make_dp_train_chunk

            run_xla = make_dp_train_chunk(cfg, opt, mesh, pre_grouped=pre_grouped)

            def run(state, x, t, rng, lrate, momentum, weightcost, n_real=None):
                if n_real is not None:
                    raise ValueError("the plain DP trainer takes trimmed chunks, not "
                                     "n_real-padded ones")
                return run_xla(state, x, t, rng, lrate, momentum, weightcost)
        else:
            raise ValueError(f"unknown engine {engine!r}")
    elif pre_grouped:
        raise ValueError("pre_grouped chunks need n_data_shards > 1")
    elif engine == "resident":
        from tpu_sednn_torch.ops.resident_chunk import make_resident_train_chunk

        run_res = make_resident_train_chunk(cfg, opt, **engine_kwargs)

        def run(state, x, t, rng, lrate, momentum, weightcost, n_real=None):
            # the in-kernel Philox stream takes an integer seed, not a generator
            seed = int(torch.randint(0, 2**31 - 1, (), generator=rng))
            return run_res(state, x, t, seed, lrate, momentum, weightcost, n_real=n_real)

    elif engine == "xla":
        run_j = make_jit_train_chunk(cfg, opt)

        def run(state, x, t, rng, lrate, momentum, weightcost):
            return run_j(state, x, t, rng, lrate, momentum, weightcost)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    _RUNNER_MEMO[memo_key] = run
    return run


@dataclass
class EpochResult:
    epoch: int
    cv_mse: float
    train_samples: int
    seconds: float
    samples_per_sec: float


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on CUDA through pinned memory, so the
    copy is asynchronous to the host thread that starts it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def train_epoch_pfile(
    state: TrainState,
    cfg: ModelConfig,
    opt: OptConfig,
    fea_file: str,
    targ_file: str,
    norm_file: str,
    fea_dim: int,
    fea_context: int,
    targ_offset: int,
    train_sent_range: Tuple[int, int],
    cv_sent_range: Tuple[int, int],
    traincache: int,
    seed: int,
    nat: bool = True,
    logger: Optional[Logger] = None,
    rand: Optional[Rand48] = None,
    n_data_shards: int = 1,
    engine: str = "xla",
    cv_dump_path: Optional[str] = None,
    device_splice: Optional[bool] = None,
    engine_kwargs: Optional[Dict] = None,
) -> Tuple[TrainState, EpochResult]:
    """One epoch over pfiles with reference semantics (shuffled chunk order,
    lrand48 scatter, quirk-exact update), then the CV pass.  Runs on the
    device `state` lives on.

    This is `BPtrain` run once, as a function: same arguments, same logging
    shape, state returned instead of written to disk (and updated in place).

    cv_dump_path: write every CV output frame as a "%f "-separated line (the
    reference's CV_out.txt channel, which it ships commented out).

    device_splice: ship RAW normalized frames + int32 gather tables per chunk
    and run splice/NAT/scatter on the device (data.device_chunk) — ~1/12th
    the host->device transfer — with every chunk padded to fixed capacities
    (the resident engine's n_real skips the padded bunches).  Same math as
    read_chunk_parity.  None = auto: on for the resident engine on a CUDA
    device with NAT, off for data parallelism.

    n_data_shards > 1: data parallelism over the process group (one rank per
    process, torch.distributed joined by the caller; `cli` does it for
    gpu_used > 1).  Every rank reads the same pfiles with the same Rand48
    stream, so chunk order and scatter agree; each regroups the chunk's
    bunch_part rows on the host and ships only its own
    (parallel.make_global_chunk); the state is broadcast from rank 0 first.
    The CV pass runs on rank 0's replica, and rank 0 alone logs; every rank
    returns the same state and result.
    """
    log = logger or Logger()
    t0 = time.time()
    dev = state.device
    mesh = None
    if n_data_shards > 1:
        from tpu_sednn_torch.parallel import make_mesh, replicate

        mesh = make_mesh(n_data=n_data_shards, devices=[dev])
        replicate(state, mesh)
        if mesh.index != 0:
            log = Logger(is_host0=False)
    fea_info = read_pfile_info(fea_file, fea_dim)
    out_dim = int(state.params.b[-1].shape[0])
    targ_info = read_pfile_info(targ_file, out_dim)
    if fea_info.num_frames != targ_info.num_frames or fea_info.num_sentences != targ_info.num_sentences:
        raise ValueError("feature/target pfiles inconsistent")
    if not np.array_equal(fea_info.frames_before_sent, targ_info.frames_before_sent):
        raise ValueError("feature/target pfile tails inconsistent")
    mean, inv_std = load_norm(norm_file, fea_dim)

    # single srand48 stream per run: parity init consumed it first, so accept
    # the caller's instance to continue the exact sequence
    rand = rand if rand is not None else Rand48(seed)
    plan = plan_chunks(fea_info.frames_before_sent, train_sent_range, fea_context, traincache)
    log.info(
        f"Training sentences have {plan.total_chunks} chunks, {plan.total_samples} samples."
    )
    chunk_order = rand.shuffle_indices(plan.total_chunks)

    resolved_engine = engine
    if resolved_engine == "auto":
        resolved_engine, _extra = _auto_engine(cfg, opt, engine_kwargs, dev)
        engine_kwargs = {**(engine_kwargs or {}), **_extra}
    if mesh is not None:
        device_splice = False  # each rank ships its rows of the host-regrouped chunk
    elif device_splice is None:
        device_splice = resolved_engine == "resident" and dev.type == "cuda" and nat
    run_chunk = make_chunk_runner(cfg, opt, resolved_engine, n_data_shards=n_data_shards,
                                  pre_grouped=mesh is not None, device=dev,
                                  **(engine_kwargs or {}))
    rng = torch.Generator().manual_seed(int(seed))

    # host chunk prep runs one step ahead of device compute (single worker, so
    # the parity lrand48 stream is still consumed strictly in chunk order)
    from tpu_sednn_torch.data.prefetch import Prefetcher

    if device_splice:
        from tpu_sednn_torch.data.device_chunk import (
            build_chunk_on_device, chunk_capacities, read_chunk_indexed,
        )

        frames_cap, samples_cap, seg_cap = chunk_capacities(fea_info, plan, fea_context)
        samples_cap = ((samples_cap + opt.bunchsize - 1)
                       // opt.bunchsize) * opt.bunchsize

        def read_idx(ci):
            item = read_chunk_indexed(
                fea_info, targ_info, plan, int(ci), fea_context, mean, inv_std,
                rand, frames_cap=frames_cap, samples_cap=samples_cap,
                seg_cap=seg_cap,
            )
            # start the host->device copy from the prefetch worker, so chunk
            # k+1's transfer is queued while chunk k trains
            return tuple(_to_device(a, dev) for a in item[:6]) + (item[6],)

        for i, item in enumerate(Prefetcher(chunk_order, read_idx, depth=2)):
            fea, targ, win_start, seg_id, seg_off, seg_len, n_samples = item
            x, t = build_chunk_on_device(
                fea, targ, win_start, seg_id, seg_off, seg_len,
                fea_context, targ_offset, nat)
            n_real = n_samples // opt.bunchsize
            if resolved_engine == "resident":
                state = run_chunk(state, x, t, rng, opt.lrate, opt.momentum,
                                  opt.weightcost, n_real=n_real)
            else:  # plain engine: trim to real bunches
                keep = n_real * opt.bunchsize
                state = run_chunk(state, x[:keep], t[:keep], rng,
                                  opt.lrate, opt.momentum, opt.weightcost)
            log.info(f"Starting chunk {i + 1} of {plan.total_chunks} "
                     f"containing {n_samples} samples.")
    else:
        def read(ci):
            return read_chunk_parity(
                fea_info, targ_info, plan, int(ci), fea_context, targ_offset,
                mean, inv_std, rand, nat=nat,
            )

        if mesh is not None:
            from tpu_sednn_torch.parallel import bunch_part_regroup_host, make_global_chunk

            def to_dev(a):
                return make_global_chunk(
                    bunch_part_regroup_host(np.asarray(a), opt.bunchsize, mesh.n_data), mesh)
        else:
            def to_dev(a):
                return _to_device(a, dev)

        for i, (indata, targ) in enumerate(Prefetcher(chunk_order, read, depth=2)):
            state = run_chunk(state, to_dev(indata), to_dev(targ), rng,
                              opt.lrate, opt.momentum, opt.weightcost)
            log.info(f"Starting chunk {i + 1} of {plan.total_chunks} containing {len(indata)} samples.")

    # CV phase: unshuffled chunks, partial bunches included; with data
    # parallelism on rank 0's replica only
    cv_plan = plan_chunks(fea_info.frames_before_sent, cv_sent_range, fea_context, traincache)
    cv_here = mesh is None or mesh.index == 0
    sq_err = 0.0
    cv_params = state.params
    dump_f = open(cv_dump_path, "w") if cv_dump_path and cv_here else None
    if device_splice and dump_f is None and cv_plan.total_chunks > 0:
        # CV over the same on-device splice path: raw frames over the link
        # instead of spliced samples, padded to fixed capacities, garbage
        # rows masked out of the error sum
        from tpu_sednn_torch.data.device_chunk import (
            build_chunk_on_device, chunk_capacities, read_chunk_indexed,
        )
        from tpu_sednn_torch.train.step import cv_squared_error_masked

        cv_caps = chunk_capacities(fea_info, cv_plan, fea_context)

        def read_cv(ci):
            return read_chunk_indexed(
                fea_info, targ_info, cv_plan, int(ci), fea_context, mean,
                inv_std, None, frames_cap=cv_caps[0], samples_cap=cv_caps[1],
                seg_cap=cv_caps[2],
            )

        for item in Prefetcher(range(cv_plan.total_chunks), read_cv, depth=2):
            n_samples = item[6]
            x, tt = build_chunk_on_device(
                *(_to_device(a, dev) for a in item[:6]), fea_context, targ_offset, nat)
            sq_err += float(cv_squared_error_masked(cv_params, x, tt, n_samples, cfg))
    else:
        for ci in range(cv_plan.total_chunks if cv_here else 0):
            indata, targ = read_chunk_parity(
                fea_info, targ_info, cv_plan, ci, fea_context, targ_offset,
                mean, inv_std, None, nat=nat,
            )
            if dump_f is not None:
                from tpu_sednn_torch.train.step import cv_forward_and_sqerr

                out, se = cv_forward_and_sqerr(
                    cv_params, _to_device(indata, dev), _to_device(targ, dev), cfg)
                np.savetxt(dump_f, out.cpu().numpy(), fmt="%f", delimiter=" ")
                sq_err += float(se)
                continue
            sq_err += float(cv_squared_error(cv_params, _to_device(indata, dev),
                                             _to_device(targ, dev), cfg))
    if dump_f is not None:
        dump_f.close()
    cv_mse = sq_err / max(cv_plan.total_samples, 1)
    if mesh is not None:  # rank 0's CV to every rank
        box = [cv_mse]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        cv_mse = float(box[0])
    dt = time.time() - t0
    log.info(f"CV over. squared error: {cv_mse:f}")
    log.info(f"Total cost time: {dt:.1f} s.")
    return state, EpochResult(
        epoch=-1, cv_mse=cv_mse, train_samples=plan.total_samples,
        seconds=dt, samples_per_sec=plan.total_samples / max(dt, 1e-9),
    )


def train_epochs_arrays(
    state: TrainState,
    cfg: ModelConfig,
    opt_schedule: Callable[[int], OptConfig],
    x: np.ndarray,
    t: np.ndarray,
    x_cv: np.ndarray,
    t_cv: np.ndarray,
    n_epochs: int,
    seed: int = 0,
    traincache: int = 102400,
    logger: Optional[Logger] = None,
    on_epoch: Optional[Callable[[int, TrainState, EpochResult], None]] = None,
    profile_dir: Optional[str] = None,
    engine: str = "xla",
    engine_kwargs: Optional[Dict] = None,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 1,
) -> Tuple[TrainState, List[EpochResult]]:
    """In-memory epoch loop over prebuilt sample matrices, on the device
    `state` lives on.

    opt_schedule(epoch) supplies per-epoch lr/momentum (the Perl recipe's
    momentum ramp 0.5 -> 0.9).  Each epoch permutes the samples with a
    generator seeded from (seed, epoch), so an epoch's order and dropout
    stream do not depend on the epochs before it.  A non-finite CV error
    aborts immediately.
    profile_dir: capture a torch.profiler trace of the run (utils/profiling:
    trace), written as a Chrome trace `trace.json` there; it carries the
    program's `sednn.*` spans (the chunk trainer's host stages) beside the
    device's operations.

    Crash recovery: when `ckpt_dir` is given, a checkpoint carrying params,
    momentum and the CV history is written every `ckpt_every` epochs
    (utils/checkpoint.py) and the call RESUMES from the newest one if
    present; with the epoch-indexed generators a killed and resumed run
    reproduces the uninterrupted final state exactly.

    A trailing partial chunk goes to the trainer at its true size.  The JAX
    recipe pads it to `traincache` rows and passes `n_real` so that one
    compiled shape serves every chunk; nothing is compiled per shape here,
    and the trained result is the same bit for bit, so the gather and copy
    of the padding are saved.
    """
    from tpu_sednn_torch.utils.profiling import trace

    log = logger or Logger()
    results: List[EpochResult] = []
    dev = state.device
    start_epoch = 0
    if ckpt_dir is not None:
        from tpu_sednn_torch.utils.checkpoint import latest_step, restore_checkpoint

        s = latest_step(ckpt_dir)
        if s is not None:
            state, extra, _ = restore_checkpoint(ckpt_dir, s, device=dev)
            start_epoch = int(extra.get("epoch", s - 1)) + 1
            for e, cv in enumerate(extra.get("cv_hist", [])):
                results.append(EpochResult(e, float(cv), x.shape[0], 0.0, 0.0))
            log.info(f"resumed from checkpoint {ckpt_dir} at epoch {start_epoch}")
    n = x.shape[0]
    opt0 = opt_schedule(0)
    engine_kwargs = dict(engine_kwargs or {})
    if engine == "auto":
        engine, extra_kw = _auto_engine(cfg, opt0, engine_kwargs, dev)
        engine_kwargs.update(extra_kw)
    run_chunk = make_chunk_runner(cfg, opt0, engine, device=dev, **engine_kwargs)
    x_cv_d, t_cv_d = _to_device(x_cv, dev), _to_device(t_cv, dev)
    with trace(profile_dir):
        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            opt = opt_schedule(epoch)
            # epoch-indexed stream: the same order whether or not earlier epochs ran
            gen = torch.Generator().manual_seed(int(seed) * 1000003 + epoch)
            perm = torch.randperm(n, generator=gen).numpy()
            for st in range(0, n, traincache):
                idx = perm[st: st + traincache]
                state = run_chunk(
                    state, _to_device(x[idx], dev), _to_device(t[idx], dev), gen,
                    opt.lrate, opt.momentum, opt.weightcost,
                )
            cv_mse = float(cv_squared_error(state.params, x_cv_d, t_cv_d, cfg)) / len(x_cv)
            if not np.isfinite(cv_mse):
                raise FloatingPointError(
                    f"non-finite CV error at epoch {epoch} (diverged); "
                    f"last checkpoint: {ckpt_dir or 'none'}")
            dt = time.time() - t0
            res = EpochResult(epoch, cv_mse, n, dt, n / max(dt, 1e-9))
            results.append(res)
            log.info(
                f"epoch {epoch}: cv_mse={cv_mse:.6f} lr={opt.lrate} m={opt.momentum} "
                f"({res.samples_per_sec:.0f} samples/s)"
            )
            if ckpt_dir is not None and ((epoch + 1) % ckpt_every == 0 or epoch == n_epochs - 1):
                from tpu_sednn_torch.utils.checkpoint import save_checkpoint

                save_checkpoint(ckpt_dir, epoch + 1, state,
                                extra={"epoch": epoch,
                                       "cv_hist": [float(r.cv_mse) for r in results]})
            if on_epoch is not None:
                on_epoch(epoch, state, res)
    return state, results
