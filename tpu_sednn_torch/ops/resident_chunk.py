"""Whole-chunk trainer on hand-written CUDA (`csrc/resident_chunk.cu`) — the
port of tpu_sednn/ops/resident_chunk.py.

The TPU kernel trains a whole chunk in one launch with all weights and
momentum pinned in on-chip memory.  An H100 has no on-chip memory of that
size, so here the float32 state stays in device memory and ONE C call per
chunk enqueues, for every bunch, the fused forward launches (dropout mask,
bias, activation and the output layer's dedx in the products' epilogues) and
the fused backward + in-place update launches of csrc/fused_mlp.cuh: no
gradient matrix is materialised, W and delta are read once and written once
per bunch in the backward, and nothing synchronises with the host inside a
chunk.

Math is identical to train/step.py:reference_train_step (the quirk-exact
update rule: dedx_L = (2/n)(out-t), raw-sum gradients, delta = m*delta -
(1-m)*lr*(G/n + wc*W), partial bunch dropped) in float32, or to
clean_train_step with rule="clean".  Dropout masks come from Philox4x32-10
inside the kernels (parity semantics: mask without train-time rescale;
"inverted" rescales), one stream per (seed, bunch, layer), the same seed
formula as the TPU kernel but not its bits; `sample_resident_masks` exposes
exactly that stream.  As in the TPU kernel, the activation derivative is
taken on the stored masked activation (in inverted mode that leaves the
1/(1-omit) factor out of the backward).

The TPU kernel's single-device variants are options of the same trainer:
its products (`bf16`, default True as the JAX factory's: operands rounded to
bfloat16, float32 sums, on the tensor cores; False: float32 products),
bfloat16 state with stochastic rounding (`sr_delta`: the weight matrices'
momentum; `sr_state`: weights and momentum), row tiles that accumulate one
bunch's gradient into the momentum (`tile_rows`), and `hbm_spill`, which has
nothing to do on this card.  Every storage form runs with either product.
The data-parallel trainer is still to port.

Plain versions, beside the wrappers: `resident_train_chunk_reference` and
`sample_resident_masks_reference` (bit-equal Philox, so a chunk trained WITH
dropout, or with stochastic rounding, is comparable between kernel and plain
version).  `make_resident_train_chunk.launches` counts calls of the C entry
point, `kernel_launches` the kernel launches it enqueued, by kernel and form.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.model.mlp import MLP, ModelConfig, dropout_omits, mm_operand
from tpu_sednn_torch.ops import _build
from tpu_sednn_torch.ops.fused_mlp import ACTS
from tpu_sednn_torch.ops.philox import (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT, mask_threshold,
                                        philox_mask, sr_bits, sr_to_bf16_reference)
from tpu_sednn_torch.train.step import OptConfig, TrainState

# seed strides: distinct streams per (bunch, layer) mask
_BUNCH_STRIDE = 7919
_LAYER_STRIDE = 104729

_mask_threshold = mask_threshold

# kernel launches enqueued by the chunk trainer's C entry point, by kernel:
# fwd_kernel, bwd_kernel, reduce_dedy_kernel, then the count of those launches
# that drew dropout bits in the kernel, then fwd_sum_kernel (one for every
# forward whose K is split over the grid); then by form: bwd_kernel launches
# that stored bfloat16 with stochastic rounding, bwd_kernel launches of
# row-tiled bunches, fwd_kernel launches that read bfloat16 weights; the
# forward and backward launches of the tensor-core forms (tc_fwd_kernel,
# tc_bwd_kernel), counted in the first two as well
kernel_launches: Dict[str, int] = {"fused_linear_act": 0, "fused_bwd_update": 0,
                                   "reduce_dedy": 0, "philox_mask": 0,
                                   "fused_linear_act_sum": 0, "sr_bwd_update": 0,
                                   "tiled_bwd_update": 0, "bf16_linear_act": 0,
                                   "tc_linear_act": 0, "tc_bwd_update": 0}


def mask_key(seed: int, bunch_idx: int, layer_idx: int) -> int:
    """The 32-bit Philox key of (seed, bunch, layer): the TPU kernel's int32
    seed sum, defined mod 2**32."""
    return (int(seed) + int(bunch_idx) * _BUNCH_STRIDE + int(layer_idx) * _LAYER_STRIDE) & 0xFFFFFFFF


def sr_key(seed: int, bunch_idx: int, layer_idx: int) -> int:
    """The stochastic-rounding stream of (seed, bunch, layer): the mask
    streams' formula plus one, as in the TPU kernel."""
    return (mask_key(seed, bunch_idx, layer_idx) + 1) & 0xFFFFFFFF


def spill_layer_order(padded_sizes) -> list:
    """Layer indices in the order the TPU kernel's hbm_spill moves them out of
    its on-chip memory: smallest padded W first, later layers preferred on
    ties.  On this card every layer's state is in device memory already, so
    the order decides nothing here; it is kept because it is public."""
    L = len(padded_sizes) - 1
    return sorted(range(L), key=lambda l: (padded_sizes[l] * padded_sizes[l + 1], -l))


def _scal_coefs(rule: str, grad_n: int, out_dim: int, lrate, momentum,
                weightcost) -> Tuple[float, float, float]:
    """[m, A, B] for the generalized update delta' = m*delta - (A*g + B*w),
    where g is the kernel's gradient of (1/grad_n)*sum((out-t)^2), in float32
    arithmetic as the JAX package computes them.

    parity: A = (1-m)*lr/grad_n, B = (1-m)*lr*wc — the reference's double-1/n
    and (1-m) quirks.  clean: the kernel's g carries 2/grad_n;
    clean_train_step's loss is the mean over ALL B*n_out elements, so scale
    by 1/out_dim too.
    """
    f = np.float32
    m, lr, wc = f(momentum), f(lrate), f(weightcost)
    if rule == "parity":
        a_coef = (f(1.0) - m) * lr * f(1.0 / grad_n)
        b_coef = (f(1.0) - m) * lr * wc
    else:
        a_coef = lr * f(1.0 / out_dim)
        b_coef = lr * wc
    return float(m), float(a_coef), float(b_coef)


def _dropout_setup(cfg: ModelConfig, n_layers: int):
    omits = dropout_omits(cfg, n_layers)
    scales = [1.0 / (1.0 - o) if (o > 0.0 and cfg.dropout_mode == "inverted") else 1.0
              for o in omits]
    return omits, scales


def _cast_state(state: TrainState, w_dtype: torch.dtype, d_dtype: torch.dtype) -> None:
    """Bring the weight matrices and their momentum to the storage types a
    variant keeps them in (rounding to nearest where that narrows; a state
    already in them is left as it is).  Biases stay float32."""
    if any(w.dtype != w_dtype for w in state.params.w):
        state.params = MLP([w.data.to(w_dtype) for w in state.params.w], list(state.params.b))
    if any(d.dtype != d_dtype for d in state.deltas.w):
        state.deltas = MLP([d.data.to(d_dtype) for d in state.deltas.w], list(state.deltas.b))


@torch.no_grad()
def resident_train_chunk_reference(state: TrainState, in_chunk: torch.Tensor,
                                   targ_chunk: torch.Tensor, cfg: ModelConfig, bunch: int,
                                   coefs: Sequence[float], seed: int,
                                   n_real: Optional[int] = None,
                                   dtype: Optional[torch.dtype] = None,
                                   sr_state: bool = False, sr_delta: bool = False,
                                   tile_rows: Optional[int] = None,
                                   bf16: bool = True) -> TrainState:
    """Plain torch version of the chunk trainer: a loop over the bunches with
    the kernel's arithmetic written out (masks from `philox_mask`, bit-equal
    to the kernel's; derivative on the stored masked activation; update
    [m, A, B] = coefs).  Updates `state` in place and returns it.

    dtype: carry the state and every product in this type through the chunk
    (torch.float64: the function free of float32 rounding) and round to
    the state's types once at the end.

    sr_delta / sr_state: the weight matrices' momentum (and the weights) are
    bfloat16 values throughout: each bunch's new value is rounded from
    float32 by `sr_to_bf16_reference` with the kernel's bits (`sr_bits` of
    `sr_key(seed, bunch, layer)`), so the rounding decisions are the
    kernel's wherever the float32 values agree.  Under sr_delta W takes the
    unrounded step.  The state must already be in those types.

    tile_rows: each bunch in row tiles; tile 0 applies the decay and weight
    cost, every tile adds its -A*g to the momentum, the step lands after
    the last, masks are keyed on the global tile index.

    bf16: the operands of the three products (forward, gradient, dedy) are
    rounded to bfloat16 (`mm_operand`) and the products summed in `dtype`;
    the update takes the unrounded W, the bias gradient the unrounded dedx.
    The net's input is then masked and scaled in float32, as the kernel does
    before it rounds it.  (The activations of later layers are `dtype`
    values; where float32 and float64 sums round to different bfloat16
    values, the difference grows from layer to layer: see chip_smoke.py.)
    """
    dt = dtype or torch.float32
    m, a_coef, b_coef = (float(c) for c in coefs)
    tile = bunch if tile_rows is None else int(tile_rows)
    accum = bunch // tile
    n_bunches = in_chunk.shape[0] // bunch
    n_real = n_bunches if n_real is None else int(n_real)
    ws = [w.data.to(dt) for w in state.params.w]
    bs = [b.data.to(dt) for b in state.params.b]
    dws = [d.data.to(dt) for d in state.deltas.w]
    dbs = [d.data.to(dt) for d in state.deltas.b]
    L = len(ws)
    omits, scales = _dropout_setup(cfg, L)
    dev = in_chunk.device

    def rounded(val, key, shift):
        bits = sr_bits(key, val.shape[0], val.shape[1], shift, dev)
        return sr_to_bf16_reference(val.to(torch.float32), bits).to(dt)

    for i in range(n_real):
        for j in range(accum):
            gi = i * accum + j
            h = in_chunk[gi * tile:(gi + 1) * tile]
            h = h.to(h.dtype if bf16 else dt)
            t = targ_chunk[gi * tile:(gi + 1) * tile].to(dt)
            ys = []
            for l in range(L):
                if omits[l] > 0.0:
                    mask = philox_mask(mask_key(seed, gi, l), tile, h.shape[1], omits[l],
                                       device=dev)
                    h = h * (mask.to(h.dtype) * scales[l])
                h = h.to(dt)
                ys.append(h)
                z = mm_operand(h, bf16, dt) @ mm_operand(ws[l], bf16, dt) + bs[l]
                act = cfg.hidden if l < L - 1 else cfg.output
                h = torch.relu(z) if act == "relu" else torch.sigmoid(z) if act == "sigmoid" else z
            out = h
            dedx = (2.0 / bunch) * (out - t)
            if cfg.output == "sigmoid":
                dedx = dedx * out * (1.0 - out)
            for l in range(L - 1, -1, -1):
                dedx_r = mm_operand(dedx, bf16, dt)
                dedy = dedx_r @ mm_operand(ws[l], bf16, dt).T if l > 0 else None  # pre-update W
                g = mm_operand(ys[l], bf16, dt).T @ dedx_r
                gb = dedx.sum(dim=0)
                if j == 0:
                    nd = m * dws[l] - (a_coef * g + b_coef * ws[l])
                    ndb = m * dbs[l] - a_coef * gb
                else:
                    nd = dws[l] - a_coef * g
                    ndb = dbs[l] - a_coef * gb
                if sr_state or sr_delta:
                    dws[l] = rounded(nd, sr_key(seed, i, l), SR_DELTA_SHIFT)
                else:
                    dws[l] = nd
                dbs[l] = ndb
                if j == accum - 1:
                    if sr_state:
                        ws[l] = rounded(ws[l] + nd, sr_key(seed, i, l), SR_WEIGHT_SHIFT)
                    else:
                        ws[l] = ws[l] + nd
                    bs[l] = bs[l] + ndb
                if l > 0:
                    y = ys[l]
                    dedx = (torch.where(y > 0, dedy, torch.zeros((), dtype=dt, device=dev))
                            if cfg.hidden == "relu" else y * (1.0 - y) * dedy)
    for dst, src in zip(list(state.params.w) + list(state.params.b)
                        + list(state.deltas.w) + list(state.deltas.b), ws + bs + dws + dbs):
        dst.data.copy_(src.to(dst.dtype))
    state.step += n_real
    return state


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("resident_chunk")
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.resident_workspace_floats.argtypes = [ip, i, i, i]
    lib.resident_workspace_floats.restype = ctypes.c_longlong
    lib.resident_chunk_train.argtypes = [p, p, i, i, i, ip, i, pp, i, pp, i, pp, pp, p, i, i, u, u,
                                         f, f, u, f, f, f, i, ctypes.POINTER(ctypes.c_longlong), p]
    lib.resident_chunk_train.restype = ctypes.c_int
    lib.philox_mask_f32.argtypes = [p, i, i, i, u, u, f, p]
    lib.philox_mask_f32.restype = ctypes.c_int
    lib.philox_words_u32.argtypes = [p, p, i, p]
    lib.philox_words_u32.restype = ctypes.c_int
    return lib


def _not_ported(what: str):
    raise NotImplementedError(f"{what}: not yet ported")


def make_resident_train_chunk(cfg: ModelConfig, opt: OptConfig,
                              bf16: bool = True,
                              rule: str = "parity", sr_state: bool = False,
                              tile_rows: int | None = None,
                              sr_delta: bool = False,
                              hbm_spill: int = 0):
    """Chunk trainer: whole chunk, one C call, state updated in place.

    Same contract as train.step.make_jit_train_chunk (partial bunch dropped;
    any layer sizes, nothing padded), but takes an integer `seed` for the
    in-kernel Philox dropout instead of a generator.  lrate/momentum/
    weightcost may change from call to call (the recipe's momentum ramp).

    rule: "parity" = the reference's quirk-exact update (double 1/n, (1-m));
    "clean" = standard Polyak momentum on the mean-MSE gradient (matches
    train.step.clean_train_step).

    sr_delta: the weight matrices' MOMENTUM stored bfloat16 (weights, biases
    and every computed value stay float32; the weight step applies the
    unrounded float32 delta) with stochastic rounding on the stored
    recurrence.  sr_state: weights AND momentum stored bfloat16 (biases
    float32), stochastic rounding on both stores.  Both are allowed with both
    rules: the update formula is unchanged, but equality with the float32
    trainer is lost to unbiased bfloat16-ulp rounding noise.  run() casts an
    incoming float32 state where needed (the state object then holds new
    bfloat16 tensors; a second call takes them as they are).  They are what
    the JAX package trains the 16 kHz net with; on this card they halve the
    state's memory and, with float32 products, are not faster (operations
    bound).

    tile_rows: stream each opt.bunchsize-row update batch through the kernels
    in row tiles of this size, accumulating the gradient into the momentum
    buffer and applying the weight step with the last tile: big update
    batches (clean rule, float32 state) with a bounded activation workspace.
    None = the whole bunch is one tile.

    hbm_spill: the TPU kernel keeps this many layers' W and delta outside its
    on-chip memory.  Here the whole state lives in device memory at every
    size and there is nothing to stage: the kwarg is validated as the JAX
    factory validates it and the run is the float32 trainer's, bit for bit.

    bf16: True (the JAX factory's default) rounds both operands of every
    product to bfloat16 and sums in float32, on the tensor cores
    (csrc/fused_mlp.cuh: tc_fwd_kernel, tc_bwd_kernel); biases, the bias
    gradient and the update on the unrounded W stay float32.  False: float32
    products.  Either runs with every storage form above.  The data-parallel
    trainer is still to port.  The TPU kernel's interpret and dedy_full have
    no counterpart (a CPU state takes the plain version; dedy_full names a
    scheduling choice of that kernel).

    run(state, x, t, seed, lrate, momentum, weightcost, n_real=None): on a
    CUDA state launches the kernels (or raises); on a CPU state runs
    `resident_train_chunk_reference`.  Writes into `state` and returns it.
    """
    sizes = tuple(int(s) for s in cfg.layersizes)
    bunch = opt.bunchsize
    if bunch % 8:
        raise ValueError(f"bunchsize {bunch} must be a multiple of 8")
    if rule not in ("parity", "clean"):
        raise ValueError(f"unknown rule {rule!r}")
    if cfg.hidden not in ("relu", "sigmoid") or cfg.output not in ("linear", "sigmoid"):
        raise ValueError(f"unsupported activations {cfg.hidden!r}/{cfg.output!r}")
    if sr_state and sr_delta:
        raise ValueError("sr_state (bf16 weights+momentum) already implies "
                         "bf16 momentum; sr_delta is mutually exclusive")
    if not 0 <= hbm_spill <= len(sizes) - 1:
        raise ValueError(f"hbm_spill {hbm_spill} out of range [0, {len(sizes)-1}]")
    if hbm_spill and (sr_state or sr_delta):
        raise ValueError("hbm_spill is the f32 hybrid-residency mode; the "
                         "bf16 sr modes shrink the state instead — combine "
                         "neither (they solve the same VMEM problem)")
    tile = tile_rows if tile_rows is not None else bunch
    if bunch % tile or tile % 8:
        raise ValueError(f"tile_rows {tile} must divide bunchsize {bunch} "
                         "and be a multiple of 8")
    accum = bunch // tile
    if accum > 1 and (rule != "clean" or sr_state or sr_delta):
        raise ValueError("row-tiled gradient accumulation (tile_rows < "
                         "bunchsize) is a clean-rule, fp32/bf16-state option; "
                         "it accumulates INTO the momentum buffer, which must "
                         "stay f32 (no sr_state/sr_delta)")
    if accum > 1 and hbm_spill:
        raise ValueError("hbm_spill with row-tiled accumulation would stream "
                         "the spilled momentum from HBM once per TILE; "
                         "unsupported — use one or the other")
    w_dtype = torch.bfloat16 if sr_state else torch.float32
    d_dtype = torch.bfloat16 if (sr_state or sr_delta) else torch.float32
    L = len(sizes) - 1
    omits, scales = _dropout_setup(cfg, L)
    omit_vis, omit_hid = omits[0], (omits[1] if L > 1 else 0.0)
    scale_vis, scale_hid = scales[0], (scales[1] if L > 1 else 1.0)

    def run(state: TrainState, in_chunk: torch.Tensor, targ_chunk: torch.Tensor, seed,
            lrate=opt.lrate, momentum=opt.momentum, weightcost=opt.weightcost,
            n_real=None) -> TrainState:
        """n_real: optional count of REAL bunches when `in_chunk` is padded
        to a fixed capacity; rows at or past n_real * bunchsize are never
        read.  None = all full bunches."""
        n_bunches = in_chunk.shape[0] // bunch
        if n_bunches == 0:
            return state
        nr = n_bunches if n_real is None else int(n_real)
        if not 0 <= nr <= n_bunches:
            raise ValueError(f"n_real {nr} outside [0, {n_bunches}]")
        coefs = _scal_coefs(rule, bunch, sizes[-1], lrate, momentum, weightcost)
        dev = state.device
        if in_chunk.shape[1] != sizes[0] or targ_chunk.shape[1] != sizes[-1]:
            raise ValueError(f"chunk widths {in_chunk.shape[1]}/{targ_chunk.shape[1]} do not "
                             f"match the net {sizes[0]}/{sizes[-1]}")
        _cast_state(state, w_dtype, d_dtype)
        if dev.type == "cpu":
            return resident_train_chunk_reference(state, in_chunk, targ_chunk, cfg, bunch, coefs,
                                                  int(seed), n_real=nr, sr_state=sr_state,
                                                  sr_delta=sr_delta, tile_rows=tile, bf16=bf16)
        if dev.type != "cuda":
            raise ValueError(f"the chunk trainer runs on cuda or cpu, got {dev}")
        tensors = (list(state.params.w), list(state.deltas.w), list(state.params.b),
                   list(state.deltas.b))
        for group, dtype in zip(tensors, (w_dtype, d_dtype, torch.float32, torch.float32)):
            for l, a in enumerate(group):
                want = (sizes[l], sizes[l + 1]) if a.dim() == 2 else (sizes[l + 1],)
                if (tuple(a.shape) != want or a.dtype != dtype or a.device != dev
                        or not a.is_contiguous()):
                    raise ValueError(f"state tensor of layer {l}: {tuple(a.shape)} {a.dtype} on "
                                     f"{a.device}; expected {dtype} {want} on {dev}, contiguous")
        for name, a in (("in_chunk", in_chunk), ("targ_chunk", targ_chunk)):
            if a.dtype != torch.float32 or a.device != dev or not a.is_contiguous():
                raise ValueError(f"{name}: float32, contiguous, on {dev} expected; got {a.dtype} "
                                 f"on {a.device}")
        if targ_chunk.shape[0] < nr * bunch:
            raise ValueError("targ_chunk has fewer rows than n_real bunches")
        lib = _lib()
        c_sizes = (ctypes.c_int * (L + 1))(*sizes)
        work = torch.empty(lib.resident_workspace_floats(c_sizes, L, tile, int(bf16)),
                           dtype=torch.float32, device=dev)
        ptrs = [(ctypes.c_void_p * L)(*[a.data_ptr() for a in group]) for group in tensors]
        tallies = (ctypes.c_longlong * len(kernel_launches))()
        with torch.cuda.device(dev):
            rc = lib.resident_chunk_train(
                in_chunk.data_ptr(), targ_chunk.data_ptr(), nr, tile, accum, c_sizes, L,
                ptrs[0], int(sr_state), ptrs[1], int(sr_state or sr_delta), ptrs[2], ptrs[3],
                work.data_ptr(),
                ACTS[cfg.hidden], ACTS[cfg.output],
                mask_threshold(omit_vis) if omit_vis > 0.0 else 0,
                mask_threshold(omit_hid) if omit_hid > 0.0 else 0,
                scale_vis, scale_hid, int(seed) & 0xFFFFFFFF, *coefs, int(bf16), tallies,
                torch.cuda.current_stream(dev).cuda_stream)
        for name, n in zip(kernel_launches, tallies):
            kernel_launches[name] += int(n)
        if rc != 0:
            raise RuntimeError(f"chunk trainer launch failed: CUDA error {rc}")
        make_resident_train_chunk.launches += 1
        state.step += nr
        return state

    return run


make_resident_train_chunk.launches = 0


def make_dp_resident_train_chunk(*args, **kwargs):
    """The data-parallel chunk trainer (bunch_part row split, gradient
    all-reduce before the in-place update) is still to port."""
    _not_ported("make_dp_resident_train_chunk (data-parallel chunk trainer)")


def _slice_rows(shape, device_idx: int, n_dev: int) -> Tuple[int, int, int, int]:
    g_rows, width = int(shape[0]), int(shape[1])
    if g_rows % n_dev:
        raise ValueError(f"global rows {g_rows} not divisible by n_dev {n_dev}")
    bs_local = g_rows // n_dev
    return g_rows, width, bs_local, device_idx * bs_local


def sample_resident_masks_reference(seed: int, bunch_idx: int, layer_idx: int, shape,
                                    omit: float, device_idx: int = 0, n_dev: int = 1,
                                    device: str | torch.device = "cpu") -> torch.Tensor:
    """Plain torch version of `sample_resident_masks` (Philox in integer
    tensor arithmetic, ops/philox.py), bit-equal to the kernel."""
    _, width, bs_local, row0 = _slice_rows(shape, device_idx, n_dev)
    return philox_mask(mask_key(seed, bunch_idx, layer_idx), bs_local, width, omit, row0=row0,
                       device=device)


def sample_resident_masks(seed: int, bunch_idx: int, layer_idx: int,
                          shape, omit: float, device_idx: int = 0,
                          n_dev: int = 1,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """The exact dropout mask the chunk trainer draws for (seed, bunch,
    layer) — same key formula, threshold and device function — from a
    standalone launch, so mask statistics (zero rate, stream collisions,
    rank-slice identity) can be checked on the card.

    `shape` is the GLOBAL bunch mask shape; with n_dev > 1 the returned mask
    is rank `device_idx`'s rows [d*bs_local, (d+1)*bs_local) of it: a mask
    element depends only on (key, global row, column), never on the number
    of devices.  device="cuda" launches the kernel (or raises); "cpu" runs
    the plain version.
    """
    _, width, bs_local, row0 = _slice_rows(shape, device_idx, n_dev)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return sample_resident_masks_reference(seed, bunch_idx, layer_idx, shape, omit,
                                               device_idx, n_dev)
    out = torch.empty((bs_local, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().philox_mask_f32(out.data_ptr(), bs_local, width, row0,
                                    mask_key(seed, bunch_idx, layer_idx), mask_threshold(omit),
                                    1.0, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"philox mask kernel launch failed: CUDA error {rc}")
    sample_resident_masks.launches += 1
    return out


sample_resident_masks.launches = 0


def philox_words_on_device(counters_and_keys: torch.Tensor) -> torch.Tensor:
    """(n, 6) int64 rows (c0, c1, c2, c3, k0, k1) on a CUDA device -> (n, 4)
    int64 words of the kernels' philox4x32_10 device function; for the
    known-answer vectors."""
    if counters_and_keys.device.type != "cuda":
        raise ValueError("philox_words_on_device needs a CUDA tensor; "
                         "ops.philox.philox4x32_10 is the plain version")
    dev = counters_and_keys.device
    inp = (counters_and_keys & 0xFFFFFFFF).to(torch.int64)
    # the C side reads uint32 words: pack the low 32 bits of each value
    packed = torch.where(inp >= 2 ** 31, inp - 2 ** 32, inp).to(torch.int32).contiguous()
    out = torch.empty((inp.shape[0], 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().philox_words_u32(packed.data_ptr(), out.data_ptr(), inp.shape[0],
                                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"philox words kernel launch failed: CUDA error {rc}")
    return out.to(torch.int64) & 0xFFFFFFFF
