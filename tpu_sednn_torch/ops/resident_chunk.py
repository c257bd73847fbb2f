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
chunk.  In both product forms every launch after a call's first is a
programmatic dependent launch: it starts while the launch before it ends and
loads, before it waits for that launch, the operands `early_read_plan`
allows it (the C code decides no hazard of its own).

Math is identical to train/step.py:reference_train_step (the quirk-exact
update rule: dedx_L = (2/n)(out-t), raw-sum gradients, delta = m*delta -
(1-m)*lr*(G/n + wc*W), partial bunch dropped) in float32, or to
clean_train_step with rule="clean".  Dropout masks come from Philox4x32-10
on the card (parity semantics: mask without train-time rescale; "inverted"
rescales), one stream per (seed, bunch, layer), the same seed formula as the
TPU kernel but not its bits; `sample_resident_masks` exposes exactly that
stream.  A call draws the input's masks of all its tiles once, by one launch
(`input_mask_bits`: 32 columns a 32-bit word; a data-parallel rank its rows
of them), before its chain, and the
layer-0 forward and backward read them; each hidden layer's mask is drawn
in the epilogue of the forward that writes that activation.  As in the TPU
kernel, the activation derivative is taken on the stored masked activation
(in inverted mode that leaves the 1/(1-omit) factor out of the backward).

The TPU kernel's single-device variants are options of the same trainer:
its products (`bf16`, default True as the JAX factory's: operands rounded to
bfloat16, float32 sums, on the tensor cores; False: float32 products),
bfloat16 state with stochastic rounding (`sr_delta`: the weight matrices'
momentum; `sr_state`: weights and momentum), row tiles that accumulate one
bunch's gradient into the momentum (`tile_rows`), and `hbm_spill`, which has
nothing to do on this card.  Every storage form runs with either product.
The data-parallel trainer (`make_dp_resident_train_chunk`) trains a rank's
rows of every bunch and sums each layer's gradient over the ranks between
the gradient-out backward and the update kernel (ops/fused_mlp.py), where
the TPU kernel sums inside the kernel: with NCCL where each rank has a card,
with the rank_sum kernel (ops/rank_sum.py) where the ranks share one.

Plain versions, beside the wrappers: `resident_train_chunk_reference` and
`sample_resident_masks_reference` (bit-equal Philox, so a chunk trained WITH
dropout, or with stochastic rounding, is comparable between kernel and plain
version).
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
from tpu_sednn_torch.ops.fused_mlp import ACTS, _check_bwd_rows
from tpu_sednn_torch.ops.philox import (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT, mask_threshold,
                                        mask_words, philox_mask, philox_mask_words, sr_bits,
                                        sr_to_bf16_reference)
from tpu_sednn_torch.parallel.mesh import Mesh, all_reduce, fence, local_rows
from tpu_sednn_torch.train.step import OptConfig, TrainState
from tpu_sednn_torch.utils.profiling import span

# seed strides: distinct streams per (bunch, layer) mask
_BUNCH_STRIDE = 7919
_LAYER_STRIDE = 104729

_mask_threshold = mask_threshold

# early_read_plan's bits (csrc/pdl.cuh): the operand groups a launch of the
# chain may read before its griddepcontrol.wait
EARLY_W = 1      # the layer's W and b
EARLY_DELTA = 2  # the layer's delta and delta_b
EARLY_YPREV = 4  # the backward's yprev, the layer's input


def plan_index(direction: int, layer: int, first: bool, n_layers: int) -> int:
    """Where early_read_plan keeps a launch's flags: direction 0 for the
    forward of `layer`, 1 for its backward; first for the first launch of a
    call."""
    return (direction * n_layers + layer) * 2 + int(first)


def early_read_plan(n_layers: int, accum: int) -> list:
    """The chunk trainer's hazard rule for its chain of launches, as
    4 * n_layers ints of EARLY_* bits at `plan_index`: the operand groups
    each launch may read before it waits for the launch just before it.

    A call enqueues, for every tile of `accum` tiles of every bunch, the
    forwards of layers 0..L-1, then the backwards of layers L-1..0: one
    launch each in either product form (tensor cores or float32 FMAs), so
    one plan serves both.  Every launch after the call's first is a
    programmatic dependent launch: it may start when every block of the
    launch before it has passed its own wait, so every launch before that
    one has completed and its writes are visible (csrc/pdl.cuh).  The rule:
    a launch may read an operand early only if the launch just before it
    does not write it.
    * The call's first launch reads nothing early.
    * The forward of layer l >= 1 follows the forward of layer l-1, which
      writes only y[l-1] (this forward's x, read after the wait): W_l early.
    * The forward of layer 0 follows the backward of layer 0 of the tile
      before, which writes W_0 and b_0 where that tile ends a bunch: before
      every bunch's first tile (with row tiles the other tiles could read
      W_0 early, but one flag serves every tile): nothing early.
    * The backward of layer l follows the forward of the last layer (which
      writes the output and dedx) or the backward of layer l+1 (which
      writes layer l+1's state and dedx, this launch's dedx): its W, b,
      delta, delta_b and yprev (x or y[l-1]) early; dedx after the wait.
    Writes wait in every launch, so nothing a launch reads early is written
    before the launch completes.  The input masks' bit table is written by
    an ordinary launch before the call's first, so every launch may read it,
    early or not: it is in no group."""
    if n_layers < 1 or accum < 1:
        raise ValueError(f"a chain of {n_layers} layers and {accum} tiles a bunch")
    plan = [0] * (4 * n_layers)
    for l in range(n_layers):
        plan[plan_index(0, l, False, n_layers)] = EARLY_W if l > 0 else 0
        plan[plan_index(1, l, False, n_layers)] = EARLY_W | EARLY_DELTA | EARLY_YPREV
    return plan


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


def _checked_state(state: TrainState, sizes, w_dtype: torch.dtype, d_dtype: torch.dtype):
    """(W, delta, b, delta_b) lists of the state after checking what the
    kernels read through raw pointers: shapes, storage types, the state's
    device, contiguity."""
    dev = state.device
    tensors = (list(state.params.w), list(state.deltas.w), list(state.params.b),
               list(state.deltas.b))
    for group, dtype in zip(tensors, (w_dtype, d_dtype, torch.float32, torch.float32)):
        for l, a in enumerate(group):
            want = (sizes[l], sizes[l + 1]) if a.dim() == 2 else (sizes[l + 1],)
            if (tuple(a.shape) != want or a.dtype != dtype or a.device != dev
                    or not a.is_contiguous()):
                raise ValueError(f"state tensor of layer {l}: {tuple(a.shape)} {a.dtype} on "
                                 f"{a.device}; expected {dtype} {want} on {dev}, contiguous")
    return tensors


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
    tile = bunch if tile_rows is None else int(tile_rows)
    return _chunk_reference(state, in_chunk, targ_chunk, cfg, tile, bunch // tile, bunch, coefs,
                            seed, n_real, dtype, sr_state, sr_delta, bf16)


@torch.no_grad()
def _chunk_reference(state: TrainState, in_chunk: torch.Tensor, targ_chunk: torch.Tensor,
                     cfg: ModelConfig, tile: int, accum: int, grad_n: int,
                     coefs: Sequence[float], seed: int, n_real: Optional[int],
                     dtype: Optional[torch.dtype], sr_state: bool, sr_delta: bool, bf16: bool,
                     row0: int = 0, reduce=None) -> TrainState:
    """The plain chunk trainer's loop, for one rank: bunches of `accum`
    tiles of `tile` rows, dedx carrying 2/grad_n (the global bunch), masks
    drawn at rows row0.. of the global tile, and each layer's gradient and
    bias gradient passed through `reduce` (the sum over the ranks) before
    the update.  A single device: row0 0, reduce None."""
    dt = dtype or torch.float32
    m, a_coef, b_coef = (float(c) for c in coefs)
    n_bunches = in_chunk.shape[0] // (tile * accum)
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
                                       row0=row0, device=dev)
                    h = h * (mask.to(h.dtype) * scales[l])
                h = h.to(dt)
                ys.append(h)
                z = mm_operand(h, bf16, dt) @ mm_operand(ws[l], bf16, dt) + bs[l]
                act = cfg.hidden if l < L - 1 else cfg.output
                h = torch.relu(z) if act == "relu" else torch.sigmoid(z) if act == "sigmoid" else z
            out = h
            dedx = (2.0 / grad_n) * (out - t)
            if cfg.output == "sigmoid":
                dedx = dedx * out * (1.0 - out)
            for l in range(L - 1, -1, -1):
                dedx_r = mm_operand(dedx, bf16, dt)
                dedy = dedx_r @ mm_operand(ws[l], bf16, dt).T if l > 0 else None  # pre-update W
                g = mm_operand(ys[l], bf16, dt).T @ dedx_r
                gb = dedx.sum(dim=0)
                if reduce is not None:
                    g, gb = reduce(g), reduce(gb)
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


def _c_api() -> Dict[str, tuple]:
    """csrc/resident_chunk.cu's entry points: name -> (argtypes, restype)."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    ll = ctypes.c_longlong
    return {
        "resident_workspace_floats": ([ip, i, i], ll),
        "resident_mask_words": ([i, i, i], ll),
        # ..., work, mask_bits, ..., bf16, plan (early_read_plan), stream
        "resident_chunk_train": ([p, p, i, i, i, ip, i, pp, i, pp, i, pp, pp, p, p, i, i, u, u, f,
                                  f, u, f, f, f, i, ip, p], i),
        # ..., scale_vis, scale_hid, mask_bits (the tile's rows of the rank's table), key0, ...
        "dp_chunk_forward": ([p, p, i, i, ip, i, pp, pp, pp, p, i, i, u, u, f, f, p, u, i, f, i,
                              p], i),
        "philox_mask_f32": ([p, i, i, i, u, u, f, p], i),
        "input_mask_bits_u32": ([p, i, i, i, i, u, u, p], i),
        "philox_words_u32": ([p, p, i, p], i),
    }


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return _build.load("resident_chunk", _c_api())


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
    (csrc/fused_mlp.cuh: tc_fwd_kernel, stripe_bwd_kernel); biases, the bias
    gradient and the update on the unrounded W stay float32.  Each rounded
    operand that one launch makes for the next is stored beside it by that
    launch (rne(dedx) for the backward, rne(y) of a hidden layer for the next
    forward), so no launch rounds another's output again.  False: float32
    products.  Either runs with every storage form above.  The data-parallel
    form is `make_dp_resident_train_chunk`.  The TPU kernel's interpret and dedy_full have
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
        with span("sednn.chunk.prepare"):
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
            if dev.type == "cuda":
                tensors = _checked_state(state, sizes, w_dtype, d_dtype)
                for name, a in (("in_chunk", in_chunk), ("targ_chunk", targ_chunk)):
                    if a.dtype != torch.float32 or a.device != dev or not a.is_contiguous():
                        raise ValueError(f"{name}: float32, contiguous, on {dev} expected; got "
                                         f"{a.dtype} on {a.device}")
                if targ_chunk.shape[0] < nr * bunch:
                    raise ValueError("targ_chunk has fewer rows than n_real bunches")
                _check_bwd_rows(tile)
        if dev.type == "cpu":
            return resident_train_chunk_reference(state, in_chunk, targ_chunk, cfg, bunch, coefs,
                                                  int(seed), n_real=nr, sr_state=sr_state,
                                                  sr_delta=sr_delta, tile_rows=tile, bf16=bf16)
        if dev.type != "cuda":
            raise ValueError(f"the chunk trainer runs on cuda or cpu, got {dev}")
        with span("sednn.chunk.alloc"):
            lib = _lib()
            c_sizes = (ctypes.c_int * (L + 1))(*sizes)
            work = torch.empty(lib.resident_workspace_floats(c_sizes, L, tile),
                               dtype=torch.float32, device=dev)
            # the input masks' bit table, drawn by the call's first launch (none without dropout)
            bits = (torch.empty(lib.resident_mask_words(nr * accum, tile, sizes[0]),
                                dtype=torch.int32, device=dev) if omit_vis > 0.0 else None)
        # no span encloses the launches: see utils/profiling.py
        ptrs = [(ctypes.c_void_p * L)(*[a.data_ptr() for a in group]) for group in tensors]
        plan = (ctypes.c_int * (4 * L))(*early_read_plan(L, accum))
        with torch.cuda.device(dev):
            rc = lib.resident_chunk_train(
                in_chunk.data_ptr(), targ_chunk.data_ptr(), nr, tile, accum, c_sizes, L,
                ptrs[0], int(sr_state), ptrs[1], int(sr_state or sr_delta), ptrs[2], ptrs[3],
                work.data_ptr(), None if bits is None else bits.data_ptr(),
                ACTS[cfg.hidden], ACTS[cfg.output],
                mask_threshold(omit_vis) if omit_vis > 0.0 else 0,
                mask_threshold(omit_hid) if omit_hid > 0.0 else 0,
                scale_vis, scale_hid, int(seed) & 0xFFFFFFFF, *coefs, int(bf16), plan,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"chunk trainer launch failed: CUDA error {rc}")
        state.step += nr
        return state

    return run


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data-parallel trainer's sum of a layer's gradient over the ranks."""
    return all_reduce(t, mesh)


def _mask_row0(mesh: Mesh, tile_local: int) -> int:
    """The first row of the global tile that this rank's rows are: where its
    masks start in their Philox streams."""
    return mesh.index * tile_local


@torch.no_grad()
def dp_resident_train_chunk_reference(state: TrainState, in_local: torch.Tensor,
                                      targ_local: torch.Tensor, cfg: ModelConfig, bunch: int,
                                      coefs: Sequence[float], seed: int, mesh: Mesh,
                                      n_real: Optional[int] = None,
                                      dtype: Optional[torch.dtype] = None,
                                      sr_delta: bool = False, tile_rows: Optional[int] = None,
                                      bf16: bool = True) -> TrainState:
    """Plain torch version of the data-parallel chunk trainer, for this rank:
    `resident_train_chunk_reference`'s loop over this rank's rows
    (`in_local`: its tile_rows / n_dev rows of every global tile, in order)
    with dedx carrying 2/bunch (the GLOBAL bunch), every mask drawn at the
    rank's rows of the global tile (`philox_mask(..., row0)`), and each
    layer's gradient and bias gradient summed over the ranks
    (torch.distributed all-reduce) before the update.  bunch and tile_rows
    are global, as the factory takes them; dtype, sr_delta, bf16 as in
    `resident_train_chunk_reference`.  Updates `state` in place."""
    tile_g = bunch if tile_rows is None else int(tile_rows)
    tile = tile_g // mesh.n_data
    _chunk_reference(state, in_local, targ_local, cfg, tile, bunch // tile_g, bunch, coefs, seed,
                     n_real, dtype, False, sr_delta, bf16, row0=_mask_row0(mesh, tile),
                     reduce=lambda a: _all_reduce(a, mesh))
    fence(mesh)
    return state


def dp_tile_forward(cfg: ModelConfig, tile: int, tile_g: int, bf16: bool,
                    device: torch.device):
    """The data-parallel trainer's forward of one tile on the card
    (csrc/resident_chunk.cu:dp_chunk_forward); -> fwd(x, t, ws, bs, key0,
    row0, coef, in_bits=None).

    fwd runs this rank's `tile` rows x, t of a global tile of `tile_g` rows
    through the net (float32 weights ws, biases bs) with the input's mask
    read from in_bits (the tile's (tile, mask_words(width)) int32 rows of the
    table `input_mask_bits` draws at row0; required with input dropout,
    refused without) and hidden layer l's mask of stream key0 + l*104729
    drawn at rows row0.. of the global tile, and K split as for the global
    tile; -> (ys, dedx): each
    layer's masked activation (the last: the net's output) and dedx =
    coef * (out - t) [* out(1-out) for a sigmoid head], flat, in buffers
    that the next call overwrites."""
    sizes = tuple(int(s) for s in cfg.layersizes)
    L = len(sizes) - 1
    lib = _lib()
    c_sizes = (ctypes.c_int * (L + 1))(*sizes)
    f32 = dict(dtype=torch.float32, device=device)
    ys = [torch.empty((tile, sizes[l + 1]), **f32) for l in range(L)]
    dedx = torch.empty(tile * max(sizes), **f32)
    y_ptrs = (ctypes.c_void_p * L)(*[y.data_ptr() for y in ys])
    omits, scales = _dropout_setup(cfg, L)
    omit_hid, scale_hid = (omits[1], scales[1]) if L > 1 else (0.0, 1.0)
    thr_vis = mask_threshold(omits[0]) if omits[0] > 0.0 else 0
    thr_hid = mask_threshold(omit_hid) if omit_hid > 0.0 else 0

    def fwd(x, t, ws, bs, key0: int, row0: int, coef: float,
            in_bits: Optional[torch.Tensor] = None):
        if tuple(x.shape) != (tile, sizes[0]) or tuple(t.shape) != (tile, sizes[-1]):
            raise ValueError(f"a tile's rows: x {tuple(x.shape)}, t {tuple(t.shape)}; expected "
                             f"{tile} rows of {sizes[0]} and {sizes[-1]}")
        if (in_bits is None) != (thr_vis == 0):
            raise ValueError("the input's mask table is given with input dropout, and only then")
        if in_bits is not None:
            _check_table(in_bits, (tile, mask_words(sizes[0])), x.device)
        w_ptrs = (ctypes.c_void_p * L)(*[w.data_ptr() for w in ws])
        b_ptrs = (ctypes.c_void_p * L)(*[b.data_ptr() for b in bs])
        with torch.cuda.device(device):
            rc = lib.dp_chunk_forward(
                x.data_ptr(), t.data_ptr(), tile, tile_g, c_sizes, L, w_ptrs, b_ptrs, y_ptrs,
                dedx.data_ptr(), ACTS[cfg.hidden], ACTS[cfg.output], thr_vis,
                thr_hid, scales[0], scale_hid, None if in_bits is None else in_bits.data_ptr(),
                int(key0) & 0xFFFFFFFF, int(row0), float(coef), int(bf16),
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"data-parallel forward launch failed: CUDA error {rc}")
        return ys, dedx

    return fwd


def make_dp_resident_train_chunk(cfg: ModelConfig, opt: OptConfig, mesh: Mesh,
                                 bf16: bool = True, rule: str = "parity",
                                 dedy_full: bool = False, pre_grouped: bool = False,
                                 tile_rows: int | None = None, sr_delta: bool = False,
                                 hbm_spill: int = 0):
    """Data-parallel chunk trainer over a ("data",) mesh (parallel.make_mesh):
    one rank per process, each holding a full replica of the state.

    Each global bunch of opt.bunchsize rows is split bunch_part-style (rank d
    takes rows [d*bs_local, (d+1)*bs_local) of every bunch, or of every
    tile_rows tile); every rank runs the forward on its rows with the masks
    of its rows of the global bunch (Philox keyed on the global row; the
    input's drawn once a call into a bit table at the rank's rows, which
    the layer-0 forward and gradient-out backward read), dedx carrying
    2/(global bunch); per layer, last first, the gradient-out
    backward writes this rank's G and gb (`fused_bwd_grad_out`), one
    all-reduce sums them over the ranks, and the update kernel (`dp_update`)
    applies the sum on every replica, so replicas stay bit-equal.  The TPU
    kernel sums inside the kernel with remote copies between chips; here the
    sum runs between the kernels (`parallel.all_reduce`): NCCL where each
    rank has a card, the rank_sum kernel over CUDA IPC where the ranks share
    one (ops/rank_sum.py).  With dropout on, a run
    equals the single-device trainer with the same seed to reduction order,
    for any number of ranks.

    Same signature, defaults and checks as the JAX factory: n_dev a power of
    two; local bunch and local tile multiples of 8; tile_rows (global rows
    per tile, gradient accumulated into the momentum) a clean-rule option,
    not with sr_delta or pre_grouped; hbm_spill not with sr_delta or row
    tiles.  dedy_full and hbm_spill name choices of the TPU kernel's on-chip
    memory and change nothing here.  sr_delta: bfloat16 momentum with
    stochastic rounding from the single-device streams.

    run(state, in_chunk, targ_chunk, seed, lrate, momentum, weightcost,
    n_real=None): in_chunk the whole chunk (every rank holds it; this rank's
    rows are taken at tile granularity), or with pre_grouped this rank's rows
    of the host-regrouped chunk (`make_global_chunk`).  On a CUDA state the
    kernels run (or raise); on a CPU state `dp_resident_train_chunk_reference`.
    Writes into `state` and returns it.
    """
    sizes = tuple(int(s) for s in cfg.layersizes)
    bunch, n_dev = opt.bunchsize, mesh.n_data
    if n_dev < 1 or n_dev & (n_dev - 1):
        raise ValueError(f"data mesh size {n_dev} must be a power of two")
    if bunch % n_dev:
        raise ValueError(f"bunchsize {bunch} not divisible by mesh data={n_dev}")
    bs_local = bunch // n_dev
    if bs_local % 8:
        raise ValueError(f"local bunch {bs_local} must be a multiple of 8")
    if rule not in ("parity", "clean"):
        raise ValueError(f"unknown rule {rule!r}")
    if cfg.hidden not in ("relu", "sigmoid") or cfg.output not in ("linear", "sigmoid"):
        raise ValueError(f"unsupported activations {cfg.hidden!r}/{cfg.output!r}")
    tile_g = tile_rows if tile_rows is not None else bunch
    if bunch % tile_g or tile_g % n_dev:
        raise ValueError(f"tile_rows {tile_g} must divide bunchsize {bunch} "
                         f"and be divisible by mesh data={n_dev}")
    tile = tile_g // n_dev
    if tile % 8:
        raise ValueError(f"local tile {tile} must be a multiple of 8")
    accum = bunch // tile_g
    if accum > 1 and rule != "clean":
        raise ValueError("row-tiled gradient accumulation is a clean-rule "
                         "option (parity is per-128 sequential semantics)")
    if accum > 1 and pre_grouped:
        raise ValueError("pre_grouped input regroups at bunch granularity; "
                         "tile_rows < bunchsize needs the regroup of the whole chunk")
    if accum > 1 and sr_delta:
        raise ValueError("row-tiled accumulation rides in the momentum "
                         "buffer, which must stay f32 (no sr_delta)")
    if not 0 <= hbm_spill <= len(sizes) - 1:
        raise ValueError(f"hbm_spill {hbm_spill} out of range [0, {len(sizes)-1}]")
    if hbm_spill and (sr_delta or accum > 1):
        raise ValueError("hbm_spill is the f32 hybrid mode; no sr_delta or "
                         "row-tiled accumulation (same constraint as the "
                         "single-chip factory)")
    d_dtype = torch.bfloat16 if sr_delta else torch.float32
    L = len(sizes) - 1
    omits, scales = _dropout_setup(cfg, L)
    omit_vis, scale_vis = omits[0], scales[0]
    coef = float(np.float32(2.0) / np.float32(bunch))  # dedx's 2/n, as the C trainer forms it

    def run_kernels(state, x, t, nr, seed, coefs):
        from tpu_sednn_torch.ops.fused_mlp import dp_update, fused_bwd_grad_out

        dev = state.device
        row0 = _mask_row0(mesh, tile)
        forward = dp_tile_forward(cfg, tile, tile_g, bf16, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        spare = torch.empty(tile * max(sizes), **f32)
        grad = torch.empty(max(sizes[l] * sizes[l + 1] + sizes[l + 1] for l in range(L)), **f32)
        ws, ds, bs, dbs = (list(state.params.w), list(state.deltas.w), list(state.params.b),
                           list(state.deltas.b))
        # this rank's rows of the call's input masks, drawn once by an ordinary launch
        # before the first forward (none without input dropout or without a bunch)
        bits = (input_mask_bits(seed, nr * accum, tile, sizes[0], omit_vis, row0=row0,
                                device=dev) if omit_vis > 0.0 and nr > 0 else None)
        for i in range(nr):
            for j in range(accum):
                gi = i * accum + j
                xi, ti = x[gi * tile:(gi + 1) * tile], t[gi * tile:(gi + 1) * tile]
                key0 = mask_key(seed, gi, 0)
                in_bits = None if bits is None else bits[gi]
                ys, dedx = forward(xi, ti, ws, bs, key0, row0, coef, in_bits)
                other = spare
                for l in range(L - 1, -1, -1):
                    K, N = sizes[l], sizes[l + 1]
                    g = grad[:K * N + N]
                    fused_bwd_grad_out(
                        dedx[:tile * N].view(tile, N), xi if l == 0 else ys[l - 1], ws[l],
                        in_mask=in_bits if l == 0 else None, in_scale=scale_vis,
                        deriv=cfg.hidden if l > 0 else None, with_dedy=l > 0, bf16=bf16,
                        grad=g, dedy=other[:tile * K].view(tile, K) if l > 0 else None)
                    _all_reduce(g, mesh)
                    dp_update(ws[l], ds[l], bs[l], dbs[l], g, *coefs,
                              sr_seed=sr_key(seed, i, l) if sr_delta else None,
                              first=j == 0, apply=j == accum - 1)
                    dedx, other = other, dedx

    def run(state: TrainState, in_chunk: torch.Tensor, targ_chunk: torch.Tensor, seed,
            lrate=opt.lrate, momentum=opt.momentum, weightcost=opt.weightcost,
            n_real=None) -> TrainState:
        """n_real: optional count of REAL bunches when the chunk is padded to
        a fixed capacity; rows past them are never trained.  None = all full
        bunches."""
        n_bunches = in_chunk.shape[0] // (bs_local if pre_grouped else bunch)
        if n_bunches == 0:
            return state
        nr = n_bunches if n_real is None else int(n_real)
        if not 0 <= nr <= n_bunches:
            raise ValueError(f"n_real {nr} outside [0, {n_bunches}]")
        if in_chunk.shape[1] != sizes[0] or targ_chunk.shape[1] != sizes[-1]:
            raise ValueError(f"chunk widths {in_chunk.shape[1]}/{targ_chunk.shape[1]} do not "
                             f"match the net {sizes[0]}/{sizes[-1]}")
        if targ_chunk.shape[0] < in_chunk.shape[0]:
            raise ValueError("targ_chunk has fewer rows than in_chunk")
        if pre_grouped:
            x, t = in_chunk[:nr * bs_local], targ_chunk[:nr * bs_local]
        else:  # this rank's rows of every global tile, at tile granularity
            x, t = (local_rows(a[:nr * bunch], tile_g, mesh) for a in (in_chunk, targ_chunk))
        coefs = _scal_coefs(rule, bunch, sizes[-1], lrate, momentum, weightcost)
        dev = state.device
        _cast_state(state, torch.float32, d_dtype)
        if dev.type == "cpu":
            return dp_resident_train_chunk_reference(state, x, t, cfg, bunch, coefs, int(seed),
                                                     mesh, n_real=nr, sr_delta=sr_delta,
                                                     tile_rows=tile_g, bf16=bf16)
        if dev.type != "cuda":
            raise ValueError(f"the chunk trainer runs on cuda or cpu, got {dev}")
        _checked_state(state, sizes, torch.float32, d_dtype)
        for name, a in (("in_chunk", x), ("targ_chunk", t)):
            if a.dtype != torch.float32 or a.device != dev:
                raise ValueError(f"{name}: float32 on {dev} expected; got {a.dtype} on {a.device}")
        run_kernels(state, x.contiguous(), t.contiguous(), nr, int(seed) & 0xFFFFFFFF, coefs)
        fence(mesh)
        state.step += nr
        return state

    return run


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
    return out


def _check_table_shape(n_tiles: int, tile: int, width: int, row0: int) -> None:
    if int(n_tiles) < 0 or int(tile) <= 0 or int(width) <= 0 or int(row0) < 0:
        raise ValueError(f"a table of {n_tiles} tiles of {tile} rows from row {row0} of width "
                         f"{width}")


def _check_table(bits: torch.Tensor, shape, device: torch.device) -> None:
    if (bits.dtype != torch.int32 or tuple(bits.shape) != tuple(shape) or bits.device != device
            or not bits.is_contiguous()):
        raise ValueError(f"a mask table: int32 {tuple(shape)}, contiguous, on {device} expected; "
                         f"got {bits.dtype} {tuple(bits.shape)} on {bits.device}")


def input_mask_bits_reference(seed: int, n_tiles: int, tile: int, width: int, omit: float,
                              device: str | torch.device = "cpu", row0: int = 0) -> torch.Tensor:
    """Plain torch version of `input_mask_bits`: (n_tiles, tile,
    ceil(width / 32)) int32, tile gi's rows the packed Philox mask of stream
    mask_key(seed, gi, 0) at rows row0.. (ops/philox.py:philox_mask_words)."""
    _check_table_shape(n_tiles, tile, width, row0)
    out = torch.empty((int(n_tiles), int(tile), mask_words(width)), dtype=torch.int32,
                      device=device)
    for gi in range(int(n_tiles)):
        out[gi] = philox_mask_words(mask_key(seed, gi, 0), tile, width, omit, row0=int(row0),
                                    device=device)
    return out


def input_mask_bits(seed: int, n_tiles: int, tile: int, width: int, omit: float,
                    device: str | torch.device = "cuda", row0: int = 0) -> torch.Tensor:
    """The input masks the chunk trainer draws for a call of n_tiles tiles
    (n_real * accum) of `tile` rows under `seed`, as the table its layer-0
    kernels read: (n_tiles, tile, ceil(width / 32)) int32, bit b of word w
    of row r the keep of column 32 w + b (0 past width) at row row0 + r of
    the tile's stream mask_key(seed, gi, 0), threshold mask_threshold(omit).
    row0: 0 for the single-device trainer; a data-parallel rank's first row
    of the global tile (its rows of that trainer's table).  One launch of
    csrc/resident_chunk.cu:input_mask_bits_kernel, the kernel both trainers
    launch; device="cpu" runs the plain version."""
    _check_table_shape(n_tiles, tile, width, row0)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return input_mask_bits_reference(seed, n_tiles, tile, width, omit, row0=row0)
    out = torch.empty((int(n_tiles), int(tile), mask_words(width)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().input_mask_bits_u32(out.data_ptr(), int(n_tiles), int(tile), int(row0),
                                        int(width), int(seed) & 0xFFFFFFFF, mask_threshold(omit),
                                        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"input mask bits kernel launch failed: CUDA error {rc}")
    return out


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
