"""Plain torch training / evaluation steps — counterpart of tpu_sednn/train/step.py.

Two modes:

* **reference parity** (`reference_train_step` / `reference_train_chunk`):
  the quirk-exact optimizer of `BP_GPU::train_bunch_single` +
  `kernUpdatedelta` (the reference's DevFunc.cu:313-318):

      dedx_L   = (2/n) * (out - targ)
      G_W      = prev_y^T @ dedx          (raw sum over the bunch)
      G_b      = sum_batch dedx
      delta   <- m*delta - (1-m)*lr*(G/n + wc*W)       (note the double /n and
      W       <- W + delta                              the (1-m) factor)

  The gradient of  loss = (1/n) * sum((out-targ)^2)  is exactly G_W / G_b
  above (including the dropout-mask chain), so parity mode is autograd plus
  the custom momentum rule.  Further parity quirks honoured: the trailing
  partial bunch is dropped, dropout does not rescale at train time, weight
  cost acts on W and not on b, pure float32.

* **clean** (`clean_train_step`): mean MSE, inverted dropout, standard Polyak
  momentum.

These are the plain versions the hand-written CUDA chunk trainer
(ops/resident_chunk.py) is held against, and the trainer of the CPU and of
`engine="xla"`.  State handling: a single step returns a NEW TrainState and
leaves its input untouched; the chunk trainers update the state they are
given IN PLACE (W and Delta are 47 MB each at the flagship width) and return
it.  `init_train_state` clones the parameters it is given, so the caller's
MLP is never written to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from tpu_sednn_torch.model.mlp import MLP, ModelConfig, _bunch_masks, forward, forward_eval


@dataclass
class TrainState:
    params: MLP
    deltas: MLP  # momentum buffers, same structure as params
    step: int = 0

    @property
    def device(self) -> torch.device:
        return self.params.device


def init_train_state(params: MLP) -> TrainState:
    """Zero momentum, step 0, and a COPY of `params` (chunk trainers write
    into the state in place)."""
    return TrainState(
        params=MLP([w.detach().clone() for w in params.w], [b.detach().clone() for b in params.b]),
        deltas=MLP([torch.zeros_like(w) for w in params.w], [torch.zeros_like(b) for b in params.b]),
        step=0,
    )


@dataclass(frozen=True)
class OptConfig:
    lrate: float = 1.0
    momentum: float = 0.5
    weightcost: float = 0.0
    bunchsize: int = 128


# ---------------------------------------------------------------------------
# reference-parity path
# ---------------------------------------------------------------------------

def _grads(state: TrainState, x, t, cfg: ModelConfig, generator, masks, mean: bool, dtype,
           compute_dtype=None, loss_fn=None):
    """(loss, dL/dW list, dL/db list) by autograd, for
    L = sum((out-t)^2)/n (parity) or mean((out-t)^2) (clean) or
    loss_fn(out, t), computed in `dtype` (None = the state's own type).
    compute_dtype: the type the products' operands are rounded to
    (model.mlp.forward); the gradient of a leaf comes back in the leaf's type."""
    cast = (lambda a: a) if dtype is None else (lambda a: a.to(dtype))
    ws = [cast(w.detach()).clone().requires_grad_(True) for w in state.params.w]
    bs = [cast(b.detach()).clone().requires_grad_(True) for b in state.params.b]
    with torch.enable_grad():
        out = forward(state.params, cast(x), cfg, train=True, generator=generator,
                      dropout_masks=masks, weights=ws, biases=bs, compute_dtype=compute_dtype)
        if loss_fn is not None:
            loss = loss_fn(out, cast(t))
        else:
            sq = (out - cast(t)) ** 2
            loss = sq.mean() if mean else sq.sum() / x.shape[0]
        grads = torch.autograd.grad(loss, ws + bs)
    return loss.detach(), list(grads[: len(ws)]), list(grads[len(ws):])


def _split_compute_dtype(compute_dtype):
    """-> (dtype, compute_dtype) for `_grads`: float64 means "everything in
    float64" (the check free of float32 rounding), a narrower type means
    "round the products' operands to it"."""
    if compute_dtype in (None, torch.float32):
        return None, None
    if compute_dtype == torch.float64:
        return compute_dtype, None
    return None, compute_dtype


def _polyak(opt: "OptConfig", with_wc: bool):
    """The clean update of one tensor: delta' = m*delta - lr*(g [+ wc*p])."""
    m, lr, wc = opt.momentum, opt.lrate, opt.weightcost

    def f(delta, p, g):
        g = g + (wc * p if with_wc else 0.0)
        new_delta = m * delta - lr * g
        return new_delta, p + new_delta
    return f


@torch.no_grad()
def _apply(state: TrainState, g_w, g_b, upd_w, upd_b, inplace: bool) -> TrainState:
    """delta', p' = upd(delta, p, g) on every tensor; a new state, or the
    given one written in place."""
    new_w, new_b, new_dw, new_db = [], [], [], []
    for upd, ps, ds, gs, out_p, out_d in (
            (upd_w, state.params.w, state.deltas.w, g_w, new_w, new_dw),
            (upd_b, state.params.b, state.deltas.b, g_b, new_b, new_db)):
        for p, d, g in zip(ps, ds, gs):
            nd, npar = upd(d.data, p.data, g.to(p.dtype))
            if inplace:
                d.data.copy_(nd)
                p.data.copy_(npar)
            else:
                out_d.append(nd)
                out_p.append(npar)
    if inplace:
        state.step += 1
        return state
    return TrainState(params=MLP(new_w, new_b), deltas=MLP(new_dw, new_db),
                      step=state.step + 1)


def reference_train_step(
    state: TrainState,
    x: torch.Tensor,
    t: torch.Tensor,
    cfg: ModelConfig,
    opt: OptConfig,
    generator: Optional[torch.Generator] = None,
    dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    inplace: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """One bunch of SGD with the reference's exact update rule.

    dtype: compute the gradient in this type (torch.float64 for a check that
    is free of float32 summation order); the state stays float32.
    """
    n = x.shape[0]
    _, g_w, g_b = _grads(state, x, t, cfg, generator, dropout_masks, False, dtype)
    m, lr, wc = opt.momentum, opt.lrate, opt.weightcost

    def upd_w(delta, w, g):
        new_delta = m * delta - (1.0 - m) * lr * (g / n + wc * w)
        return new_delta, w + new_delta

    def upd_b(delta, b, g):
        new_delta = m * delta - (1.0 - m) * lr * (g / n)  # weightcost=0 for bias
        return new_delta, b + new_delta

    return _apply(state, g_w, g_b, upd_w, upd_b, inplace)


def reference_train_chunk(
    state: TrainState,
    in_chunk: torch.Tensor,
    targ_chunk: torch.Tensor,
    cfg: ModelConfig,
    opt: OptConfig,
    generator: Optional[torch.Generator] = None,
    dropout_masks: Optional[Sequence[Sequence[Optional[torch.Tensor]]]] = None,
    dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """Train over a whole chunk, bunch by bunch; the trailing
    `n % bunchsize` samples are skipped exactly like the reference
    (BP_GPU.cu:315-318).  Updates `state` in place and returns it.

    dropout_masks[i][l]: optional explicit mask of bunch i, layer l.  Else,
    with dropout and a generator, the masks are drawn MASK_GROUP bunches at
    a time (`grouped_masks`): the masks of a draw bunch by bunch.
    `reference_train_chunk.calls` counts calls that trained at least a bunch.
    """
    bs = opt.bunchsize
    n_bunches = in_chunk.shape[0] // bs
    if n_bunches == 0:  # chunk smaller than one bunch: all samples dropped
        return state
    reference_train_chunk.calls += 1
    if dropout_masks is None:
        dropout_masks = grouped_masks(generator, cfg, state, bs, n_bunches, in_chunk.device)
    masks = iter(dropout_masks) if dropout_masks is not None else None
    for i in range(n_bunches):  # the generator serves only the masks drawn above
        reference_train_step(state, in_chunk[i * bs:(i + 1) * bs], targ_chunk[i * bs:(i + 1) * bs],
                             cfg, opt, dropout_masks=next(masks) if masks is not None else None,
                             inplace=True, dtype=dtype)
    return state


reference_train_chunk.calls = 0

# Bunches whose dropout masks one draw covers: with tpu_prng at
# 3084-2048x3-257, 8 bunches are 32 masks (one launch of at most 64) and
# 37.8 MB, a write of four times a launch's fixed cost, so the launch is
# bound by its bytes and not by that cost; more would hold more memory
# for little.  threefry's torch.rand draws gain nothing from the group and
# lose nothing by it.
MASK_GROUP = 8


def grouped_masks(generator: Optional[torch.Generator], cfg: ModelConfig, state: TrainState,
                  rows: int, n_bunches: int, device: torch.device):
    """An iterator over the dropout masks of `n_bunches` bunches of `rows`
    rows, bunch by bunch ([layer], None where a layer's omit is 0), drawn
    MASK_GROUP bunches at a time, each group when its first bunch is
    reached: the masks `forward` would draw from `generator` bunch after
    bunch.  None without dropout or without a generator."""
    if generator is None or not cfg.use_dropout:
        return None
    widths = [w.shape[0] for w in state.params.w]
    return (masks for i in range(0, n_bunches, MASK_GROUP)
            for masks in _bunch_masks(generator, cfg, rows, widths, device,
                                      n_bunches=min(MASK_GROUP, n_bunches - i)))


def make_jit_train_chunk(cfg: ModelConfig, opt: OptConfig):
    """The plain chunk trainer as a runner (there is nothing to compile in
    the port; the name is the JAX package's).  Model config and bunchsize are
    fixed; lrate/momentum/weightcost may change from call to call, as the
    recipe's momentum ramp does.  `rng` is a torch.Generator for the dropout
    masks (unused when dropout is off).  Updates `state` in place."""
    bunchsize = opt.bunchsize

    def run(state: TrainState, in_chunk, targ_chunk, rng,
            lrate=opt.lrate, momentum=opt.momentum, weightcost=opt.weightcost):
        dyn_opt = OptConfig(lrate=lrate, momentum=momentum, weightcost=weightcost,
                            bunchsize=bunchsize)
        return reference_train_chunk(state, in_chunk, targ_chunk, cfg, dyn_opt, generator=rng)

    return run


# ---------------------------------------------------------------------------
# clean path
# ---------------------------------------------------------------------------

def clean_train_step(
    state: TrainState,
    x: torch.Tensor,
    t: torch.Tensor,
    cfg: ModelConfig,
    opt: OptConfig,
    generator: Optional[torch.Generator] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
    dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> Tuple[TrainState, torch.Tensor]:
    """Modern training step: mean-MSE, Polyak momentum, bfloat16 products.

    Returns (new_state, loss).  Expects cfg.dropout_mode == "inverted" when
    dropout is enabled.  compute_dtype: torch.bfloat16 (the default, as the
    JAX package's) = operands rounded to bfloat16 and summed in float32;
    None = float32 products; torch.float64 = everything in float64.
    """
    dtype, cd = _split_compute_dtype(compute_dtype)
    loss, g_w, g_b = _grads(state, x, t, cfg, generator, dropout_masks, True, dtype,
                            compute_dtype=cd)
    return (_apply(state, g_w, g_b, _polyak(opt, True), _polyak(opt, False), False),
            loss.to(torch.float32))


def softmax_xent_train_step(
    state: TrainState,
    x: torch.Tensor,
    labels: torch.Tensor,
    cfg: ModelConfig,
    opt: OptConfig,
    generator: Optional[torch.Generator] = None,
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> Tuple[TrainState, torch.Tensor]:
    """Softmax classification step — the working analog of the reference's
    shipped-but-dead softmax kernels.

    cfg.output must be "softmax"; `labels` is either integer class ids
    (batch,) or one-hot / soft targets (batch, n_out).  Loss is the mean
    cross-entropy from the logits via log_softmax; the update is the clean
    Polyak-momentum rule.  compute_dtype as in `clean_train_step` (default
    bfloat16 products, as the JAX package's).
    """
    from dataclasses import replace as _replace

    if cfg.output != "softmax":
        raise ValueError("softmax_xent_train_step requires cfg.output='softmax'")
    logits_cfg = _replace(cfg, output="linear")
    n_out = cfg.layersizes[-1]
    t1h = (torch.nn.functional.one_hot(labels.long(), n_out).to(torch.float32)
           if labels.dim() == 1 else labels)

    def xent(logits, t):
        return -torch.mean(torch.sum(t * torch.log_softmax(logits, dim=-1), dim=-1))

    dtype, cd = _split_compute_dtype(compute_dtype)
    loss, g_w, g_b = _grads(state, x, t1h, logits_cfg, generator, None, True, dtype,
                            compute_dtype=cd, loss_fn=xent)
    return (_apply(state, g_w, g_b, _polyak(opt, True), _polyak(opt, False), False),
            loss.to(torch.float32))


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

@torch.no_grad()
def cv_forward_and_sqerr(params: MLP, x: torch.Tensor, t: torch.Tensor, cfg: ModelConfig):
    """(outputs, total squared error) for a CV batch — the outputs feed the
    optional CV output dump (one "%f "-separated line per frame)."""
    out = forward_eval(params, x, cfg)
    return out, torch.sum((out - t) ** 2)


@torch.no_grad()
def cv_squared_error_masked(params: MLP, x: torch.Tensor, t: torch.Tensor,
                            n_valid: int, cfg: ModelConfig) -> torch.Tensor:
    """Squared error over the first n_valid rows of a capacity-padded CV
    chunk (the device-splice path pads every chunk to fixed shapes; padded
    rows hold garbage)."""
    out = forward_eval(params, x, cfg)
    mask = (torch.arange(x.shape[0], device=x.device) < int(n_valid))[:, None]
    return torch.sum(torch.where(mask, (out - t) ** 2, torch.zeros((), device=x.device)))


@torch.no_grad()
def cv_squared_error(params: MLP, x: torch.Tensor, t: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Total squared error over a CV batch (the reference's CV metric).

    BPtrain accumulates sum((out-targ)^2) over all CV samples and divides by
    cv_total_samples at the end; the caller does the final division.  Forward
    uses the parity inference path (weight-scaling when dropout is configured).
    """
    out = forward_eval(params, x, cfg)
    return torch.sum((out - t) ** 2)
