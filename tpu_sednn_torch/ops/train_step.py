"""Per-bunch training step built from the fused layer kernels — the port of
tpu_sednn/ops/train_step.py.

Same math as tpu_sednn_torch.train.step.reference_train_step (the quirk-exact
reference optimizer), but every layer's forward is one `fused_linear_act`
launch and its backward + update one `fused_bwd_update` launch, reading and
writing each weight/momentum matrix once per bunch.  The kernels take the
true layer sizes, so the JAX package's zero-padding to 128-aligned sizes
(`_pad_state`) has no counterpart here.  On CPU tensors the wrappers run
their plain versions, so this module is testable without a card.

`bf16` (default True, as the JAX package's) goes to both wrappers: products
of operands rounded to bfloat16 on the tensor cores; False: float32 products.

The state is updated IN PLACE and returned.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tpu_sednn_torch.model.mlp import ModelConfig, _bunch_masks, dropout_omits
from tpu_sednn_torch.ops.fused_mlp import fused_bwd_update, fused_linear_act
from tpu_sednn_torch.train.step import OptConfig, TrainState, grouped_masks


@torch.no_grad()
def fused_train_step(
    state: TrainState,
    x: torch.Tensor,
    t: torch.Tensor,
    cfg: ModelConfig,
    opt: OptConfig,
    generator: Optional[torch.Generator] = None,
    dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    bf16: bool = True,
) -> TrainState:
    """One bunch: forward with each layer's dropout mask fused into the
    launch that produces (or, for the net's input, loads) the activation,
    then per-layer backward + update, last layer first."""
    ws, bs = state.params.w, state.params.b
    dws, dbs = state.deltas.w, state.deltas.b
    n_layers = len(ws)
    n = x.shape[0]
    omits = dropout_omits(cfg, n_layers)
    if cfg.use_dropout and generator is None and dropout_masks is None:
        raise ValueError("dropout training requires a generator or explicit masks")
    if dropout_masks is not None:
        masks = [dropout_masks[l] if omits[l] > 0.0 else None for l in range(n_layers)]
    else:
        masks = _bunch_masks(generator, cfg, n, [x.shape[1]] + [w.shape[0] for w in ws[1:]],
                             x.device)[0]
    scale = [1.0 / (1.0 - o) if (o > 0.0 and cfg.dropout_mode == "inverted") else 1.0
             for o in omits]

    # forward, keeping the post-dropout input of every layer after the first
    ys = [x]
    h = x
    for l in range(n_layers):
        last = l == n_layers - 1
        h = fused_linear_act(
            h, ws[l], bs[l], act=cfg.output if last else cfg.hidden,
            in_mask=masks[0] if l == 0 else None, in_scale=scale[0] if l == 0 else 1.0,
            out_mask=None if last else masks[l + 1], out_scale=1.0 if last else scale[l + 1],
            bf16=bf16)
        if not last:
            ys.append(h)
    out = h

    dedx = (2.0 / n) * (out - t)
    if cfg.output == "sigmoid":  # mask-head extension: chain through sigma'
        dedx = dedx * out * (1.0 - out)
    for l in range(n_layers - 1, -1, -1):
        # the derivative of the layer below is taken on its stored, masked
        # activation ys[l] (the reference masks layer_y in place)
        _, _, dedx, _, _ = fused_bwd_update(
            dedx.contiguous(), ys[l], ws[l], dws[l], bs[l], dbs[l],
            opt.momentum, opt.lrate, 1.0 / n, opt.weightcost,
            in_mask=masks[0] if l == 0 else None, in_scale=scale[0] if l == 0 else 1.0,
            deriv=cfg.hidden if (l > 0 and cfg.hidden != "linear") else None, bf16=bf16)
    state.step += 1
    return state


def make_fused_train_chunk(cfg: ModelConfig, opt: OptConfig, bf16: bool = True):
    """Chunk trainer over `fused_train_step` (partial bunch dropped); a
    Python loop, two launches per layer and bunch.  The whole-chunk trainer
    of ops/resident_chunk.py enqueues the same kernels from one C call.
    The masks are drawn as `reference_train_chunk` draws them, MASK_GROUP
    bunches at a time."""
    def run(state: TrainState, in_chunk, targ_chunk, rng,
            lrate=opt.lrate, momentum=opt.momentum, weightcost=opt.weightcost):
        bs = opt.bunchsize
        dyn = OptConfig(lrate=lrate, momentum=momentum, weightcost=weightcost, bunchsize=bs)
        n_bunches = in_chunk.shape[0] // bs
        grouped = grouped_masks(rng, cfg, state, bs, n_bunches, in_chunk.device)
        for i in range(n_bunches):
            fused_train_step(state, in_chunk[i * bs:(i + 1) * bs], targ_chunk[i * bs:(i + 1) * bs],
                             cfg, dyn, dropout_masks=next(grouped) if grouped is not None else None,
                             bf16=bf16)
        return state

    return run


# the JAX package's names for the same two functions
pallas_train_step = fused_train_step
make_pallas_train_chunk = make_fused_train_chunk
