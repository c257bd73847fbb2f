"""Feed-forward regression DNN — counterpart of tpu_sednn/model/mlp.py.

The `MLP` module keeps the JAX package's weight layout: W[l] is (n_in, n_out)
and a layer is `y = x @ W + b` on row-major batches (not nn.Linear's
transposed layout), so `.wts` interop and the JAX pytree are straight copies.

`ModelConfig`, `init_params` (uniform / fanin / glorot from a
torch.Generator), `init_params_parity` (the reference's drand48 stream),
the training `forward` (dropout on each layer's input: parity = mask without
rescale, inverted = mask and 1/(1-omit)), `forward_eval` (parity keep-prob
weight scaling), `fold_eval_params`, `params_from_wts`, `params_to_wts`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tpu_sednn_torch._device import resolve_device


@dataclass(frozen=True)
class ModelConfig:
    layersizes: Tuple[int, ...] = (1548, 2048, 2048, 2048, 129)
    hidden: str = "relu"  # "relu" | "sigmoid"
    output: str = "linear"  # "linear" | "sigmoid" (mask head) | "softmax"
    dropout_vis: float = 0.0  # visible_omit
    dropout_hid: float = 0.0  # hid_omit
    dropout_mode: str = "parity"  # "parity" | "inverted"
    # carried over from the JAX package, where "default" selects bf16-input
    # TPU matmuls; the port computes float32 products in full float32 and
    # does not read this field
    precision: str = "default"
    # which generator draws the training masks of `forward`: "threefry" =
    # torch.rand on the caller's generator (the JAX package's jax.random
    # path); "tpu_prng" = the hand-written Philox kernel of
    # ops/dropout_mask.py, seeded with one integer drawn from the generator
    # (the JAX package's TPU hardware generator; the name is kept so that
    # configurations carry over)
    dropout_rng: str = "threefry"

    @property
    def num_layers(self) -> int:
        return len(self.layersizes)

    @property
    def use_dropout(self) -> bool:
        return self.dropout_vis > 0.0 or self.dropout_hid > 0.0

    def with_dropout(self, vis: float, hid: float, mode: str = "parity") -> "ModelConfig":
        return replace(self, dropout_vis=vis, dropout_hid=hid, dropout_mode=mode)


class MLP(nn.Module):
    """Weights w[l] (n_in, n_out) and biases b[l] (n_out,): float32, or
    bfloat16 where they are given so (the stochastic-rounding trainers keep
    weights and momentum in bfloat16); any other type is made float32."""

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
        super().__init__()
        if len(weights) != len(biases):
            raise ValueError("weights and biases must have the same number of layers")
        for l, (w, b) in enumerate(zip(weights, biases)):
            if w.dim() != 2 or b.shape != (w.shape[1],):
                raise ValueError(f"layer {l}: shape mismatch {tuple(w.shape)} vs {tuple(b.shape)}")
        def keep(a):
            return a if a.dtype == torch.bfloat16 else a.float()

        self.w = nn.ParameterList(nn.Parameter(keep(w), requires_grad=False) for w in weights)
        self.b = nn.ParameterList(nn.Parameter(keep(b), requires_grad=False) for b in biases)

    @property
    def layersizes(self) -> Tuple[int, ...]:
        return (self.w[0].shape[0],) + tuple(w.shape[1] for w in self.w)

    @property
    def device(self) -> torch.device:
        return self.w[0].device

    def on(self, device: torch.device) -> "MLP":
        """self if already on `device`, else a copy there (self is untouched)."""
        if self.device == torch.device(device):
            return self
        return MLP([w.to(device) for w in self.w], [b.to(device) for b in self.b])

    def forward(self, x: torch.Tensor, cfg: "ModelConfig") -> torch.Tensor:
        return forward_eval(self, x, cfg)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "softmax":
        return torch.softmax(x, dim=-1)
    if name == "linear":
        return x
    raise ValueError(f"unknown activation {name}")


def init_params(
    generator: torch.Generator,
    cfg: ModelConfig,
    scheme: str = "glorot",
    beta: float = 1.0,
    w_range: Tuple[float, float] = (-0.1, 0.1),
    b_range: Tuple[float, float] = (0.0, 0.0),
    device: str | torch.device = "cuda",
) -> MLP:
    """Random init, drawn on the host from `generator` (so a seed gives the
    same weights on every device), then moved to `device`.

    scheme:
      "uniform"  — U[w_range] for weights, U[b_range] for biases
      "fanin"    — U(±beta/sqrt(n_in)), zero bias
      "glorot"   — U(±beta*sqrt(6)/sqrt(n_in+n_out)), zero bias
    """
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, dtype=torch.float32) * (hi - lo) + lo

    ws: List[torch.Tensor] = []
    bs: List[torch.Tensor] = []
    sizes = cfg.layersizes
    for i in range(1, len(sizes)):
        n_in, n_out = sizes[i - 1], sizes[i]
        if scheme == "uniform":
            w = uniform((n_in, n_out), *w_range)
            b = uniform((n_out,), *b_range)
        elif scheme in ("fanin", "glorot"):
            r = beta / np.sqrt(n_in) if scheme == "fanin" else beta * np.sqrt(6.0) / np.sqrt(n_in + n_out)
            w = uniform((n_in, n_out), -r, r)
            b = torch.zeros((n_out,), dtype=torch.float32)
        else:
            raise ValueError(f"unknown init scheme {scheme}")
        ws.append(w.to(dev))
        bs.append(b.to(dev))
    return MLP(ws, bs)


def init_params_parity(rand: Any, cfg: ModelConfig, w_min: float, w_max: float,
                       b_min: float, b_max: float,
                       device: str | torch.device = "cuda") -> MLP:
    """Bit-exact reference init: drand48 stream, weights then bias per layer
    in file order (Interface.cc:338-350).  `rand` is a
    tpu_sednn_torch.data.rand48.Rand48; it is advanced by the draws.

    The reference fills its column-major (cur, prev) buffer sequentially; the
    (prev, cur) row-major matrix has the same flat layout, so a straight
    reshape reproduces it element for element.
    """
    dev = resolve_device(device)
    ws, bs = [], []
    sizes = cfg.layersizes
    for i in range(1, len(sizes)):
        n_in, n_out = sizes[i - 1], sizes[i]
        ws.append(torch.from_numpy(rand.uniform(w_min, w_max, n_in * n_out)
                                   .reshape(n_in, n_out)).to(dev))
        bs.append(torch.from_numpy(rand.uniform(b_min, b_max, n_out)).to(dev))
    return MLP(ws, bs)


def dropout_omits(cfg: ModelConfig, n_layers: int) -> List[float]:
    """Per-layer input omit probability at train time (0.0 when off)."""
    if not cfg.use_dropout:
        return [0.0] * n_layers
    return [cfg.dropout_vis if l == 0 else cfg.dropout_hid for l in range(n_layers)]


def _dropout_mask(generator: torch.Generator, shape, omit: float,
                  device: torch.device, impl: str = "threefry") -> torch.Tensor:
    """Reference mask: zero where uniform < omit (kernDropout, DevFunc.cu:34-45).
    "threefry": torch.rand on the generator's device, then moved to `device`.
    "tpu_prng": one integer seed from the generator, then the Philox mask of
    ops/dropout_mask.py on `device` (its kernel on a CUDA device)."""
    if impl == "tpu_prng":
        from tpu_sednn_torch.ops.dropout_mask import dropout_mask

        seed = int(torch.randint(-2**31, 2**31, (), generator=generator,
                                 device=generator.device))  # one scalar
        return dropout_mask(seed, tuple(shape), omit, device=device)
    if impl != "threefry":
        raise ValueError(f"unknown dropout_rng {impl!r}")
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    return (u >= omit).to(torch.float32).to(device)


def _dropout_masks(generator: torch.Generator, shapes, omits: Sequence[float],
                   device: torch.device, impl: str = "threefry",
                   row0s: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The masks `_dropout_mask` draws one after another for (shapes[i],
    omits[i]), bit for bit, from the same generator.  "tpu_prng": one seed
    per mask in that order, then one `dropout_masks` call (one kernel launch
    per 64 masks on a CUDA device); with row0s, mask i is rows row0s[i]..
    of the mask its seed keys.  "threefry": the torch.rand draws in turn;
    torch.rand has no row offset, so it takes no row0s."""
    if impl == "tpu_prng":
        from tpu_sednn_torch.ops.dropout_mask import dropout_masks

        seeds = [int(torch.randint(-2**31, 2**31, (), generator=generator,
                                   device=generator.device)) for _ in shapes]  # one scalar each
        return dropout_masks(seeds, [tuple(s) for s in shapes], omits, row0s, device=device)
    if impl != "threefry":
        raise ValueError(f"unknown dropout_rng {impl!r}")
    if row0s is not None:
        raise ValueError("threefry masks are drawn whole: no row0s")
    return [_dropout_mask(generator, s, o, device) for s, o in zip(shapes, omits)]


def _bunch_masks(generator: torch.Generator, cfg: ModelConfig, rows: int,
                 widths: Sequence[int], device: torch.device, n_bunches: int = 1,
                 row0: int = 0) -> List[List[Optional[torch.Tensor]]]:
    """The training masks of `n_bunches` bunches in the order `forward`
    draws them, bunch after bunch: [bunch][layer], layer l's input (rows,
    widths[l]), None where its omit is 0; all drawn by one `_dropout_masks`
    call.  row0 > 0 (tpu_prng only): rows row0.. of each bunch's masks."""
    omits = dropout_omits(cfg, len(widths))
    drawn = [l for l, o in enumerate(omits) if o > 0.0]
    flat = iter(_dropout_masks(generator, [(rows, widths[l]) for l in drawn] * n_bunches,
                               [omits[l] for l in drawn] * n_bunches, device, cfg.dropout_rng,
                               [row0] * (len(drawn) * n_bunches) if row0 else None))
    out = []
    for _ in range(n_bunches):
        masks: List[Optional[torch.Tensor]] = [None] * len(widths)
        for l in drawn:
            masks[l] = next(flat)
        out.append(masks)
    return out


def mm_operand(a: torch.Tensor, bf16: bool, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """An operand of a product as the JAX package's `_dot` takes it: with
    bf16, rounded to bfloat16 (to nearest even, as astype(jnp.bfloat16)),
    then in `dtype`, where the products are summed.  Rounded bfloat16 values
    multiply exactly in float32 or float64, so a product of such operands is
    the bf16-input, wide-accumulation product up to summation order."""
    return (a.to(torch.bfloat16) if bf16 else a).to(dtype)


def _matmul_bias(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """h @ w + b.  compute_dtype (torch.bfloat16): both operands rounded to
    it, the products summed in float32, the result float32 (`mm_operand`):
    the JAX package's bf16-input product with float32 accumulation, on either
    device; the cotangents pass back through the same roundings.  Without
    it, a weight stored in another type than h (bfloat16 state) is widened
    to h's."""
    if compute_dtype is not None:
        if compute_dtype != torch.bfloat16:
            raise ValueError(f"compute_dtype {compute_dtype}: only torch.bfloat16 rounds operands")
        return torch.matmul(mm_operand(h, True), mm_operand(w, True)) + b.float()
    if w.dtype != h.dtype:
        w, b = w.to(h.dtype), b.to(h.dtype)
    return torch.matmul(h, w) + b


def forward(
    params: MLP,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    dropout_masks: Optional[Sequence[Optional[torch.Tensor]]] = None,
    weights: Optional[Sequence[torch.Tensor]] = None,
    biases: Optional[Sequence[torch.Tensor]] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Batched forward pass; (batch, n_in) -> (batch, n_out).

    train=True applies dropout per cfg.dropout_mode to each layer's INPUT
    (BP_GPU.cu:536-551); train=False is `forward_eval`.  dropout_masks:
    optional per-layer explicit 0/1 masks (for parity testing against an
    external reference); they override masks drawn from `generator`.
    weights/biases: use these tensors instead of params.w / params.b (the
    train step passes leaves that require grad, or a float64 copy).
    compute_dtype=torch.bfloat16: products of operands rounded to bfloat16,
    summed in float32 (clean mode only; parity runs pure float32).
    """
    if not train:
        return forward_eval(params, x, cfg, compute_dtype=compute_dtype)
    ws = list(params.w) if weights is None else list(weights)
    bs = list(params.b) if biases is None else list(biases)
    n_layers = len(ws)
    omits = dropout_omits(cfg, n_layers)
    if cfg.use_dropout and generator is None and dropout_masks is None:
        raise ValueError("dropout training requires a generator or explicit masks")
    if cfg.use_dropout and dropout_masks is None:  # the generator serves nothing else here
        dropout_masks = _bunch_masks(generator, cfg, x.shape[0],
                                     [x.shape[1]] + [w.shape[0] for w in ws[1:]], x.device)[0]
    h = x
    for l, (w, b) in enumerate(zip(ws, bs)):
        if omits[l] > 0.0:
            h = h * dropout_masks[l].to(h.dtype)
            if cfg.dropout_mode == "inverted":
                h = h / (1.0 - omits[l])
        h = _matmul_bias(h, w, b, compute_dtype)
        h = _act(cfg.hidden if l < n_layers - 1 else cfg.output, h)
    return h


def _keep_probs(cfg: ModelConfig, n_layers: int) -> List[float]:
    """Per-layer input keep-prob of parity dropout (1.0 when off)."""
    if not (cfg.use_dropout and cfg.dropout_mode == "parity"):
        return [1.0] * n_layers
    return [1.0 - (cfg.dropout_vis if l == 0 else cfg.dropout_hid) for l in range(n_layers)]


@torch.no_grad()
def forward_eval(params: MLP, x: torch.Tensor, cfg: ModelConfig, *,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Inference forward; (..., n_in) -> (..., n_out).

    parity dropout mode: every layer's weights scaled by its input keep-prob
    (layer 0 by 1-visible_omit, all others by 1-hid_omit), as the reference's
    cv_bunch_single does; inverted mode needs no compensation.
    """
    n_layers = len(params.w)
    h = x
    for l, (w, b, keep) in enumerate(zip(params.w, params.b, _keep_probs(cfg, n_layers))):
        if keep != 1.0:
            # the factor in the weight's own type, as the JAX package's weak-typed
            # scalar: for a bfloat16 weight it is rounded to bfloat16 first
            w = w * torch.tensor(keep, dtype=w.dtype, device=w.device)
        h = _matmul_bias(h, w, b, compute_dtype)
        h = _act(cfg.hidden if l < n_layers - 1 else cfg.output, h)
    return h


def fold_eval_params(params: MLP, cfg: ModelConfig) -> Tuple[MLP, ModelConfig]:
    """Fold the parity-mode inference compensation into the weights ONCE.

    -> (params with W[l] * keep[l], cfg without dropout): numerically the
    same forward_eval output, without rescaling the weights on every call.
    """
    keeps = _keep_probs(cfg, len(params.w))
    if any(k != 1.0 for k in keeps):
        params = MLP([w * k for w, k in zip(params.w, keeps)], list(params.b))
    return params, replace(cfg, dropout_vis=0.0, dropout_hid=0.0)


def params_from_wts(weights: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                    device: str | torch.device = "cuda") -> MLP:
    """(weights, biases) as io.load_wts returns them -> MLP on `device`,
    copied element for element."""
    dev = resolve_device(device)
    return MLP([torch.tensor(np.asarray(w, np.float32), device=dev) for w in weights],
               [torch.tensor(np.asarray(b, np.float32), device=dev) for b in biases])


def params_to_wts(params: MLP) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    return ([w.detach().cpu().numpy().astype(np.float32) for w in params.w],
            [b.detach().cpu().numpy().astype(np.float32) for b in params.b])
