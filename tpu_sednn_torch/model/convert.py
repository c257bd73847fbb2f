"""Weights and training state carried across from the JAX package.

The JAX model is a pytree {"w": (W_0, ...), "b": (b_0, ...)} with W_l of
shape (n_in, n_out); the port's MLP keeps the same layout, so conversion is
an element-for-element copy both ways.  Pass the pytree's leaves as numpy
arrays (`np.asarray` on each): the port never imports JAX.  A training state
is the same twice over (params and momentum deltas) plus the step count.

bfloat16 leaves (the stochastic-rounding trainers keep weights and momentum
so) cross exactly: numpy has no bfloat16 of its own, so a leaf comes in as the
array `np.asarray` makes of a JAX bfloat16 array (dtype named "bfloat16", two
bytes an element; its bit patterns are copied) and goes out as float32, the
exact widening (`jnp.asarray(a, jnp.bfloat16)` gives the same bits back).  No
value is rounded either way.  An int8 serving model (the JAX QuantParams)
crosses field by field (`quant_params_from_jax`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tpu_sednn_torch.model.mlp import MLP


def _leaf_to_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # what np.asarray makes of a JAX bfloat16 array
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(dev)
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy()  # exact for bfloat16


def params_from_jax(p: Dict[str, Sequence[np.ndarray]],
                    device: str | torch.device = "cuda") -> MLP:
    """{"w": tuple, "b": tuple} of numpy arrays -> MLP on `device`.  A leaf
    whose dtype is named "bfloat16" becomes a bfloat16 tensor with the same
    bits."""
    from tpu_sednn_torch._device import resolve_device

    dev = resolve_device(device)
    return MLP([_leaf_to_tensor(w, dev) for w in p["w"]],
               [_leaf_to_tensor(b, dev) for b in p["b"]])


def params_to_numpy(mlp: MLP) -> Dict[str, Tuple[np.ndarray, ...]]:
    """MLP -> {"w": tuple, "b": tuple} of float32 numpy arrays (the JAX
    layout), a bfloat16 leaf widened exactly."""
    return {"w": tuple(_leaf_to_numpy(w) for w in mlp.w),
            "b": tuple(_leaf_to_numpy(b) for b in mlp.b)}


def train_state_from_jax(params: Dict[str, Sequence[np.ndarray]],
                         deltas: Dict[str, Sequence[np.ndarray]], step: int = 0,
                         device: str | torch.device = "cuda"):
    """The JAX TrainState's fields as numpy pytrees -> the port's TrainState
    on `device`, element for element, bfloat16 leaves included."""
    from tpu_sednn_torch.train.step import TrainState

    return TrainState(params=params_from_jax(params, device), deltas=params_from_jax(deltas, device),
                      step=int(step))


def train_state_to_numpy(state) -> Tuple[Dict, Dict, int]:
    """TrainState -> (params, deltas, step): the JAX layout as float32 numpy
    arrays, as `params_to_numpy`."""
    return params_to_numpy(state.params), params_to_numpy(state.deltas), int(state.step)


def quant_params_from_jax(wq: Sequence, sw: Sequence, w_f32: Sequence, b: Sequence,
                          skip_last: bool = True, device: str | torch.device = "cuda"):
    """The fields of a JAX QuantParams as numpy leaves (None placeholders
    kept) -> the port's QuantParams on `device`: int8 weights stay int8, the
    scales, float weights and biases float32, element for element."""
    from tpu_sednn_torch._device import resolve_device
    from tpu_sednn_torch.model.quant import QuantParams, _col_major

    dev = resolve_device(device)

    def on(a, dtype):
        return None if a is None else torch.tensor(np.asarray(a, dtype), device=dev)

    return QuantParams(wq=tuple(None if a is None else _col_major(on(a, np.int8)) for a in wq),
                       sw=tuple(on(a, np.float32) for a in sw),
                       w_f32=tuple(on(a, np.float32) for a in w_f32),
                       b=tuple(on(a, np.float32) for a in b), skip_last=bool(skip_last))
