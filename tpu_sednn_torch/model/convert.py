"""Weights and training state carried across from the JAX package.

The JAX model is a pytree {"w": (W_0, ...), "b": (b_0, ...)} with W_l of
shape (n_in, n_out); the port's MLP keeps the same layout, so conversion is
an element-for-element copy both ways.  Pass the pytree's leaves as numpy
arrays (`np.asarray` on each): the port never imports JAX.  A training state
is the same twice over (params and momentum deltas) plus the step count.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from tpu_sednn_torch.model.mlp import MLP, params_from_wts, params_to_wts


def params_from_jax(p: Dict[str, Sequence[np.ndarray]],
                    device: str | torch.device = "cuda") -> MLP:
    """{"w": tuple, "b": tuple} of numpy arrays -> MLP on `device`."""
    return params_from_wts(p["w"], p["b"], device=device)


def params_to_numpy(mlp: MLP) -> Dict[str, Tuple[np.ndarray, ...]]:
    """MLP -> {"w": tuple, "b": tuple} of float32 numpy arrays (the JAX layout)."""
    ws, bs = params_to_wts(mlp)
    return {"w": tuple(ws), "b": tuple(bs)}


def train_state_from_jax(params: Dict[str, Sequence[np.ndarray]],
                         deltas: Dict[str, Sequence[np.ndarray]], step: int = 0,
                         device: str | torch.device = "cuda"):
    """The JAX TrainState's fields as numpy pytrees -> the port's TrainState
    on `device`, element for element."""
    from tpu_sednn_torch.train.step import TrainState

    return TrainState(params=params_from_jax(params, device), deltas=params_from_jax(deltas, device),
                      step=int(step))


def train_state_to_numpy(state) -> Tuple[Dict, Dict, int]:
    """TrainState -> (params, deltas, step): the JAX layout as numpy arrays."""
    return params_to_numpy(state.params), params_to_numpy(state.deltas), int(state.step)
