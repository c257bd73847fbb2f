"""Checkpoint / resume — counterpart of tpu_sednn/utils/checkpoint.py.

The reference's only checkpoint is the per-epoch `.wts` file written at
process exit; momentum state is lost every epoch.  Here:

* `save_checkpoint` / `restore_checkpoint` carry params AND optimizer state
  (momentum deltas) AND the step counter plus a JSON `extra` (epoch, CV
  history, schedule position), so training resumes exactly.  Tensors keep
  their types: a bfloat16 momentum comes back bfloat16, bit for bit.
* `latest_step` + `restore_or_init`: crash recovery — pick up from the newest
  complete checkpoint automatically.

A checkpoint is one file `<ckpt_dir>/step_<n>.pt` (torch.save of plain
tensors, the extra as a JSON string), written under a temporary name and
renamed, so a crash mid-write leaves no half checkpoint; the newest
`max_to_keep` are kept.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

import torch

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.model.mlp import MLP
from tpu_sednn_torch.train.step import TrainState, init_train_state

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{int(step)}.pt")


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState,
                    extra: Optional[Dict[str, Any]] = None,
                    max_to_keep: int = 3) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)

    def leaves(mlp: MLP):
        return {"w": [w.detach().cpu() for w in mlp.w], "b": [b.detach().cpu() for b in mlp.b]}

    payload = {"params": leaves(state.params), "deltas": leaves(state.deltas),
               "step": int(state.step), "extra": json.dumps(extra or {})}
    tmp = _path(ckpt_dir, step) + f".{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, _path(ckpt_dir, step))
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       device: str | torch.device = "cuda"):
    """-> (TrainState on `device`, extra dict, step).  Raises if nothing to
    restore, and if `device` is the card (the default) and there is none."""
    device = resolve_device(device)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    payload = torch.load(_path(ckpt_dir, step), map_location="cpu", weights_only=True)

    def mlp(tree) -> MLP:
        return MLP([w.to(device) for w in tree["w"]], [b.to(device) for b in tree["b"]])

    state = TrainState(params=mlp(payload["params"]), deltas=mlp(payload["deltas"]),
                       step=int(payload["step"]))
    return state, json.loads(payload["extra"]), step


def restore_or_init(ckpt_dir: str, init_params_fn, device: str | torch.device = "cuda"):
    """Crash-resilient bring-up: newest checkpoint if present, else fresh
    (init_params_fn() -> MLP).  Either way the state is on `device`."""
    device = resolve_device(device)
    s = latest_step(ckpt_dir)
    if s is not None:
        return restore_checkpoint(ckpt_dir, s, device=device)
    fresh = init_params_fn()
    fresh = MLP([w.to(device) for w in fresh.w], [b.to(device) for b in fresh.b])
    return init_train_state(fresh), {}, 0
