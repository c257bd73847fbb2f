"""The CRN's LSTM recurrence (model/crn.py:lstm_layer) on hand-written CUDA
(`csrc/lstm_cell.cu`): a layer's steps, each the product of h[t-1] with
W_hh added onto the step's input projection (cuBLAS) and one launch of the
cell kernel, all enqueued by one C call:

    i, f, o = sigmoid(G_i, G_f, G_o),  g = tanh(G_g)
    c' = f c + i g,  h = o tanh(c')

`lstm_steps` launches on CUDA tensors and runs the plain version,
`lstm_steps_reference` (the step loop in Python, the cell update
`lstm_cell_reference` one torch operation at a time in the kernel's order),
on CPU tensors.  At T = 1 with h[0] = 0 the product adds exact zeros, so the
gates reach the cell kernel as given: that is how the kernel is held against
`lstm_cell_reference`.  `lstm_steps.launches` counts launches of the cell
kernel.  The library is its own and is built on first use.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_sednn_torch.ops import _build


def lstm_cell_reference(gates: torch.Tensor, c: torch.Tensor, h: torch.Tensor) -> None:
    """The cell kernel's update in plain torch: gates (B, 4H), ordered i, f,
    g, o along a row; c (B, H) updated in place; h (B, H) written."""
    H = c.shape[1]
    i, f = torch.sigmoid(gates[:, :H]), torch.sigmoid(gates[:, H:2 * H])
    g, o = torch.tanh(gates[:, 2 * H:3 * H]), torch.sigmoid(gates[:, 3 * H:])
    c.copy_(f * c + i * g)
    h.copy_(o * torch.tanh(c))


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("lstm_cell")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lstm_steps_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.lstm_steps_f32.restype = ctypes.c_int
    return lib


def lstm_steps_reference(proj: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
                         c: torch.Tensor) -> None:
    """Plain torch version of `lstm_steps`: the step loop in Python."""
    for t in range(proj.shape[0]):
        proj[t].addmm_(hs[t], w_hh)
        lstm_cell_reference(proj[t], c, hs[t + 1])


def lstm_steps(proj: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
               c: torch.Tensor) -> None:
    """A layer's T steps: for t = 0 .. T-1, proj[t] += hs[t] W_hh, then the
    cell update of c by proj[t] into hs[t + 1].  proj (T, B, 4H), its input
    projection, is overwritten by the gates; w_hh (H, 4H); hs (T + 1, B, H)
    holds the initial h in hs[0] and receives h; c (B, H) the initial cell,
    updated in place.  Every tensor float32 and contiguous, on one device."""
    T, B, G = proj.shape
    H = G // 4
    if G != 4 * H or w_hh.shape != (H, G) or hs.shape != (T + 1, B, H) or c.shape != (B, H):
        raise ValueError(f"shapes {tuple(proj.shape)}, {tuple(w_hh.shape)}, {tuple(hs.shape)}, "
                         f"{tuple(c.shape)}: want (T, B, 4H), (H, 4H), (T + 1, B, H), (B, H)")
    tensors = (proj, w_hh, hs, c)
    if any(a.dtype != torch.float32 for a in tensors):
        raise TypeError("proj, w_hh, hs and c must be float32")
    dev = proj.device
    if any(a.device != dev for a in tensors):
        raise ValueError("proj, w_hh, hs and c must be on one device")
    if dev.type == "cpu":
        lstm_steps_reference(proj, w_hh, hs, c)
        return
    if dev.type != "cuda":
        raise ValueError(f"lstm_steps runs on cuda or cpu tensors, got {dev}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("proj, w_hh, hs and c must be contiguous")
    rc = _lib().lstm_steps_f32(proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(), c.data_ptr(),
                               T, B, H, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        what = f"cuBLAS status {rc - 1000}" if rc >= 1000 else f"CUDA error {rc}"
        raise RuntimeError(f"lstm_steps failed: {what}")
    lstm_steps.launches += T


lstm_steps.launches = 0
