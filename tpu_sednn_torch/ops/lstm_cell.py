"""The CRN's LSTM recurrence (model/crn.py:lstm_layer) on hand-written CUDA
(`csrc/lstm_cell.cu`): one persistent kernel a layer runs all its steps,
each the product of h[t-1] with W_hh added onto the step's input projection
and the cell update:

    i, f, o = sigmoid(G_i, G_f, G_o),  g = tanh(G_g)
    c' = f c + i g,  h = o tanh(c')

`lstm_plan` decides how a layer is cut over the card's SMs (a plain function
of B, H and the card's limits, pinned by the CPU tests); `lstm_steps`
launches on CUDA tensors and runs the plain version, `lstm_steps_reference`
(the step loop in Python, the cell update `lstm_cell_reference` one torch
operation at a time in the kernel's order), on CPU tensors.  At T = 1 with
h[0] = 0 the product adds exact zeros, so the kernel's cell sees the gates
as given: that is how it is held against `lstm_cell_reference`.
`lstm_steps.launches` counts the kernel's launches (one a layer wherever a
layer's rows fit one launch), `lstm_steps.resident_layers` and
`.streamed_layers` the layers run with W_hh held in registers or streamed
each step.  The library is its own and is built on first use.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from tpu_sednn_torch.ops import _build

# the kernel's fixed shape (csrc/lstm_cell.cu): 8 warps, ring stages of 16 rows of 1024
# floats, 512 k's a warp, 128 W floats a thread (16 k's x 8 columns)
WARPS, ROWS, WARP_K, MAX_RING, STRIDE = 8, 16, 512, 8, 1024
RING = 4  # ring stages wanted


class LstmPlan(NamedTuple):
    """How lstm_steps cuts a layer (csrc/lstm_cell.cu's header explains the terms)."""
    h: int            # units as the kernel sees them: H rounded up to a multiple of 4
    units: int        # units a block owns (4 x units columns of W_hh)
    col_groups: int   # 8-column groups of a pass; 8 / col_groups warps along k
    grid: int         # blocks, one an SM, all resident at once
    k_chunk: int      # floats of a row a pass copies
    k_passes: int     # passes over k a step (1: W_hh's slice stays in registers)
    col_passes: int   # passes over the block's columns a step
    ring: int         # ring stages
    rows: int         # rows of the batch a launch takes
    launches: int     # launches a layer
    smem: int         # shared memory a block, bytes
    resident: bool    # W_hh's slice held in registers for all steps


def lstm_plan(B: int, H: int, sms: int, smem: int) -> LstmPlan:
    """The kernel's plan for a layer of B rows and H units on a card of `sms`
    SMs and `smem` bytes of shared memory a block.  A block an SM: the
    fewest units a block (an even power of two) that `sms` blocks cover;
    2 units a column group, up to 8 groups; the warps left over go along k.
    W_hh's slice stays in registers when one pass covers it, else it is
    streamed a pass at a time.  The ring gets up to 4 stages of 16 rows, the
    rows of a launch what shared memory leaves (c for every row, and the sums
    carried over k passes when there are several).  The C entry launches
    this plan as it is and only checks it."""
    if B < 1 or H < 1 or sms < 1:
        raise ValueError(f"no plan for B = {B}, H = {H} on {sms} SMs")
    hp = -(-H // 4) * 4
    units = 2
    while units * sms < hp:
        units *= 2
    col_groups = min(units // 2, 8)
    k_pass = WARP_K * (WARPS // col_groups)
    k_passes, col_passes = -(-hp // k_pass), units // (2 * col_groups)
    k_chunk = min(k_pass, hp)
    stage = 4 * ROWS * STRIDE
    fixed = 8 * MAX_RING + 4 * 2 * ROWS * 8 * WARPS
    per_row = 4 * units + (4 * 8 * col_groups if k_passes > 1 else 0)
    cap = (smem - fixed - 2 * stage) // per_row
    if cap < 1:
        raise ValueError(f"{smem} bytes of shared memory hold no plan for H = {H}")
    rows = min(B, cap)
    ring = min(RING, (smem - fixed - rows * per_row) // stage)
    return LstmPlan(h=hp, units=units, col_groups=col_groups, grid=-(-hp // units),
                    k_chunk=k_chunk, k_passes=k_passes, col_passes=col_passes, ring=ring,
                    rows=rows, launches=-(-B // rows), smem=fixed + ring * stage + rows * per_row,
                    resident=k_passes == 1 and col_passes == 1)


def lstm_cell_reference(gates: torch.Tensor, c: torch.Tensor, h: torch.Tensor) -> None:
    """The kernel's cell update in plain torch: gates (B, 4H), ordered i, f,
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
    lib.lstm_steps_f32.argtypes = [p] * 5 + [i] * 12 + [p]
    lib.lstm_steps_f32.restype = ctypes.c_int
    lib.lstm_card_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.lstm_card_limits.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def card_limits(index: int) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of CUDA device `index`."""
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _lib().lstm_card_limits(ctypes.byref(sms), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"lstm_card_limits failed: CUDA error {rc}")
    return sms.value, smem.value


def lstm_steps_reference(proj: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
                         c: torch.Tensor) -> None:
    """Plain torch version of `lstm_steps`: the step loop in Python (it
    leaves the gates in proj)."""
    for t in range(proj.shape[0]):
        proj[t].addmm_(hs[t], w_hh)
        lstm_cell_reference(proj[t], c, hs[t + 1])


def _launch(plan: LstmPlan, proj, w_hh, hs, c) -> None:
    """The plan's launches on tensors whose H is plan.h, 16-byte aligned."""
    T, B = proj.shape[:2]
    flags = torch.zeros(plan.launches, plan.grid, dtype=torch.int32, device=proj.device)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    for i in range(plan.launches):
        row0 = i * plan.rows
        rc = _lib().lstm_steps_f32(proj.data_ptr(), w_hh.data_ptr(), hs.data_ptr(),
                                   c.data_ptr(), flags[i].data_ptr(), T, B, row0,
                                   min(plan.rows, B - row0), plan.h, plan.units,
                                   plan.col_groups, plan.k_passes, plan.col_passes, plan.ring,
                                   plan.grid, plan.smem, stream)
        if rc != 0:
            raise RuntimeError(f"lstm_steps failed: CUDA error {rc}")
        lstm_steps.launches += 1


def run_plan(plan: LstmPlan, proj: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
             c: torch.Tensor, launch=_launch) -> None:
    """`launch(plan, proj, w_hh, hs, c)` on the tensors themselves where H is
    plan.h and each is 16-byte aligned, else on zero-padded copies (padded
    units' gates are 0, so their c and h stay 0), copied back."""
    T, B, G = proj.shape
    H, Hp = G // 4, plan.h
    if Hp == H and all(a.data_ptr() % 16 == 0 for a in (proj, w_hh, hs, c)):
        launch(plan, proj, w_hh, hs, c)
        return
    pp = proj.new_zeros(T, B, 4, Hp)
    pp[..., :H] = proj.view(T, B, 4, H)
    ww = w_hh.new_zeros(Hp, 4, Hp)
    ww[:H, :, :H] = w_hh.view(H, 4, H)
    hh, cc = hs.new_zeros(T + 1, B, Hp), c.new_zeros(B, Hp)
    hh[0, :, :H], cc[:, :H] = hs[0], c
    launch(plan, pp.view(T, B, 4 * Hp), ww.view(Hp, 4 * Hp), hh, cc)
    hs[1:].copy_(hh[1:, :, :H])
    c.copy_(cc[:, :H])


def lstm_steps(proj: torch.Tensor, w_hh: torch.Tensor, hs: torch.Tensor,
               c: torch.Tensor) -> None:
    """A layer's T steps: for t = 0 .. T-1, the gates proj[t] + hs[t] W_hh
    and the cell update of c by them into hs[t + 1].  proj (T, B, 4H), the
    input projection (the plain version leaves the gates in it, the kernel
    only reads it); w_hh (H, 4H); hs (T + 1, B, H) holds the initial h in
    hs[0] and receives h; c (B, H) the initial cell, updated in place.
    Every tensor float32 and contiguous, on one device.  On a card, an H
    that is not a multiple of 4 (or a tensor not 16-byte aligned) runs on
    zero-padded copies: padded units stay 0."""
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
    if T == 0 or B == 0 or H == 0:
        return
    plan = lstm_plan(B, H, *card_limits(dev.index if dev.index is not None
                                        else torch.cuda.current_device()))
    run_plan(plan, proj, w_hh, hs, c)
    if plan.resident:
        lstm_steps.resident_layers += 1
    else:
        lstm_steps.streamed_layers += 1


lstm_steps.launches = lstm_steps.resident_layers = lstm_steps.streamed_layers = 0
