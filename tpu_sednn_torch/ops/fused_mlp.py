"""The fused MLP layer kernels on hand-written CUDA (`csrc/fused_mlp.cu`) —
the port of tpu_sednn/ops/fused_mlp.py:

* `fused_linear_act`  — y = act(x @ W + b) (`_fwd_kernel`): bias and
  activation in the product's epilogue, y written once.  Both product forms
  are one launch: K is split over the blocks of a thread-block cluster, which
  sum their partial tiles through distributed shared memory (the float32
  form's split is `fwd_k_chunk`'s, so its sums keep one order whatever its
  tiles).  Two optional fusions the chunk trainer uses: a dropout mask on x while it is
  loaded (`in_mask`) and the dropout mask of the NEXT layer's input applied
  to y in the epilogue (`out_mask`), each either an explicit 0/1 tensor or
  `(key, omit)` for the Philox stream of ops/philox.py generated in the
  kernel, with `*_scale` on the kept elements (1/(1-omit) in inverted mode);
  `in_mask` may also be a packed int32 table of keep bits
  (ops/philox.py:philox_mask_words), which the chunk trainer's layer-0
  kernels read instead of drawing the bits themselves.
* `fused_bwd_update`  — one layer's backward and momentum update
  (`_bwd_kernel`): dedy = dedx @ W^T with W BEFORE the update,
  G = y_prev^T @ dedx, delta' = m*delta - c*(G/n + wc*W), W' = W + delta',
  the bias likewise; W and delta read once and written once, no G in memory.
  Both product forms are one launch of one kernel (stripe_bwd_kernel): a
  block streams a stripe of W's rows over a range of N, and dedy is summed
  over the ranges within a thread-block cluster (no dedy scratch, no second
  launch; at most BWD_MAX_ROWS rows on the card).
* `fused_bwd_grad_out` and `dp_update` — the same backward split in two for
  the data-parallel chunk trainer, which sums the gradient over the ranks
  between them (the TPU kernel sums it with remote copies inside the kernel,
  resident_chunk.py:_allreduce): the gradient-out form writes G and gb and
  updates nothing; the update kernel applies a given gradient with the same
  rule and the same arithmetic as the fused one.

All take the true sizes (K = 1548, N = 129, any batch): nothing is padded.
On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version beside it (`*_reference`).

`bf16` is the TPU kernels' flag, with their default True: both operands of
every product are rounded to bfloat16 (to nearest even, as
astype(jnp.bfloat16)) and the products summed in float32, on the tensor
cores (tc_fwd_kernel, stripe_bwd_kernel's tensor-core form).  Everything
else stays float32 and unrounded: biases, the bias gradient, wc*W and the
step W + delta' on the unrounded W, the activation derivative.  bf16=False:
float32 products (f32_fwd_kernel, stripe_bwd_kernel's FMA form).  On a CUDA
tensor each value launches its own form or raises; neither falls back on the
other.

Activations and biases are float32.  W may be stored bfloat16 (widened as it
is loaded), and `fused_bwd_update` then stores W' and delta' bfloat16 with
stochastic rounding (`sr_seed`: the stream of `csrc/sr_round.cuh`, whose bits
the plain version draws too); delta alone may be bfloat16 with W float32, and
W then takes the unrounded step: the chunk trainer's sr_state and sr_delta.
`fused_bwd_update` writes W, delta, b and delta_b IN PLACE on both devices
and returns them.  `<wrapper>.launches` counts launches of the wrapper's
product kernel (either form), `<wrapper>.tc_launches` those of its
tensor-core form; each is counted where the C entry point reports the
launch (one launch a layer in either form).
`fused_bwd_grad_out.philox_launches` counts the launches that drew a (key,
omit) input mask by Philox in the kernel (the data-parallel trainer gives a
table: 0 there).  `dp_update.sr_launches` counts the update's launches that
rounded a bfloat16 delta stochastically.  The float32 forms
are FMA-bound at the flagship shapes, the tensor-core forms bytes-bound
(csrc/fused_mlp.cuh says why).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from tpu_sednn_torch.model.mlp import mm_operand
from tpu_sednn_torch.ops import _build
from tpu_sednn_torch.ops.philox import (SR_DELTA_SHIFT, SR_WEIGHT_SHIFT, mask_threshold,
                                        mask_words, philox_mask, sr_bits, sr_to_bf16_reference,
                                        unpack_mask_words)

ACTS = {"linear": 0, "relu": 1, "sigmoid": 2}
_STORAGE = (torch.float32, torch.bfloat16)
MaskArg = Union[None, torch.Tensor, Tuple[int, float]]


def _act(name: str, z: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(z)
    if name == "sigmoid":
        return torch.sigmoid(z)
    if name == "linear":
        return z
    raise ValueError(f"unknown activation {name!r}")


def _mask_tensor(mask: MaskArg, shape, device, row0: int = 0) -> Optional[torch.Tensor]:
    """An explicit mask as it is, a packed int32 table of keep bits unpacked,
    a (key, omit) spec as its Philox tensor (rows row0.. of the stream)."""
    if isinstance(mask, torch.Tensor) and mask.dtype == torch.int32:
        if tuple(mask.shape) != (shape[0], mask_words(shape[1])):
            raise ValueError(f"a table of keep bits of shape {tuple(mask.shape)} for {tuple(shape)}; "
                             f"expected {(shape[0], mask_words(shape[1]))}")
        return unpack_mask_words(mask, shape[1])
    if mask is None or isinstance(mask, torch.Tensor):
        return mask
    key, omit = mask
    return philox_mask(int(key), shape[0], shape[1], float(omit), row0=row0, device=device)


def _masked(x, mask: Optional[torch.Tensor], scale: float, dtype: torch.dtype) -> torch.Tensor:
    """x * (mask * scale) computed in `dtype` (x as it is without a mask)."""
    h = x.to(dtype)
    return h if mask is None else h * (mask.to(dtype) * scale)


def fused_linear_act_reference(x, w, b, act: str = "linear", in_mask: MaskArg = None,
                               in_scale: float = 1.0, out_mask: MaskArg = None,
                               out_scale: float = 1.0, dtype: Optional[torch.dtype] = None,
                               bf16: bool = True):
    """Plain torch version of `fused_linear_act`; products in `dtype`
    (None = float32; torch.float64 gives the function free of float32
    summation order), of the masked and scaled x and of W rounded to
    bfloat16 first if bf16 (x is then masked and scaled in its own type,
    as the kernel and the TPU kernel do before they round it); result
    returned as float32."""
    dt = dtype or torch.float32
    h = _masked(x, _mask_tensor(in_mask, x.shape, x.device), in_scale, x.dtype if bf16 else dt)
    y = _act(act, mm_operand(h, bf16, dt) @ mm_operand(w, bf16, dt) + b.to(dt))
    om = _mask_tensor(out_mask, y.shape, x.device)
    if om is not None:
        y = y * (om.to(dt) * out_scale)
    return y.to(torch.float32)


def _layer_grads(dedx, y_prev, w, in_mask: MaskArg, in_scale: float, mask_row0: int,
                 deriv: Optional[str], dt: torch.dtype, bf16: bool):
    """(G, gb, dedy) of one layer in `dt`, as kernel 2 forms them: G =
    y^T @ dedx and dedy = dedx @ W^T (times `deriv`'s derivative on y) from
    operands rounded to bfloat16 if bf16, gb = the rows' sum of dedx."""
    dx = dedx.to(dt)
    y = _masked(y_prev, _mask_tensor(in_mask, y_prev.shape, y_prev.device, mask_row0), in_scale,
                y_prev.dtype if bf16 else dt).to(dt)
    dx_r = mm_operand(dx, bf16, dt)
    dedy = dx_r @ mm_operand(w.to(dt), bf16, dt).T
    if deriv == "relu":
        dedy = torch.where(y > 0, dedy, torch.zeros((), dtype=dt, device=dedy.device))
    elif deriv == "sigmoid":
        dedy = y * (1.0 - y) * dedy
    elif deriv is not None:
        raise ValueError(f"unknown derivative {deriv!r}")
    return mm_operand(y, bf16, dt).T @ dx_r, dx.sum(dim=0), dedy


def fused_bwd_update_reference(dedx, y_prev, w, delta, b, delta_b, momentum, lrate, inv_n,
                               weightcost, in_mask: MaskArg = None, in_scale: float = 1.0,
                               deriv: Optional[str] = None,
                               dtype: Optional[torch.dtype] = None,
                               sr_seed: Optional[int] = None, bf16: bool = True):
    """Plain torch version of `fused_bwd_update`, pure: -> (w', delta',
    dedy_prev, b', delta_b') as new tensors, float32 but for a w' or delta'
    whose input is bfloat16: that one is rounded from float32 with the bits of
    stream `sr_seed`, as the kernel rounds it.  deriv: None, "relu" or
    "sigmoid" multiplies dedy_prev by that activation's derivative taken on
    y_prev (where(y > 0) / y*(1-y)).  bf16: the two products (dedy and G)
    take their operands rounded to bfloat16; the update, the bias gradient
    and the derivative take them as they are."""
    dt = dtype or torch.float32
    m, c = float(momentum), (1.0 - float(momentum)) * float(lrate)
    w_, d_ = w.to(dt), delta.to(dt)
    g, gb, dedy = _layer_grads(dedx, y_prev, w_, in_mask, in_scale, 0, deriv, dt, bf16)
    new_delta = m * d_ - c * (g * float(inv_n) + float(weightcost) * w_)
    new_db = m * delta_b.to(dt) - c * (gb * float(inv_n))
    f32 = torch.float32

    def store(val, like, shift):
        if like.dtype != torch.bfloat16:
            return val.to(f32)
        bits = sr_bits(int(sr_seed), val.shape[0], val.shape[1], shift, val.device)
        return sr_to_bf16_reference(val.to(f32), bits)

    return (store(w_ + new_delta, w, SR_WEIGHT_SHIFT), store(new_delta, delta, SR_DELTA_SHIFT),
            dedy.to(f32), (b.to(dt) + new_db).to(f32), new_db.to(f32))


def fused_bwd_grad_out_reference(dedx, y_prev, w, in_mask: MaskArg = None, in_scale: float = 1.0,
                                 mask_row0: int = 0, deriv: Optional[str] = None,
                                 with_dedy: bool = True, dtype: Optional[torch.dtype] = None,
                                 bf16: bool = True):
    """Plain torch version of `fused_bwd_grad_out` -> (grad, dedy_prev):
    grad the flat float32 (K*N + N,) G then gb, dedy_prev float32 (None
    without with_dedy); products in `dtype` (None = float32), of operands
    rounded to bfloat16 if bf16."""
    dt = dtype or torch.float32
    g, gb, dedy = _layer_grads(dedx, y_prev, w, in_mask, in_scale, mask_row0, deriv, dt, bf16)
    return (torch.cat([g.reshape(-1), gb]).to(torch.float32),
            dedy.to(torch.float32) if with_dedy else None)


def dp_update_reference(w, delta, b, delta_b, grad, momentum, a_coef, b_coef,
                        sr_seed: Optional[int] = None, first: bool = True, apply: bool = True):
    """Plain torch version of `dp_update`, pure: -> (w', delta', b', delta_b'),
    one float32 operation at a time in the kernel's order (so the two agree
    bit for bit on the same gradient); a bfloat16 delta' rounded
    stochastically with the bits of stream `sr_seed`, as the kernel rounds
    it, and w' taking the unrounded step."""
    K, N = w.shape
    f32 = torch.float32
    m, a, c = (torch.tensor(float(v), dtype=f32, device=w.device)
               for v in (momentum, a_coef, b_coef))
    g, gb = grad[:K * N].reshape(K, N).to(f32), grad[K * N:].to(f32)
    d, db = delta.to(f32), delta_b.to(f32)
    nd = m * d - (a * g + c * w) if first else d - a * g
    ndb = m * db - a * gb if first else db - a * gb
    if delta.dtype == torch.bfloat16:
        d_store = sr_to_bf16_reference(nd, sr_bits(int(sr_seed), K, N, SR_DELTA_SHIFT, w.device))
    else:
        d_store = nd
    return (w + nd if apply else w.clone(), d_store, b + ndb if apply else b.clone(), ndb)


def _c_api() -> dict:
    """csrc/fused_mlp.cu's entry points: name -> (argtypes, restype)."""
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    return {
        "fused_linear_act_f32": ([p, p, i, p, p, i, i, i, i, i, p, u, u, f, i, p, u, u, f, i, ip,
                                  p], i),
        "fused_bwd_update_f32": ([p, p, p, i, p, i, u, p, p, p, i, i, i, f, f, f, i, p, u, u, f,
                                  i, i, ip, p], i),
        "fused_bwd_grad_out_f32": ([p, p, p, p, p, i, i, i, i, p, u, u, f, i, i, i, ip, p], i),
        "fused_f32_fwd_plan": ([i, i, i, i, ip], i),
        "fused_bwd_plan": ([i, i, i, i, i, ip], i),
        "fused_tc_smem_bytes": ([ip], None),
        "dp_update_f32": ([p, p, i, p, p, p, i, i, f, f, f, u, i, p], i),
    }


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp")
    for name, (argtypes, restype) in _c_api().items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def _check(name: str, t: torch.Tensor, shape, device, dtypes=(torch.float32,)) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {' or '.join(str(d)[6:] for d in dtypes)} expected, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _mask_args(name: str, mask: MaskArg, scale: float, shape, device):
    """-> (mode, pointer, key, threshold, scale, tensor kept alive) for the C call:
    mode 1 a float32 0/1 tensor, 2 a (key, omit) Philox spec, 3 a packed int32
    table of keep bits, (rows, mask_words(cols))."""
    if mask is None:
        return 0, None, 0, 0, 1.0, None
    if isinstance(mask, torch.Tensor) and mask.dtype == torch.int32:
        _check(name, mask, (shape[0], mask_words(shape[1])), device, (torch.int32,))
        return 3, mask.data_ptr(), 0, 0, float(scale), mask
    if isinstance(mask, torch.Tensor):
        _check(name, mask, shape, device)
        return 1, mask.data_ptr(), 0, 0, float(scale), mask
    key, omit = mask
    return 2, None, int(key) & 0xFFFFFFFF, mask_threshold(float(omit)), float(scale), None


# Rows of dedx the backward kernel takes on the card, in either product form:
# it keeps a stripe of dedy in registers, narrower as the rows grow
# (csrc/fused_mlp.cuh:kBwdMaxRows).  The plain version on the CPU takes any.
BWD_MAX_ROWS = 512


def _check_bwd_rows(rows: int) -> None:
    if rows > BWD_MAX_ROWS:
        raise ValueError(f"the backward kernel takes at most {BWD_MAX_ROWS} rows, got {rows}: "
                         f"use row tiles (tile_rows)")


def _count(wrapper, launched) -> None:
    """Add a backward call's launches, as the C entry point reports them."""
    wrapper.launches += launched[0] + launched[1]
    wrapper.tc_launches += launched[0]


def fused_linear_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str = "linear",
                     in_mask: MaskArg = None, in_scale: float = 1.0,
                     out_mask: MaskArg = None, out_scale: float = 1.0,
                     bf16: bool = True) -> torch.Tensor:
    """(B, K) @ (K, N) + (N,) -> act -> (B, N), any B, K, N.  w float32 or
    bfloat16 storage (widened as it is loaded).  bf16: products of operands
    rounded to bfloat16, summed in float32 (the tensor-core form); False:
    float32 products."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do not match")
    (B, K), N = x.shape, w.shape[1]
    if isinstance(out_mask, torch.Tensor) and out_mask.dtype == torch.int32:
        raise ValueError("out_mask: a packed table of keep bits is taken for in_mask only")
    if x.device.type == "cpu":
        return fused_linear_act_reference(x, w, b, act, in_mask, in_scale, out_mask, out_scale,
                                          bf16=bf16)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear_act runs on cuda or cpu tensors, got {x.device}")
    _check("x", x, (B, K), x.device)
    _check("w", w, (K, N), x.device, _STORAGE)
    _check("b", b, (N,), x.device)
    im = _mask_args("in_mask", in_mask, in_scale, (B, K), x.device)
    om = _mask_args("out_mask", out_mask, out_scale, (B, N), x.device)
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    launched = (ctypes.c_int * 2)()  # tc_fwd_kernel, f32_fwd_kernel
    with torch.cuda.device(x.device):
        rc = _lib().fused_linear_act_f32(
            x.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), b.data_ptr(),
            y.data_ptr(), B, K, N, ACTS[act], *im[:5], *om[:5], int(bf16), launched,
            torch.cuda.current_stream(x.device).cuda_stream)
    fused_linear_act.launches += launched[0] + launched[1]
    fused_linear_act.tc_launches += launched[0]
    if rc != 0:
        raise RuntimeError(f"fused_linear_act kernel launch failed: CUDA error {rc}")
    return y


fused_linear_act.launches = 0
fused_linear_act.tc_launches = 0


def fused_bwd_update(
    dedx: torch.Tensor,     # (B, N) upstream gradient dE/dx of this layer
    y_prev: torch.Tensor,   # (B, K) layer input (post-dropout, unless in_mask is given)
    w: torch.Tensor,        # (K, N), updated in place
    delta: torch.Tensor,    # (K, N) momentum buffer, updated in place
    b: torch.Tensor,        # (N,), updated in place
    delta_b: torch.Tensor,  # (N,), updated in place
    momentum: float,
    lrate: float,
    inv_n: float,           # 1 / bunchsize
    weightcost: float,
    in_mask: MaskArg = None,
    in_scale: float = 1.0,
    deriv: Optional[str] = None,
    sr_seed: Optional[int] = None,
    bf16: bool = True,
):
    """-> (w, delta, dedy_prev, b, delta_b) with one read/write of W/delta.

    Implements the reference rule delta' = m*delta - (1-m)*lr*(G/n + wc*W);
    the kernel takes it as [m, A, B] = [m, (1-m)*lr/n, (1-m)*lr*wc], the
    form `_scal_coefs` of the chunk trainer produces, so one kernel serves
    both update rules.  dedy_prev uses W before the update; unless `deriv`
    names an activation, the caller multiplies it by the derivative.
    in_mask masks y_prev while it is loaded (the first layer's input); it
    cannot be combined with `deriv`, which reads the stored y_prev.
    delta, or w and delta, may be bfloat16: their new values are then stored
    with stochastic rounding from stream `sr_seed` (required), and a float32
    w beside a bfloat16 delta takes the unrounded step.
    bf16: dedy_prev and G from operands rounded to bfloat16, summed in
    float32 (the tensor-core form); the update takes the unrounded W.
    False: float32 products.
    """
    if deriv not in (None, "relu", "sigmoid"):
        raise ValueError(f"unknown derivative {deriv!r}")
    if in_mask is not None and deriv is not None:
        raise ValueError("deriv is taken on the stored y_prev: give y_prev masked, not in_mask")
    if dedx.dim() != 2 or y_prev.dim() != 2 or dedx.shape[0] != y_prev.shape[0]:
        raise ValueError(f"shapes {tuple(dedx.shape)} and {tuple(y_prev.shape)} do not match")
    (B, N), K = dedx.shape, y_prev.shape[1]
    dev = dedx.device
    for name, t, shape in (("dedx", dedx, (B, N)), ("y_prev", y_prev, (B, K)), ("b", b, (N,)),
                           ("delta_b", delta_b, (N,))):
        _check(name, t, shape, dev)
    _check("w", w, (K, N), dev, _STORAGE)
    _check("delta", delta, (K, N), dev, _STORAGE)
    w_bf16, d_bf16 = w.dtype == torch.bfloat16, delta.dtype == torch.bfloat16
    if w_bf16 and not d_bf16:
        raise TypeError("bfloat16 w needs a bfloat16 delta (float32 w with bfloat16 delta is the "
                        "other supported mix)")
    if d_bf16 and sr_seed is None:
        raise ValueError("bfloat16 storage is rounded stochastically: give sr_seed")
    if dev.type == "cpu":
        w_, d_, dedy, b_, db_ = fused_bwd_update_reference(
            dedx, y_prev, w, delta, b, delta_b, momentum, lrate, inv_n, weightcost,
            in_mask, in_scale, deriv, sr_seed=sr_seed, bf16=bf16)
        with torch.no_grad():
            for dst, src in ((w, w_), (delta, d_), (b, b_), (delta_b, db_)):
                dst.copy_(src)
        return w, delta, dedy, b, delta_b
    if dev.type != "cuda":
        raise ValueError(f"fused_bwd_update runs on cuda or cpu tensors, got {dev}")
    _check_bwd_rows(B)
    c = (1.0 - float(momentum)) * float(lrate)
    im = _mask_args("in_mask", in_mask, in_scale, (B, K), dev)
    dedy = torch.empty((B, K), dtype=torch.float32, device=dev)
    launched = (ctypes.c_int * 2)()  # stripe_bwd_kernel: tensor-core, float32 form
    with torch.cuda.device(dev):
        rc = _lib().fused_bwd_update_f32(
            dedx.data_ptr(), y_prev.data_ptr(), w.data_ptr(), int(w_bf16), delta.data_ptr(),
            int(d_bf16), int(sr_seed or 0) & 0xFFFFFFFF, b.data_ptr(),
            delta_b.data_ptr(), dedy.data_ptr(), B, K, N, float(momentum), c * float(inv_n), c * float(weightcost), *im[:5],
            ACTS[deriv] if deriv else 0, int(bf16), launched,
            torch.cuda.current_stream(dev).cuda_stream)
    _count(fused_bwd_update, launched)
    if rc != 0:
        raise RuntimeError(f"fused_bwd_update kernel launch failed: CUDA error {rc}")
    return w, delta, dedy, b, delta_b


fused_bwd_update.launches = 0
fused_bwd_update.tc_launches = 0


def fused_bwd_grad_out(
    dedx: torch.Tensor,     # (B, N) upstream gradient dE/dx of this layer
    y_prev: torch.Tensor,   # (B, K) layer input (post-dropout, unless in_mask is given)
    w: torch.Tensor,        # (K, N) float32, read only
    in_mask: MaskArg = None,
    in_scale: float = 1.0,
    mask_row0: int = 0,
    deriv: Optional[str] = None,
    with_dedy: bool = True,
    bf16: bool = True,
    grad: Optional[torch.Tensor] = None,
    dedy: Optional[torch.Tensor] = None,
):
    """One layer's backward without its update: the gradient-out form of
    `fused_bwd_update`, which the data-parallel chunk trainer runs so that
    the gradient can be summed over the ranks before `dp_update` applies it.

    -> (grad, dedy_prev).  grad: (K*N + N,) float32, G = y_prev^T @ dedx
    row-major, then gb = the sum of dedx's rows.  dedy_prev: (B, K) = dedx @
    W^T, times `deriv`'s derivative on y_prev, or None when with_dedy is False
    (the first layer).  A (key, omit) in_mask draws rows mask_row0.. of its
    Philox stream (a rank's rows of the global bunch); an int32 table (the
    data-parallel trainer's: its rows of a call's table, input_mask_bits at
    the rank's row0) is read as it is, mask_row0 unused.  bf16: products of
    operands rounded to bfloat16, float32 sums (tensor cores); False: float32
    products.  grad and dedy may be given to be written into.
    """
    if deriv not in (None, "relu", "sigmoid"):
        raise ValueError(f"unknown derivative {deriv!r}")
    if in_mask is not None and deriv is not None:
        raise ValueError("deriv is taken on the stored y_prev: give y_prev masked, not in_mask")
    if dedx.dim() != 2 or y_prev.dim() != 2 or dedx.shape[0] != y_prev.shape[0]:
        raise ValueError(f"shapes {tuple(dedx.shape)} and {tuple(y_prev.shape)} do not match")
    (B, N), K = dedx.shape, y_prev.shape[1]
    dev = dedx.device
    for name, t, shape in (("dedx", dedx, (B, N)), ("y_prev", y_prev, (B, K)), ("w", w, (K, N))):
        _check(name, t, shape, dev)
    if dev.type == "cpu":
        g, dy = fused_bwd_grad_out_reference(dedx, y_prev, w, in_mask, in_scale, mask_row0, deriv,
                                             with_dedy, bf16=bf16)
        if grad is not None:
            grad.copy_(g)
            g = grad
        if dedy is not None and dy is not None:
            dedy.copy_(dy)
            dy = dedy
        return g, dy
    if dev.type != "cuda":
        raise ValueError(f"fused_bwd_grad_out runs on cuda or cpu tensors, got {dev}")
    _check_bwd_rows(B)
    im = _mask_args("in_mask", in_mask, in_scale, (B, K), dev)
    grad = torch.empty(K * N + N, dtype=torch.float32, device=dev) if grad is None else grad
    _check("grad", grad, (K * N + N,), dev)
    if with_dedy:
        dedy = torch.empty((B, K), dtype=torch.float32, device=dev) if dedy is None else dedy
        _check("dedy", dedy, (B, K), dev)
    else:
        dedy = None
    launched = (ctypes.c_int * 2)()  # stripe_bwd_kernel: tensor-core, float32 form
    with torch.cuda.device(dev):
        rc = _lib().fused_bwd_grad_out_f32(
            dedx.data_ptr(), y_prev.data_ptr(), w.data_ptr(), grad.data_ptr(),
            None if dedy is None else dedy.data_ptr(),
            B, K, N, *im[:5], int(mask_row0), ACTS[deriv] if deriv else 0, int(bf16), launched,
            torch.cuda.current_stream(dev).cuda_stream)
    _count(fused_bwd_grad_out, launched)
    fused_bwd_grad_out.philox_launches += launched[0] + launched[1] if im[0] == 2 else 0
    if rc != 0:
        raise RuntimeError(f"fused_bwd_grad_out kernel launch failed: CUDA error {rc}")
    return grad, dedy


fused_bwd_grad_out.launches = 0
fused_bwd_grad_out.tc_launches = 0
fused_bwd_grad_out.philox_launches = 0


def dp_update(w: torch.Tensor, delta: torch.Tensor, b: torch.Tensor, delta_b: torch.Tensor,
              grad: torch.Tensor, momentum: float, a_coef: float, b_coef: float,
              sr_seed: Optional[int] = None, first: bool = True, apply: bool = True):
    """The update from a given gradient, in place: grad (K*N + N,) as
    `fused_bwd_grad_out` writes it (summed over the ranks by the data-parallel
    trainer); delta' = m*delta - (A*G + B*W) (first) or delta - A*G, W' =
    W + delta' (apply), the bias alike with gb: the chunk trainer's rule
    [m, A, B] (`resident_chunk._scal_coefs`) and its row-tile flags.  w
    float32; delta float32 or bfloat16 (then stored with stochastic rounding
    from stream `sr_seed`, and w takes the unrounded step: sr_delta).
    -> (w, delta, b, delta_b)."""
    if w.dim() != 2:
        raise ValueError(f"w: 2-D expected, got {tuple(w.shape)}")
    (K, N), dev = w.shape, w.device
    _check("w", w, (K, N), dev)
    _check("delta", delta, (K, N), dev, _STORAGE)
    for name, t, shape in (("b", b, (N,)), ("delta_b", delta_b, (N,)), ("grad", grad, (K * N + N,))):
        _check(name, t, shape, dev)
    d_bf16 = delta.dtype == torch.bfloat16
    if d_bf16 and sr_seed is None:
        raise ValueError("bfloat16 storage is rounded stochastically: give sr_seed")
    if dev.type == "cpu":
        new = dp_update_reference(w, delta, b, delta_b, grad, momentum, a_coef, b_coef, sr_seed,
                                  first, apply)
        with torch.no_grad():
            for dst, src in zip((w, delta, b, delta_b), new):
                dst.copy_(src)
        return w, delta, b, delta_b
    if dev.type != "cuda":
        raise ValueError(f"dp_update runs on cuda or cpu tensors, got {dev}")
    flags = (1 if first else 0) | (2 if apply else 0)  # kUpdFirst, kUpdApply
    with torch.cuda.device(dev):
        rc = _lib().dp_update_f32(
            w.data_ptr(), delta.data_ptr(), int(d_bf16), b.data_ptr(), delta_b.data_ptr(),
            grad.data_ptr(), K, N, float(momentum), float(a_coef), float(b_coef),
            int(sr_seed or 0) & 0xFFFFFFFF, flags, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dp_update kernel launch failed: CUDA error {rc}")
    dp_update.launches += 1
    dp_update.sr_launches += 1 if d_bf16 else 0
    return w, delta, b, delta_b


dp_update.launches = 0
dp_update.sr_launches = 0
