"""Data and tensor parallelism over torch.distributed — counterpart of
tpu_sednn/parallel/mesh.py.

The reference's parallelism (split each bunch across GPUs, sum the gradients,
one update, identical replicas; BP_GPU.cu:29-37, 775-908) is one process per
rank here, joined by a torch.distributed process group:

* `initialize_distributed` joins the group from torchrun's environment
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or from explicit
  arguments; a single process is left alone.  nccl where each rank has a
  card, gloo where all ranks share one card or run on the CPU
  (`backend_rule`).
* `make_mesh` describes the group as the JAX package's ("data", "model")
  mesh: rank r sits at (r // n_model, r % n_model), with a group for each
  axis (its sums and gathers run there) and this rank's device.
* `all_reduce` sums a tensor over one axis of the mesh: nccl on the cards,
  gloo on the CPU, and where the ranks share a card, on that card
  (ops/rank_sum.py's kernel over CUDA IPC); `all_gather_cols` puts the
  "model" ranks' blocks of columns side by side; `fence` waits for the sums
  on a shared card before a rank exits.
* `replicate` broadcasts a state from rank 0, so replicas start bit-equal.
* `bunch_part_regroup_host` / `make_global_chunk`: the bunch_part row split
  (rank d takes rows [d*bs_local, (d+1)*bs_local) of every bunch), on the
  host, and this rank's rows of the regrouped chunk on its device.
* `make_dp_train_chunk`: the plain torch data-parallel trainer (the JAX
  package's shard_map + psum trainer): per bunch, autograd on this rank's
  rows with the loss normalised by the GLOBAL bunch, an all-reduce of the
  gradients, the parity update on every replica; dropout masks of the global
  bunch drawn from the same generator stream on every rank and sliced to the
  rank's rows, so a run equals the single-process trainer with the same
  generator to reduction order.
* `state_shardings` / `make_auto_sharded_train_chunk`: the tensor-parallel
  trainer (the JAX package's jit over a 2-D mesh): rows split over "data",
  the columns of every W and b over "model"; a forward gathers each layer's
  columns, a backward sums dedy over "model" and the gradients over "data".
  It computes `reference_train_chunk` on the global chunk.

The chunk trainer on the hand-written kernels has its data-parallel form in
ops/resident_chunk.py (`make_dp_resident_train_chunk`).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.model.mlp import (MLP, ModelConfig, _act, _bunch_masks, _dropout_mask,
                                         dropout_omits)
from tpu_sednn_torch.train.step import OptConfig, TrainState, _apply, _grads


@dataclass
class Mesh:
    """A ("data", "model") mesh of the process group.  The data axis keeps
    the names of the 1-D mesh: `n_data` ranks, this rank's data coordinate
    `index`, and `group`, the ranks of this rank's model column, which the
    gradient sums run over (None: the default group).  The model axis:
    `n_model` ranks, this rank's `model_index`, and `model_group`, the ranks
    of this rank's data row.  `device` is this rank's device."""
    n_data: int
    index: int
    device: torch.device
    group: Any = None
    n_model: int = 1
    model_index: int = 0
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def axis(self, name: str) -> tuple:
        """(size, group) of the "data" or the "model" axis."""
        if name == "data":
            return self.n_data, self.group
        if name == "model":
            return self.n_model, self.model_group
        raise ValueError(f"mesh axis {name!r}: 'data' or 'model'")


def backend_rule(on_card: bool, n_cards: int, local_world: int, world: int) -> str:
    """The backend the ranks take: "nccl" where every rank of the host has a
    card of its own (local_world <= n_cards); "gloo" on the CPU, or where
    every rank of the group shares the one card of one host (NCCL refuses
    two ranks on one card; their sums then run on that card through CUDA
    IPC, ops/rank_sum.py, and gloo carries only the rendezvous and the
    barriers).  Any other layout of ranks on cards raises ValueError."""
    if not on_card:
        return "gloo"
    if n_cards >= local_world:
        return "nccl"
    if n_cards == 1 and local_world == world:
        return "gloo"
    raise ValueError(f"{local_world} ranks on a host with {n_cards} cards ({world} ranks in all): "
                     "the ranks must each have a card (nccl) or all share one card of one host "
                     "(gloo, sums on that card)")


def initialize_distributed(device: str | torch.device = "cuda", backend: Optional[str] = None,
                           init_method: Optional[str] = None, world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> Optional[str]:
    """Join the process group; -> its backend, or None for a single process
    (WORLD_SIZE unset or 1), which is left alone.  Already joined: returns the
    group's backend.

    world_size / rank default to torchrun's WORLD_SIZE / RANK, init_method to
    "env://" (MASTER_ADDR, MASTER_PORT).  On a CUDA `device` rank r takes card
    LOCAL_RANK % torch.cuda.device_count().

    Backend rule (`backend_rule`): "nccl" where every rank of the host has a
    card of its own, "gloo" where all the ranks share one card, or run on the
    CPU.  Ranks that share a card sum their gradients on it (`all_reduce`);
    no sum runs on the host.  Asking for "nccl" where ranks share a card or
    run on the CPU, or for "gloo" with card tensors where the ranks have a
    card each, raises.  Rank 0 prints the choice.
    """
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(rank if rank is not None else os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    on_card = torch.device(device).type == "cuda"
    n_cards = 0
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % n_cards)
    rule = backend_rule(on_card, n_cards, local_world, world)
    backend = backend or rule
    if backend != rule:
        raise ValueError(f"backend {backend} for {local_world} ranks on a host with {n_cards} "
                         f"cards: this layout takes {rule} (nccl needs a card for each rank; "
                         "gloo with card tensors needs every rank on one card)")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world,
                            rank=rank)
    if rank == 0:
        how = ("every rank has a card of its own" if backend == "nccl" else
               f"the {world} ranks share one card and sum on it (CUDA IPC)" if on_card else
               "the ranks run on the CPU")
        print(f"[distributed] {world} ranks, backend {backend}: {how}", file=sys.stderr, flush=True)
    return backend


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The (n_data x n_model) mesh of the process group (a single process:
    1 x 1); n_data * n_model must equal the world size, n_data defaults to
    world / n_model.  Rank r sits at (r // n_model, r % n_model), the order
    of the JAX package's devices.reshape(n_data, n_model).  With n_model > 1
    every rank creates every axis group (dist.new_group) in one order: the
    data groups of the model columns 0, 1, ..., then the model groups of the
    data rows.  devices: this rank's device as a one-element sequence, or
    every rank's, indexed by rank; default the current CUDA device (raises
    where there is none)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_model = int(n_model)
    if n_model < 1:
        raise ValueError(f"mesh model={n_model}: at least 1")
    n = world // n_model if n_data is None else int(n_data)
    if n < 1 or n * n_model != world:
        raise ValueError(f"mesh {n} x {n_model} must hold the world size {world} (one rank per "
                         "process: launch with python -m torch.distributed.run "
                         f"--nproc_per_node={max(n, 1) * n_model})")
    if devices is not None:
        devices = list(devices)
        dev = torch.device(devices[0] if len(devices) == 1 else devices[rank])
    else:
        dev = resolve_device("cuda")
    if n_model == 1:
        return Mesh(n_data=n, index=rank, device=dev)
    data_groups = [dist.new_group([d * n_model + m for d in range(n)]) for m in range(n_model)]
    model_groups = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n)]
    d, m = divmod(rank, n_model)
    return Mesh(n_data=n, index=d, device=dev, group=data_groups[m], n_model=n_model,
                model_index=m, model_group=model_groups[d])


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, TrainState):
        return _tensors(tree.params) + _tensors(tree.deltas)
    if isinstance(tree, MLP):
        return [p.data for p in list(tree.w) + list(tree.b)]
    return [t for sub in tree for t in _tensors(sub)]


def replicate(tree, mesh: Mesh):
    """Broadcast every tensor of `tree` (a tensor, an MLP, a TrainState or
    a sequence of them) from rank 0, in place, so that the replicas start
    bit-equal; -> tree.  On a 1-D mesh over its group, on a 2-D one over
    every rank.  A no-op on a one-rank mesh."""
    if mesh.n_data * mesh.n_model > 1:
        group = mesh.group if mesh.n_model == 1 else None
        for t in _tensors(tree):
            buf = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            if buf.is_cuda and dist.get_backend(group) == "gloo":  # a copy through the host
                host = buf.cpu()
                dist.broadcast(host, src=0, group=group)
                buf.copy_(host)
            else:
                dist.broadcast(buf, src=0, group=group)
    return tree


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of the rows of x, on its device."""
    n = x.shape[0] // mesh.n_data
    return x[mesh.index * n:(mesh.index + 1) * n].to(mesh.device)


def bunch_part_regroup_host(a: np.ndarray, bunchsize: int, n_dev: int) -> np.ndarray:
    """Rank d's b-th local slice = rows [b*bunchsize + d*bs_local, ...) of the
    chunk (BP_GPU.cu:29-37), ranks in order, the partial bunch dropped: the
    multi-process input pipeline regroups on the host so that each rank ships
    only its own rows, and global bunches match single-process order."""
    n_bunches = len(a) // bunchsize
    bs_local = bunchsize // n_dev
    a = np.ascontiguousarray(a[: n_bunches * bunchsize])
    return (a.reshape(n_bunches, n_dev, bs_local, a.shape[1])
             .transpose(1, 0, 2, 3)
             .reshape(n_dev * n_bunches * bs_local, a.shape[1]))


def make_global_chunk(a: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a regrouped chunk (`bunch_part_regroup_host`),
    and only those, on its device (through pinned memory on a card)."""
    n = a.shape[0] // mesh.n_data
    t = torch.from_numpy(np.ascontiguousarray(a[mesh.index * n:(mesh.index + 1) * n]))
    if mesh.device.type == "cuda":
        return t.pin_memory().to(mesh.device, non_blocking=True)
    return t


def local_rows(a: torch.Tensor, tile: int, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of every `tile` rows of a (the partial tile dropped):
    the bunch_part split of a whole chunk, contiguous, on a's device."""
    n_tiles, width = a.shape[0] // tile, a.shape[1]
    local = tile // mesh.n_data
    return a[: n_tiles * tile].reshape(n_tiles, mesh.n_data, local, width)[:, mesh.index] \
        .reshape(n_tiles * local, width)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Sum t over the ranks of one axis of the mesh (the gradient sums:
    "data"), in place (every rank gets the same bits); -> t.  A no-op on an
    axis of one rank.  nccl sums on the cards; gloo sums a CPU tensor on the
    CPU and a card tensor on the card the ranks share (ops/rank_sum.py:
    CardSum, float32).  After sums of card tensors under gloo, `fence`
    before a rank may exit."""
    n, group = mesh.axis(axis)
    if n > 1:
        if t.is_cuda and dist.get_backend(group) == "gloo":
            from tpu_sednn_torch.ops.rank_sum import card_sum

            card_sum(group, t.device).all_reduce(t)
        else:
            dist.all_reduce(t, group=group)
    return t


def all_gather_cols(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The "model" ranks' blocks of columns side by side, in rank order:
    t (rows, k) on every rank -> (rows, n_model * k), the same bits on every
    rank; t itself on an axis of one rank.  nccl gathers on the cards
    (all_gather_into_tensor), gloo a CPU tensor on the CPU; ranks that share
    a card gather there as a sum (CardSum) of each rank's block written into
    zeros, which is exact, as x + 0 = x in float32."""
    n, group = mesh.axis("model")
    if n == 1:
        return t
    rows, k = t.shape
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        from tpu_sednn_torch.ops.rank_sum import card_sum

        full = t.new_zeros(rows, n * k)
        full[:, mesh.model_index * k:(mesh.model_index + 1) * k] = t
        return card_sum(group, t.device).all_reduce(full)
    if t.is_cuda:
        stacked = t.new_empty(n * rows, k)
        dist.all_gather_into_tensor(stacked, t, group=group)
        return stacked.view(n, rows, k).permute(1, 0, 2).reshape(rows, n * k)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=1)


def fence(mesh: Mesh) -> None:
    """Wait until every rank's sums on a shared card have ended (their
    staging buffers are read by the other ranks' kernels), on both axes;
    nothing to wait for otherwise."""
    if mesh.device.type == "cuda" and dist.is_initialized():
        from tpu_sednn_torch.ops.rank_sum import fence as card_fence

        for name in ("data", "model"):
            n, group = mesh.axis(name)
            if n > 1:
                card_fence(group, mesh.device)


def _rank_masks(cfg: ModelConfig, rng, bunch: int, mesh: Mesh, device) -> Optional[list]:
    """A bunch's dropout masks as the single-process trainer draws them (the
    global bunch at full width, layer by layer from `rng`), at this rank's
    rows of the bunch; None without dropout.  tpu_prng draws only those rows
    (row0 = the rank's first), all layers in one `_dropout_masks` call;
    threefry draws the whole masks and slices them."""
    if not cfg.use_dropout:
        return None
    local = bunch // mesh.n_data
    if cfg.dropout_rng == "tpu_prng":
        return _bunch_masks(rng, cfg, local, cfg.layersizes[:-1], device,
                            row0=mesh.index * local)[0]
    rows = slice(mesh.index * local, (mesh.index + 1) * local)
    omits = dropout_omits(cfg, len(cfg.layersizes) - 1)
    return [None if o == 0.0 else _dropout_mask(rng, (bunch, n), o, device, cfg.dropout_rng)[rows]
            for n, o in zip(cfg.layersizes, omits)]


# ---------------------------------------------------------------------------
# plain data-parallel chunk trainer (the JAX package's shard_map + psum)
# ---------------------------------------------------------------------------

def make_dp_train_chunk(cfg: ModelConfig, opt: OptConfig, mesh: Mesh, pre_grouped: bool = False):
    """Data-parallel plain chunk trainer: each rank trains its bunch_part
    rows of every bunch; the gradients of the loss sum((out-t)^2)/n_global
    are summed over the ranks before the parity update, which every rank
    applies, so replicas stay equal (the reference's multi-GPU design,
    BP_GPU.cu:863-884).

    run(state, in_chunk, targ_chunk, rng, lrate, momentum, weightcost):
    in_chunk the whole chunk (every rank holds it), or with pre_grouped this
    rank's rows of the regrouped chunk (`make_global_chunk`).  `rng` is a
    torch.Generator in the same state on every rank: each bunch's dropout
    masks are drawn for the GLOBAL bunch, in the order the single-process
    trainer draws them, and sliced to this rank's rows.  Updates `state` in
    place.
    """
    n_dev, bunch = mesh.n_data, opt.bunchsize
    if bunch % n_dev:
        raise ValueError(f"bunchsize {bunch} not divisible by mesh data={n_dev}")
    bs_local = bunch // n_dev

    def step(state, x, t, rng, lrate, momentum, weightcost):
        masks = _rank_masks(cfg, rng, bunch, mesh, x.device)
        _, g_w, g_b = _grads(state, x, t, cfg, None, masks, False, None,
                             loss_fn=lambda out, tt: ((out - tt) ** 2).sum() / bunch)
        flat = all_reduce(torch.cat([g.reshape(-1) for g in g_w + g_b]), mesh)
        parts = flat.split([g.numel() for g in g_w + g_b])
        g_all = [p.view_as(g) for p, g in zip(parts, g_w + g_b)]
        m, lr, wc = momentum, lrate, weightcost

        def upd_w(delta, w, g):
            nd = m * delta - (1.0 - m) * lr * (g / bunch + wc * w)
            return nd, w + nd

        def upd_b(delta, b, g):
            nd = m * delta - (1.0 - m) * lr * (g / bunch)
            return nd, b + nd

        _apply(state, g_all[:len(g_w)], g_all[len(g_w):], upd_w, upd_b, inplace=True)

    def run(state: TrainState, in_chunk, targ_chunk, rng, lrate=opt.lrate, momentum=opt.momentum,
            weightcost=opt.weightcost):
        n_bunches = (in_chunk.shape[0] // bs_local if pre_grouped
                     else in_chunk.shape[0] // bunch)
        if n_bunches == 0:  # chunk smaller than one bunch: all samples dropped
            return state
        x, t = ((a[: n_bunches * bs_local] for a in (in_chunk, targ_chunk)) if pre_grouped
                else (local_rows(a, bunch, mesh) for a in (in_chunk, targ_chunk)))
        for i in range(n_bunches):
            step(state, x[i * bs_local:(i + 1) * bs_local], t[i * bs_local:(i + 1) * bs_local],
                 rng, lrate, momentum, weightcost)
        fence(mesh)
        return state

    return run


# ---------------------------------------------------------------------------
# tensor-parallel chunk trainer (the JAX package's jit over a 2-D mesh)
# ---------------------------------------------------------------------------

def state_shardings(state: TrainState, mesh: Mesh, shard_model_axis: bool) -> TrainState:
    """This rank's part of every tensor of `state`: with shard_model_axis,
    its block of columns of each W and delta and of elements of each b and
    db over "model"; otherwise every tensor whole.  The parts are views of
    the state's tensors (an update of a part in place updates the state);
    `step` is the state's.  A width that n_model does not divide raises
    ValueError, where the JAX package's sharding is refused."""
    if not shard_model_axis or mesh.n_model == 1:
        return TrainState(params=state.params, deltas=state.deltas, step=state.step)
    n, m = mesh.n_model, mesh.model_index

    def cols(a: torch.Tensor, name: str) -> torch.Tensor:
        width = a.shape[-1]
        if width % n:
            raise ValueError(f"{name} of shape {tuple(a.shape)}: its width {width} is not "
                             f"divisible by mesh model={n}")
        k = width // n
        return a[..., m * k:(m + 1) * k]

    def part(mlp: MLP, kind: str) -> MLP:
        return MLP([cols(w, f"{kind} w[{l}]") for l, w in enumerate(mlp.w)],
                   [cols(b, f"{kind} b[{l}]") for l, b in enumerate(mlp.b)])

    return TrainState(params=part(state.params, "params"), deltas=part(state.deltas, "deltas"),
                      step=state.step)


def make_auto_sharded_train_chunk(cfg: ModelConfig, opt: OptConfig, mesh: Mesh,
                                  shard_model_axis: bool = True):
    """Tensor-parallel plain chunk trainer over a ("data", "model") mesh: it
    computes `reference_train_chunk` on the global chunk (parity update, the
    partial bunch dropped, dropout as the single-process trainer draws it).

    run(state, in_chunk, targ_chunk, rng, lrate, momentum, weightcost): every
    rank is handed the whole state and the whole chunk; `rng` is a
    torch.Generator in the same state on every rank.  A bunch on data rank d
    and model rank m:
      * rows: d's bunch_part rows (`local_rows`); the dropout masks are drawn
        for the global bunch at full width and sliced to those rows;
      * forward, each layer: z = h W[:, cols_m] + b[cols_m], gathered over
        "model" (`all_gather_cols`), then the activation on the whole row;
      * backward: the activation's derivative as autograd takes it, on the
        whole row, then m's columns; G and gb of m's columns, dedy =
        dz W[:, cols_m]^T summed over "model", then the mask;
      * the gradients summed over "data", and the parity update of m's
        columns of W, delta, b and db (`state_shardings`, in place).
    Once a chunk ends, each tensor's columns are gathered over "model":
    every rank holds the whole updated state, the same bits on each.
    Without shard_model_axis every rank holds the whole state, rows split
    over "data", and the ranks of one data row repeat the same work.
    Updates `state` in place.
    """
    n_data, bunch = mesh.n_data, opt.bunchsize
    if bunch % n_data:
        raise ValueError(f"bunchsize {bunch} not divisible by mesh data={n_data}")
    sharded = shard_model_axis and mesh.n_model > 1
    n_layers = len(cfg.layersizes) - 1
    acts = [cfg.hidden] * (n_layers - 1) + [cfg.output]

    def gather(a: torch.Tensor) -> torch.Tensor:
        return all_gather_cols(a, mesh) if sharded else a

    def model_sum(a: torch.Tensor) -> torch.Tensor:
        return all_reduce(a, mesh, "model") if sharded else a

    def act_vjp(name: str, z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            return torch.autograd.grad(_act(name, z), z, g)[0]

    @torch.no_grad()
    def step(part: TrainState, x, t, rng, lrate, momentum, weightcost) -> None:
        masks = _rank_masks(cfg, rng, bunch, mesh, x.device)
        ys, zs = [], []
        h = x
        for l in range(n_layers):
            if masks is not None and masks[l] is not None:
                h = h * masks[l]
            ys.append(h)
            zs.append(gather(torch.matmul(h, part.params.w[l]) + part.params.b[l]))
            h = _act(acts[l], zs[l])
        g = (2.0 / bunch) * (h - t)  # d sum((out - t)^2) / n_global
        g_w, g_b = [None] * n_layers, [None] * n_layers
        for l in range(n_layers - 1, -1, -1):
            dz = act_vjp(acts[l], zs[l], g)
            if sharded:
                k = part.params.b[l].shape[0]
                dz = dz[:, mesh.model_index * k:(mesh.model_index + 1) * k]
            g_w[l], g_b[l] = ys[l].T @ dz, dz.sum(dim=0)
            if l > 0:
                g = model_sum(dz @ part.params.w[l].T)
                if masks is not None and masks[l] is not None:
                    g = g * masks[l]
        flat = all_reduce(torch.cat([a.reshape(-1) for a in g_w + g_b]), mesh)
        parts = flat.split([a.numel() for a in g_w + g_b])
        m, lr = momentum, lrate
        for l in range(n_layers):  # the parity update of this rank's columns
            w, dw, b, db = part.params.w[l], part.deltas.w[l], part.params.b[l], part.deltas.b[l]
            nd = m * dw - (1.0 - m) * lr * (parts[l].view_as(w) / bunch + weightcost * w)
            dw.copy_(nd)
            w.copy_(w + nd)
            nd = m * db - (1.0 - m) * lr * (parts[n_layers + l] / bunch)
            db.copy_(nd)
            b.copy_(b + nd)

    def run(state: TrainState, in_chunk, targ_chunk, rng, lrate=opt.lrate, momentum=opt.momentum,
            weightcost=opt.weightcost):
        n_bunches = in_chunk.shape[0] // bunch
        if n_bunches == 0:  # chunk smaller than one bunch: all samples dropped
            return state
        part = state_shardings(state, mesh, shard_model_axis)
        x, t = (local_rows(a, bunch, mesh) for a in (in_chunk, targ_chunk))
        local = bunch // n_data
        for i in range(n_bunches):
            rows = slice(i * local, (i + 1) * local)
            step(part, x[rows], t[rows], rng, lrate, momentum, weightcost)
        state.step += n_bunches
        if sharded:
            with torch.no_grad():
                for full, mine in zip(_tensors(state), _tensors(part)):
                    full.copy_(gather(mine.reshape(-1, mine.shape[-1])).view_as(full))
        fence(mesh)
        return state

    return run
