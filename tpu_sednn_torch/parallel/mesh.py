"""Data parallelism over torch.distributed — counterpart of
tpu_sednn/parallel/mesh.py.

The reference's parallelism (split each bunch across GPUs, sum the gradients,
one update, identical replicas; BP_GPU.cu:29-37, 775-908) is one process per
rank here, joined by a torch.distributed process group:

* `initialize_distributed` joins the group from torchrun's environment
  (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or from explicit
  arguments; a single process is left alone.  nccl where each rank has a
  card, gloo where all ranks share one card or run on the CPU
  (`backend_rule`).
* `all_reduce` sums a tensor over the ranks: nccl on the cards, gloo on the
  CPU, and where the ranks share a card, on that card (ops/rank_sum.py's
  kernel over CUDA IPC); `fence` waits for those sums before a rank exits.
* `make_mesh` describes the group as the JAX package's 1-D ("data",) mesh:
  its size, this rank's index and this rank's device.
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

The chunk trainer on the hand-written kernels has its data-parallel form in
ops/resident_chunk.py (`make_dp_resident_train_chunk`).  The tensor-parallel
`make_auto_sharded_train_chunk` (a "model" axis) is not yet ported.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_sednn_torch.model.mlp import MLP, ModelConfig, _dropout_mask, dropout_omits
from tpu_sednn_torch.train.step import OptConfig, TrainState, _apply, _grads


@dataclass
class Mesh:
    """A 1-D ("data",) mesh of the process group: `n_data` ranks, this rank's
    `index` and `device`; `group` None is the default group."""
    n_data: int
    index: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": 1}


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
    """The ("data",) mesh of the process group (a single process: one rank).
    n_data must equal the world size.  devices: this rank's device as a
    one-element sequence, or every rank's, indexed by rank; default the
    current CUDA device, or the CPU without one."""
    if n_model > 1:
        raise NotImplementedError("n_model > 1 (the tensor-parallel "
                                  "make_auto_sharded_train_chunk): not yet ported")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = world if n_data is None else int(n_data)
    if n != world:
        raise ValueError(f"mesh data={n} must equal the world size {world} (one rank per "
                         "process: launch with python -m torch.distributed.run "
                         f"--nproc_per_node={n})")
    if devices is not None:
        devices = list(devices)
        dev = torch.device(devices[0] if len(devices) == 1 else devices[rank])
    elif torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return Mesh(n_data=n, index=rank, device=dev)


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
    bit-equal; -> tree.  A no-op on a one-rank mesh."""
    if mesh.n_data > 1:
        for t in _tensors(tree):
            buf = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            if buf.is_cuda and dist.get_backend(mesh.group) == "gloo":  # a copy through the host
                host = buf.cpu()
                dist.broadcast(host, src=0, group=mesh.group)
                buf.copy_(host)
            else:
                dist.broadcast(buf, src=0, group=mesh.group)
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


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum t over the mesh's ranks, in place (every rank gets the same bits);
    -> t.  A no-op on a one-rank mesh.  nccl sums on the cards; gloo sums a
    CPU tensor on the CPU and a card tensor on the card the ranks share
    (ops/rank_sum.py: CardSum, float32).  After sums of card tensors under
    gloo, `fence` before a rank may exit."""
    if mesh.n_data > 1:
        if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
            from tpu_sednn_torch.ops.rank_sum import card_sum

            card_sum(mesh.group, t.device).all_reduce(t)
        else:
            dist.all_reduce(t, group=mesh.group)
    return t


def fence(mesh: Mesh) -> None:
    """Wait until every rank's sums on a shared card have ended (their
    staging buffers are read by the other ranks' kernels); nothing to wait
    for otherwise."""
    if mesh.n_data > 1 and mesh.device.type == "cuda" and dist.is_initialized():
        from tpu_sednn_torch.ops.rank_sum import fence as card_fence

        card_fence(mesh.group, mesh.device)


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
    sizes = cfg.layersizes
    omits = dropout_omits(cfg, len(sizes) - 1)

    def step(state, x, t, rng, lrate, momentum, weightcost):
        masks = None
        if cfg.use_dropout:
            masks = [None if o == 0.0 else
                     _dropout_mask(rng, (bunch, sizes[l]), o, x.device, cfg.dropout_rng)
                     [mesh.index * bs_local:(mesh.index + 1) * bs_local]
                     for l, o in enumerate(omits)]
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
