"""`python -m tpu_sednn_torch.cli key=value ...` — the BPtrain-compatible trainer,
the port of `python -m tpu_sednn.cli`.

One invocation = one epoch over the pfiles + a CV pass, exactly like the
reference's BPtrain.cc:16-97: same flags, same file formats, same log
lines — so the reference's Perl recipes port by swapping the executable.
One key more: `device=cuda|cpu` (default cuda: the epoch runs on the card,
with `engine=auto` on the hand-written CUDA chunk trainer with tensor-core
products, bf16=True, as the JAX command trains on its chip, and raises when
there is no card; `device=cpu` runs the plain float32 torch trainer).
`run_epoch(flags, engine_kwargs=...)` passes options to the chunk trainer
(e.g. {"bf16": False}: float32 products).

NAT semantics: layersizes[0] == fea_dim*fea_context + fea_dim is enforced as
in the reference (Interface.cc:395-399); dropoutflag gates parity dropout.

Data parallelism: gpu_used=N trains on N ranks, one process each, launched by
torchrun:

    python -m torch.distributed.run --nproc_per_node=N -m tpu_sednn_torch.cli ... gpu_used=N

Each rank takes its rows of every bunch and the gradients are summed between
the ranks before every update (parallel/mesh.py; the backend is nccl where
every rank has a card of its own, gloo where ranks share a card or run on
the CPU).  The number of processes must equal gpu_used.  Rank 0 alone writes
the log and the .wts and prints "all finish!".
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from tpu_sednn_torch._device import resolve_device
from tpu_sednn_torch.config import TrainFlags
from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.io.wts import load_wts, save_wts
from tpu_sednn_torch.model.mlp import ModelConfig, init_params_parity, params_from_wts, params_to_wts
from tpu_sednn_torch.train.loop import train_epoch_pfile
from tpu_sednn_torch.train.step import OptConfig, init_train_state
from tpu_sednn_torch.utils.logging import Logger


def run_epoch(flags: TrainFlags, logger: Logger | None = None,
              engine_kwargs: dict | None = None) -> float:
    """Returns the CV MSE (the scalar the recipe scrapes from the log).
    engine_kwargs: forwarded to the resident chunk trainer's factory."""
    flags.validate()
    rank0 = True
    if flags.gpu_used > 1:
        from tpu_sednn_torch.parallel import initialize_distributed

        initialize_distributed(device=flags.device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != flags.gpu_used:
            raise ValueError(f"gpu_used={flags.gpu_used} needs as many processes, found {world}: "
                             f"launch with python -m torch.distributed.run "
                             f"--nproc_per_node={flags.gpu_used} -m tpu_sednn_torch.cli ...")
        rank0 = dist.get_rank() == 0
    dev = resolve_device(flags.device)
    log = logger or Logger(log_path=flags.log_file or None, is_host0=rank0)
    log.info(flags.echo())

    cfg = ModelConfig(
        layersizes=flags.layersizes,
        hidden="relu",
        output="linear",
        dropout_vis=flags.visible_omit if flags.dropoutflag else 0.0,
        dropout_hid=flags.hid_omit if flags.dropoutflag else 0.0,
        dropout_mode="parity",
    )
    opt = OptConfig(
        lrate=flags.lrate, momentum=flags.momentum,
        weightcost=flags.weightcost, bunchsize=flags.bunchsize,
    )

    # srand48(seed) once; weight init consumes the stream first, then shuffles
    # (Interface.cc:337-350) — reproduced via the same Rand48 instance.
    rand = Rand48(flags.init_randem_seed)
    if flags.initwts_file:
        ws, bs = load_wts(flags.initwts_file, layersizes=list(flags.layersizes))
        params = params_from_wts(ws, bs, device=dev)
        log.info("Init weight file loaded.")
    else:
        log.info("Getting Randemed initial weights...")
        params = init_params_parity(
            rand, cfg,
            flags.init_randem_weight_min, flags.init_randem_weight_max,
            flags.init_randem_bias_min, flags.init_randem_bias_max,
            device=dev,
        )
    state = init_train_state(params)

    state, result = train_epoch_pfile(
        state, cfg, opt,
        fea_file=flags.fea_file, targ_file=flags.targ_file, norm_file=flags.norm_file,
        fea_dim=flags.fea_dim, fea_context=flags.fea_context,
        targ_offset=flags.targ_offset,
        train_sent_range=flags.sent_range("train"),
        cv_sent_range=flags.sent_range("cv"),
        traincache=flags.traincache,
        seed=flags.init_randem_seed,
        nat=True,
        logger=log,
        rand=rand,
        n_data_shards=flags.gpu_used,
        engine=flags.engine,
        cv_dump_path=flags.cv_out_file or None,
        device_splice=None if flags.device_splice < 0 else bool(flags.device_splice),
        engine_kwargs=engine_kwargs,
    )

    if flags.outwts_file and rank0:
        ws, bs = params_to_wts(state.params)
        save_wts(flags.outwts_file, ws, bs,
                 debug_txt=flags.weights_txt or None)
        log.info("Saving over.")
    return result.cv_mse


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    flags = TrainFlags.from_argv(argv)
    run_epoch(flags)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank0:
        print("all finish!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
