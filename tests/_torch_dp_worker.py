"""One rank of the port's data-parallel tests, on the CPU over gloo.

    python tests/_torch_dp_worker.py <rank> <world> <init_file> <job.json>

Joins a `world`-rank process group (`file://<init_file>`), then runs every
case of the job on this rank and writes its final state to
<dir>/<case>.rank<r>.npz (w<l>, b<l>, dw<l>, db<l> as float32, step, and for
an epoch cv).  Imports torch and the port only: the tests compare the files
with the JAX package and with each other.

A case (a dict in job["cases"]):
  name, kind: "resident" (make_dp_resident_train_chunk), "xla"
    (parallel.make_dp_train_chunk) or "pfile" (train_epoch_pfile);
  inputs: an .npz with w<l>, b<l> and, but for "pfile", x and t (the whole
    chunk, which every rank holds);
  cfg, opt, kw: ModelConfig, OptConfig and factory (or epoch) keywords;
  calls: one dict per call of the runner (seed, n_real, momentum, ...);
  pre_grouped: regroup on the host and hand the runner this rank's rows;
  perturb: ranks other than 0 start from other weights (a run that
    broadcasts the state from rank 0 first must not see it);
  fault: "no_allreduce" (the sum over the ranks skipped) or "row0" (every
    rank's masks drawn at row 0): the deliberately broken runs.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tpu_sednn_torch.ops.resident_chunk as rc  # noqa: E402
from tpu_sednn_torch.model.mlp import MLP, ModelConfig  # noqa: E402
from tpu_sednn_torch.parallel import (bunch_part_regroup_host, make_dp_train_chunk,  # noqa: E402
                                      make_global_chunk, make_mesh)
from tpu_sednn_torch.train.step import OptConfig, init_train_state  # noqa: E402


def _state(inputs, n_layers):
    return init_train_state(MLP([torch.from_numpy(inputs[f"w{l}"]) for l in range(n_layers)],
                                [torch.from_numpy(inputs[f"b{l}"]) for l in range(n_layers)]))


def _save(path, state, **extra):
    out = {"step": np.int64(state.step)}
    for l in range(len(state.params.w)):
        for key, t in (("w", state.params.w[l]), ("b", state.params.b[l]),
                       ("dw", state.deltas.w[l]), ("db", state.deltas.b[l])):
            out[f"{key}{l}"] = t.detach().float().numpy()
    np.savez(path, **out, **extra)


def run_case(case, mesh, outdir):
    inputs = np.load(case["inputs"])
    cfg = ModelConfig(**dict(case["cfg"], layersizes=tuple(case["cfg"]["layersizes"])))
    opt = OptConfig(**case["opt"])
    n_layers = len(cfg.layersizes) - 1
    state = _state(inputs, n_layers)
    if case.get("perturb") and mesh.index != 0:
        for w in state.params.w:
            w.data += 0.01 * mesh.index
    fault = case.get("fault")
    if fault == "no_allreduce":
        rc._all_reduce = lambda t, m: t
    elif fault == "row0":
        rc._mask_row0 = lambda m, tile: 0
    extra = {}
    if case["kind"] == "pfile":
        from tpu_sednn_torch.data.rand48 import Rand48
        from tpu_sednn_torch.train.loop import train_epoch_pfile

        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in case["kw"].items()}
        state, res = train_epoch_pfile(state, cfg, opt, rand=Rand48(kw.pop("rand_seed")),
                                       n_data_shards=mesh.n_data, **kw)
        extra["cv"] = np.float64(res.cv_mse)
    else:
        x, t = inputs["x"], inputs["t"]
        if case.get("pre_grouped"):
            x, t = (make_global_chunk(bunch_part_regroup_host(a, opt.bunchsize, mesh.n_data), mesh)
                    for a in (x, t))
        else:
            x, t = torch.from_numpy(x), torch.from_numpy(t)
        if case["kind"] == "resident":
            run = rc.make_dp_resident_train_chunk(cfg, opt, mesh,
                                                  pre_grouped=bool(case.get("pre_grouped")),
                                                  **case["kw"])
            for call in case["calls"]:
                call = dict(call)
                run(state, x, t, call.pop("seed"), **call)
        else:
            run = make_dp_train_chunk(cfg, opt, mesh, pre_grouped=bool(case.get("pre_grouped")))
            for call in case["calls"]:
                call = dict(call)
                gen = torch.Generator().manual_seed(call.pop("seed"))
                run(state, x, t, gen, call.get("lrate", opt.lrate),
                    call.get("momentum", opt.momentum), call.get("weightcost", opt.weightcost))
    _save(os.path.join(outdir, f"{case['name']}.rank{mesh.index}.npz"), state, **extra)


def spawn_ranks(cases, world: int, workdir, timeout: float = 120.0) -> dict:
    """Run `cases` on `world` spawned ranks -> {case name: [state of each rank
    (np.load of its file)]}; raises with the ranks' output if one fails."""
    import subprocess

    workdir = str(workdir)
    job = os.path.join(workdir, f"job{world}.json")
    with open(job, "w") as f:
        json.dump({"dir": workdir, "cases": cases}, f)
    init_file = os.path.join(workdir, f"rendezvous{world}")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               init_file, job], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"[rank {r}] OK" not in out:
            raise RuntimeError(f"rank {r} of {world} failed (rc {p.returncode}):\n{out[-4000:]}")
    return {c["name"]: [dict(np.load(os.path.join(workdir, f"{c['name']}.rank{r}.npz")))
                        for r in range(world)] for c in cases}


def save_inputs(path, params_w, params_b, x=None, t=None) -> str:
    """The .npz a case reads: float32 weights and biases (and the chunk)."""
    arrays = {f"w{l}": np.asarray(w, np.float32) for l, w in enumerate(params_w)}
    arrays.update({f"b{l}": np.asarray(b, np.float32) for l, b in enumerate(params_b)})
    if x is not None:
        arrays.update(x=np.asarray(x, np.float32), t=np.asarray(t, np.float32))
    np.savez(path, **arrays)
    return str(path)


def main() -> None:
    rank, world, init_file, job_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                        sys.argv[4])
    torch.set_num_threads(1)
    with open(job_path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
    mesh = make_mesh(n_data=world, devices=["cpu"])
    plain_all_reduce, plain_row0 = rc._all_reduce, rc._mask_row0
    for case in job["cases"]:
        run_case(case, mesh, job["dir"])
        rc._all_reduce, rc._mask_row0 = plain_all_reduce, plain_row0
    dist.barrier()
    dist.destroy_process_group()
    print(f"[rank {rank}] OK {len(job['cases'])} cases", flush=True)


if __name__ == "__main__":
    main()
