"""One rank of the port's data-parallel tests, on the CPU over gloo.

    python tests/_torch_dp_worker.py <rank> <world> <init_file> <job.json>

Joins a `world`-rank process group (`file://<init_file>`), then runs every
case of the job on this rank and writes its final state to
<dir>/<case>.rank<r>.npz (w<l>, b<l>, dw<l>, db<l> as float32, step, and for
an epoch cv).  Imports torch and the port only: the tests compare the files
with the JAX package and with each other.

A case (a dict in job["cases"]):
  name, kind: "resident" (make_dp_resident_train_chunk), "xla"
    (parallel.make_dp_train_chunk), "pfile" (train_epoch_pfile), "tp"
    (parallel.make_auto_sharded_train_chunk) or "recipe"
    (recipes.multi_condition.run_multi_condition);
  inputs: an .npz with w<l>, b<l> and, but for "pfile", x and t (the whole
    chunk, which every rank holds);
  cfg, opt, kw: ModelConfig, OptConfig and factory (or epoch) keywords;
  calls: one dict per call of the runner (seed, n_real, momentum, ...);
  pre_grouped: regroup on the host and hand the runner this rank's rows;
  perturb: ranks other than 0 start from other weights (a run that
    broadcasts the state from rank 0 first must not see it);
  fault: "no_allreduce" (the sum over the ranks skipped), "row0" (every
    rank's masks drawn at row 0) or, for "tp", "no_model_sum" (dedy not
    summed over "model"): the deliberately broken runs;
  "tp" only: mesh [n_data, n_model] and shard (shard_model_axis);
  "recipe" only: mc (MultiConditionConfig keywords but out_dir, which is
    <dir>/<name>), kill_at (the run dies as epoch kill_at starts, then is
    run again and resumes), subs (an .npz of the JAX recipe's draws: init
    w<l>/b<l>, perm<epoch>, and the features of the corpus, fp_clean /
    fp_noisy with clean<i> / noisy<i>); it writes <name>.rank<r>.json: the
    results, and every file the rank opened for writing.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import tpu_sednn_torch.ops.resident_chunk as rc  # noqa: E402
import tpu_sednn_torch.parallel.mesh as pm  # noqa: E402
from tpu_sednn_torch.model.mlp import MLP, ModelConfig  # noqa: E402
from tpu_sednn_torch.parallel import (bunch_part_regroup_host, make_auto_sharded_train_chunk,  # noqa: E402
                                      make_dp_train_chunk, make_global_chunk, make_mesh)
from tpu_sednn_torch.train.step import OptConfig, init_train_state  # noqa: E402


plain_sum = pm.all_reduce


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


def _fingerprint(wavs) -> str:
    h = hashlib.sha1()
    for w in wavs:
        h.update(np.ascontiguousarray(w, np.float32).tobytes())
    return h.hexdigest()


def _substitutes(path):
    """The recipe's init, epoch permutations and features replaced by the
    JAX recipe's draws, read from the .npz at path."""
    import tpu_sednn_torch.recipes.multi_condition as tmc

    subs = dict(np.load(path))

    def init(mcfg, seed, device):
        n = len(mcfg.layersizes) - 1
        return MLP([torch.from_numpy(subs[f"w{l}"]) for l in range(n)],
                   [torch.from_numpy(subs[f"b{l}"]) for l in range(n)]).on(device)

    def permutation(seed, epoch, n, device):
        perm = subs[f"perm{epoch}"]
        if len(perm) != n:
            raise ValueError(f"epoch {epoch}: a permutation of {n} samples asked, {len(perm)} given")
        return torch.from_numpy(perm.astype(np.int64)).to(device)

    def featurize(wavs, cfg_stft, device, batch=64):
        fp = _fingerprint(wavs)
        for kind in ("clean", "noisy"):
            if str(subs[f"fp_{kind}"]) == fp:
                return [subs[f"{kind}{i}"] for i in range(len(wavs))]
        raise KeyError("the corpus differs from the one the JAX features were made of")

    tmc._init_params, tmc._epoch_permutation, tmc._featurize = init, permutation, featurize


class _Killed(Exception):
    pass


def run_recipe(case, outdir, rank):
    """A "recipe" case: the recipe on every rank of the group, the files each
    rank opened for writing recorded."""
    import builtins

    import tpu_sednn_torch.recipes.multi_condition as tmc
    from tpu_sednn_torch.utils.logging import Logger

    plain = (tmc._init_params, tmc._epoch_permutation, tmc._featurize)
    if case.get("subs"):
        _substitutes(case["subs"])
    mc = tmc.MultiConditionConfig(out_dir=os.path.join(outdir, case["name"]), device="cpu",
                                  **{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in case["mc"].items()})
    written, real_open, real_save = [], builtins.open, torch.save

    def recording_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            written.append(os.path.relpath(os.fspath(file), mc.out_dir))
        return real_open(file, mode, *args, **kwargs)

    def recording_save(obj, f, *args, **kwargs):  # torch.save opens its file itself
        written.append(os.path.relpath(os.fspath(f), mc.out_dir))
        return real_save(obj, f, *args, **kwargs)

    builtins.open, torch.save = recording_open, recording_save
    try:
        if case.get("kill_at") is not None:
            perm = tmc._epoch_permutation

            def dies(seed, epoch, n, device):
                if epoch == case["kill_at"]:
                    raise _Killed()
                return perm(seed, epoch, n, device)

            tmc._epoch_permutation = dies
            try:
                tmc.run_multi_condition(mc, Logger(stream=None))
                raise RuntimeError(f"the run did not die at epoch {case['kill_at']}")
            except _Killed:
                pass
            tmc._epoch_permutation = perm
        res = tmc.run_multi_condition(mc, Logger(stream=None))
    finally:
        builtins.open, torch.save = real_open, real_save
        tmc._init_params, tmc._epoch_permutation, tmc._featurize = plain
    with open(os.path.join(outdir, f"{case['name']}.rank{rank}.json"), "w") as f:
        json.dump({"results": res, "written": sorted(set(written))}, f)


def run_case(case, mesh, outdir):
    rank = dist.get_rank()
    if case["kind"] == "recipe":
        return run_recipe(case, outdir, rank)
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
    elif fault == "no_model_sum":
        pm.all_reduce = lambda t, m, axis="data": t if axis == "model" else plain_sum(t, m, axis)
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
        if case["kind"] == "tp":
            tp_mesh = make_mesh(*case["mesh"], devices=["cpu"])
            run = make_auto_sharded_train_chunk(cfg, opt, tp_mesh, shard_model_axis=case["shard"])
            for call in case["calls"]:
                call = dict(call)
                run(state, x, t, torch.Generator().manual_seed(call.pop("seed")), **call)
            extra.update(mesh_index=np.int64(tp_mesh.index),
                         mesh_model_index=np.int64(tp_mesh.model_index))
        elif case["kind"] == "resident":
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
    _save(os.path.join(outdir, f"{case['name']}.rank{rank}.npz"), state, **extra)


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
    def load(c, r):
        if c["kind"] == "recipe":
            with open(os.path.join(workdir, f"{c['name']}.rank{r}.json")) as f:
                return json.load(f)
        return dict(np.load(os.path.join(workdir, f"{c['name']}.rank{r}.npz")))

    return {c["name"]: [load(c, r) for r in range(world)] for c in cases}


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
        rc._all_reduce, rc._mask_row0, pm.all_reduce = plain_all_reduce, plain_row0, plain_sum
    dist.barrier()
    dist.destroy_process_group()
    print(f"[rank {rank}] OK {len(job['cases'])} cases", flush=True)


if __name__ == "__main__":
    main()
