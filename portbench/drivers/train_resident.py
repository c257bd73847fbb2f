"""Training over a corpus resident on the device: the recipe's training stage
(an epoch permutation on the device, `index_select` of each chunk, the
chunk trainer, the CV pass at each epoch's end).

Set-up makes the weights and the corpus from the seed, builds the trainer
state, and drives it through the check's three steps with the window's own
calls and feed: call A trains one bunch (step 1), call B two (steps 2 and 3,
so that the check covers the chain from one bunch to the next), each on a
chunk gathered from the permutation's rows, the CV pass after each.  One
full chunk then warms every shape, and the same state goes on to the
window.  The reference follows the three steps once the window has closed.

The window's own calls are checked too.  Before each of them the harness
keeps a copy of the state (the program's own, so this stage is checked
from it, the start by the three steps above); once the window has closed
the reference follows the window's last call, a full chunk of bunches at
its epoch's momentum, from that copy over the call's chunk and seed, and
the state after it is compared.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Dict, List

import torch

from portbench import harness
from portbench.generate import training_corpus
from portbench.reference import train as ref
from portbench.reference.philox import keep_masks, mask_key

# bunches whose masks the reference draws in one go as it follows a call
MASK_BLOCK = 50


def momentum(cfg: Dict, epoch: int) -> float:
    """The recipe's ramp: start, plus step an epoch, up to max."""
    return min(cfg["momentum_start"] + cfg["momentum_step"] * epoch, cfg["momentum_max"])


def omits(cfg: Dict) -> List[float]:
    layers = len(cfg["layersizes"]) - 1
    return [cfg["dropout_vis"]] + [cfg["dropout_hid"]] * (layers - 1)


def call_seed(rng: torch.Generator) -> int:
    """The integer seed the runner draws from a call's generator for its
    in-kernel Philox stream (a twin generator, so `rng` is left as it is)."""
    twin = torch.Generator().manual_seed(0)
    twin.set_state(rng.get_state())
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=twin))


class Program:
    """The calls into the port that the timed path makes."""

    def __init__(self, cfg: Dict, dev: torch.device):
        from tpu_sednn_torch.model.mlp import MLP, ModelConfig
        from tpu_sednn_torch.train.loop import make_chunk_runner
        from tpu_sednn_torch.train.step import OptConfig, cv_squared_error, init_train_state

        self.cfg = cfg
        self.mcfg = ModelConfig(tuple(cfg["layersizes"]), hidden=cfg["hidden"],
                                output=cfg["output"]).with_dropout(
            cfg["dropout_vis"], cfg["dropout_hid"], cfg["dropout_mode"])
        opt = OptConfig(lrate=cfg["lrate"], momentum=cfg["momentum_start"],
                        weightcost=cfg["weightcost"], bunchsize=cfg["bunchsize"])
        # "resident" is what engine="auto" resolves to on a card, and on the CPU
        # it runs that trainer's plain version (the same Philox masks)
        self._run = make_chunk_runner(self.mcfg, opt, engine="resident", device=dev)
        self._mlp, self._init, self._cv = MLP, init_train_state, cv_squared_error

    def state(self, ws, bs):
        return self._init(self._mlp(ws, bs))

    def train(self, state, x, t, rng, lrate, m, n_real=None):
        return self._run(state, x, t, rng, lrate, m, self.cfg["weightcost"], n_real=n_real)

    def cv(self, state, x, t) -> float:
        return float(self._cv(state.params, x, t, self.mcfg)) / x.shape[0]

    def leaves(self, state) -> List[torch.Tensor]:
        """Weights, biases, then their momentum (the state itself, not copies)."""
        return (list(state.params.w) + list(state.params.b) + list(state.deltas.w)
                + list(state.deltas.b))


class Reference:
    """The training step of reference/train.py in the trainer's place:
    `precision` "fp8" is the control of bfloat16 products; `half` trains
    each bunch on its first half of rows alone (the mean over them)."""

    def __init__(self, cfg: Dict, dev: torch.device, precision: str = "fp8",
                 half: bool = False):
        self.cfg, self.precision, self.half = cfg, precision, half
        self.omits = omits(cfg)

    def state(self, ws, bs):
        return ref.Net.fresh(ws, bs)

    def train(self, net, x, t, rng, lrate, m, n_real=None):
        bunch = self.cfg["bunchsize"]
        seed = call_seed(rng)
        rows = bunch // 2 if self.half else bunch
        for b in range(n_real if n_real is not None else x.shape[0] // bunch):
            ref.train_step(net, x[b * bunch:b * bunch + rows], t[b * bunch:b * bunch + rows],
                           seed, b, self.omits, lrate, m, self.cfg["weightcost"], self.precision)
        return net

    def cv(self, net, x, t) -> float:
        return ref.cv_mse(net.w, net.b, x, t, [1.0 - o for o in self.omits], self.precision)

    def leaves(self, net):
        return net.w + net.b + net.dw + net.db


class Unchanged(Program):
    """The port's trainer with every call leaving the state as it was."""

    def train(self, state, x, t, rng, lrate, m, n_real=None):
        return state


# stand-ins for the program in the check's three steps, for the readings
STAND_INS = {"control": lambda cfg, dev: Reference(cfg, dev, "fp8"),
             "half": lambda cfg, dev: Reference(cfg, dev, "bf16", half=True),
             "unchanged": Unchanged}
# the modes of `python3 -m portbench.readings`: the program, and the control
# and faults, read in the check's three steps (stand-ins above) and in the
# window's last call (the reference following it as the mode departs)
MODES = ("program", "control", "half", "unchanged", "skip", "stale", "masks")
# a size the CPU trains in a second (the tests)
TINY = dict(config=dict(layersizes=[48, 32, 32, 32, 4], train_samples=1024, cv_samples=256,
                        traincache=512, bunchsize=32),
            traffic=dict(utterance_frames=50))
# the published widths, a corpus a test run on the card holds
CARD_CUT = dict(config=dict(train_samples=204800, cv_samples=4096), traffic={})


def setup(cell, program_cls=Program, warm: bool = True) -> Dict:
    """Everything before the window (without `warm`, the full chunk that
    warms the window's shapes is left out); -> the run's record."""
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sizes = cfg["layersizes"]
    n_bins = sizes[-1]
    gen = torch.Generator(device=dev).manual_seed(cell.seed)
    ws, bs = harness.uniform_weights(gen, sizes, dev)
    corpus = dict(n_bins=n_bins, context=cfg["fea_context"], offset=cfg["targ_offset"],
                  nat_frames=cfg["nat_frames"], utt_frames=tr["utterance_frames"],
                  target_gain=tr["target_gain"], target_noise=tr["target_noise"], device=dev)
    x_all, t_all = training_corpus(gen, cfg["train_samples"], **corpus)
    x_cv, t_cv = training_corpus(gen, cfg["cv_samples"], **corpus)
    prog = program_cls(cfg, dev)
    state = prog.state(ws, bs)
    rec = dict(gen=gen, ws=ws, bs=bs, x=x_all, t=t_all, x_cv=x_cv, t_cv=t_cv, prog=prog,
               state=state, steps=[], prog_cv=[])
    tc, bunch, m0 = cfg["traincache"], cfg["bunchsize"], momentum(cfg, 0)
    with harness.label("epoch_perm"):
        perm = torch.randperm(x_all.shape[0], generator=gen, device=dev)
    for call, n_real in enumerate(tr["check_calls"] + ([None] if warm else [])):
        with harness.label("chunk_gather"):
            idx = perm[call * tc:(call + 1) * tc]
            x, t = x_all.index_select(0, idx), t_all.index_select(0, idx)
        rng = torch.Generator().manual_seed(harness.stream_seed(cell.seed, 1 << 20, call))
        if n_real is not None:
            seed = call_seed(rng)
            for b in range(n_real):
                rec["steps"].append((x[b * bunch:(b + 1) * bunch].clone(),
                                     t[b * bunch:(b + 1) * bunch].clone(), seed, b))
        with harness.label("chunk_train"):
            prog.train(state, x, t, rng, cfg["lrate"], m0, n_real=n_real)
        if n_real is None:
            break
        leaves = [a.detach().clone() for a in prog.leaves(state)]
        rec["params3"] = leaves[:len(leaves) // 2]
        if call == 0:
            rec["grad1"] = leaves[len(leaves) // 2:]
        with harness.label("cv"):
            rec["prog_cv"].append(prog.cv(state, x_cv, t_cv))
    harness.sync(dev)
    return rec


def _epoch_chunks(rec, cell, epoch):
    """(chunk index, x, t, rng) of an epoch, gathered lazily in order."""
    cfg, dev = cell.config, cell.device
    tc = cfg["traincache"]
    n = rec["x"].shape[0]
    with harness.label("epoch_perm"):
        perm = torch.randperm(n, generator=rec["gen"], device=dev)
    for c in range(n // tc):
        with harness.label("chunk_gather"):
            idx = perm[c * tc:(c + 1) * tc]
            x, t = rec["x"].index_select(0, idx), rec["t"].index_select(0, idx)
        yield c, x, t, torch.Generator().manual_seed(harness.stream_seed(cell.seed, epoch, c))


def _call(rec, cell, x, t, rng, m) -> None:
    """One chunk call of the timed path, after a copy of the state before it
    and what the reference needs to follow it are kept in rec["last"]."""
    prog, state = rec["prog"], rec["state"]
    with harness.label("state_copy"):
        before = [a.detach().clone() for a in prog.leaves(state)]
    rec["last"] = dict(before=before, x=x, t=t, seed=call_seed(rng), m=m)
    with harness.label("chunk_train"):
        prog.train(state, x, t, rng, cell.config["lrate"], m)


def _after_last_call(rec) -> None:
    """The state after the last call, once the timing has ended."""
    rec["after"] = [a.detach().clone() for a in rec["prog"].leaves(rec["state"])]


def window(rec, cell) -> Dict:
    """Epochs until `seconds` have passed, at a chunk's end: every chunk
    trained and CV pass run within them, over all of their time."""
    cfg, dev, prog, state = cell.config, cell.device, rec["prog"], rec["state"]
    per_chunk = cfg["traincache"] // cfg["bunchsize"] * cfg["bunchsize"]
    harness.sync(dev)
    t0 = time.perf_counter()
    chunks, cvs, pending, epoch, done = 0, [], None, 0, False
    while not done:
        for _, x, t, rng in _epoch_chunks(rec, cell, epoch):
            _call(rec, cell, x, t, rng, momentum(cfg, epoch))
            mark = harness.Mark(dev)
            chunks += 1
            if pending is not None:
                with harness.label("sync"):
                    pending.wait()
            pending = mark
            if time.perf_counter() - t0 >= cell.seconds:
                done = True
                break
        else:
            with harness.label("cv"):
                cvs.append(prog.cv(state, rec["x_cv"], rec["t_cv"]))
            epoch += 1
    with harness.label("sync"):
        harness.sync(dev)
    elapsed = time.perf_counter() - t0
    _after_last_call(rec)
    bad = sum(1 for v in cvs if not math.isfinite(v))
    return dict(samples=chunks * per_chunk, seconds=elapsed, chunks=chunks, epochs=epoch,
                cv=cvs, failed=bad)


def measure_layers(rec, cell) -> Dict:
    """The traced run's readings: one whole epoch profiled (its permutation,
    gathers, chunk calls and CV pass), its last call checked as the
    window's is."""
    cfg, dev = cell.config, cell.device
    m = momentum(cfg, 0)
    reading: Dict = {}
    chunks = 0
    with harness.traced(dev, reading):
        for _, x, t, rng in _epoch_chunks(rec, cell, 0):
            _call(rec, cell, x, t, rng, m)
            chunks += 1
        with harness.label("cv"):
            rec["prog"].cv(rec["state"], rec["x_cv"], rec["t_cv"])
    _after_last_call(rec)
    return dict(chunks=chunks, bunches=chunks * (cfg["traincache"] // cfg["bunchsize"]),
                sizes=cfg["layersizes"], bunch=cfg["bunchsize"], products=cfg["train_products"],
                slice=reading)


def free_program(rec) -> None:
    for key in ("x", "t", "state", "prog"):
        rec.pop(key, None)


def _leaf_norms(leaves):
    return [float(a.double().norm()) for a in leaves]


def _worst_gap(prog_leaves, ref_leaves, ref_grad_norms, diff=False) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (or, with diff, the norm of their difference), against the larger of
    the reference's norm of that leaf and of the median leaf; leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (they move by round-off alone)."""
    med_grad = statistics.median(ref_grad_norms)
    ref_norms = _leaf_norms(ref_leaves)
    med = statistics.median(ref_norms)
    worst = 0.0
    for p, r, rn, gn in zip(prog_leaves, ref_leaves, ref_norms, ref_grad_norms):
        if gn < 1e-3 * med_grad:
            continue
        p = p.to(torch.float64)
        num = float((p - r).norm()) if diff else abs(float(p.norm()) - rn)
        worst = max(worst, num / max(rn, med))
    return worst


def step_readings(rec, cell, precision: str = "bf16") -> Dict[str, float]:
    """The reference follows the three steps; -> the numbers compared."""
    cfg = cell.config
    om = omits(cfg)
    keeps = [1.0 - o for o in om]
    m0, lr = momentum(cfg, 0), cfg["lrate"]
    net = ref.Net.fresh(rec["ws"], rec["bs"])
    w0 = [a.to(torch.float64) for a in rec["ws"] + rec["bs"]]
    ref_cv, ref_grad1 = [], None
    for k, (x, t, seed, bunch) in enumerate(rec["steps"]):
        ref.train_step(net, x, t, seed, bunch, om, lr, m0, cfg["weightcost"], precision)
        if k == 0:
            ref_grad1 = [d / (-(1.0 - m0) * lr) for d in net.dw + net.db]
        if k in (0, len(rec["steps"]) - 1):
            ref_cv.append(ref.cv_mse(net.w, net.b, rec["x_cv"], rec["t_cv"], keeps))
    grad_norms = _leaf_norms(ref_grad1)
    prog_grad1 = [d / (-(1.0 - m0) * lr) for d in rec["grad1"]]
    change_ref = [a - b for a, b in zip(net.w + net.b, w0)]
    change_prog = [a.to(torch.float64) - b for a, b in zip(rec["params3"], w0)]
    return {
        "cv_loss_gap": max(abs(p - r) / abs(r) for p, r in zip(rec["prog_cv"], ref_cv)),
        "grad1_gap": _worst_gap(prog_grad1, ref_grad1, grad_norms),
        "grad1_diff": _worst_gap(prog_grad1, ref_grad1, grad_norms, diff=True),
        "change3_gap": _worst_gap(change_prog, change_ref, grad_norms),
    }


def follow_last_call(rec, cell, mode: str = "program"):
    """The reference follows the window's last call from the program's state
    before it: -> its state.  Any other mode than "program" departs from the
    call as that control or fault would: "control" fp8
    products; "half" each bunch on half of its rows; "skip" the bunches past
    the call's first half left out; "stale" the first epoch's momentum;
    "masks" every bunch past the third given the third's masks; "unchanged"
    the state left as it was."""
    cfg, last = cell.config, rec["last"]
    n_layers = len(cfg["layersizes"]) - 1
    leaves = [a.to(torch.float64).clone() for a in last["before"]]
    net = ref.Net(*(leaves[i * n_layers:(i + 1) * n_layers] for i in range(4)))
    precision = "fp8" if mode == "control" else "bf16"
    bunch, om = cfg["bunchsize"], omits(cfg)
    n = 0 if mode == "unchanged" else last["x"].shape[0] // bunch
    n = n // 2 if mode == "skip" else n
    rows = bunch // 2 if mode == "half" else bunch
    m = momentum(cfg, 0) if mode == "stale" else last["m"]
    widths = cfg["layersizes"][:-1]
    for b0 in range(0, n, MASK_BLOCK):
        block = range(b0, min(n, b0 + MASK_BLOCK))
        streams = [min(b, 2) if mode == "masks" else b for b in block]
        masks = [keep_masks([mask_key(last["seed"], b, l) for b in streams], bunch, w, o,
                            last["x"].device) if o > 0.0 else None
                 for l, (w, o) in enumerate(zip(widths, om))]
        for i, b in enumerate(block):
            ref.train_step(net, last["x"][b * bunch:b * bunch + rows],
                           last["t"][b * bunch:b * bunch + rows], last["seed"], streams[i], om,
                           cfg["lrate"], m, cfg["weightcost"], precision,
                           [None if a is None else a[i] for a in masks])
    return net


def call_readings(rec, cell, mode: str = "program") -> Dict[str, float]:
    """The window's last call against the reference's: the worst leaf's gap
    between norms of the call's change (weights and biases), of the momentum
    after it, and of the change's difference.  The program's side is the
    program's own, or the reference as `mode` departs (see
    follow_last_call)."""
    if "ref_call" not in rec:
        rec["ref_call"] = follow_last_call(rec, cell)
    ref_net = rec["ref_call"]
    if mode == "program":
        after = [a.to(torch.float64) for a in rec["after"]]
    else:
        net = follow_last_call(rec, cell, mode)
        after = net.w + net.b + net.dw + net.db
    n_par = 2 * len(ref_net.w)
    before = [a.to(torch.float64) for a in rec["last"]["before"][:n_par]]
    change_ref = [a - b for a, b in zip(ref_net.w + ref_net.b, before)]
    change = [a - b for a, b in zip(after[:n_par], before)]
    rule = _leaf_norms(change_ref)
    return {
        "call_change_gap": _worst_gap(change, change_ref, rule),
        "call_change_diff": _worst_gap(change, change_ref, rule, diff=True),
        "call_momentum_gap": _worst_gap(after[n_par:], ref_net.dw + ref_net.db, rule),
    }


def readings(rec, cell) -> Dict[str, float]:
    """Every number compared: the three steps', then the window's last call's."""
    return dict(step_readings(rec, cell), **call_readings(rec, cell))


def read_seed(cell, modes, steps: bool = True) -> Dict[str, Dict[str, float]]:
    """The numbers of each mode on one seed (`python3 -m portbench.readings`):
    one set-up and window of the program, the reference following its last
    call as each mode departs; with `steps`, the three steps of each mode's
    stand-in (a set-up of its own)."""
    rec = setup(cell)
    window(rec, cell)
    free_program(rec)
    cell.release()
    out = {mode: call_readings(rec, cell, mode) for mode in modes}
    if "program" in out:
        out["program"].update(step_readings(rec, cell))
    del rec
    for mode in modes:
        if steps and mode in STAND_INS:
            cell.release()
            rec = setup(cell, STAND_INS[mode], warm=False)
            free_program(rec)
            out[mode].update(step_readings(rec, cell))
            del rec
    return out


def run(cell, program_cls=Program) -> Dict:
    rec = setup(cell, program_cls)
    cell.setup_done()
    out: Dict = {}
    if cell.trace:
        out["layers"] = measure_layers(rec, cell)
        out["attempted"], out["failed"] = out["layers"]["chunks"], 0
    else:
        w = window(rec, cell)
        print(f"train: {w['chunks']} chunks, {w['epochs']} epochs in {w['seconds']:.3f} s; "
              f"CV after each epoch {w['cv']}", file=sys.stderr)
        out["e2e"] = {"train_samples_per_s": (w["samples"] / w["seconds"], "samples/s")}
        out["attempted"], out["failed"] = w["chunks"], w["failed"]
    out["memory_peak_bytes"] = cell.memory_peak()
    free_program(rec)
    cell.release()
    out["numbers"] = readings(rec, cell)
    return out
