"""One run of one benchmark cell:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
are found by name from BENCHMARK.json: configs/<config>.json (the file the
configuration names), traffic/<traffic>.json (whose "driver" names the
module under drivers/ that generates and drives that kind of traffic),
limits/<workload>.json (the limit of each number the correctness check
compares) and, with --trace 1, layer_metrics/<metric>.py for each per-layer
metric of the cell.

The run warms up, measures for --seconds (with --trace 1 it takes the
per-layer readings instead), holds what the timed path produced against the
plain reference in portbench/reference/, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the last
lines on standard error and the last key of that line.  It exits with 2,
printing no result, without a card (or with fewer than the cell asks for),
and with 3 if the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: Dict, workload: str) -> Dict:
    """-> {"workload", "config", "traffic", "limits"} of the named cell."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    limits_path = os.path.join(HERE, "limits", f"{workload}.json")
    return dict(workload=w, config=load_json(os.path.join(ROOT, cfg_entry["file"])),
                traffic=load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
                limits=load_json(limits_path) if os.path.exists(limits_path) else None)


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_layer_metric(name: str, layers: Dict) -> Optional[float]:
    path = os.path.join(HERE, "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_layer_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(layers)


def run_cell(bench: Dict, found: Dict, seed: int, seconds: float, trace: bool,
             device: torch.device, program=None) -> Dict:
    """Drive the cell once on `device` and judge it; -> the result line's
    fields.  `program`: a stand-in for the driver's Program (a control or a
    planted fault, for the tests)."""
    workload = found["workload"]["name"]
    marks: Dict = {}

    def release():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    cell = SimpleNamespace(
        name=workload, config=found["config"], traffic=found["traffic"], seed=int(seed),
        seconds=float(seconds), trace=bool(trace), device=device,
        setup_done=lambda: marks.setdefault("setup_s", time.perf_counter() - T_START),
        memory_peak=lambda: (torch.cuda.max_memory_allocated(device)
                             if device.type == "cuda" else 0),
        release=release)
    driver = importlib.import_module(f"portbench.drivers.{found['traffic']['driver']}")
    out = driver.run(cell) if program is None else driver.run(cell, program)
    limits = found["limits"] or {}
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in out["numbers"].items()}
    correct = (out["failed"] == 0 and bool(checks)
               and all(c["limit"] is not None and math.isfinite(c["value"])
                       and c["value"] <= c["limit"] for c in checks.values()))
    metrics: Dict = {}
    if trace:
        for m in bench["per_layer"]:
            if _applies(m, workload):
                value = read_layer_metric(m["name"], out["layers"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=(marks["setup_s"], "s"))
        for m in bench["end_to_end"]:
            if _applies(m, workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]][0], "unit": m["unit"]}
    return dict(correct=correct, attempted=out["attempted"], failed=out["failed"],
                metrics=metrics, memory_peak_bytes=out["memory_peak_bytes"],
                layers=out.get("layers"), checks=checks)


def result_line(res: Dict, dev_info: Dict, trace: bool) -> Dict:
    """The result's line: the contract's keys, then the numbers compared."""
    dev_info = dict(dev_info, memory_peak_bytes=int(res["memory_peak_bytes"]))
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": dev_info}
    if trace:
        sl = res["layers"]["slice"]
        dev_info.update(busy_s=sl["busy_s"], window_s=sl["window_s"])
        line["breakdown"] = sl["breakdown"]
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    found = find_cell(bench, args.workload)
    chips = int(found["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(bench, found, args.seed, args.seconds, bool(args.trace), device)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 3
    dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    line = result_line(res, dev_info, bool(args.trace))
    if args.trace:
        line = dict(line, card=harness.card_limits(), checks=line.pop("checks"))
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
