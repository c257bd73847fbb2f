"""Readings of the correctness check's numbers over many seeds in one process,
for setting each number's limit between the program's sound runs (the
lower reading) and the lower-precision control or a planted fault (the
upper reading):

    python3 -m portbench.readings --workload <name> --seeds 1,2,3 \\
        --modes program,control [--seconds 20] [--no-steps]

The cell's driver (drivers/<driver>.py, named by its traffic) defines the
modes (its MODES) and reads them (its read_seed): "program" runs the port
as the cell does, "control" the plain reference in its place in the
precision below the configuration's, and the rest the faults the cell can
have.  --seconds is the window a training cell runs before its last call is
followed; --no-steps leaves out the stand-ins' own set-ups.  One JSON line
a seed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from types import SimpleNamespace

import torch

from portbench import run


def driver_of(found):
    return importlib.import_module(f"portbench.drivers.{found['traffic']['driver']}")


def read_seed(found, seed: int, modes, device: torch.device, seconds: float = 0.0,
              steps: bool = True) -> dict:
    """{"seed", "seconds", then each mode's numbers under its name}."""
    t0 = time.perf_counter()

    def release():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    cell = SimpleNamespace(name=found["workload"]["name"], config=found["config"],
                           traffic=found["traffic"], seed=int(seed), seconds=float(seconds),
                           trace=False, device=device, release=release)
    numbers = driver_of(found).read_seed(cell, list(modes), steps)
    release()
    return dict(seed=seed, seconds=time.perf_counter() - t0, **numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--no-steps", action="store_true")
    args = ap.parse_args(argv)
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    found = run.find_cell(bench, args.workload)
    modes = args.modes.split(",")
    unknown = set(modes) - set(driver_of(found).MODES)
    if unknown:
        print(f"portbench.readings: unknown modes {sorted(unknown)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read_seed(found, seed, modes, device, args.seconds,
                                   not args.no_steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
