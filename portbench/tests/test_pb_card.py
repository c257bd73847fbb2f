"""On the card: the program reads within every limit and the lower-precision
control (the reference in the program's place: fp8 products for a training
cell, TF32 for a serving cell) reads past at least one, on three seeds, at
the cells' published widths with a corpus and batches cut to what a test
run holds (each driver's CARD_CUT), a training cell's last call after a
window of 3 s.  Run on the chip: `python3 -m pytest portbench/tests -q -m card`."""

import pytest

from portbench import readings, run

SEEDS = (2 ** 31 + 101, 7, 40961)


def _cut(workload):
    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))
    found = run.find_cell(bench, workload)
    cut = readings.driver_of(found).CARD_CUT
    found["config"] = dict(found["config"], **cut["config"])
    found["traffic"] = dict(found["traffic"], **cut["traffic"])
    return found


def _within(found, numbers):
    return all(numbers[k] <= v for k, v in found["limits"].items())


@pytest.mark.card
@pytest.mark.parametrize("workload", ["train-8k-resident", "serve-8k-batch",
                                      "train-16k-resident", "serve-16k-batch"])
def test_program_within_and_control_past_the_limits(card, workload):
    found = _cut(workload)
    for seed in SEEDS:
        read = readings.read_seed(found, seed, ["program", "control"], card, seconds=3.0)
        assert _within(found, read["program"])
        assert not _within(found, read["control"])
