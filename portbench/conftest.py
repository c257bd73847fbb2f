"""pytest settings of the benchmark's own tests (`python -m pytest
portbench/tests -q`): the `card` marker, and the fixture that skips a
card-only test where no CUDA device is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips where none is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: card-only tests run on the chip")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """-> tiny(workload): the cell as BENCHMARK.json finds it, its net, corpus
    and batches cut to its driver's TINY, a size the CPU trains and decodes
    in a second."""
    from portbench import readings, run

    bench = run.load_json(run.os.path.join(run.ROOT, "BENCHMARK.json"))

    def make(workload):
        found = run.find_cell(bench, workload)
        cut = readings.driver_of(found).TINY
        found["config"] = dict(found["config"], **cut["config"])
        found["traffic"] = dict(found["traffic"], **cut["traffic"])
        return bench, found

    return make
