"""The sum over ranks that share a card (ops/rank_sum.py) and the backend
rule that sends ranks to it (parallel.backend_rule): the plain version of
the rank_sum kernel adds in rank order, bit-equal to float32 additions in
numpy; the rule takes nccl where each rank has a card, gloo where all ranks
share one card or run on the CPU, and refuses every other layout.  The
kernel itself and the CUDA IPC exchange run only on the card (chip_smoke.py
holds them there)."""

import numpy as np
import pytest
import torch

from tpu_sednn_torch.ops import rank_sum, rank_sum_reference
from tpu_sednn_torch.parallel import Mesh, backend_rule, fence, initialize_distributed


@pytest.mark.parametrize("n_src", [1, 2, 4, 16])
def test_rank_sum_adds_in_rank_order(n_src):
    rng = np.random.default_rng(n_src)
    srcs = [(rng.standard_normal(1001) * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
            for _ in range(n_src)]
    want = srcs[0].copy()
    for a in srcs[1:]:
        want = want + a  # float32 additions, rank order
    ts = [torch.from_numpy(a) for a in srcs]
    got = rank_sum(ts, torch.empty(1001))
    assert np.array_equal(got.numpy(), want)
    inplace = ts[0].clone()  # out may be one of the sources
    rank_sum([inplace] + ts[1:], inplace)
    assert np.array_equal(inplace.numpy(), want)
    assert np.array_equal(rank_sum_reference(ts, torch.empty(1001)).numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "size", "count", "strided"])
def test_rank_sum_refuses(bad):
    a = torch.zeros(8)
    srcs, out = {"dtype": ([a.double(), a.double()], torch.zeros(8, dtype=torch.float64)),
                 "size": ([a, torch.zeros(9)], a.clone()),
                 "count": ([a] * 17, a.clone()),
                 "strided": ([torch.zeros(16)[::2], a], a.clone())}[bad]
    with pytest.raises(ValueError):
        rank_sum(srcs, out)


@pytest.mark.parametrize("layout,want", [
    ((False, 0, 4, 4), "gloo"),   # ranks on the CPU
    ((True, 4, 4, 4), "nccl"),    # a card for each rank
    ((True, 8, 4, 8), "nccl"),    # two hosts of four ranks, eight cards each
    ((True, 1, 2, 2), "gloo"),    # two ranks share the one card
    ((True, 1, 4, 4), "gloo"),
    ((True, 2, 4, 4), None),      # pairs on two cards: neither layout
    ((True, 1, 2, 4), None),      # one card a host, two hosts
])
def test_backend_rule(layout, want):
    if want is None:
        with pytest.raises(ValueError, match="each have a card"):
            backend_rule(*layout)
    else:
        assert backend_rule(*layout) == want


@pytest.mark.parametrize("cards,ranks,backend", [(2, 2, "gloo"), (1, 2, "nccl"), (2, 4, None)])
def test_initialize_distributed_refuses_before_joining(monkeypatch, cards, ranks, backend):
    """gloo for card tensors where each rank has a card (it would sum on
    the host), nccl on a shared card, and a mixed layout all raise before
    any process group is joined."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(ranks))
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError):
        initialize_distributed(device="cuda", backend=backend, world_size=ranks, rank=0)
    assert not torch.distributed.is_initialized()


def test_fence_without_card_sums_is_a_noop():
    fence(Mesh(1, 0, torch.device("cpu")))
    fence(Mesh(2, 0, torch.device("cpu")))  # no group joined: nothing to wait for
