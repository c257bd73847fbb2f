"""The port's checkpoint / resume (utils/checkpoint.py, train_epochs_arrays'
ckpt_dir) held to what tests/test_checkpoint.py holds the JAX package to:
round trip with momentum, resume continues identically, restore_or_init,
kill-and-resume equal to the straight run exactly; and bfloat16 state through
a checkpoint and through model/convert.py, bit for bit."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sednn.model as jm
from tpu_sednn.train.loop import train_epochs_arrays as j_train_epochs_arrays
from tpu_sednn.train.step import OptConfig as JOpt, init_train_state as j_init
import tpu_sednn_torch.model as tm
from tpu_sednn_torch.model.convert import train_state_from_jax, train_state_to_numpy
from tpu_sednn_torch.train.loop import train_epochs_arrays
from tpu_sednn_torch.train.step import (OptConfig, TrainState, init_train_state,
                                        make_jit_train_chunk)
from tpu_sednn_torch.utils.checkpoint import (latest_step, restore_checkpoint, restore_or_init,
                                              save_checkpoint)
from tpu_sednn_torch.utils.logging import Logger
from tpu_sednn_torch.utils.profiling import trace

SIZES = (12, 16, 4)


def _params(sizes=SIZES, seed=0):
    p = jm.init_params(jax.random.key(seed), jm.ModelConfig(layersizes=sizes), "glorot")
    return p, tm.params_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _leaves(st):
    return list(st.params.w) + list(st.params.b) + list(st.deltas.w) + list(st.deltas.b)


def _chunks(n=2):
    rng = np.random.default_rng(0)
    return [(torch.from_numpy(rng.standard_normal((32, SIZES[0])).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((32, SIZES[-1])).astype(np.float32)))
            for _ in range(n)]


def _trained_state():
    cfg = tm.ModelConfig(layersizes=SIZES)
    run = make_jit_train_chunk(cfg, OptConfig(lrate=0.3, momentum=0.6, weightcost=0.0, bunchsize=8))
    st = init_train_state(_params()[1])
    for x, t in _chunks():
        st = run(st, x, t, None)
    return st


def test_roundtrip_with_momentum(tmp_path):
    st = _trained_state()
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    save_checkpoint(d, 5, st, extra={"epoch": 5, "lrate": 0.15, "cv_hist": [1.5, 1.25]})
    assert latest_step(d) == 5
    st2, extra, step = restore_checkpoint(d, device="cpu")
    assert step == 5 and extra == {"epoch": 5, "lrate": 0.15, "cv_hist": [1.5, 1.25]}
    assert st2.step == st.step == 8
    for a, b in zip(_leaves(st), _leaves(st2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(float(d_.abs().max()) > 0 for d_ in st2.deltas.w)  # momentum survives
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_resume_continues_identically(tmp_path):
    cfg = tm.ModelConfig(layersizes=SIZES)
    run = make_jit_train_chunk(cfg, OptConfig(lrate=0.3, momentum=0.6, weightcost=0.0, bunchsize=8))
    (x0, t0), (x1, t1) = _chunks()
    st = run(init_train_state(_params()[1]), x0, t0, None)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, st)
    resumed = run(restore_checkpoint(d, device="cpu")[0], x1, t1, None)
    straight = run(run(init_train_state(_params()[1]), x0, t0, None), x1, t1, None)
    for a, b in zip(_leaves(straight), _leaves(resumed)):
        assert torch.equal(a, b)


def test_restore_or_init(tmp_path):
    d = str(tmp_path / "ckpt")
    st, extra, step = restore_or_init(d, lambda: _params(seed=0)[1], device="cpu")
    assert step == 0 and st.step == 0 and extra == {}
    save_checkpoint(d, 3, st, extra={"epoch": 3})
    st2, extra2, step2 = restore_or_init(d, lambda: _params(seed=1)[1], device="cpu")
    assert step2 == 3 and extra2["epoch"] == 3 and torch.equal(st2.params.w[0], st.params.w[0])
    if not torch.cuda.is_available():  # the default is the card, on both branches: no quiet CPU run
        for call in (lambda: restore_or_init(d, lambda: _params()[1]),
                     lambda: restore_or_init(str(tmp_path / "fresh"), lambda: _params()[1]),
                     lambda: restore_checkpoint(d)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_newest_three_are_kept_and_no_partial_file_is_seen(tmp_path):
    st = _trained_state()
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3, 10, 4):
        save_checkpoint(d, step, st)
    assert sorted(os.listdir(d)) == ["step_10.pt", "step_3.pt", "step_4.pt"]
    assert latest_step(d) == 10
    open(os.path.join(d, "step_99.pt.123.tmp"), "wb").close()  # a crash mid-write
    assert latest_step(d) == 10
    save_checkpoint(d, 11, st, max_to_keep=1)
    assert [f for f in sorted(os.listdir(d)) if f.endswith(".pt")] == ["step_11.pt"]


def test_bf16_state_round_trips_through_a_checkpoint_and_through_convert(tmp_path):
    rng = np.random.default_rng(3)
    st = init_train_state(_params()[1])
    st = TrainState(params=st.params,
                    deltas=tm.MLP([torch.from_numpy(rng.standard_normal(tuple(w.shape))
                                                    .astype(np.float32) * 1e-3).bfloat16()
                                   for w in st.params.w], list(st.deltas.b)), step=7)
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, st)
    back, _, _ = restore_checkpoint(d, device="cpu")
    assert back.step == 7
    for a, b in zip(_leaves(st), _leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back.deltas.w[0].dtype == torch.bfloat16 and back.params.w[0].dtype == torch.float32
    # convert.py: out as float32 (the exact widening), to JAX's bfloat16 and back: nothing rounds
    params, deltas, step = train_state_to_numpy(st)
    assert deltas["w"][0].dtype == params["w"][0].dtype == np.float32
    assert torch.equal(torch.from_numpy(deltas["w"][0]).bfloat16(), st.deltas.w[0])
    jd = tuple(jnp.asarray(a, jnp.bfloat16) for a in deltas["w"])
    np.testing.assert_array_equal(np.asarray(jd[0], np.float32), st.deltas.w[0].float().numpy())
    want_bits = st.deltas.w[1].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(np.asarray(jd[1]).view(np.uint16), want_bits)
    st2 = train_state_from_jax(params, {"w": tuple(np.asarray(a) for a in jd), "b": deltas["b"]},
                               step, device="cpu")
    for a, b in zip(_leaves(st), _leaves(st2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("engine,kwargs", [("xla", None), ("resident", None),
                                           ("resident", dict(sr_delta=True))])
def test_kill_and_resume_identical_final_state(tmp_path, engine, kwargs):
    """Train 4 epochs straight vs 2 epochs, "die", and a fresh call that
    resumes from the checkpoint: final states and CV histories equal exactly
    (the epoch's generator is seeded from (seed, epoch))."""
    sizes = (24, 32, 8)
    cfg = tm.ModelConfig(layersizes=sizes, dropout_vis=0.1, dropout_hid=0.2)
    sched = lambda e: OptConfig(lrate=0.3, momentum=0.5 + 0.04 * e, bunchsize=16)  # noqa: E731
    rng = np.random.default_rng(0)
    x = rng.standard_normal((168, sizes[0])).astype(np.float32)  # 64 + 64 + 40: a partial last chunk
    t = rng.standard_normal((168, sizes[-1])).astype(np.float32)
    mlp = _params(sizes, seed=3)[1]
    kw = dict(seed=11, traincache=64, engine=engine, engine_kwargs=kwargs, logger=Logger(stream=None))

    def go(n_epochs, **more):
        return train_epochs_arrays(init_train_state(mlp), cfg, sched, x, t, x[:32], t[:32],
                                   n_epochs=n_epochs, **kw, **more)

    st_full, res_full = go(4)
    ck = str(tmp_path / "ck")
    go(2, ckpt_dir=ck)
    seen = []
    st_res, res_res = go(4, ckpt_dir=ck, on_epoch=lambda e, s, r: seen.append(e))
    assert seen == [2, 3] and len(res_res) == 4  # the first two epochs came from the checkpoint
    assert [r.cv_mse for r in res_res] == [r.cv_mse for r in res_full]
    assert st_res.step == st_full.step == 4 * 10  # 4 + 4 + 2 bunches an epoch
    for a, b in zip(_leaves(st_full), _leaves(st_res)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if kwargs:
        assert st_res.deltas.w[0].dtype == torch.bfloat16
    # ckpt_every: only every second epoch and the last are written
    ck2 = str(tmp_path / "ck2")
    go(3, ckpt_dir=ck2, ckpt_every=2)
    assert sorted(os.listdir(ck2)) == ["step_2.pt", "step_3.pt"]


def test_epoch_loop_learns_like_the_jax_loop():
    """The same arrays through both packages' in-memory loops (dropout off,
    plain engine): the CV error falls in both, to a similar value (the two
    draw other permutations)."""
    sizes = (24, 32, 8)
    p, mlp = _params(sizes, seed=3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((160, sizes[0])).astype(np.float32)
    t = (x @ rng.standard_normal((sizes[0], sizes[-1])).astype(np.float32) * 0.2)
    _, jres = j_train_epochs_arrays(j_init(p), jm.ModelConfig(layersizes=sizes),
                                    lambda e: JOpt(lrate=0.3, momentum=0.5, bunchsize=16), x, t,
                                    x[:32], t[:32], n_epochs=3, seed=11, traincache=64)
    _, res = train_epochs_arrays(init_train_state(mlp), tm.ModelConfig(layersizes=sizes),
                                 lambda e: OptConfig(lrate=0.3, momentum=0.5, bunchsize=16), x, t,
                                 x[:32], t[:32], n_epochs=3, seed=11, traincache=64,
                                 logger=Logger(stream=None))
    assert res[-1].cv_mse < res[0].cv_mse and jres[-1].cv_mse < jres[0].cv_mse
    assert res[-1].cv_mse == pytest.approx(jres[-1].cv_mse, rel=0.25)


def test_profiling_hooks(tmp_path):
    with trace(None):  # a no-op
        pass
    with trace(str(tmp_path / "prof")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
