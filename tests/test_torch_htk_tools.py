"""The port's HTK codec (tpu_sednn_torch/io/htk.py) and weight tools
(tpu_sednn_torch/tools/{netgen,lenscp,export}.py) against the JAX
package's: HTK files written by either package byte-equal and read back by
the other, both endiannesses; gen_rand_net / extend_net / extend_net_boost
bit-equal for the same seed; the same .len files; the same .mat contents;
the `python -m` entry points as tests/test_tool_clis.py runs the JAX ones."""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import loadmat

import tpu_sednn.io.htk as jh
import tpu_sednn.tools.export as jx
import tpu_sednn.tools.lenscp as jl
import tpu_sednn.tools.netgen as jn
import tpu_sednn_torch.io.htk as th
import tpu_sednn_torch.tools.export as tx
import tpu_sednn_torch.tools.lenscp as tl
import tpu_sednn_torch.tools.netgen as tn
from tpu_sednn_torch.io import load_wts, save_wts, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("big_endian", [True, False])
def test_htk_files_byte_equal_and_cross_read(tmp_path, big_endian):
    fea = np.random.default_rng(0).standard_normal((37, 129)).astype(np.float32)
    pj, pt = str(tmp_path / "j.htk"), str(tmp_path / "t.htk")
    jh.write_htk(pj, fea, sample_period_100ns=80000, param_kind=6, big_endian=big_endian)
    th.write_htk(pt, fea, sample_period_100ns=80000, param_kind=6, big_endian=big_endian)
    assert _bytes(pj) == _bytes(pt)
    for reader, path in ((th.read_htk, pj), (jh.read_htk, pt)):
        got, period, kind = reader(path, big_endian=big_endian)
        np.testing.assert_array_equal(got, fea)
        assert (period, kind) == (80000, 6) and got.dtype == np.float32


def test_htk_le2be_and_truncation(tmp_path):
    fea = np.random.default_rng(1).standard_normal((11, 5)).astype(np.float32)
    le = str(tmp_path / "le.htk")
    th.write_htk(le, fea, big_endian=False)
    bj, bt = str(tmp_path / "bj.htk"), str(tmp_path / "bt.htk")
    jh.htk_le2be(le, bj)
    th.htk_le2be(le, bt)
    assert _bytes(bj) == _bytes(bt)
    np.testing.assert_array_equal(th.read_htk(bt)[0], fea)
    cut = str(tmp_path / "cut.htk")
    with open(cut, "wb") as f:
        f.write(_bytes(bt)[:-4])
    with pytest.raises(ValueError, match="truncated"):
        th.read_htk(cut)
    with pytest.raises(ValueError, match="n_frames, dim"):
        th.write_htk(cut, fea.ravel())


@pytest.mark.parametrize("flag,beta,seed", [(1, 1.0, 0), (0, 0.5, 3), (1, 2.0, 7)])
def test_gen_rand_net_bit_equal(flag, beta, seed):
    sizes = [1548, 64, 32, 129]
    ws_j, bs_j = jn.gen_rand_net(sizes, flag=flag, beta=beta, seed=seed)
    ws_t, bs_t = tn.gen_rand_net(sizes, flag=flag, beta=beta, seed=seed)
    for a, b in zip(ws_j + bs_j, ws_t + bs_t):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("boost", [False, True])
def test_extend_net_bit_equal(boost):
    ws, bs = jn.gen_rand_net([10, 8, 6, 4], seed=1)
    bs = [b + 0.1 * i for i, b in enumerate(bs)]  # a nonzero bias pool
    add = [0, 6, 3, 0]
    if boost:
        want, got = jn.extend_net_boost(ws, bs, add, seed=5), tn.extend_net_boost(ws, bs, add, seed=5)
    else:
        want, got = jn.extend_net(ws, bs, add, beta=0.7, seed=5), tn.extend_net(ws, bs, add,
                                                                                beta=0.7, seed=5)
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        np.testing.assert_array_equal(a, b)
    assert got[0][0].shape == (10, 14) and got[0][1].shape == (14, 9)
    with pytest.raises(ValueError, match="cannot grow"):
        tn.extend_net(ws, bs, [1, 0, 0, 0])
    with pytest.raises(ValueError, match="length mismatch"):
        tn.extend_net_boost(ws, bs, [0, 0])


def test_lenscp_output_equal(tmp_path):
    rng = np.random.default_rng(0)
    be, le, wavs = [], [], []
    for i, n in enumerate([37, 11, 90]):
        fea = rng.standard_normal((n, 5)).astype(np.float32)
        be.append(str(tmp_path / f"u{i}.lsp"))
        le.append(str(tmp_path / f"u{i}.le"))
        th.write_htk(be[-1], fea)
        th.write_htk(le[-1], fea, big_endian=False)
        wavs.append(str(tmp_path / f"u{i}.wav"))
        write_wav(wavs[-1], 0.1 * rng.standard_normal(200 * n).astype(np.float32), 8000)
    for paths, flags in ((be, []), (le, ["--le"]), (wavs, ["--wav"]),
                         (wavs, ["--wav", "--sr", "16000"])):
        scp = str(tmp_path / "in.scp")
        with open(scp, "w") as f:
            f.write("\n".join(paths) + "\n\n")
        oj, ot = str(tmp_path / "j.len"), str(tmp_path / "t.len")
        assert jl.main([scp, oj] + flags) == 0
        assert tl.main([scp, ot] + flags) == 0
        assert _bytes(oj) == _bytes(ot)
    assert [int(v) for v in open(str(tmp_path / "t.len")).read().split()] == [
        tl.wav_num_frames(w, 16000) for w in wavs]
    assert tl.main([scp]) == 1  # usage


def test_save_matlab_weights_same_contents(tmp_path):
    ws, bs = tn.gen_rand_net([12, 8, 3], seed=2)
    dj, dt = jx.wts_to_matlab_dict(ws, bs), tx.wts_to_matlab_dict(ws, bs)
    assert dj.keys() == dt.keys() == {"w1", "w2"}
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k])
    assert dt["w1"].shape == (13, 8)
    pj, pt = str(tmp_path / "j.mat"), str(tmp_path / "t.mat")
    jx.save_matlab_weights(pj, ws, bs)
    tx.save_matlab_weights(pt, ws, bs)
    mj, mt = loadmat(pj), loadmat(pt)
    for k in ("w1", "w2"):
        np.testing.assert_array_equal(mt[k], mj[k])
        np.testing.assert_array_equal(mt[k][:-1], ws[int(k[1]) - 1])
        np.testing.assert_array_equal(mt[k][-1], bs[int(k[1]) - 1])


def test_netgen_cli(tmp_path):
    out_t, out_j = str(tmp_path / "t.wts"), str(tmp_path / "j.wts")
    args = ["4", "12", "24", "24", "6"]
    assert tn.main(args + [out_t, "1", "0.5"]) == 0
    assert jn.main(args + [out_j, "1", "0.5"]) == 0
    assert _bytes(out_t) == _bytes(out_j)
    ws, bs = load_wts(out_t, layersizes=[12, 24, 24, 6])
    assert np.abs(ws[0]).max() <= 0.5 * np.sqrt(6.0) / np.sqrt(36)
    assert all((b == 0).all() for b in bs)
    assert tn.main(["4"]) == 1


def test_extend_net_cli(tmp_path):
    ws, bs = tn.gen_rand_net([10, 8, 4], seed=1)
    src = str(tmp_path / "a.wts")
    save_wts(src, ws, bs)
    args = ["3", "1.0", "10", "8", "4", "0", "6", "0", src]
    for extra in ([], ["--boost"]):
        out_t, out_j = str(tmp_path / "t.wts"), str(tmp_path / "j.wts")
        assert tn.extend_main(args + [out_t] + extra) == 0
        assert jn.extend_main(args + [out_j] + extra) == 0
        assert _bytes(out_t) == _bytes(out_j)
        w2, _ = load_wts(out_t, layersizes=[10, 14, 4])
        np.testing.assert_array_equal(w2[0][:, :8], ws[0])
    assert tn.extend_main(["3", "1.0", "10"]) == 1


def test_python_m_entry_points(tmp_path):
    """The modules run as commands: netgen, netgen extend and lenscp."""
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(*args):
        return subprocess.run([sys.executable, "-m", *args], cwd=str(tmp_path), env=env,
                              capture_output=True, text=True, timeout=120)

    net = str(tmp_path / "g.wts")
    r = run("tpu_sednn_torch.tools.netgen", "3", "6", "5", "4", net, "1", "1.0")
    assert r.returncode == 0, r.stderr
    big = str(tmp_path / "h.wts")
    r = run("tpu_sednn_torch.tools.netgen", "extend", "3", "1.0", "6", "5", "4", "0", "2", "0",
            net, big)
    assert r.returncode == 0, r.stderr
    assert load_wts(big, layersizes=[6, 7, 4])[0][0].shape == (6, 7)
    lsp = str(tmp_path / "u.lsp")
    th.write_htk(lsp, np.zeros((9, 3), np.float32))
    scp, out = str(tmp_path / "a.scp"), str(tmp_path / "a.len")
    with open(scp, "w") as f:
        f.write(lsp + "\n")
    r = run("tpu_sednn_torch.tools.lenscp", scp, out)
    assert r.returncode == 0, r.stderr
    assert open(out).read() == "9\n"
