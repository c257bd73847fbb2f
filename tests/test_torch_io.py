"""Port codecs (tpu_sednn_torch.io) against tpu_sednn.io: the same arrays
written by both packages give byte-identical files, and each reads the
other's files back exactly."""

import numpy as np
import pytest

import tpu_sednn.io as jio
import tpu_sednn_torch.io as tio


def _utts(seed=0, dim=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(3, 40)), dim)).astype(np.float32)
            for _ in range(5)]


def test_wav_bytes_identical(tmp_path):
    rng = np.random.default_rng(1)
    x = (0.3 * rng.standard_normal(4001)).astype(np.float32)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    jio.write_wav(str(a), x, 8000)
    tio.write_wav(str(b), x, 8000)
    assert a.read_bytes() == b.read_bytes()
    xa, sra = jio.read_wav(str(b))
    xb, srb = tio.read_wav(str(a))
    assert sra == srb == 8000
    np.testing.assert_array_equal(xa, xb)


def test_norm_bytes_identical(tmp_path):
    feats = np.concatenate(_utts(2))
    mean_j, istd_j = jio.compute_norm(feats)
    mean_t, istd_t = tio.compute_norm(feats)
    np.testing.assert_array_equal(mean_j, mean_t)
    np.testing.assert_array_equal(istd_j, istd_t)
    a, b = tmp_path / "a.norm", tmp_path / "b.norm"
    jio.save_norm(str(a), mean_j, istd_j)
    tio.save_norm(str(b), mean_t, istd_t)
    assert a.read_bytes() == b.read_bytes()
    for got, want in zip(tio.load_norm(str(a), feats.shape[1]),
                         jio.load_norm(str(b), feats.shape[1])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sizes", [(12, 8, 3), (20, 16, 16, 5)])
def test_wts_bytes_identical(tmp_path, sizes):
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal((sizes[i - 1], sizes[i])).astype(np.float32)
          for i in range(1, len(sizes))]
    bs = [rng.standard_normal(sizes[i]).astype(np.float32) for i in range(1, len(sizes))]
    a, b = tmp_path / "a.wts", tmp_path / "b.wts"
    jio.save_wts(str(a), ws, bs)
    tio.save_wts(str(b), ws, bs)
    assert a.read_bytes() == b.read_bytes()
    ws2, bs2 = tio.load_wts(str(a), layersizes=sizes)
    for x, y in zip(ws + bs, ws2 + bs2):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tio.load_wts(str(a), layersizes=sizes[:-1] + (sizes[-1] + 1,))


def test_pfile_bytes_identical(tmp_path):
    utts = _utts(4)
    a, b = tmp_path / "a.pfile", tmp_path / "b.pfile"
    jio.write_pfile(str(a), utts)
    tio.write_pfile(str(b), utts)
    assert a.read_bytes() == b.read_bytes()
    info_j = jio.read_pfile_info(str(b), 7)
    info_t = tio.read_pfile_info(str(a), 7)
    assert (info_j.num_sentences, info_j.num_frames) == (info_t.num_sentences, info_t.num_frames)
    np.testing.assert_array_equal(info_j.frames_per_sent, info_t.frames_per_sent)
    for u, v in zip(utts, tio.read_pfile_utterances(str(a), 7)):
        np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(tio.read_pfile_frames(str(a), 7, 3, 5),
                                  jio.read_pfile_frames(str(a), 7, 3, 5))
    with pytest.raises(ValueError):
        tio.read_pfile_info(str(a), 8)  # wrong fea_dim lands in frame data
