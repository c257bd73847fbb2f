"""Byte-exact codecs for the reference's on-disk formats (numpy; own copies of
`tpu_sednn.io`'s wav, .norm, .wts, pfile and HTK modules) and `native`,
the port's own read-only ctypes loader of the shared host library."""

from tpu_sednn_torch.io.wts import load_wts, save_wts
from tpu_sednn_torch.io.norm import load_norm, save_norm, compute_norm
from tpu_sednn_torch.io.pfile import (
    PfileInfo,
    read_pfile_info,
    read_pfile_frames,
    read_pfile_utterances,
    write_pfile,
)
from tpu_sednn_torch.io.htk import read_htk, write_htk
from tpu_sednn_torch.io.wav import read_wav, write_wav
