"""Framing, STFT, log-power spectrum and overlap-add ISTFT (plain torch)."""

from tpu_sednn_torch.dsp.stft import (
    LPS_FLOOR,
    StftConfig,
    frame_signal,
    stft_logpower,
    stft_real_imag,
    istft_overlap_add,
    reconstruct_from_lps,
)
