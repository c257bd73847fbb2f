"""Decode: forward pass + noisy-phase overlap-add reconstruction.  Streaming
and head fusion are not ported yet."""

from tpu_sednn_torch.enhance.decode import (
    EnhanceConfig,
    compute_gv,
    enhance_waveform,
    enhance_lps,
    equalize_gv,
    finalize_lps,
    limit_gain,
    lps_from_mask,
    make_bucketed_decoder,
    make_serving_decoder,
    postprocess_mask,
)
