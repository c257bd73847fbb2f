"""Decode: forward pass + noisy-phase overlap-add reconstruction; the
offline and serving decoders (float32 or int8), the streaming enhancers
(host or device state) and head fusion."""

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
from tpu_sednn_torch.enhance.streaming import DeviceStreamingEnhancer, StreamingEnhancer
from tpu_sednn_torch.enhance.fusion import (
    enhance_lps_multi,
    enhance_waveform_fused,
    make_fused_serving_decoder,
)
