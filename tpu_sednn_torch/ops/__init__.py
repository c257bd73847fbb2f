"""Hand-written Hopper kernels, each with its wrapper, its plain torch
version and its launch counter.  Kernels are built on first use, never at
import."""

from tpu_sednn_torch.ops.stft_lps import stft_lps, stft_lps_reference
