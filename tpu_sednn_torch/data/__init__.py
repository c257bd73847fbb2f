from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.data.pipeline import (
    ChunkPlan,
    plan_chunks,
    splice,
    nat_estimate,
    build_training_arrays,
    read_chunk_parity,
)
from tpu_sednn_torch.data.mixing import mix_at_snr, synth_speech, synth_noise
from tpu_sednn_torch.data.masks import (
    irm_from_clean_noise,
    ibm_from_clean_noise,
    irm_from_lps,
    ibm_from_lps,
    psm_from_stft,
)
