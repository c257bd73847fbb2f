"""Speech-quality and throughput metrics (host numpy + scipy): own copies of
tpu_sednn/metrics, scored on arrays on the host."""

from tpu_sednn_torch.metrics.quality import stoi, seg_snr, lsd, si_sdr, snr
from tpu_sednn_torch.metrics.pesq import pesq
from tpu_sednn_torch.metrics.composite import composite, llr, wss
from tpu_sednn_torch.metrics.throughput import audio_seconds_per_second
