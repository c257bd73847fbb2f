"""tpu_sednn_torch — the PyTorch/CUDA port of `tpu_sednn` for NVIDIA Hopper.

Mirrors the module paths and public names of the JAX package, which stays
beside it as the reference.  Plain tensor code is PyTorch; every Pallas TPU
kernel of a ported path is a hand-written CUDA kernel under `csrc/`, built
with nvcc for sm_90a on first use (`ops/_build.py`).

Subpackages ported so far
-------------------------
config    TrainFlags: the key=value flags of the training command
cli       `python -m tpu_sednn_torch.cli key=value ...`: one epoch + CV over pfiles
io        byte-exact codecs: wav, .norm, .wts, pfile, HTK; loader of the native host library
data      rand48, chunk planning and reading, on-device splice, prefetch; the
          synthetic corpus (mixing), mask targets (masks), the on-device
          sample builder (device_pipeline)
metrics   STOI, SNR, SegSNR, SI-SDR, LSD, PESQ estimator, CSIG/CBAK/COVL (host)
dsp       framing, rDFT/irDFT, log-power spectrum, overlap-add ISTFT
ops       hand-written Hopper kernels, their wrappers and plain versions
model     MLP (JAX weight layout), init, train and eval forward, .wts interop;
          int8 serving (quant)
train     plain torch train/CV steps, the epoch loop and its chunk engines
parallel  data parallelism over torch.distributed: process group, mesh, host regroup
recipes   the fine-tune recipe (momentum schedule, warm start per epoch); the
          multi-condition recipe; run-dir loader, demo gate, decode sweep,
          head-fusion sweep
utils     Logger
enhance   offline/batched decode (float32 or int8), streaming (host or device
          state), head fusion, and the `python -m tpu_sednn_torch.enhance` CLI
tools     make_pfile (wav -> LPS pfile featurizer on the STFT kernel), netgen,
          lenscp, export

Entry points take `device=` and default to "cuda"; they raise when CUDA is
asked for and absent, and never continue on the CPU unless asked to.
"""

from tpu_sednn_torch._device import resolve_device

__version__ = "0.1.0"
