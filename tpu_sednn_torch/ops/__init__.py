"""Hand-written Hopper kernels, each with its wrapper and its plain torch
version.  Kernels are built on first use, never at import."""

from tpu_sednn_torch.ops.stft_lps import stft_lps, stft_lps_reference
from tpu_sednn_torch.ops.fused_mlp import (
    dp_update,
    dp_update_reference,
    fused_bwd_grad_out,
    fused_bwd_grad_out_reference,
    fused_bwd_update,
    fused_bwd_update_reference,
    fused_linear_act,
    fused_linear_act_reference,
)
from tpu_sednn_torch.ops.dropout_mask import dropout_mask, dropout_mask_reference
from tpu_sednn_torch.ops.rank_sum import rank_sum, rank_sum_reference
from tpu_sednn_torch.ops.lstm_cell import (
    lstm_cell_reference,
    lstm_plan,
    lstm_steps,
    lstm_steps_reference,
)
from tpu_sednn_torch.ops.sr_update import (
    sr_momentum_update,
    sr_momentum_update_reference,
    sr_train_step,
)

# the JAX package's names for the same two functions (tpu_sednn/ops/stft_pallas.py,
# tpu_sednn/ops/dropout_pallas.py)
stft_lps_pallas = stft_lps
dropout_mask_pallas = dropout_mask

KERNEL_SOURCES = ("stft_lps", "fused_mlp", "resident_chunk", "sr_update",
                  "dropout_mask", "rank_sum", "lstm_cell")  # csrc/<name>.cu

