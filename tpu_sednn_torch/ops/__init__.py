"""Hand-written Hopper kernels, each with its wrapper, its plain torch
version and its launch counter.  Kernels are built on first use, never at
import."""

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


def launch_counts() -> dict:
    """Every launch counter of the port, as plain integers: the wrappers'
    own counts (and the masks the dropout mask launches wrote), the
    kernel launches the chunk trainer's C entry points enqueued (by
    kernel), the chunk trainer's runs (single-device and data-parallel) on
    a card, and the calls of the plain chunk trainer."""
    from tpu_sednn_torch.ops import resident_chunk
    from tpu_sednn_torch.train.step import reference_train_chunk

    return {
        "dropout_mask": dropout_mask.launches,
        "dropout_mask_masks": dropout_mask.masks,
        "sr_momentum_update": sr_momentum_update.launches,
        "stft_lps": stft_lps.launches,
        "fused_linear_act": fused_linear_act.launches,
        "fused_linear_act_tc": fused_linear_act.tc_launches,
        "fused_bwd_update": fused_bwd_update.launches,
        "fused_bwd_update_tc": fused_bwd_update.tc_launches,
        "fused_bwd_update_dedx_casts": fused_bwd_update.dedx_casts,
        "fused_bwd_grad_out": fused_bwd_grad_out.launches,
        "fused_bwd_grad_out_tc": fused_bwd_grad_out.tc_launches,
        "fused_bwd_grad_out_dedx_casts": fused_bwd_grad_out.dedx_casts,
        "fused_bwd_grad_out_philox": fused_bwd_grad_out.philox_launches,
        "dp_update": dp_update.launches,
        "dp_update_sr": dp_update.sr_launches,
        "rank_sum": rank_sum.launches,
        "lstm_steps": lstm_steps.launches,
        "lstm_steps_resident": lstm_steps.resident_layers,
        "lstm_steps_streamed": lstm_steps.streamed_layers,
        "sample_resident_masks": resident_chunk.sample_resident_masks.launches,
        "input_mask_bits": resident_chunk.input_mask_bits.launches,
        "resident_chunk": resident_chunk.make_resident_train_chunk.launches,
        "dp_resident_chunk": resident_chunk.make_dp_resident_train_chunk.launches,
        "resident_chunk_kernels": dict(resident_chunk.kernel_launches),
        "plain_train_chunk": reference_train_chunk.calls,
    }


def write_launch_report() -> None:
    """If the environment variable TPU_SEDNN_TORCH_LAUNCH_REPORT names a
    file, write `launch_counts()` there as JSON (the commands call this as
    they end, so a caller can see which kernels ran)."""
    import json
    import os

    path = os.environ.get("TPU_SEDNN_TORCH_LAUNCH_REPORT")
    if path:
        with open(path, "w") as f:
            json.dump(launch_counts(), f)


def reset_launch_counts() -> None:
    """Set every counter of `launch_counts` to 0."""
    from tpu_sednn_torch.ops import resident_chunk
    from tpu_sednn_torch.train.step import reference_train_chunk

    dropout_mask.launches = dropout_mask.masks = sr_momentum_update.launches = 0
    stft_lps.launches = fused_linear_act.launches = fused_bwd_update.launches = 0
    fused_linear_act.tc_launches = fused_bwd_update.tc_launches = 0
    fused_bwd_grad_out.launches = fused_bwd_grad_out.tc_launches = 0
    fused_bwd_update.dedx_casts = fused_bwd_grad_out.dedx_casts = 0
    dp_update.launches = dp_update.sr_launches = 0
    fused_bwd_grad_out.philox_launches = 0
    rank_sum.launches = lstm_steps.launches = 0
    lstm_steps.resident_layers = lstm_steps.streamed_layers = 0
    resident_chunk.sample_resident_masks.launches = 0
    resident_chunk.input_mask_bits.launches = 0
    resident_chunk.make_resident_train_chunk.launches = 0
    resident_chunk.make_dp_resident_train_chunk.launches = 0
    for name in resident_chunk.kernel_launches:
        resident_chunk.kernel_launches[name] = 0
    reference_train_chunk.calls = 0
