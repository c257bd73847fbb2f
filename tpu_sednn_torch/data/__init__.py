from tpu_sednn_torch.data.rand48 import Rand48
from tpu_sednn_torch.data.pipeline import (
    ChunkPlan,
    plan_chunks,
    splice,
    nat_estimate,
    build_training_arrays,
    read_chunk_parity,
)
