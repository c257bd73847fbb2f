from tpu_sednn_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    backend_rule,
    bunch_part_regroup_host,
    fence,
    initialize_distributed,
    local_rows,
    make_dp_train_chunk,
    make_global_chunk,
    make_mesh,
    replicate,
    shard_batch,
)
