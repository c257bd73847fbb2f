from tpu_sednn_torch.model.mlp import (
    MLP,
    ModelConfig,
    init_params,
    init_params_parity,
    forward,
    forward_eval,
    fold_eval_params,
    params_from_wts,
    params_to_wts,
)
from tpu_sednn_torch.model.convert import (
    params_from_jax,
    quant_params_from_jax,
    params_to_numpy,
    train_state_from_jax,
    train_state_to_numpy,
)
from tpu_sednn_torch.model.quant import (
    QuantParams,
    forward_eval_int8,
    quantize_params_int8,
)
