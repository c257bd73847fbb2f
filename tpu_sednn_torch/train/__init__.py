from tpu_sednn_torch.train.step import (
    OptConfig,
    TrainState,
    init_train_state,
    reference_train_step,
    reference_train_chunk,
    clean_train_step,
    softmax_xent_train_step,
    cv_squared_error,
    make_jit_train_chunk,
)
