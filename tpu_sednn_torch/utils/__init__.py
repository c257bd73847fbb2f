from tpu_sednn_torch.utils.logging import Logger
