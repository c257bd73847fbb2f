"""Command-line and weight tools: make_pfile (wav -> LPS pfile featurizer on
the STFT kernel), netgen (random nets and their widening), lenscp (.len
files), export (weights as MATLAB matrices)."""

from tpu_sednn_torch.tools.netgen import gen_rand_net, extend_net, extend_net_boost
from tpu_sednn_torch.tools.export import wts_to_matlab_dict, save_matlab_weights
