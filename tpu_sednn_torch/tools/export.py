"""Weight export for external decode tools — a copy of
tpu_sednn/tools/export.py (numpy + scipy).

Equivalent of toolbox/weights/change_cudaSavedModels2matlabWeigths_4layers.m:
repacks trained weights into the `w_i = [W; b]` augmented matrices the
reference's (binary-only) Matlab enhancement tool consumes — each matrix is
(prev+1, cur): weight rows stacked over the bias row.  Saved as MATLAB v4
.mat via scipy (readable by any Matlab/Octave).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy.io import savemat


def wts_to_matlab_dict(
    weights: Sequence[np.ndarray], biases: Sequence[np.ndarray]
) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for i, (w, b) in enumerate(zip(weights, biases), start=1):
        out[f"w{i}"] = np.vstack([np.asarray(w, np.float64), np.asarray(b, np.float64)[None, :]])
    return out


def save_matlab_weights(path: str, weights: Sequence[np.ndarray],
                        biases: Sequence[np.ndarray]) -> None:
    savemat(path, wts_to_matlab_dict(weights, biases))
