"""The canonical fine-tune recipe — replacement for
finetune_DNN_speech_enhancement_dropout_NAT.pl; the port of
tpu_sednn/recipes/finetune_nat.py.

Schedule reproduced exactly (the reference's finetune_...NAT.pl):
  * epoch 1: momentum 0.5 (line 36)
  * epochs 2-10: momentum += 0.04 per epoch (line 138)
  * epochs 11+: momentum = 0.9 (line 221)
  * lrate constant (1 in the recipe), weightcost 0
  * init_randem_seed += 345 per epoch (line 137)
  * warm start from the previous epoch's .wts (line 134)
plus the optional CV-driven lr-halving/early-stop the Perl keeps commented out
(lines 167-211) — exposed here behind `halve_on_plateau`.

Unlike the Perl/BPtrain pair (one process per epoch, momentum deltas reset to
zero at every epoch boundary because BP_GPU reallocates them), this recipe can
either reproduce that quirk (`reset_momentum_each_epoch=True`, the default for
parity) or carry optimizer state across epochs (the sane mode).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

from tpu_sednn_torch.config import TrainFlags
from tpu_sednn_torch.train.step import OptConfig
from tpu_sednn_torch.utils.logging import Logger


def recipe_opt_schedule(epoch0: int, lrate: float = 1.0, bunchsize: int = 128,
                        weightcost: float = 0.0) -> OptConfig:
    """Momentum schedule by 0-based epoch index."""
    if epoch0 == 0:
        m = 0.5
    elif epoch0 <= 9:
        m = 0.5 + 0.04 * epoch0
    else:
        m = 0.9
    return OptConfig(lrate=lrate, momentum=m, weightcost=weightcost, bunchsize=bunchsize)


@dataclass
class RecipeConfig:
    mlp_dir: str
    fea_file: str
    targ_file: str
    norm_file: str
    train_sent_range: str
    cv_sent_range: str
    layersizes: Tuple[int, ...] = (1548, 2048, 2048, 2048, 129)
    fea_dim: int = 129
    fea_context: int = 11
    targ_offset: int = 5
    bunchsize: int = 128
    lrate: float = 1.0
    weightcost: float = 0.0
    traincache: int = 102400
    init_randem_seed: int = 27863875
    n_epochs: int = 20
    dropoutflag: int = 1
    visible_omit: float = 0.1
    hid_omit: float = 0.2
    init_wts: str = ""  # epoch-1 warm start (e.g. from gen_rand_net)
    engine: str = "auto"  # chunk trainer: auto | xla | resident
    device: str = "cuda"  # where every epoch runs: cuda | cpu
    reset_momentum_each_epoch: bool = True  # reference quirk (SURVEY.md §5.4)
    halve_on_plateau: bool = False
    plateau_threshold: float = 0.0  # improvement below this halves lrate
    early_stop_lrate: float = 1e-3


def run_recipe(rc: RecipeConfig, logger: Optional[Logger] = None) -> List[float]:
    """Run the epoch loop via the BPtrain-equivalent CLI path; returns the
    per-epoch CV MSE history.  Writes mlp.N.wts + mlp.N.log under mlp_dir."""
    from tpu_sednn_torch.cli import run_epoch

    os.makedirs(rc.mlp_dir, exist_ok=True)
    log = logger or Logger()
    lrate = rc.lrate
    seed = rc.init_randem_seed
    cv_hist: List[float] = []
    prev_wts = rc.init_wts
    for i in range(1, rc.n_epochs + 1):
        opt = recipe_opt_schedule(i - 1, lrate, rc.bunchsize, rc.weightcost)
        flags = TrainFlags(
            fea_file=rc.fea_file, targ_file=rc.targ_file, norm_file=rc.norm_file,
            outwts_file=os.path.join(rc.mlp_dir, f"mlp.{i}.wts"),
            log_file=os.path.join(rc.mlp_dir, f"mlp.{i}.log"),
            initwts_file=prev_wts,
            train_sent_range=rc.train_sent_range, cv_sent_range=rc.cv_sent_range,
            fea_dim=rc.fea_dim, fea_context=rc.fea_context, targ_offset=rc.targ_offset,
            dropoutflag=rc.dropoutflag, traincache=rc.traincache,
            bunchsize=rc.bunchsize, init_randem_seed=seed,
            momentum=opt.momentum, weightcost=rc.weightcost, lrate=lrate,
            visible_omit=rc.visible_omit, hid_omit=rc.hid_omit,
            layersizes=rc.layersizes, engine=rc.engine, device=rc.device,
        )
        cv = run_epoch(flags)
        log.info(f"iter {i} lrate={lrate} momentum={opt.momentum} cv_mse={cv:.6f}")
        if rc.halve_on_plateau and cv_hist:
            if cv_hist[-1] - cv < rc.plateau_threshold:
                lrate *= 0.5
                log.info(f"plateau: halving lrate to {lrate}")
        cv_hist.append(cv)
        prev_wts = flags.outwts_file
        seed += 345
        if rc.halve_on_plateau and lrate < rc.early_stop_lrate:
            log.info("early stop: lrate below threshold")
            break
    return cv_hist
