"""Flat key=value configuration mirroring the reference trainer's 24 flags.

Names map 1:1 to the argv keys parsed by Interface::Initial
(the reference's Interface.cc:89-244) so existing recipes translate directly;
defaults follow the reference where it has them (weight-init ranges,
Interface.cc:79-82) and the canonical Perl recipe otherwise.

Own copy of tpu_sednn/config.py, plus one key: `device=cuda|cpu` (default
cuda; the command raises when CUDA is asked for and absent).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Sequence, Tuple


@dataclass
class TrainFlags:
    fea_file: str = ""
    norm_file: str = ""
    targ_file: str = ""
    outwts_file: str = ""
    log_file: str = ""
    initwts_file: str = ""  # "" => random init (Interface.cc:339)
    train_sent_range: str = ""
    cv_sent_range: str = ""
    fea_dim: int = 129
    fea_context: int = 11
    targ_offset: int = 5
    dropoutflag: int = 0
    traincache: int = 102400
    bunchsize: int = 128
    gpu_used: int = 1  # data-parallel ranks (one process each, torchrun)
    init_randem_seed: int = 0
    momentum: float = 0.5
    weightcost: float = 0.0
    lrate: float = 1.0
    visible_omit: float = 0.0
    hid_omit: float = 0.0
    init_randem_weight_min: float = -0.1
    init_randem_weight_max: float = 0.1
    init_randem_bias_min: float = 0.0
    init_randem_bias_max: float = 0.0
    layersizes: Tuple[int, ...] = (1548, 2048, 2048, 2048, 129)
    # extensions beyond the reference's 24 flags:
    # opt-in CV output dump (the reference hardcodes an always-created-but-
    # empty CV_out.txt, BP_GPU.cu:443-473); "" = off
    cv_out_file: str = ""
    # chunk-trainer engine: "auto" = the hand-written CUDA chunk trainer on a
    # CUDA device / the plain torch trainer on the CPU; "resident" | "xla"
    # force one (the JAX package's names, kept so recipes carry over: "xla"
    # is the plain torch trainer here)
    engine: str = "auto"
    # on-device splice/NAT/scatter (1/12th host->device transfer):
    # -1 = auto (CUDA + resident), 0 = off, 1 = on
    device_splice: int = -1
    # opt-in human-readable weight dump (the reference writes weights.txt
    # unconditionally next to outwts_file, Interface.cc:420,435-436); "" = off
    weights_txt: str = ""
    # where the epoch runs: "cuda" (default; raises without a card) or "cpu"
    device: str = "cuda"

    @classmethod
    def from_argv(cls, argv: Sequence[str]) -> "TrainFlags":
        """Parse BPtrain-style `key=value` arguments."""
        self = cls()
        types = {f.name: f.type for f in fields(cls)}
        for arg in argv:
            if "=" not in arg:
                raise ValueError(f"argument '{arg}' is not key=value")
            key, val = arg.split("=", 1)
            if not hasattr(self, key):
                raise ValueError(f"unknown flag '{key}'")
            cur = getattr(self, key)
            if key == "layersizes":
                setattr(self, key, tuple(int(v) for v in val.split(",")))
            elif isinstance(cur, int):
                setattr(self, key, int(val))
            elif isinstance(cur, float):
                setattr(self, key, float(val))
            else:
                setattr(self, key, val)
        return self

    @property
    def numlayers(self) -> int:
        return len(self.layersizes)

    def sent_range(self, which: str) -> Tuple[int, int]:
        raw = self.train_sent_range if which == "train" else self.cv_sent_range
        if "-" not in raw:
            raise ValueError(f"sent range: {raw} format error.")
        a, b = raw.split("-", 1)
        return int(a), int(b)

    def validate(self) -> None:
        expect = self.fea_dim * self.fea_context + self.fea_dim  # NAT input
        if self.layersizes[0] != expect:
            raise ValueError(
                "feadim times (+ noise) context must be equal to layersizes[0] "
                f"({self.layersizes[0]} != {expect})"
            )

    def echo(self) -> str:
        """Parameter echo in the reference's log style (Interface.cc:267-298)."""
        lines = []
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "layersizes":
                v = ",".join(str(s) for s in v)
            lines.append(f"{f.name}: {v}")
        return "\n".join(lines)
