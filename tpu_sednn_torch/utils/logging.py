"""Structured logging — replaces the reference's append-only epoch log file
(Interface.cc fp_log; the Perl recipe regex-scrapes it for CV error,
finetune_...NAT.pl:108-123).

Writes human-readable lines (same shape as the reference's so existing
log-scraping recipes keep working) and optionally machine-readable JSONL
metrics.  In multi-process runs only process 0 writes.  Own copy of
tpu_sednn/utils/logging.py.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Optional


class Logger:
    _DEFAULT = object()  # sentinel: stream=None means "silent"

    def __init__(
        self,
        log_path: Optional[str] = None,
        metrics_path: Optional[str] = None,
        stream: Any = _DEFAULT,
        is_host0: bool = True,
    ):
        self.is_host0 = is_host0
        self._fp = open(log_path, "a") if (log_path and is_host0) else None
        self._mfp = open(metrics_path, "a") if (metrics_path and is_host0) else None
        self._stream = sys.stderr if stream is Logger._DEFAULT else stream

    def info(self, msg: str) -> None:
        if not self.is_host0:
            return
        line = msg if msg.endswith("\n") else msg + "\n"
        if self._fp is not None:
            self._fp.write(line)
            self._fp.flush()
        if self._stream is not None:
            self._stream.write(line)

    def metrics(self, **kv: Any) -> None:
        if not self.is_host0 or self._mfp is None:
            return
        kv.setdefault("ts", time.time())
        self._mfp.write(json.dumps(kv) + "\n")
        self._mfp.flush()

    def close(self) -> None:
        for fp in (self._fp, self._mfp):
            if fp is not None:
                fp.close()
