"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
its own shared library under `tpu_sednn_torch/build/`, then loaded with
ctypes (no PyTorch headers, so a build takes seconds).  The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt on next use.  nvcc's output, with `-Xptxas -v`'s register and
shared-memory report, is kept beside the library as `<name>-<hash>.log`.

Nothing here runs at import: the CPU-only test machines have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library lives for its current source and flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists; -> the library's
    path.  Raises with nvcc's output if the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = library_path(name)
    if path.exists():
        return path
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def load(name: str) -> ctypes.CDLL:
    """Load the library of csrc/<name>.cu, built first if needed (callers
    keep the handle: ops/<name>.py caches it and declares its argtypes)."""
    return ctypes.CDLL(str(build(name)))
