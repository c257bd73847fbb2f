"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
its own shared library under `tpu_sednn_torch/build/`, then loaded with
ctypes (no PyTorch headers, so a build takes seconds).  The library's file
name carries a hash of the source, of every `csrc/` file it includes
(`#include "..."`, followed recursively) and of the flags, so an edited
source or shared header is rebuilt on next use.  nvcc's output, with
`-Xptxas -v`'s register and shared-memory report, is kept beside the library
as `<name>-<hash>.log`.  `build_all` starts one nvcc per source, all together.

Nothing here runs at import: the CPU-only test machines have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

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


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> List[Path]:
    """csrc/<name>.cu and every csrc/ file it includes with quotes, directly
    or through another, in a fixed order."""
    seen: List[Path] = []
    todo = [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            cand = (path.parent / inc).resolve()
            if cand.is_file() and SRC_DIR in cand.parents:
                todo.append(cand)
    return [seen[0]] + sorted(seen[1:])


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu's library lives for its current sources and flags."""
    h = hashlib.sha256()
    for path in source_files(name):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, path: Path):
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, path: Path, tmp: Path, proc) -> Path:
    out, _ = proc.communicate()
    path.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return path


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every csrc/<name>.cu whose library is missing, one nvcc each,
    all started together; -> {name: library path}.  Raises with nvcc's output
    if a build fails (after the others have ended)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    running = {name: _start(name, path) for name, path in paths.items() if not path.exists()}
    errors = []
    for name, (tmp, proc) in running.items():
        try:
            _finish(name, paths[name], tmp, proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists; -> the library's
    path.  Raises with nvcc's output if the build fails."""
    return build_all([name])[name]


def load(name: str, api: Dict[str, tuple]) -> ctypes.CDLL:
    """Load the library of csrc/<name>.cu, built first if needed (callers
    keep the handle: ops/<name>.py caches it).  api: the entry points' name
    -> (argtypes, restype), ops/<name>.py's _c_api(), declared on the handle."""
    lib = ctypes.CDLL(str(build(name)))
    for entry, (argtypes, restype) in api.items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = restype
    return lib
