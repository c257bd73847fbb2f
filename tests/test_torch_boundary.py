"""Import boundary of the port: no module of tpu_sednn_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package tpu_sednn — checked on
the exact top-level module name, since "tpu_sednn_torch" itself begins with
"tpu_sednn"."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "tpu_sednn"}
FILES = sorted((ROOT / "tpu_sednn_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = _top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_checker_sees_the_difference(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import tpu_sednn_torch.io\nfrom . import x\nfrom tpu_sednn.io import wav\n"
                   "import numpy, jax.numpy as jnp\n")
    assert _top_level_imports(src) & FORBIDDEN == {"tpu_sednn", "jax"}
    assert len(FILES) > 15 and (ROOT / "chip_smoke.py") in FILES
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"tpu_sednn_torch/ops/sr_update.py", "tpu_sednn_torch/ops/dropout_mask.py",
            "tpu_sednn_torch/utils/checkpoint.py", "tpu_sednn_torch/utils/profiling.py"} <= names


@pytest.mark.parametrize("name", ["sr_update", "dropout_mask", "fused_mlp", "resident_chunk",
                                  "stft_lps", "rank_sum"])
def test_kernel_sources_are_listed_with_their_headers(name):
    """Every csrc/<name>.cu is in KERNEL_SOURCES, and its library's name
    hashes the headers it includes (so an edited header rebuilds it)."""
    from tpu_sednn_torch.ops import KERNEL_SOURCES, _build

    assert name in KERNEL_SOURCES
    assert {p.stem for p in _build.SRC_DIR.glob("*.cu")} == set(KERNEL_SOURCES)
    files = {p.name for p in _build.source_files(name)}
    want = {"sr_update": {"sr_round.cuh", "philox.cuh", "vec4.cuh"},
            "dropout_mask": {"philox.cuh"},
            "fused_mlp": {"fused_mlp.cuh", "mma_bf16.cuh", "pdl.cuh", "sr_round.cuh",
                          "philox.cuh", "vec4.cuh"},
            "resident_chunk": {"fused_mlp.cuh", "mma_bf16.cuh", "pdl.cuh", "sr_round.cuh",
                               "philox.cuh", "vec4.cuh"},
            "stft_lps": set(), "rank_sum": set()}[name]
    assert files == want | {f"{name}.cu"}
    assert _build.library_path(name).parent == _build.BUILD_DIR
