"""The chunk trainer's chain of programmatic dependent launches
(csrc/resident_chunk.cu:train_chunk, csrc/pdl.cuh): the hazard rule that
`ops/resident_chunk.py:early_read_plan` encodes, held against a brute-force
simulation of the chain's reads and writes, and the C interface that carries
the plan to the kernels (with the ctypes bindings of every entry point of
every csrc/*.cu).

The TPU kernel (tpu_sednn/ops/resident_chunk.py:_resident_kernel) trains a
chunk in one launch and has no chain, so there is no JAX counterpart to hold
the plan against; the chunk trainer's arithmetic is held against it in
tests/test_torch_resident.py and tests/test_torch_tensor_core.py.  The chain
itself runs only on the card (chip_smoke.py holds it there bit for bit)."""

import ctypes
import re
from importlib import import_module
from pathlib import Path

import pytest

import tpu_sednn_torch.ops.fused_mlp as fm
import tpu_sednn_torch.ops.resident_chunk as rc

CSRC = Path(rc.__file__).resolve().parent.parent / "csrc"
GROUPS = (rc.EARLY_W, rc.EARLY_DELTA, rc.EARLY_YPREV)
CASES = [(L, accum) for L in (1, 2, 3, 4) for accum in (1, 2, 3)]
N_BUNCHES = 3
# The kernels each product form launches for a layer's forward (direction 0)
# and backward (1): one launch each way in both forms (csrc/fused_mlp.cuh:
# launch_fwd, launch_bwd; each sums its split of K or N inside the kernel),
# which is why one plan serves both chains.
FORMS = {"tc": ("tc_fwd_kernel", "stripe_bwd_kernel<true>"),
         "f32": ("f32_fwd_kernel", "stripe_bwd_kernel<false>")}


def _chain(L: int, accum: int, n_bunches: int, form: str = "tc") -> list:
    """Every launch of one call of the `form` chain, in stream order, with what
    it reads and writes by buffer: `groups` the operand groups it may read
    early (bit -> buffers), `late` what it reads only after its wait,
    `writes`."""
    fwd_kernel, bwd_kernel = FORMS[form]
    launches = []
    for i in range(n_bunches):
        for j in range(accum):
            gi, apply = i * accum + j, j == accum - 1

            def inp(l):  # a layer's input: the tile of the chunk, or the layer below's output
                return ("x", gi) if l == 0 else ("y", l - 1)

            for l in range(L):
                launches.append(dict(
                    kernel=fwd_kernel, dir=0, layer=l, groups={rc.EARLY_W: {("W", l), ("b", l)}},
                    late={inp(l)}, writes={("y", l)} | ({"dedx_a"} if l == L - 1 else set())))
            cur, other = "dedx_a", "dedx_b"
            for l in range(L - 1, -1, -1):
                writes = {("D", l), ("db", l)} | ({("W", l), ("b", l)} if apply else set())
                launches.append(dict(
                    kernel=bwd_kernel, dir=1, layer=l, late={cur},
                    groups={rc.EARLY_W: {("W", l), ("b", l)}, rc.EARLY_DELTA: {("D", l), ("db", l)},
                            rc.EARLY_YPREV: {inp(l)}},
                    writes=writes | ({other} if l > 0 else set())))
                cur, other = other, cur
    for n, launch in enumerate(launches):
        launch["first"] = n == 0
    return launches


def _simulated_plan(L: int, accum: int, n_bunches: int, form: str = "tc") -> list:
    """The plan the rule gives on the simulated chain: for each (direction,
    layer, first) the groups that no launch of that kind finds written by
    the launch just before it (0 where the call has no such launch)."""
    allowed = {}
    launches = _chain(L, accum, n_bunches, form)
    for n, launch in enumerate(launches):
        ok = 0
        if n > 0:
            for bit, bufs in launch["groups"].items():
                if not bufs & launches[n - 1]["writes"]:
                    ok |= bit
        key = rc.plan_index(launch["dir"], launch["layer"], launch["first"], L)
        allowed[key] = allowed.get(key, ok) & ok
    return [allowed.get(k, 0) for k in range(4 * L)]


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("L,accum", CASES)
def test_plan_matches_simulated_chain(L, accum, form):
    """The one plan is the rule's on the chain of either product form: the
    same launches (2 L a tile, every one after the call's first a dependent
    one), so the same flags."""
    chain = _chain(L, accum, N_BUNCHES, form)
    assert len(chain) == 2 * L * accum * N_BUNCHES
    assert {c["kernel"] for c in chain} == set(FORMS[form])
    assert rc.early_read_plan(L, accum) == _simulated_plan(L, accum, N_BUNCHES, form)


def test_both_product_forms_take_the_plan():
    """The chunk trainer gates no dependent launch on the product form, and the
    layer launchers hand a dependent launch to either form."""
    src = (CSRC / "resident_chunk.cu").read_text()
    assert "const bool pdl = plan != nullptr && !*first;" in src  # a forward
    assert "const bool pdl = plan != nullptr;  // a forward came first" in src  # a backward
    assert "tc && plan" not in src
    fm_src = (CSRC / "fused_mlp.cuh").read_text()
    for form in ("tc", "f32"):  # launch_fwd (the tensor-core form also takes x's copy)
        assert re.search(rf"launch_{form}_fwd\(x, [^;]*\bw, M, K, N, in_mask, epi, plan_rows, "
                         rf"pdl, early, stream\)", fm_src)
    for tc in ("true", "false"):  # launch_bwd
        assert re.search(rf"launch_bwd_form<{tc}>\([^;]*\bpdl, early,\s*stream\)", fm_src)
    assert "tc && pdl" not in fm_src


@pytest.mark.parametrize("L,accum", CASES)
def test_no_early_read_of_the_launch_before(L, accum):
    """Applied to the chain, the plan lets no launch read early what the
    launch just before it wrote, nor a group it does not read."""
    plan = rc.early_read_plan(L, accum)
    last_writer = {}
    for n, launch in enumerate(_chain(L, accum, N_BUNCHES)):
        flags = plan[rc.plan_index(launch["dir"], launch["layer"], launch["first"], L)]
        assert flags & ~sum(launch["groups"]) == 0
        for bit in GROUPS:
            if flags & bit:
                for buf in launch["groups"][bit]:
                    assert last_writer.get(buf, -1) < n - 1, (n, buf)
        for buf in launch["writes"]:
            last_writer[buf] = n


@pytest.mark.parametrize("L,accum", CASES)
def test_first_launch_of_a_call_reads_nothing_early(L, accum):
    plan = rc.early_read_plan(L, accum)
    first = _chain(L, accum, N_BUNCHES)[0]
    assert (first["dir"], first["layer"]) == (0, 0)
    for d in (0, 1):
        for l in range(L):
            assert plan[rc.plan_index(d, l, True, L)] == 0


def test_plan_at_the_flagship_depth():
    """Four layers, whole bunches: W early for every forward but the first
    layer's, and W, delta and yprev for every backward (so the chain does
    overlap)."""
    L, plan = 4, rc.early_read_plan(4, 1)
    for l in range(L):
        assert plan[rc.plan_index(0, l, False, L)] == (rc.EARLY_W if l > 0 else 0)
        assert plan[rc.plan_index(1, l, False, L)] == rc.EARLY_W | rc.EARLY_DELTA | rc.EARLY_YPREV


@pytest.mark.parametrize("L,accum", [(0, 1), (4, 0)])
def test_plan_refuses_an_empty_chain(L, accum):
    with pytest.raises(ValueError):
        rc.early_read_plan(L, accum)


def _ctype(decl: str):
    """The ctypes type of a C parameter or return type of csrc/*.cu."""
    decl = " ".join(decl.replace("*", " * ").split())
    if decl.endswith("* const *") or decl.endswith("* *"):
        return ctypes.POINTER(ctypes.c_void_p)
    if decl.endswith("*"):
        base = " ".join(decl[:-1].replace("const", "").split())
        return {"int": ctypes.POINTER(ctypes.c_int),
                "long long": ctypes.POINTER(ctypes.c_longlong),
                "unsigned": ctypes.POINTER(ctypes.c_uint),
                "unsigned char": ctypes.c_char_p}.get(base, ctypes.c_void_p)
    return {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float,
            "long long": ctypes.c_longlong, "void": None}[decl]


# the C sources and their bindings: csrc/<name>.cu -> ops/<name>.py's _c_api()
C_APIS = {name: import_module(f"tpu_sednn_torch.ops.{name}")._c_api()
          for name in ("resident_chunk", "fused_mlp", "lstm_cell", "stft_lps", "rank_sum",
                       "dropout_mask", "sr_update")}


def _c_api(name: str):
    """(argtypes, restype) the port binds to entry point `name`."""
    return next(api[name] for api in C_APIS.values() if name in api)


def _c_signature(name: str):
    """(restype, [(type, name)]) of the entry point in its csrc/<name>.cu."""
    source = next(src for src, api in C_APIS.items() if name in api)
    src = (CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" ([\w ]+?) ' + name + r"\(([^)]*)\)", src)
    assert m, name
    params = []
    for p in filter(str.strip, m.group(2).split(",")):
        p = " ".join(p.split())
        cut = max(p.rfind(" "), p.rfind("*"))
        params.append((p[:cut + 1].strip(), p[cut + 1:].strip()))
    return m.group(1), params


@pytest.mark.parametrize("name", [n for api in C_APIS.values() for n in sorted(api)])
def test_argtypes_match_the_c_entry_points(name):
    restype, params = _c_signature(name)
    argtypes, want_restype = _c_api(name)
    assert [_ctype(t) for t, _ in params] == argtypes
    assert _ctype(restype) is want_restype


def test_argtypes_carry_the_plan():
    _, params = _c_signature("resident_chunk_train")
    names = [n for _, n in params]
    i = names.index("plan")
    assert " ".join(params[i][0].split()) == "const int*"
    assert rc._c_api()["resident_chunk_train"][0][i] is ctypes.POINTER(ctypes.c_int)
    assert names[i - 1:i + 2] == ["bf16", "plan", "stream_"]


def test_plan_bits_and_index_match_the_kernels():
    """pdl.cuh's bits and resident_chunk.cu's index are the plan's."""
    pdl = (CSRC / "pdl.cuh").read_text()
    for name, bit in (("kEarlyW", rc.EARLY_W), ("kEarlyDelta", rc.EARLY_DELTA),
                      ("kEarlyYprev", rc.EARLY_YPREV)):
        assert re.search(rf"constexpr int {name} = {bit};", pdl), name
    src = (CSRC / "resident_chunk.cu").read_text()
    assert "return plan[(direction * L + l) * 2];" in src
    assert rc.plan_index(1, 2, False, 4) == (1 * 4 + 2) * 2
