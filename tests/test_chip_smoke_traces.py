"""chip_smoke.py's reading of the port's kernels from a torch.profiler trace,
on the CPU: the kernel names it knows are the sources' kernels, a trace's
names are read without namespace or template arguments (but for the forms
of KERNEL_FORMS: the tensor-core forward that reads its input's bfloat16
copy), and a count is read again until it holds what was launched, short
only by the records the tracer loses.  The traces themselves are taken on
the card."""
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import chip_smoke

CSRC = Path(__file__).resolve().parents[1] / "tpu_sednn_torch" / "csrc"


def _prof(*events):
    """A stand-in for a torch.profiler trace: (key, count, device type)."""
    return SimpleNamespace(key_averages=lambda: [
        SimpleNamespace(key=k, count=n, device_type=d) for k, n, d in events])


def test_port_kernels_are_the_sources_kernels():
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    found = {m.group(1) for f in CSRC.glob("*.cu*") for m in pattern.finditer(f.read_text())}
    assert found == set(chip_smoke.PORT_KERNELS)


@pytest.mark.parametrize("key, name", [
    ("void sednn::stripe_bwd_kernel<true, float, float, 64>(CUtensorMap_st, CUtensorMap_st)",
     "stripe_bwd_kernel"),
    ("void sednn::tc_fwd_kernel<float, 128>(CUtensorMap_st, CUtensorMap_st, float const*)",
     "tc_fwd_kernel"),
    ("sednn::bf16_copy_kernel(float const*, unsigned short*, int, int, int, bool)",
     "bf16_copy_kernel"),
    ("void (anonymous namespace)::input_mask_bits_kernel(unsigned int*, int, int)",
     "input_mask_bits_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >(int)",
     "vectorized_elementwise_kernel"),
    ("rank_sum_kernel", "rank_sum_kernel"),
    ("void sednn::tc_fwd_kernel<float, 128, float>(CUtensorMap_st, CUtensorMap_st, float const*)",
     "tc_fwd_kernel"),
    ("void sednn::tc_fwd_kernel<unsigned short, 64, float>(CUtensorMap_st, CUtensorMap_st)",
     "tc_fwd_kernel"),
    ("void sednn::tc_fwd_kernel<float, 128, unsigned short>(CUtensorMap_st, CUtensorMap_st, "
     "unsigned short const*, float const*)", "tc_fwd_kernel_xbf16"),
    ("void sednn::tc_fwd_kernel<unsigned short, 64, unsigned short>(CUtensorMap_st)",
     "tc_fwd_kernel_xbf16"),
    ("void sednn::f32_fwd_kernel<unsigned short, true>(CUtensorMap_st, CUtensorMap_st)",
     "f32_fwd_kernel"),
])
def test_trace_counts_name_a_kernel_by_its_own_name(key, name):
    got = chip_smoke._trace_counts(_prof((key, 3, DeviceType.CUDA), (key, 2, DeviceType.CUDA),
                                         ("aten::mm", 7, DeviceType.CPU)))
    assert got == {name: 5}


def test_kernel_forms_are_forms_of_port_kernels():
    assert all(kernel in chip_smoke.PORT_KERNELS and form not in chip_smoke.PORT_KERNELS
               for form, (kernel, _) in chip_smoke.KERNEL_FORMS.items())


def test_port_counts_every_kernel_and_refuses_others():
    want = chip_smoke._port(update_kernel=4)
    assert set(want) == set(chip_smoke.PORT_KERNELS) | set(chip_smoke.KERNEL_FORMS)
    assert want["update_kernel"] == 4 and sum(want.values()) == 4
    with pytest.raises(RuntimeError):
        chip_smoke._port(reduce_dedy_kernel=1)


@pytest.mark.parametrize("fwd, L, n, want", [
    ("tc_fwd_kernel", 4, 3, {"tc_fwd_kernel": 3, "tc_fwd_kernel_xbf16": 9}),
    ("tc_fwd_kernel", 1, 5, {"tc_fwd_kernel": 5, "tc_fwd_kernel_xbf16": 0}),
    ("f32_fwd_kernel", 4, 3, {"f32_fwd_kernel": 12}),
])
def test_chain_forwards_split_the_tensor_core_forms(fwd, L, n, want):
    """The chunk trainer's tensor-core forwards: layer 0 rounds float32 x, the
    L - 1 above it read their input's copy; the float32 form has one form."""
    assert chip_smoke._chain_forwards(fwd, L, n) == want
    assert set(chip_smoke._port(**want)) >= set(want)


@pytest.mark.parametrize("got, want, reads", [
    ({"tc_fwd_kernel": 12, "bf16_copy_kernel": 0}, {"tc_fwd_kernel": 12, "bf16_copy_kernel": 0},
     True),
    ({"tc_fwd_kernel": 11}, {"tc_fwd_kernel": 12}, False),  # exact below 50 launches
    ({"tc_fwd_kernel": 13}, {"tc_fwd_kernel": 12}, False),  # a lost record never adds one
    ({"stripe_bwd_kernel": 3728}, {"stripe_bwd_kernel": 3740}, True),
    ({"stripe_bwd_kernel": 3660}, {"stripe_bwd_kernel": 3740}, False),
    ({"stripe_bwd_kernel": 3740, "bf16_copy_kernel": 1},
     {"stripe_bwd_kernel": 3740, "bf16_copy_kernel": 0}, False),
    ({}, {"tc_fwd_kernel": 0, "update_kernel": 0}, True),
])
def test_reads_allows_only_lost_records(got, want, reads):
    assert chip_smoke._reads(got, want) == reads


@pytest.mark.parametrize("reads, tries, calls, held", [
    ([{"tc_fwd_kernel": 12}], 5, 1, True),
    ([{}, {"tc_fwd_kernel": 11}, {"tc_fwd_kernel": 12}], 5, 3, True),
    ([{}, {}, {}], 3, 3, False),
    ([{"tc_fwd_kernel": 12, "bf16_copy_kernel": 1}] * 2, 2, 2, False),
])
def test_until_counts_reads_again_until_held(reads, tries, calls, held):
    """A lost record only lowers a count: a short read is taken again, and
    a kernel that should be absent is read only from a trace that holds the
    others' launches."""
    seen = []

    def run():
        seen.append(len(seen))
        return len(seen), reads[len(seen) - 1]

    want = {"tc_fwd_kernel": 12, "bf16_copy_kernel": 0}
    got, w, value = chip_smoke._until_counts(run, want, tries)
    assert len(seen) == calls and value == calls and w == want
    assert chip_smoke._reads(got, want) == held
    assert got == {k: reads[calls - 1].get(k, 0) for k in want}


def test_until_counts_takes_want_from_the_value():
    got, w, value = chip_smoke._until_counts(lambda: (3, {"update_kernel": 12}),
                                             lambda v: {"update_kernel": 4 * v})
    assert got == w == {"update_kernel": 12} and value == 3
