"""The port's measuring tools on the CPU: the profiler's kernel categories,
the build's kept ptxas report, and chip_smoke.py's reading of it."""

import importlib.util
from pathlib import Path

import pytest

from slowfast_tpu_torch import profile_eval
from slowfast_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name, category", [
    ("void pooled_attention_kernel<__nv_bfloat16, false, false, 6>(__nv_bfloat16 const*, ",
     "attention_core"),
    ("void exact_fwd_kernel<6>(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 co",
     "attention_core"),
    ("void attention_bwd_rows_kernel<__nv_bfloat16, false>(__nv_bfloat16 const*, ",
     "attention_bwd"),
    ("void exact_bwd_rows_kernel<8>(__nv_bfloat16 const*, __nv_bfloat16 const*, ",
     "attention_bwd"),
    ("void exact_bwd_keys_kernel<8, 6>(__nv_bfloat16 const*, __nv_bfloat16 const*, ",
     "attention_bwd"),
    ("sum_slices_kernel(float const*, __nv_bfloat16*, long, int)", "attention_bwd"),
    ("void flash_bwd_rows_kernel<false, 8>(__nv_bfloat16 const*, __nv_bfloat16 const*, ",
     "attention_bwd"),
    ("void flash_bwd_rows_kernel<true, 9>(__nv_bfloat16 const*, __nv_bfloat16 const*, ",
     "attention_bwd"),
    ("void flash_bwd_keys_kernel<false, 8, 6>(__nv_bfloat16 const*, __nv_bfloat16 const*, ",
     "attention_bwd"),
    ("void flash_bwd_keys_kernel<true, 9, 6>(__nv_bfloat16 const*, __nv_bfloat16 const*, ",
     "attention_bwd"),
    ("void fused_bwd_keys_kernel<__nv_bfloat16, 6>(__nv_bfloat16 const*, ", "attention_bwd"),
    ("void at::native::(anonymous namespace)::conv_depthwise3d_cuda_backward_input_kernel<",
     "conv"),
])
def test_profile_categories(name, category):
    """Every attention kernel of the port lands in an attention category."""
    assert profile_eval.category(name) == category


class _FakeNvcc:
    returncode = 0

    def communicate(self):
        return b"ptxas info    : Used 12 registers\n", None


def test_build_keeps_the_ptxas_report(tmp_path):
    """A finished build moves the library into place and keeps nvcc's
    output beside it, where ``log_path`` finds it."""
    tmp, out = tmp_path / "libx.123.tmp", tmp_path / "libx-abc.so"
    tmp.write_bytes(b"library")
    assert _build._finish("x", _FakeNvcc(), tmp, out) == out
    assert out.read_bytes() == b"library"
    assert out.with_suffix(".log").read_bytes() == b"ptxas info    : Used 12 registers\n"
    assert "-v" in _build.NVCC_FLAGS
    assert _build.log_path("preprocess") == _build._lib_path("preprocess").with_suffix(".log")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z17sum_slices_kernelPKfP13__nv_bfloat16xi' for 'sm_90a'
ptxas info    : Function properties for _Z17sum_slices_kernelPKfP13__nv_bfloat16xi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21exact_bwd_keys_kernelILi12ELi8EEvPK13__nv_bfloat16S2_S2_S2_PKfS4_S4_PfS5_iiiiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z21exact_bwd_keys_kernelILi12ELi8EEvPK13__nv_bfloat16S2_S2_S2_PKfS4_S4_PfS5_iiiiiiiiiii
    312 bytes stack frame, 308 bytes spill stores, 308 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16exact_fwd_kernelILi6EEvPK13__nv_bfloat16S2_S2_PS0_iiiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z16exact_fwd_kernelILi6EEvPK13__nv_bfloat16S2_S2_PS0_iiiiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 189 registers, used 1 barriers, 424 bytes cmem[0]
"""


def test_chip_smoke_reads_ptxas_usage():
    """The build phase's reading of ptxas's report: registers and spill
    bytes by kernel name with its template arguments."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.ptxas_usage(PTXAS_LOG) == {
        "sum_slices_kernel": {"spill_bytes": 0, "registers": 32},
        "exact_bwd_keys_kernel<12, 8>": {"spill_bytes": 308, "registers": 255},
        "exact_fwd_kernel<6>": {"spill_bytes": 0, "registers": 189},
    }


def test_chip_smoke_reads_ptxas_bool_template_arguments():
    """Kernels templated on a bool (the constant-shift backward's read or
    recompute mode) keep one entry per instance."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    log = "".join(
        f"ptxas info    : Function properties for _Z21flash_bwd_keys_kernelIL{flag}ELi8ELi6EEvPK13"
        f"__nv_bfloat16S2_S2_S2_S2_PKfPfS5_iiiiiiiiiii\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers, 440 bytes cmem[0]\n"
        for flag, spill, regs in (("b0", 4, 255), ("b1", 0, 230)))
    assert chip_smoke.ptxas_usage(log) == {
        "flash_bwd_keys_kernel<false, 8, 6>": {"spill_bytes": 4, "registers": 255},
        "flash_bwd_keys_kernel<true, 8, 6>": {"spill_bytes": 0, "registers": 230},
    }
