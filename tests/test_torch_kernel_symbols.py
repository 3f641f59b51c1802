"""The Hopper kernels' names against the profiler's kernel groups.

tools/profile_gpt.py charges a kernel to "flash forward (ours)" or "flash
backward (ours)" by a substring of the symbol a trace reports. So every
__global__ kernel of the flash sources must land in its group, every
library's kernels must carry the library's name (a trace then tells two
libraries that share a body apart), and no header may define a kernel (a
header is compiled into several libraries).
"""

import os
import re

import pytest
import torch

from paddle_tpu_torch.tools import profile_gpt
from torch_port_common import one_torch_thread  # noqa: F401


CSRC = os.path.join(os.path.dirname(os.path.dirname(profile_gpt.__file__)),
                    "ops", "csrc")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
FWD = ("flash_fwd.cu", "flash_small_fwd.cu")
BWD = ("flash_bwd_dkv.cu", "flash_bwd_dq.cu", "flash_small_bwd.cu")


def _kernels(fname):
    with open(os.path.join(CSRC, fname)) as f:
        return _GLOBAL.findall(f.read())


@pytest.mark.parametrize("src", FWD + BWD)
def test_flash_kernels_land_in_their_group(src):
    names = _kernels(src)
    assert names
    group = "flash forward (ours)" if src in FWD else "flash backward (ours)"
    for n in names:
        # a kernel's name as torch.profiler reports it: the demangled symbol
        sym = (f"void (anonymous namespace)::{n}<__nv_bfloat16, 64>"
               f"(__nv_bfloat16 const*, float const*, int, float)")
        assert profile_gpt._train_group(sym, "fused_attention", False) \
            == group
        assert profile_gpt._train_group(sym, "fused_attention_grad",
                                        False) == group
        if src in FWD:
            assert profile_gpt._group(sym) == "flash attention (ours)"


@pytest.mark.parametrize("src", sorted(
    f for f in os.listdir(CSRC) if f.endswith(".cu")))
def test_kernels_carry_their_library_name(src):
    names = _kernels(src)
    assert names
    assert all(n.startswith(src[:-len(".cu")]) for n in names), names


def test_kernel_names_are_unique_and_headers_define_none():
    seen = {}
    for f in sorted(os.listdir(CSRC)):
        for n in _kernels(f):
            assert f.endswith(".cu"), (f, n)
            assert n not in seen, (n, f, seen.get(n))
            seen[n] = f


@pytest.mark.parametrize("src", ("flash_bwd_dkv.cu", "flash_bwd_dq.cu"))
def test_tensor_core_backward_kernels_are_counted(src):
    """The tiled backward pair's tensor-core kernels (`<library>_kernel_tc`)
    sit beside the FMA ones, land in the flash backward group, and keep
    their own name in the per-kernel flash breakdown."""
    lib = src[:-len(".cu")]
    names = _kernels(src)
    assert f"{lib}_kernel" in names and f"{lib}_kernel_tc" in names
    sym = (f"void (anonymous namespace)::{lib}_kernel_tc<64>(float const*, "
           "float const*, int, float)")
    assert profile_gpt._train_group(sym, "fused_attention_grad", False) \
        == "flash backward (ours)"
    assert re.search(r"flash_\w+", sym).group(0) == f"{lib}_kernel_tc"


@pytest.mark.parametrize("kernel,args", [
    ("flash_fwd_kernel_tc", "<64>(float const*, float const*, int, float)"),
    ("flash_fwd_kernel_wgmma", "<64>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, int, float)")])
def test_tensor_core_forward_kernels_are_counted(kernel, args):
    """The tiled forward's tensor-core kernels (fp32 split TF32,
    `flash_fwd_kernel_tc`; bf16 wgmma, `flash_fwd_kernel_wgmma`) sit beside
    the FMA one, land in the flash forward group of a train step and in
    the flash attention group of a request, and keep their own name in the
    per-kernel flash breakdown."""
    assert {"flash_fwd_kernel", kernel} <= set(_kernels("flash_fwd.cu"))
    sym = f"void (anonymous namespace)::{kernel}{args}"
    assert profile_gpt._train_group(sym, "fused_attention", False) \
        == "flash forward (ours)"
    assert profile_gpt._group(sym) == "flash attention (ours)"
    assert re.search(r"flash_\w+", sym).group(0) == kernel
