"""Build and load the hand-written CUDA kernels under `ops/csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a
plain C interface and loaded with `ctypes` — no PyTorch headers, so a
build takes seconds. Libraries go to `paddle_tpu_torch/ops/_build/`
(listed in `.gitignore`), named by a hash of the source and flags, so an
edited source rebuilds and an unchanged one is reused. Nothing here runs
at import time: the first launch of a kernel builds it, and
`build_all()` starts one `nvcc` per source at once.

`on_cuda` and `launch` are the launch path of the kernels whose C entry
`<name>_launch(pointers..., integers..., stream)` returns a cudaError_t
(the spikes' kernels; the flash kernels have their own signature).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

__all__ = ["KERNEL_SOURCES", "build_all", "load_library", "nvcc_path",
           "on_cuda", "launch"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

# kernel library name -> source file under csrc/
KERNEL_SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_small_fwd": "flash_small_fwd.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
    "flash_small_bwd": "flash_small_bwd.cu",
    "residual_ln_fwd": "residual_ln_fwd.cu",
    "residual_ln_bwd": "residual_ln_bwd.cu",
    "conv_bn_stats": "conv_bn_stats.cu",
    "bn_apply_relu": "bn_apply_relu.cu",
    "headslice_gram": "headslice_gram.cu",
}

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # name -> nvcc's output (ptxas -v lines)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.isfile(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "paddle_tpu_torch build on a machine with the "
                           "CUDA toolkit")
    return found


def _target(name: str) -> str:
    """Library path keyed by the source, every shared header and the
    flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for fname in [KERNEL_SOURCES[name]] + headers:
        with open(os.path.join(_CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"{name}-{h.hexdigest()[:16]}.so")


def _command(name: str, out: str) -> List[str]:
    return [nvcc_path()] + _FLAGS + ["-o", out,
                                     os.path.join(_CSRC,
                                                  KERNEL_SOURCES[name])]


def build_all(names=None) -> Dict[str, float]:
    """Compile every missing kernel library, one nvcc per source, all
    started together. Returns {name: seconds} for the ones built."""
    names = list(names or KERNEL_SOURCES)
    os.makedirs(_BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        # nvcc's output goes to a file, so no process waits on a full pipe
        # and each source's time is its own
        logf = open(f"{tmp}.log", "w+")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=logf,
                                        stderr=subprocess.STDOUT),
                       logf, tmp, out, time.perf_counter())
    took = {}
    failed = []
    while len(took) < len(procs):
        for name, (p, logf, tmp, out, t0) in procs.items():
            if name in took or p.poll() is None:
                continue
            took[name] = time.perf_counter() - t0
            logf.seek(0)
            build_logs[name] = log = logf.read()
            logf.close()
            os.remove(logf.name)
            if p.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return took


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _target(name)
            if not os.path.exists(out):
                build_all([name])
            lib = ctypes.CDLL(out)
            _libs[name] = lib
        return lib


_INT_TYPES = {"i": ctypes.c_int, "q": ctypes.c_longlong}


@functools.lru_cache(maxsize=None)
def _launch_fn(name: str, n_ptrs: int, int_types: str):
    fn = getattr(load_library(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
        _INT_TYPES[t] for t in int_types] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def on_cuda(name: str, x) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    caller runs the plain version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def launch(name: str, tensors, ints, int_types: str = "") -> None:
    """Call `<name>_launch` with the pointers of `tensors`, then `ints`
    (C int each, or per `int_types`: "i" int, "q" long long), then the
    current stream of the tensors' device; raise if the launch was
    refused."""
    import torch
    fn = _launch_fn(name, len(tensors), int_types or "i" * len(ints))
    device = tensors[0].device
    with torch.cuda.device(device):
        err = fn(*[t.data_ptr() for t in tensors], *ints,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err} (ints {list(ints)})")
