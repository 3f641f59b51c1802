"""Compile-on-demand loader for the port's native C++ libraries.

Copy of `paddle_tpu/native_loader.py`. The port's native component (the
pskv parameter server, `distributed/csrc/pskv.cc`) is plain C++ with an
extern "C" API, built with g++ at first use and bound with ctypes. Its
caller names the library by a hash of the source and builds it into
`paddle_tpu_torch/ops/_build/`, beside the CUDA kernels: nothing is
written next to a source, and nothing under the JAX package's `native/`
is loaded or built.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_build_lock = threading.Lock()
# every build's flags, besides the optimisation level (-O2; -O1 with a
# sanitizer) and the sanitizer's own
CXX_FLAGS = ("-std=c++17", "-shared", "-fPIC", "-pthread")


def _sanitize_flags():
    """PADDLE_TPU_SANITIZE=address|thread|undefined|leak[,...] — the
    reference's CMake SANITIZER_TYPE knob (CMakeLists.txt:77) for the
    native components: race/memory-error detection builds of the C++
    pserver and datafeed (SURVEY §5 sanitizers row). Sanitized builds
    get a distinct .so suffix so they never shadow the release build."""
    kinds = os.environ.get("PADDLE_TPU_SANITIZE", "").strip()
    if not kinds:
        return [], ""
    # g++-supported set ('memory'/MSan is clang-only)
    allowed = {"address", "thread", "undefined", "leak"}
    picked = [k.strip() for k in kinds.split(",") if k.strip()]
    bad = [k for k in picked if k not in allowed]
    if bad:
        raise ValueError(
            f"PADDLE_TPU_SANITIZE: unknown sanitizer(s) {bad}; "
            f"choose from {sorted(allowed)} (g++-supported)")
    exclusive = {"address", "thread", "leak"} & set(picked)
    if len(exclusive) > 1:
        raise ValueError(
            f"PADDLE_TPU_SANITIZE: {sorted(exclusive)} are mutually "
            "exclusive — pick one (undefined combines with any)")
    flags = [f"-fsanitize={k}" for k in picked] + [
        "-g", "-fno-omit-frame-pointer"]
    return flags, "." + "_".join(picked)


def compile_and_load(src: str, so: str) -> ctypes.CDLL:
    """Build `so` from `src` if missing or stale (source newer), then dlopen
    it; the directory of `so` is made if absent. A missing source next
    to a prebuilt .so is fine (deployment without sources). Raises
    RuntimeError with the compiler's stderr on failure."""
    san_flags, san_suffix = _sanitize_flags()
    if san_suffix:
        so = so + san_suffix
    with _build_lock:
        needs = not os.path.exists(so) or (
            os.path.exists(src)
            and os.path.getmtime(so) < os.path.getmtime(src))
        if needs:
            if not os.path.exists(src):
                raise FileNotFoundError(
                    f"native library {so} missing and source {src} absent")
            os.makedirs(os.path.dirname(so) or ".", exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"  # unique per building process
            opt = ["-O1"] if san_flags else ["-O2"]  # -O1: usable stacks
            proc = subprocess.run(
                ["g++", *opt, *CXX_FLAGS] + san_flags + ["-o", tmp, src],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build of {os.path.basename(src)} failed:\n"
                    f"{proc.stderr}")
            os.replace(tmp, so)  # atomic vs concurrent processes
        return ctypes.CDLL(so)
