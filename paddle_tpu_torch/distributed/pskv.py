"""ctypes bindings for the pskv parameter server
(`distributed/csrc/pskv.cc`, the port's copy of the JAX package's
native/pskv/pskv.cc).

Copy of `paddle_tpu/distributed/pskv.py`. The C++ library is compiled on
demand with g++ (plain extern "C" + ctypes) into `paddle_tpu_torch/ops/
_build/pskv-<hash>.so`, named by a hash of the source and the build
flags, as ops/cuda_build.py names the kernels. The wire protocol is the
JAX server's, byte for byte: a client of either package talks to a server
of the other. `pull_sparse(..., out=)` and `pull_dense(..., out=)` may
write into a caller's buffer (the trainer's pinned staging).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "pskv.cc")
_BUILD = os.path.join(os.path.dirname(_HERE), "ops", "_build")


def library_path() -> str:
    """Where the server library is (or will be) built: keyed by the
    source and the loader's flags, so an edited source never loads a
    stale build (a sanitized build adds its own suffix)."""
    from ..native_loader import CXX_FLAGS
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(_BUILD, f"pskv-{h.hexdigest()[:16]}.so")


_lib = None
_lib_lock = threading.Lock()

OPT_SGD, OPT_ADAGRAD, OPT_ADAM = 0, 1, 2

_OPT_BY_NAME = {"sgd": OPT_SGD, "adagrad": OPT_ADAGRAD, "adam": OPT_ADAM}


def load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ..native_loader import compile_and_load
        lib = compile_and_load(_SRC, library_path())
        c = ctypes
        lib.pskv_server_start.restype = c.c_void_p
        lib.pskv_server_start.argtypes = [c.c_int, c.c_int, c.c_int,
                                          c.c_int64]
        lib.pskv_server_port.restype = c.c_int
        lib.pskv_server_port.argtypes = [c.c_void_p]
        lib.pskv_server_stopped.restype = c.c_int
        lib.pskv_server_stopped.argtypes = [c.c_void_p]
        lib.pskv_server_stop.argtypes = [c.c_void_p]
        lib.pskv_connect.restype = c.c_int
        lib.pskv_connect.argtypes = [c.c_char_p, c.c_int]
        lib.pskv_close.argtypes = [c.c_int]
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.pskv_create_dense.restype = c.c_int
        lib.pskv_create_dense.argtypes = [
            c.c_int, c.c_char_p, c.c_uint64, c.c_int,
            c.c_float, c.c_float, c.c_float, c.c_float]
        lib.pskv_init_dense.restype = c.c_int
        lib.pskv_init_dense.argtypes = [c.c_int, c.c_char_p, f32p, c.c_uint64]
        lib.pskv_pull_dense.restype = c.c_int
        lib.pskv_pull_dense.argtypes = [c.c_int, c.c_char_p, f32p, c.c_uint64]
        lib.pskv_push_dense.restype = c.c_int
        lib.pskv_push_dense.argtypes = [c.c_int, c.c_char_p, c.c_uint32,
                                        f32p, c.c_uint64]
        lib.pskv_create_sparse.restype = c.c_int
        lib.pskv_create_sparse.argtypes = [
            c.c_int, c.c_char_p, c.c_uint64, c.c_int,
            c.c_float, c.c_float, c.c_float, c.c_float,
            c.c_float, c.c_uint64]
        lib.pskv_pull_sparse.restype = c.c_int
        lib.pskv_pull_sparse.argtypes = [c.c_int, c.c_char_p, i64p,
                                         c.c_uint64, f32p, c.c_uint64]
        lib.pskv_push_sparse.restype = c.c_int
        lib.pskv_push_sparse.argtypes = [c.c_int, c.c_char_p, c.c_uint32,
                                         i64p, c.c_uint64, f32p, c.c_uint64]
        lib.pskv_init_sparse.restype = c.c_int
        lib.pskv_init_sparse.argtypes = [c.c_int, c.c_char_p, i64p,
                                         c.c_uint64, f32p, c.c_uint64]
        lib.pskv_save.restype = c.c_int
        lib.pskv_save.argtypes = [c.c_int, c.c_char_p]
        lib.pskv_load.restype = c.c_int
        lib.pskv_load.argtypes = [c.c_int, c.c_char_p]
        lib.pskv_barrier.restype = c.c_int
        lib.pskv_barrier.argtypes = [c.c_int, c.c_uint32]
        lib.pskv_set_lr.restype = c.c_int
        lib.pskv_set_lr.argtypes = [c.c_int, c.c_char_p, c.c_float]
        lib.pskv_shutdown.restype = c.c_int
        lib.pskv_shutdown.argtypes = [c.c_int]
        _lib = lib
        return _lib


class KVServer:
    """In-process pserver (listen_and_serv analog). Runs its accept loop on
    C++ threads; `port` is the bound port (pass port=0 for ephemeral)."""

    def __init__(self, port: int = 0, trainers: int = 1, sync: bool = True,
                 sync_timeout_ms: int = 0):
        """sync_timeout_ms > 0: a sync aggregation round that waits longer
        than this for missing trainers fails the waiting pushes with an
        error instead of hanging forever (failure detection for crashed
        trainers; their contribution is rolled back so a retry round stays
        correct)."""
        self._lib = load_lib()
        self._handle = self._lib.pskv_server_start(int(port), int(trainers),
                                                   1 if sync else 0,
                                                   int(sync_timeout_ms))
        if not self._handle:
            raise RuntimeError(f"pskv server failed to bind port {port}")
        self.port = self._lib.pskv_server_port(self._handle)

    def stopped(self) -> bool:
        """True once a trainer sent the shutdown command."""
        if not self._handle:
            return True
        return bool(self._lib.pskv_server_stopped(self._handle))

    def stop(self):
        if self._handle:
            self._lib.pskv_server_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def _out_buffer(out, shape) -> np.ndarray:
    """`out` checked as a C-contiguous float32 array of `shape` (the
    library writes through its pointer), or a new one."""
    if out is None:
        return np.empty(shape, np.float32)
    if out.dtype != np.float32 or tuple(out.shape) != tuple(shape) or \
            not out.flags.c_contiguous:
        raise ValueError(f"pskv: out must be a C-contiguous float32 array "
                         f"of shape {tuple(shape)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    return out


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"pskv {what} failed (rc={rc})")


class _FaultInjector:
    """Chaos knob for the PS transport (the fault-injection framework the
    reference lacks — SURVEY §5 names it a modern gap next to elastic
    scaling). FLAGS_pskv_fault_inject="drop=0.3,delay_ms=50[,seed=7]"
    makes every push/pull drop (raise ConnectionError) with the given
    probability and/or adds latency — letting tests and users prove
    their training loop survives flaky transport (sync rounds time out
    and roll back; the async Communicator retries). `ops=push` (prefix
    match) targets only pushes/pulls of that kind."""

    # seeded streams are PROCESS-global so reconnecting clients continue
    # the sequence instead of replaying it (a fresh RandomState(seed) per
    # reconnect would turn "drop with probability p" into a deterministic
    # livelock for any reconnect-on-error consumer)
    _streams = {}

    def __init__(self):
        spec = os.environ.get("FLAGS_pskv_fault_inject", "")
        self.drop = 0.0
        self.delay_ms = 0.0
        self.ops = ""        # prefix filter; "" = all operations
        seed = None
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            if k == "drop":
                self.drop = float(v)
            elif k == "delay_ms":
                self.delay_ms = float(v)
            elif k == "seed":
                seed = int(v)
            elif k == "ops":
                self.ops = v
            else:
                raise ValueError(
                    f"FLAGS_pskv_fault_inject: unknown key {k!r} "
                    "(use drop=, delay_ms=, seed=, ops=)")
        if seed is None:
            self._rng = np.random.RandomState()
        else:
            self._rng = _FaultInjector._streams.setdefault(
                seed, np.random.RandomState(seed))

    def maybe_fault(self, what: str):
        if self.ops and not what.startswith(self.ops):
            return
        if self.delay_ms > 0:
            import time
            time.sleep(self.delay_ms / 1000.0)
        if self.drop > 0 and self._rng.random_sample() < self.drop:
            raise ConnectionError(
                f"pskv fault injection: dropped {what} "
                "(FLAGS_pskv_fault_inject)")


class KVClient:
    """Trainer-side connection to one pserver (RPCClient analog,
    reference operators/distributed/rpc_client.h:33)."""

    def __init__(self, host: str, port: int, trainer_id: int = 0):
        self._lib = load_lib()
        self._fd = self._lib.pskv_connect(host.encode(), int(port))
        if self._fd < 0:
            raise ConnectionError(f"cannot connect to pserver {host}:{port}")
        self.trainer_id = int(trainer_id)
        self._faults = _FaultInjector()  # env re-read per client

    def close(self):
        if self._fd >= 0:
            self._lib.pskv_close(self._fd)
            self._fd = -1

    # -- dense ---------------------------------------------------------------
    def create_dense(self, name: str, size: int, opt: str = "sgd",
                     lr: float = 0.01, beta1: float = 0.9,
                     beta2: float = 0.999, epsilon: float = 1e-8):
        _check(self._lib.pskv_create_dense(
            self._fd, name.encode(), int(size), _OPT_BY_NAME[opt],
            lr, beta1, beta2, epsilon), "create_dense")

    def init_dense(self, name: str, value: np.ndarray):
        v = np.ascontiguousarray(value, np.float32).ravel()
        _check(self._lib.pskv_init_dense(self._fd, name.encode(), v,
                                         v.size), "init_dense")

    def pull_dense(self, name: str, size: int,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
        self._faults.maybe_fault("pull_dense")
        out = _out_buffer(out, (int(size),))
        _check(self._lib.pskv_pull_dense(self._fd, name.encode(), out,
                                         out.size), "pull_dense")
        return out

    def push_dense(self, name: str, grad: np.ndarray):
        self._faults.maybe_fault("push_dense")
        g = np.ascontiguousarray(grad, np.float32).ravel()
        _check(self._lib.pskv_push_dense(self._fd, name.encode(),
                                         self.trainer_id, g, g.size),
               "push_dense")

    # -- sparse --------------------------------------------------------------
    def create_sparse(self, name: str, dim: int, opt: str = "sgd",
                      lr: float = 0.01, beta1: float = 0.9,
                      beta2: float = 0.999, epsilon: float = 1e-8,
                      init_scale: float = 0.0, seed: int = 0):
        _check(self._lib.pskv_create_sparse(
            self._fd, name.encode(), int(dim), _OPT_BY_NAME[opt],
            lr, beta1, beta2, epsilon, init_scale, seed), "create_sparse")

    def init_sparse(self, name: str, ids: np.ndarray, values: np.ndarray):
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        v = np.ascontiguousarray(values, np.float32).reshape(ids.size, -1)
        _check(self._lib.pskv_init_sparse(self._fd, name.encode(), ids,
                                          ids.size, v, v.shape[1]),
               "init_sparse")

    def pull_sparse(self, name: str, ids: np.ndarray, dim: int,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
        self._faults.maybe_fault("pull_sparse")
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        out = _out_buffer(out, (ids.size, int(dim)))
        _check(self._lib.pskv_pull_sparse(self._fd, name.encode(), ids,
                                          ids.size, out, int(dim)),
               "pull_sparse")
        return out

    def push_sparse(self, name: str, ids: np.ndarray, grads: np.ndarray):
        self._faults.maybe_fault("push_sparse")
        ids = np.ascontiguousarray(ids, np.int64).ravel()
        g = np.ascontiguousarray(grads, np.float32)
        dim = g.shape[-1]
        g = g.reshape(ids.size, dim)
        _check(self._lib.pskv_push_sparse(self._fd, name.encode(),
                                          self.trainer_id, ids, ids.size,
                                          np.ascontiguousarray(g), dim),
               "push_sparse")

    # -- checkpoint (checkpoint_notify / RequestCheckpoint analog) -----------
    def save_checkpoint(self, path: str):
        """Server serializes its shard (tables + optimizer state) to
        `path` on ITS filesystem."""
        _check(self._lib.pskv_save(self._fd, path.encode()),
               "save_checkpoint")

    def load_checkpoint(self, path: str):
        _check(self._lib.pskv_load(self._fd, path.encode()),
               "load_checkpoint")

    # -- control -------------------------------------------------------------
    def barrier(self):
        _check(self._lib.pskv_barrier(self._fd, self.trainer_id), "barrier")

    def set_lr(self, name: str, lr: float):
        _check(self._lib.pskv_set_lr(self._fd, name.encode(), float(lr)),
               "set_lr")

    def shutdown_server(self):
        self._lib.pskv_shutdown(self._fd)
