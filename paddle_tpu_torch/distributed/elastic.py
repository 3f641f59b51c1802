"""Elastic trainer membership for parameter-server training.

Copy of `paddle_tpu/distributed/elastic.py` (it imports no JAX).

The reference has no elastic scaling (SURVEY §5 lists it as a modern gap
to fill); its sync PS assumes a fixed trainer count for aggregation
rounds. This design adds elasticity where it is sound: ASYNC
mode, where pushes are independent and a trainer joining or leaving
never blocks a round (the sync path keeps its fixed-world validation —
changing the divisor of an in-flight aggregation round is exactly the
silent-gradient-mis-scaling bug the Executor guards against).

Components:
  ElasticController — tiny line-protocol TCP registry (one per job,
    typically colocated with pserver 0): join/heartbeat/leave, expiring
    members whose heartbeats stop (crash = departure, the failure-
    detection story); reports (world_version, world_size, members).
  ElasticAgent — trainer-side handle: background heartbeat thread,
    world() query, and an on_change callback fired when membership
    changes (rescale LR with world size, re-shard data, log).

A joining trainer's bootstrap is the normal async flow: pull current
dense params from the pservers (PSPlan.before_step does this every step
already), then start pushing — no global pause.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["ElasticController", "ElasticAgent", "SyncElasticTrainer"]


class ElasticController:
    """Membership registry. Protocol (one line per request):
        join\t<id>      -> ok\t<version>\t<size>
        beat\t<id>      -> ok\t<version>\t<size>   (err if unknown/expired)
        leave\t<id>     -> ok\t<version>\t<size>
        world           -> ok\t<version>\t<size>\t<id,id,...>
    """

    def __init__(self, address=("127.0.0.1", 0), heartbeat_timeout=3.0):
        self._timeout = heartbeat_timeout
        self._members: Dict[str, float] = {}   # id -> last heartbeat
        self._version = 0
        self._lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(address)
        self._sock.listen(64)
        self._closed = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def _expire(self, now):
        dead = [m for m, t in self._members.items()
                if now - t > self._timeout]
        for m in dead:
            del self._members[m]
        if dead:
            self._version += 1

    def _world_locked(self) -> Tuple[int, int, List[str]]:
        self._expire(time.time())
        return self._version, len(self._members), sorted(self._members)

    def world(self) -> Tuple[int, int, List[str]]:
        with self._lock:
            return self._world_locked()

    def _serve(self):
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                try:
                    # a hung client must not wedge the (sequential) serve
                    # loop: that would stall every other member's beats
                    # past the expiry timeout
                    conn.settimeout(1.0)
                    parts = conn.recv(1024).decode().strip().split("\t")
                    cmd = parts[0]
                    with self._lock:
                        now = time.time()
                        if cmd == "join":
                            if parts[1] not in self._members:
                                self._version += 1
                            self._members[parts[1]] = now
                        elif cmd == "beat":
                            if parts[1] not in self._members:
                                conn.sendall(b"err\texpired")
                                continue
                            self._members[parts[1]] = now
                        elif cmd == "leave":
                            if self._members.pop(parts[1], None) is not None:
                                self._version += 1
                        elif cmd != "world":
                            conn.sendall(b"err\tbad command")
                            continue
                        v, n, members = self._world_locked()
                    if cmd == "world":
                        conn.sendall(
                            f"ok\t{v}\t{n}\t{','.join(members)}".encode())
                    else:
                        conn.sendall(f"ok\t{v}\t{n}".encode())
                except Exception as e:  # noqa: BLE001 — keep serving
                    try:
                        conn.sendall(f"err\t{e}".encode())
                    except OSError:
                        pass

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class ElasticAgent:
    """Trainer-side membership handle. start() joins and heartbeats in
    the background; on_change(old_size, new_size) fires from the
    heartbeat thread whenever the version moves (use it to rescale the
    learning rate with world size — pass the new lr to
    PSPlan._sync_lr via the optimizer's LearningRate var, or simply
    record it)."""

    def __init__(self, server_ip: str, server_port: int, trainer_id: str,
                 beat_interval: float = 0.5,
                 on_change: Optional[Callable[[int, int], None]] = None):
        self._addr = (server_ip, server_port)
        self._id = trainer_id
        self._interval = beat_interval
        self._on_change = on_change
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._version = -1
        self._size = 0

    def _rpc(self, msg: str) -> List[str]:
        with socket.create_connection(self._addr, timeout=5) as s:
            s.sendall(msg.encode())
            parts = s.recv(4096).decode().strip().split("\t")
        if parts[0] != "ok":
            raise RuntimeError(f"elastic controller: {parts}")
        return parts[1:]

    def start(self):
        v, n = self._rpc(f"join\t{self._id}")[:2]
        self._version, self._size = int(v), int(n)

        def beat():
            while not self._stop.wait(self._interval):
                try:
                    try:
                        v, n = self._rpc(f"beat\t{self._id}")[:2]
                    except RuntimeError:
                        # expired (e.g. long GC pause): rejoin
                        v, n = self._rpc(f"join\t{self._id}")[:2]
                except (OSError, RuntimeError):
                    # controller restarting / transient network error:
                    # keep the thread ALIVE and retry next interval — a
                    # dead heartbeat thread would expire a healthy
                    # trainer and freeze world_size() forever
                    continue
                v, n = int(v), int(n)
                if v != self._version:
                    old = self._size
                    self._version, self._size = v, n
                    if self._on_change is not None:
                        self._on_change(old, n)

        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        return self

    def world_size(self) -> int:
        return self._size

    def world(self) -> Tuple[int, int, List[str]]:
        v, n, members = self._rpc("world")
        return int(v), int(n), [m for m in members.split(",") if m]

    def stop(self, leave: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if leave:
            try:
                self._rpc(f"leave\t{self._id}")
            except (RuntimeError, OSError):
                pass


class SyncElasticTrainer:
    """Checkpoint-restart-on-resize for SYNC data-parallel training (a
    sync collective world cannot be resized mid-round; the program is
    rebuilt for the new world, which is a restart).

    build_fn(world_size) -> (target, main, startup, fetch_vars): target is
    the CompiledProgram (or plain Program) sized to `world_size`; main the
    raw Program (for persistable listing); fetch_vars what step() returns.
    world_fn() -> (version, size): e.g. ElasticAgent.world()[:2] or a test
    stub. On a version change the trainer: (1) saves persistables
    (atomic, io.py writer), (2) rebuilds via build_fn under a fresh
    unique_name guard so var names line up, (3) runs the new startup,
    (4) reloads the checkpoint — training state survives the resize
    exactly; only the sharding layout changes.
    """

    def __init__(self, build_fn, world_fn, ckpt_dir, executor=None,
                 scope=None):
        from ..framework.executor import Executor, Scope
        self._build = build_fn
        self._world = world_fn
        self._ckpt = ckpt_dir
        self._exe = executor or Executor()
        self._scope = scope if scope is not None else Scope()
        self._version = None
        self.world_size = None
        self.resizes = 0
        self._target = self._main = self._fetches = None

    def _rebuild(self, version, size):
        from .. import io
        from ..framework.core import unique_name_guard
        from ..framework.executor import scope_guard

        import os

        first = self._version is None
        with scope_guard(self._scope):
            if not first:
                io.save_persistables(self._exe, self._ckpt, self._main,
                                     sync=True)
            with unique_name_guard():
                self._target, self._main, startup, self._fetches = \
                    self._build(size)
            self._exe.run(startup)
            # a FRESH worker joining an elastic world must also load: the
            # survivors' checkpoint is the truth, not its startup init
            # (otherwise sync gradient averaging mixes random weights in)
            has_ckpt = os.path.isdir(self._ckpt) and os.listdir(self._ckpt)
            if not first or has_ckpt:
                io.load_persistables(self._exe, self._ckpt, self._main)
            if not first:
                self.resizes += 1
        self._version = version
        self.world_size = size

    def step(self, feed):
        """One training step; transparently restarts on a world change."""
        from ..framework.executor import scope_guard
        version, size = self._world()
        if version != self._version:
            self._rebuild(version, size)
        with scope_guard(self._scope):
            return self._exe.run(self._target, feed=feed,
                                 fetch_list=self._fetches)
