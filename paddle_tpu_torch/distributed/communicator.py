"""Async-mode Communicator: background gradient send + parameter recv.

Copy of `paddle_tpu/distributed/communicator.py`, with the recv thread's
write in torch. Reference: paddle/fluid/operators/distributed/communicator.h:160 — async
parameter-server training decouples the compute step from communication:
gradients go into per-variable queues, a send thread merges queued
gradients (FLAGS_communicator_max_merge_var_num) and pushes them to the
pservers, and a recv thread periodically pulls fresh parameters. The
trainer step never blocks on the network; staleness is the accepted
async-SGD tradeoff.

The recv thread REBINDS each refreshed parameter (a new tensor on the old
one's device, in its dtype, bound with `scope.set_var`); it never writes a
tensor in place. The trainer thread may be inside a step that read the old
tensor: an in-place copy from another thread would land between that
step's kernels (its forward and backward would read two values), a race
that JAX's rebinding never had. A step holds the tensors it read from the
scope at its start, so a rebind reaches the next step, and a scope lookup
and a rebind are each one dict operation under the interpreter lock.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observability.tracer import trace_span, tracing_enabled

_LOG = logging.getLogger(__name__)


def _comm_span(name, argfn):
    """Span for one KV-service RPC. `argfn` builds the byte-count args and
    only runs while tracing is on — the send/recv loops fire every batch
    and the disabled path must stay (near-)allocation-free."""
    if not tracing_enabled():
        return trace_span(name)        # the shared no-op span
    return trace_span(name, "comm", argfn())

__all__ = ["Communicator"]


class Communicator:
    def __init__(self, plan, scope, max_merge_var_num: int = 20,
                 send_wait_ms: int = 5, recv_interval_ms: int = 50,
                 merge_add: bool = False):
        """plan: the trainer program's PSPlan (async mode); scope: the
        training Scope whose params the recv thread refreshes.
        merge_add=False averages merged gradients (the reference's default
        unless communicator_is_sgd_optimizer); True sums them."""
        if plan.sync_mode:
            raise ValueError("Communicator is for async PS mode")
        self._merge_add = merge_add
        # each thread owns PRIVATE connections: the wire protocol is
        # request/response per socket, so sharing the plan's clients with
        # the training thread would interleave frames
        self._send_clients = {}
        self._recv_clients = {}
        self._plan = plan
        self._scope = scope
        self._max_merge = max_merge_var_num
        self._send_wait = send_wait_ms / 1000.0
        self._recv_interval = recv_interval_ms / 1000.0
        self._queues: Dict[str, List] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._running = False
        self._send_thread: Optional[threading.Thread] = None
        self._recv_thread: Optional[threading.Thread] = None
        self.sent_batches = 0
        self.merged_grads = 0
        self.last_error: Optional[Exception] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        self._running = True
        self._send_thread = threading.Thread(target=self._send_loop,
                                             daemon=True)
        self._recv_thread = threading.Thread(target=self._recv_loop,
                                             daemon=True)
        self._send_thread.start()
        self._recv_thread.start()

    def stop(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()
        for t in (self._send_thread, self._recv_thread):
            if t is not None:
                t.join(timeout=30)
        try:
            self._flush()
        except Exception as e:
            self.last_error = e  # server may already be down at shutdown
        for cache in (self._send_clients, self._recv_clients):
            for c in cache.values():
                c.close()
            cache.clear()

    # -- producer side (called by PSPlan.after_step) -------------------------
    def push(self, grads: Dict[str, object]):
        """Enqueue one step's gradients; returns immediately."""
        with self._cv:
            for name, g in grads.items():
                q = self._queues.setdefault(name, [])
                q.append(g)
                # bounded queue: merge down when the producer outruns the
                # sender (the reference drops into merge at max_merge)
                if len(q) > self._max_merge:
                    merged = self._merge(q)
                    q.clear()
                    q.append(merged)
            self._cv.notify_all()

    # -- internals -----------------------------------------------------------
    def _merge(self, items):
        if isinstance(items[0], tuple):  # sparse: (rows, vals) numpy pair
            rows = np.concatenate([r for r, _ in items])
            vals = np.concatenate([v for v, _ in items])
            if not self._merge_add:
                vals = vals / float(len(items))
            self.merged_grads += len(items) - 1
            return (rows, vals)
        self.merged_grads += len(items) - 1
        out = items[0].astype(np.float32).copy()
        for g in items[1:]:
            out += g
        if not self._merge_add:
            out /= float(len(items))
        return out

    def _drain(self):
        with self._cv:
            batch = {}
            for name, q in self._queues.items():
                if q:
                    batch[name] = self._merge(q) if len(q) > 1 else q[0]
                    q.clear()
            return batch

    def _flush(self, retries: int = 5):
        """Drain + send remaining batches; retried so an injected/
        transient fault at shutdown does not silently lose the run's
        final gradients."""
        batch = self._drain()
        last = None
        while batch:
            try:
                self._send(batch)
                batch = self._drain()
                last = None
            except Exception as e:
                retries -= 1
                if retries <= 0:
                    raise
                last = e
                time.sleep(self._send_wait)
        if last is not None:
            raise last

    def _client(self, cache, endpoint):
        from .pskv import KVClient
        if endpoint not in cache:
            host, port = endpoint.rsplit(":", 1)
            cache[endpoint] = KVClient(host, int(port),
                                       trainer_id=self._plan.trainer_id)
        return cache[endpoint]

    def _send(self, batch):
        """Push the batch var by var, REMOVING each var after its push
        lands — on a mid-batch failure the caller's retry then covers
        only the unsent remainder (requeueing the whole dict would apply
        the already-pushed gradients twice)."""
        plan = self._plan
        for s in plan.specs:
            g = batch.get(s.grad_name)
            if g is None:
                continue
            if s.sparse and isinstance(g, tuple):
                # id-hash sharded over all servers (this thread's own
                # client cache). Shards push sequentially; on a partial
                # failure the batch keeps only the UNSENT rows — a
                # retried push then cannot double-apply the shards whose
                # server-side optimizer update already ran.
                parts = plan.sparse_shard_parts(s, g[0], g[1])
                for j, (ep, r, v) in enumerate(parts):
                    try:
                        with _comm_span(
                                "comm/push_sparse",
                                lambda r=r, v=v: {
                                    "var": s.name,
                                    "bytes": int(r.nbytes + v.nbytes),
                                    "rows": int(r.shape[0])}):
                            self._client(self._send_clients,
                                         ep).push_sparse(s.name, r, v)
                    except Exception:
                        rem = parts[j:]
                        batch[s.grad_name] = (
                            np.concatenate([p[1] for p in rem]),
                            np.concatenate([p[2] for p in rem]))
                        raise
            else:
                c = self._client(self._send_clients, s.endpoint)
                dense = np.asarray(g, np.float32)
                with _comm_span("comm/push_dense",
                                lambda: {"var": s.name,
                                         "bytes": int(dense.nbytes)}):
                    c.push_dense(s.name, dense)
            del batch[s.grad_name]
        self.sent_batches += 1

    def _send_loop(self):
        while True:
            with self._cv:
                if not self._running and not any(self._queues.values()):
                    return
                if not any(self._queues.values()):
                    self._cv.wait(timeout=self._send_wait)
            batch = self._drain()
            if not batch:
                continue
            try:
                self._send(batch)
            except Exception as e:
                # requeue only the UNsent remainder (_send removed the
                # delivered vars) so retries never double-apply
                if batch:
                    self.push(dict(batch))
                if not self._running:
                    return  # shutdown: stop()'s retried _flush takes over
                # transient push failure: retry — a dead send thread
                # would silently freeze training
                self.last_error = e
                _LOG.warning("communicator send failed, retrying: %s", e)
                time.sleep(self._send_wait)

    def _recv_loop(self):
        plan = self._plan
        while self._running:
            time.sleep(self._recv_interval)
            for s in plan.specs:
                if s.sparse or not self._running:
                    continue
                try:
                    c = self._client(self._recv_clients, s.endpoint)
                    with _comm_span("comm/pull_dense",
                                    lambda: {"var": s.name,
                                             "bytes": int(s.size * 4)}):
                        w = c.pull_dense(s.name, s.size).reshape(s.shape)
                except Exception as e:
                    if not self._running:
                        return  # shutdown
                    self.last_error = e
                    _LOG.warning("communicator recv failed, retrying: %s",
                                 e)
                    stale = self._recv_clients.pop(s.endpoint, None)
                    if stale is not None:
                        try:
                            stale.close()  # else one fd leaks per failure
                        except Exception:
                            pass
                    break  # retry next interval with a fresh connection
                cur = self._scope.find_var(s.name)
                if isinstance(cur, torch.Tensor):
                    self._scope.set_var(s.name, torch.from_numpy(w).to(
                        device=cur.device, dtype=cur.dtype))
