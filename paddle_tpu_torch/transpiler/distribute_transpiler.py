"""Parameter-server DistributeTranspiler.

Port of `paddle_tpu/transpiler/distribute_transpiler.py` (reference:
python/paddle/fluid/transpiler/distribute_transpiler.py:181): rewrites one
trained program into a trainer program (grads -> pushes, params <- pulls)
and per-pserver specs; ps_dispatcher.py's RoundRobin/HashName assign vars
to pservers.

The trainer step stays one Executor run (forward + backward + grad clip) on
the executor's device; the send/recv boundary is a host-side exchange
between steps through the pskv service (distributed/pskv.py, the C++ server
of distributed/csrc/), which runs the optimizer server-side like the
reference's pserver optimize blocks. Sparse embeddings use remote prefetch:
rows for the ids in the current feed are pulled before the step
(parameter_prefetch.cc analog) and SelectedRows grads are pushed after it
as rows and values.

On a card the trainer-side runtime (PSPlan) keeps the scope's tensors and
writes into them in place (the executor's plan cache and donation bind the
persistables): the prefetched rows go through one pinned staging buffer
into the table by `index_copy_`, and the pulled dense values are copied
into the parameters on the trainer's stream, so they land after the
queued kernels that read the old values. The gradients and learning rates
a step fetched come to the host in one batch with one synchronisation.
Each part of the exchange runs under a `ps/<part>` span (cat "ps":
ensure_init, pull_sparse, scatter, fetch, push_sparse, push_dense,
pull_dense; the executor's `ps/step` is the step between them), which a
trace reads as the host time of each.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework.core import Program
from ..observability.tracer import trace_span

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "RoundRobin", "HashName", "PServerSpec", "start_pserver",
           "run_pserver"]

# optimizer op type -> (server opt name, attr keys for h0/h1/h2)
_SERVER_OPTS = {
    "sgd": ("sgd", ()),
    "adagrad": ("adagrad", ("epsilon",)),
    "adam": ("adam", ("beta1", "beta2", "epsilon")),
}


class PSDispatcher:
    def __init__(self, pserver_endpoints: Sequence[str]):
        self._eps = list(pserver_endpoints)

    def dispatch(self, varlist: Sequence[str]) -> List[str]:
        raise NotImplementedError


class RoundRobin(PSDispatcher):
    """reference: transpiler/ps_dispatcher.py RoundRobin."""

    def dispatch(self, varlist):
        out = []
        for i, _ in enumerate(varlist):
            out.append(self._eps[i % len(self._eps)])
        return out


class HashName(PSDispatcher):
    """reference: transpiler/ps_dispatcher.py HashName. Uses crc32, not
    Python's per-process-salted hash(): every trainer/pserver process must
    agree on the param -> endpoint assignment."""

    def dispatch(self, varlist):
        import zlib
        return [self._eps[zlib.crc32(v.encode()) % len(self._eps)]
                for v in varlist]


@dataclass
class DistributeTranspilerConfig:
    """reference: DistributeTranspilerConfig — slice_var_up etc. accepted
    for compatibility; vars are dispatched whole, as in the JAX package
    (sparse tables shard by row over every pserver instead, PSPlan)."""
    slice_var_up: bool = False
    split_method: type = RoundRobin
    min_block_size: int = 8192
    sync_mode: Optional[bool] = None


@dataclass
class _ParamSpec:
    name: str
    grad_name: str
    shape: Tuple[int, ...]
    endpoint: str
    opt: str
    lr_var: str
    hyper: Tuple[float, float, float]  # beta1/beta2/epsilon semantics
    sparse: bool = False
    ids_feed: Optional[str] = None  # feed var holding the lookup ids

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def dim(self) -> int:
        return self.shape[-1]


@dataclass
class PServerSpec:
    """What one pserver must serve (get_pserver_program analog)."""
    endpoint: str
    trainers: int
    sync_mode: bool
    dense: List[_ParamSpec] = field(default_factory=list)
    sparse: List[_ParamSpec] = field(default_factory=list)


class DistributeTranspiler:
    """transpile() -> get_trainer_program() / get_pserver_program()."""

    def __init__(self, config: Optional[DistributeTranspilerConfig] = None):
        self.config = config or DistributeTranspilerConfig()

    def transpile(self, trainer_id: int, program: Optional[Program] = None,
                  pservers: str = "127.0.0.1:6174", trainers: int = 1,
                  sync_mode: bool = True,
                  startup_program: Optional[Program] = None):
        from ..framework.core import default_main_program
        self.trainer_id = trainer_id
        self.trainers = trainers
        if self.config.sync_mode is not None:
            sync_mode = self.config.sync_mode
        self.sync_mode = sync_mode
        self.endpoints = [e.strip() for e in pservers.split(",") if e.strip()]
        self.program = program if program is not None \
            else default_main_program()
        self.startup_program = startup_program

        block = self.program.global_block
        specs: List[_ParamSpec] = []
        opt_idxs: List[int] = []
        for i, op in enumerate(block.ops):
            if op.attrs.get("op_role") != "optimize":
                continue
            if not op.input("Param"):
                # grad-clip / regularization / accumulator ops appended by
                # apply_gradients: keep them in the trainer program so the
                # pushed grad already includes clipping and weight decay
                # (the reference runs these in pserver optimize blocks;
                # we fold them trainer-side instead).
                continue
            opt_idxs.append(i)
            pname = op.input("Param")[0]
            gname = op.input("Grad")[0]
            if op.type not in _SERVER_OPTS:
                raise NotImplementedError(
                    f"parameter-server mode supports optimizers "
                    f"{sorted(_SERVER_OPTS)}, got {op.type!r} — run this "
                    f"optimizer locally (collective mode) instead")
            opt_name, keys = _SERVER_OPTS[op.type]
            defaults = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
            hyper = [0.9, 0.999, 1e-8]
            if op.type == "adagrad":
                hyper[2] = op.attrs.get("epsilon", 1e-6)
            elif op.type == "adam":
                hyper = [op.attrs.get(k, defaults[k]) for k in
                         ("beta1", "beta2", "epsilon")]
            pvar = block.var(pname)
            gvar = block.var(gname)
            specs.append(_ParamSpec(
                name=pname, grad_name=gname, shape=tuple(pvar.shape),
                endpoint="", opt=opt_name,
                lr_var=op.input("LearningRate")[0],
                hyper=tuple(hyper),
                sparse=(gvar.type == "selected_rows")))

        # sparse prefetch: map each sparse param to the data var feeding its
        # lookup ids (reference: remote prefetch in parameter_prefetch.cc)
        sparse_names = {s.name for s in specs if s.sparse}
        for op in block.ops:
            if op.type in ("lookup_table", "lookup_table_v2") and \
                    op.input("W") and op.input("W")[0] in sparse_names:
                ids_name = op.input("Ids")[0]
                try:
                    ids_var = block.var(ids_name)
                except KeyError:
                    continue
                if ids_var.is_data:
                    for s in specs:
                        if s.name == op.input("W")[0]:
                            s.ids_feed = ids_name

        # dispatch params to pservers (whole-var; biggest first for balance)
        order = sorted(range(len(specs)), key=lambda i: -specs[i].size)
        eps = self.config.split_method(self.endpoints).dispatch(
            [specs[i].name for i in order])
        for slot, i in enumerate(order):
            specs[i].endpoint = eps[slot]

        self.param_specs = specs

        # trainer program: drop optimizer ops (they run on the pservers)
        block.ops = [op for i, op in enumerate(block.ops)
                     if i not in set(opt_idxs)]
        self.program._bump_version()
        plan = PSPlan(specs, self.endpoints, trainer_id, trainers, sync_mode)
        self.program._ps_plan = plan
        # SelectedRows grads must be fetched raw (rows+values), not densified
        self.program._sparse_fetch_names = {
            s.grad_name for s in specs if s.sparse}
        return self.program

    def get_trainer_program(self) -> Program:
        return self.program

    def get_pserver_program(self, endpoint: str) -> PServerSpec:
        spec = PServerSpec(endpoint=endpoint, trainers=self.trainers,
                           sync_mode=self.sync_mode)
        for s in self.param_specs:
            if s.endpoint != endpoint:
                continue
            (spec.sparse if s.sparse else spec.dense).append(s)
        return spec

    def get_pserver_programs(self, endpoint: str):
        return self.get_pserver_program(endpoint), None

    def get_startup_program(self, endpoint: str = None,
                            pserver_program=None) -> Program:
        return Program()  # table creation happens over the wire


# ---------------------------------------------------------------------------
# pserver process entry
# ---------------------------------------------------------------------------

def start_pserver(spec: PServerSpec, sync_timeout_ms: int = 0):
    """Start the native KV server for `spec` in-process; returns the server
    handle (tests / notebook use). Tables are created lazily by trainer 0.
    sync_timeout_ms: see KVServer — crashed-trainer detection for sync
    aggregation rounds."""
    from ..distributed.pskv import KVServer
    port = int(spec.endpoint.rsplit(":", 1)[1])
    return KVServer(port=port, trainers=spec.trainers, sync=spec.sync_mode,
                    sync_timeout_ms=sync_timeout_ms)


def run_pserver(spec: PServerSpec):
    """Blocking pserver loop (listen_and_serv_op analog): serves until a
    trainer sends shutdown."""
    import time
    srv = start_pserver(spec)
    try:
        while not srv.stopped():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# trainer-side runtime
# ---------------------------------------------------------------------------

class PSPlan:
    """Host-side send/recv runtime attached to the trainer program. The
    Executor calls ensure_init, before_step and after_step around the
    step."""

    def __init__(self, specs: List[_ParamSpec], endpoints: List[str],
                 trainer_id: int, trainers: int, sync_mode: bool):
        self.specs = specs
        self.endpoints = endpoints
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.sync_mode = sync_mode
        self._clients: Dict[str, "KVClient"] = {}
        self._inited = False
        self._lock = threading.Lock()
        self._last_lr: Dict[str, float] = {}
        self._communicator = None
        self.scatter_widths: List[int] = []  # the prefetch's padded widths

    # names the executor must additionally fetch each step
    def extra_fetches(self) -> List[str]:
        names = [s.grad_name for s in self.specs]
        names += sorted({s.lr_var for s in self.specs})
        return names

    def _client(self, endpoint: str):
        from ..distributed.pskv import KVClient
        if endpoint not in self._clients:
            host, port = endpoint.rsplit(":", 1)
            self._clients[endpoint] = KVClient(host, int(port),
                                               trainer_id=self.trainer_id)
        return self._clients[endpoint]

    # -- sparse-table sharding over ALL pservers -----------------------------
    # The reference shards every var across pservers (VarBlock splitting,
    # distribute_transpiler.py:70); here dense params stay whole-var
    # (they're small next to embeddings) but sparse tables shard rows by
    # id % n_servers over every endpoint, with the per-server round trips
    # fanned out concurrently — the point of having N servers.

    def _pool(self):
        with self._lock:  # trainer + communicator threads race first use
            if getattr(self, "_fanout_pool", None) is None:
                from concurrent.futures import ThreadPoolExecutor
                self._fanout_pool = ThreadPoolExecutor(
                    max_workers=max(2, len(self.endpoints)))
            return self._fanout_pool

    def sparse_shard_parts(self, spec, rows: np.ndarray, vals: np.ndarray):
        """[(endpoint, rows_shard, vals_shard)] over ALL endpoints (empty
        shards included — sync aggregation counts a contribution per
        trainer per table on every server)."""
        eps = self.endpoints
        n = len(eps)
        if n == 1:
            return [(eps[0], rows, vals)]
        asn = rows % n
        out = []
        for i, ep in enumerate(eps):
            m = np.nonzero(asn == i)[0]
            out.append((ep, rows[m], vals[m]))
        return out

    def pull_sparse_sharded(self, spec, ids: np.ndarray,
                            out: Optional[np.ndarray] = None) -> np.ndarray:
        """The rows of `ids`, each from its id-hash shard, written into
        `out` (a C-contiguous float32 (len(ids), dim) array) if given."""
        eps = self.endpoints
        n = len(eps)
        if n == 1:
            return self._client(eps[0]).pull_sparse(spec.name, ids,
                                                    spec.dim, out=out)
        asn = ids % n
        if out is None:
            out = np.empty((len(ids), spec.dim), np.float32)
        clients = [self._client(ep) for ep in eps]  # pre-create: the
        # client cache dict is not touched from worker threads

        def one(i):
            m = np.nonzero(asn == i)[0]
            if len(m):
                out[m] = clients[i].pull_sparse(spec.name, ids[m],
                                                spec.dim)
        list(self._pool().map(one, range(n)))
        return out

    def push_sparse_sharded(self, spec, rows: np.ndarray,
                            vals: np.ndarray, client_fn=None):
        """Push sparse grads to their id-hash shards. EVERY server gets a
        push (possibly zero rows): in sync mode the aggregation barrier
        counts one contribution per trainer per table, so a skipped empty
        shard would stall the round."""
        get = client_fn or self._client
        parts = self.sparse_shard_parts(spec, rows, vals)
        if len(parts) == 1:
            get(parts[0][0]).push_sparse(spec.name, parts[0][1],
                                         parts[0][2])
            return
        clients = [get(ep) for ep, _, _ in parts]

        def one(i):
            _, r, v = parts[i]
            clients[i].push_sparse(spec.name, r, v)
        list(self._pool().map(one, range(len(parts))))

    def ensure_init(self, scope):
        """First-run handshake: trainer 0 creates tables and seeds them from
        its startup-initialized scope; everyone then pulls a consistent
        model (BCastParamsToDevices analog over the PS)."""
        from ..io import _host_arrays
        with self._lock, trace_span("ps/ensure_init", "ps"):
            if self._inited:
                return
            if self.trainer_id == 0:
                host = _host_arrays({s.name: scope.find_var(s.name)
                                     for s in self.specs})
                for s in self.specs:
                    h0, h1, h2 = s.hyper
                    w = np.asarray(host[s.name], np.float32)
                    if s.sparse:
                        # sharded: every server holds its id%n rows
                        n = len(self.endpoints)
                        all_ids = np.arange(s.shape[0])
                        for i, ep in enumerate(self.endpoints):
                            c = self._client(ep)
                            c.create_sparse(s.name, s.dim, opt=s.opt,
                                            lr=0.0, beta1=h0, beta2=h1,
                                            epsilon=h2)
                            shard = all_ids[all_ids % n == i]
                            c.init_sparse(s.name, shard, w[shard])
                    else:
                        c = self._client(s.endpoint)
                        c.create_dense(s.name, s.size, opt=s.opt, lr=0.0,
                                       beta1=h0, beta2=h1, epsilon=h2)
                        c.init_dense(s.name, w)
            # one barrier per endpoint so no trainer races table creation
            for ep in self.endpoints:
                self._client(ep).barrier()
            self.pull_dense(scope)
            self._inited = True

    def pull_dense(self, scope):
        """Pull every dense param from its pserver into the scope's tensor,
        in place and in its dtype. On a card the values land in one pinned
        buffer and go up by non-blocking copies on the current stream:
        kernels queued before read the old values, those queued after the
        new (JAX rebinds the array instead)."""
        dense = [s for s in self.specs if not s.sparse]
        if not dense:
            return
        with trace_span("ps/pull_dense", "ps"):
            self._pull_dense(scope, dense)

    def _pull_dense(self, scope, dense):
        cur = {s.name: scope.find_var(s.name) for s in dense}
        pin = any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
                  for t in cur.values())
        buf = torch.empty(sum(s.size for s in dense), dtype=torch.float32,
                          pin_memory=pin)
        off = 0
        for s in dense:
            view = buf[off:off + s.size]
            off += s.size
            self._client(s.endpoint).pull_dense(s.name, s.size,
                                                out=view.numpy())
            t = cur[s.name]
            if isinstance(t, torch.Tensor) and t.numel() == s.size:
                t.copy_(view.view(t.shape), non_blocking=pin)
            else:   # no tensor of this size to write into: bind one
                scope.set_var(s.name, view.view(s.shape).clone())

    def before_step(self, scope, feed: Dict[str, object]):
        """Sparse remote prefetch: refresh the scope's embedding rows for
        the ids this batch will touch.

        The unique-id count is padded to a power-of-two bucket, as in the
        JAX package, whose scatter compiles once a distinct length (its
        DeepFM step recompiled every step before the padding;
        reader/bucketing.py is the same discipline for feeds): padding
        repeats the first id with its own row, a duplicate write of the
        same values. `scatter_widths` records the padded widths. The ids
        and rows share one staging buffer (pinned for a card table) that
        `index_copy_` writes into the table in place."""
        from ..reader.bucketing import bucket_for, pow2_boundaries
        for s in self.specs:
            if not s.sparse:
                continue
            if s.ids_feed is None or s.ids_feed not in feed:
                ids = np.arange(s.shape[0])  # no feed mapping: pull all
            else:
                v = feed[s.ids_feed]
                if isinstance(v, torch.Tensor):
                    v = v.cpu().numpy()
                ids = np.unique(np.asarray(v).ravel())
            n = len(ids)
            if n == 0:
                self.scatter_widths.append(0)
                continue
            target = max(n, bucket_for(n, pow2_boundaries(
                64, int(s.shape[0]))))
            w = scope.find_var(s.name)
            pin = w.device.type == "cuda"
            buf = torch.empty(target * 8 + target * s.dim * 4,
                              dtype=torch.uint8, pin_memory=pin)
            ids_t = buf[:target * 8].view(torch.int64)
            rows_t = buf[target * 8:].view(torch.float32).view(target,
                                                                s.dim)
            ids_h, rows_h = ids_t.numpy(), rows_t.numpy()
            ids_h[:n] = ids
            with trace_span("ps/pull_sparse", "ps"):
                self.pull_sparse_sharded(s, ids, out=rows_h[:n])
            ids_h[n:] = ids[0]
            rows_h[n:] = rows_h[0]
            # telemetry: the widths the scatter ACTUALLY used (tests
            # assert these collapse to few buckets)
            self.scatter_widths.append(target)
            with trace_span("ps/scatter", "ps"):
                w.index_copy_(0, ids_t.to(w.device, non_blocking=pin),
                              rows_t.to(w.device, non_blocking=pin)
                              .to(w.dtype))

    def start_communicator(self, scope, **kw):
        """Async mode: route gradient pushes through a background
        Communicator (reference communicator.h) so the step never blocks
        on the network; a recv thread refreshes dense params."""
        from ..distributed.communicator import Communicator
        self.ensure_init(scope)
        self._communicator = Communicator(self, scope, **kw)
        self._communicator.start()
        return self._communicator

    def _marshal_grad(self, spec, g):
        """One representation for both send paths: sparse specs yield an
        (int64 rows, float32 vals) pair — densified grads fall back to
        full-table rows — dense specs a float32 ndarray. `g` is a host
        array or a (rows, values) pair of host arrays."""
        if spec.sparse:
            if isinstance(g, tuple):
                rows, vals = g
                return (np.asarray(rows, np.int64).ravel(),
                        np.asarray(vals, np.float32).reshape(
                            -1, spec.dim))
            return (np.arange(spec.shape[0]),
                    np.asarray(g, np.float32).reshape(spec.shape))
        return np.asarray(g, np.float32)

    def _sync_lr(self, spec, fetched):
        lr = float(np.ravel(np.asarray(fetched[spec.lr_var]))[0])
        if self._last_lr.get(spec.name) != lr:
            # sharded sparse tables exist on EVERY server
            eps = self.endpoints if spec.sparse else [spec.endpoint]
            for ep in eps:
                self._client(ep).set_lr(spec.name, lr)
            self._last_lr[spec.name] = lr

    def _fetch_host(self, fetched):
        """The gradients and learning rates of a step on the host: one
        batch of copies and one synchronisation for all of them
        (io._host_arrays), a SelectedRows as its (rows, values) pair."""
        from ..framework.selected_rows import SelectedRows
        from ..io import _host_arrays
        flat, sparse = {}, set()
        for name in self.extra_fetches():
            v = fetched[name]
            if isinstance(v, SelectedRows):
                flat[name + "@rows"], flat[name] = v.rows, v.values
                sparse.add(name)
            else:
                flat[name] = v
        with trace_span("ps/fetch", "ps"):
            host = _host_arrays(flat)
        return {name: ((host[name + "@rows"], host[name])
                       if name in sparse else host[name])
                for name in self.extra_fetches()}

    def after_step(self, scope, fetched: Dict[str, object]):
        """Push grads (optimizer runs server-side), pull updated dense
        params. Sync mode's push blocks until all trainers contributed —
        the send_barrier/fetch_barrier of the reference collapsed into the
        aggregation round. With a Communicator, pushes are queued and this
        returns immediately."""
        fetched = self._fetch_host(fetched)
        if self._communicator is not None:
            grads = {}
            for s in self.specs:
                self._sync_lr(s, fetched)
                grads[s.grad_name] = self._marshal_grad(
                    s, fetched[s.grad_name])
            self._communicator.push(grads)
            return
        for s in self.specs:
            self._sync_lr(s, fetched)
            g = self._marshal_grad(s, fetched[s.grad_name])
            if s.sparse:
                with trace_span("ps/push_sparse", "ps"):
                    self.push_sparse_sharded(s, g[0], g[1])
            else:
                with trace_span("ps/push_dense", "ps"):
                    self._client(s.endpoint).push_dense(s.name, g)
        self.pull_dense(scope)

    def checkpoint_notify(self, dirname: str):
        """Ask every pserver to snapshot its shard (tables + optimizer
        state) under dirname/shard-<i>.pskv on the server's filesystem —
        the reference's checkpoint_notify_op -> RequestCheckpoint flow."""
        import os
        for i, ep in enumerate(self.endpoints):
            self._client(ep).save_checkpoint(
                os.path.join(dirname, f"shard-{i}.pskv"))

    def restore_notify(self, dirname: str, scope=None):
        """Restore every pserver shard; with `scope`, also refresh the
        trainer's dense params from the restored tables (otherwise the
        local params silently stay at their startup values until the
        first after_step pull)."""
        import os
        for i, ep in enumerate(self.endpoints):
            self._client(ep).load_checkpoint(
                os.path.join(dirname, f"shard-{i}.pskv"))
        if scope is not None:
            self.pull_dense(scope)

    def shutdown(self, stop_servers: bool = False):
        if self._communicator is not None:
            self._communicator.stop()
            self._communicator = None
        pool = getattr(self, "_fanout_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._fanout_pool = None
        for ep, c in list(self._clients.items()):
            if stop_servers:
                try:
                    c.shutdown_server()
                except Exception:
                    pass
            c.close()
        self._clients.clear()
