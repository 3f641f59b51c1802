"""In-program reader ops (reference: operators/reader/): create_py_reader,
create_double_buffer_reader, create_custom_reader, create_ctr_reader and
read.

Port of `paddle_tpu/ops/reader_ops.py`. The ops are host ops
(registry.register_host_op): `read` runs before the step and puts the
popped batch into the run's feed, the position the reference's
ReadOp::RunImpl occupies (reader/read_op.cc). Reader values in the scope
are _ReaderState objects, the reference's ReaderHolder scope vars.

Two things differ from the JAX file, both so that a reader gives every
batch once, in order, and leaves no thread behind:
  * a create_* op whose output already holds a live reader over the same
    source keeps it: the reader keeps its place across runs (JAX rebinds
    one each run; a double buffer rebound each run loses the batches its
    last thread had staged);
  * every reader can be closed (PyReader.reset, a new epoch's queue,
    `close_readers`), which stops its threads; a reader's thread also ends
    at the end of its data.
The double buffer stages the next batches on the executor's device: on a
card, each array is copied from pinned host memory on a side CUDA stream,
with an event that the step's stream waits on before the batch is used
(the JAX package's double buffer keeps them as host arrays, which its step
copies). On the CPU it stages the host arrays, so both places read the
same batches in the same order.

create_ctr_reader parses CTR log files (svm or csv, plain or gzip) into
the JAX reader's batches; it keeps its place across runs like the other
readers, and closes at the end of its files, so the run after an epoch's
EOFError starts the next epoch.
"""

import gzip
import queue as _queue
import threading

import numpy as np
import torch

from ..framework.registry import register_host_op, lower_op, LowerContext

_POLL_S = 0.1   # how often a blocked reader thread looks at its stop flag


class _ReaderState:
    """Scope-resident reader: pop() -> {var_name: value} or None at the end
    of its data. `root` is the blocking queue it drains, directly or
    through `inner`; close() stops it and the readers under it."""

    def __init__(self, source, out_names, root=None, inner=None, stop=None):
        self._source = source          # iterator of feed dicts / tuples
        self.out_names = list(out_names)
        self.root = root
        self.inner = inner
        self._stop = stop or threading.Event()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def pop(self):
        try:
            item = next(self._source)
        except StopIteration:
            return None
        if isinstance(item, dict):
            return item
        return dict(zip(self.out_names, item))

    def close(self):
        self._stop.set()
        if self.inner is not None:
            self.inner.close()


def close_readers(scope, root) -> None:
    """Close every reader in `scope` that drains the blocking queue `root`
    (PyReader.reset: an epoch cut short leaves no reader thread behind)."""
    if root is None:
        return
    for name in scope.var_names():
        r = scope.find_var(name)
        if isinstance(r, _ReaderState) and r.root is root:
            r.close()


def _keep(scope, out_name, **same):
    """True when the op's output already holds a live reader whose
    attributes equal `same` (the op ran on an earlier step); a reader there
    over another source is closed."""
    cur = scope.find_var(out_name)
    if not isinstance(cur, _ReaderState):
        return False
    if not cur.closed and all(getattr(cur, k) is v for k, v in same.items()):
        return True
    cur.close()
    return False


@register_host_op("create_py_reader")
def _create_py_reader(op, scope, feed, device):
    """reference: reader/create_py_reader_op.cc: turn the blocking queue
    var (fed by PyReader.start()'s thread) into a reader var."""
    qname = op.input("blocking_queue")[0] if op.inputs.get(
        "blocking_queue") else op.attrs.get("queue_name")
    q = scope.find_var(qname)
    if q is None:
        raise RuntimeError(
            f"create_py_reader: queue var {qname!r} not in scope; call "
            "PyReader.start() first")
    out = op.output("Out")[0]
    if _keep(scope, out, root=q):
        return
    stop = threading.Event()

    def drain():
        while not stop.is_set():
            try:
                item = q.get(timeout=_POLL_S)
            except _queue.Empty:
                continue
            if item is None:     # sentinel from PyReader exhaustion
                return
            yield item

    scope.set_var(out, _ReaderState(drain(), op.attrs.get("out_names", []),
                                    root=q, stop=stop))


class _DoubleBuffer(_ReaderState):
    """A thread pops the inner reader ahead and stages up to two batches
    on `device` (reference: reader/create_double_buffer_reader_op.cc,
    buffered_reader.cc). On a card: pinned host copy, non-blocking copy on
    a side stream, an event; pop() makes the caller's stream wait on it."""

    def __init__(self, inner, device):
        super().__init__(None, inner.out_names, root=inner.root, inner=inner)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._buf: _queue.Queue = _queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="reader.double_buffer")
        self._thread.start()

    def _stage(self, item):
        if isinstance(item, dict):
            names, vals = list(item), list(item.values())
        else:
            names, vals = self.out_names, list(item)
        if self._stream is None:
            return dict(zip(names, vals)), None
        out = {}
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._stream):
            for n, v in zip(names, vals):
                t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(np.asarray(v)))
                if t.device.type == "cpu":
                    t = t.pin_memory()
                out[n] = t.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._buf.put(item, timeout=_POLL_S)
                return True
            except _queue.Full:
                continue
        return False

    def _pump(self):
        try:
            while not self._stop.is_set():
                item = self.inner.pop()
                if item is None:
                    self._put(None)
                    return
                if not self._put(self._stage(item)):
                    return
        except BaseException as e:  # raised to the reading step
            self._put(e)

    def pop(self):
        while True:
            try:
                item = self._buf.get(timeout=_POLL_S)
                break
            except _queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive():
                    return None
        if item is None:
            return None
        if isinstance(item, BaseException):
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch


@register_host_op("create_double_buffer_reader")
def _create_double_buffer_reader(op, scope, feed, device):
    """reference: reader/create_double_buffer_reader_op.cc: prefetch two
    batches ahead on a thread, staged on the executor's device."""
    inner = scope.find_var(op.input("UnderlyingReader")[0])
    out = op.output("Out")[0]
    if _keep(scope, out, inner=inner):
        return
    scope.set_var(out, _DoubleBuffer(inner, device))


@register_host_op("create_custom_reader")
def _create_custom_reader(op, scope, feed, device):
    """reference: reader/create_custom_reader_op.cc: run a user sub-block
    over every batch (source vars in, sink vars out), eagerly on the
    executor's device, the reference's nested-executor semantics. The
    sub-block's random ops draw from a generator seeded 0, as JAX's key."""
    inner = scope.find_var(op.input("UnderlyingReader")[0])
    out = op.output("Out")[0]
    if _keep(scope, out, inner=inner):
        return
    program = op.block.program
    sub = program.blocks[op.attrs["sub_block"]]
    sources = list(op.attrs["source_var_names"])
    sinks = list(op.attrs["sink_var_names"])

    def gen():
        while True:
            item = inner.pop()
            if item is None:
                return
            vals = (list(item.values()) if isinstance(item, dict)
                    else list(item))
            env = {n: (v if isinstance(v, torch.Tensor) else
                       torch.from_numpy(np.ascontiguousarray(np.asarray(v))))
                   .to(device) for n, v in zip(sources, vals)}
            ctx = LowerContext(device=device, seed=0)
            with torch.no_grad():
                for sop in sub.ops:
                    lower_op(ctx, sop, env)
            yield {n: env[n] for n in sinks}

    scope.set_var(out, _ReaderState(gen(), sinks, root=inner.root,
                                    inner=inner))


def _parse_ctr_lines(lines, file_format, slots):
    """svm: 'label slot:feasign slot:feasign...';
    csv: 'label,id,id,...' (ids assigned to slots round-robin)."""
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        if file_format == "svm":
            parts = ln.split()
            label = int(float(parts[0]))
            per_slot = {s: [] for s in slots}
            for tok in parts[1:]:
                s, v = tok.split(":", 1)
                if s in per_slot:
                    per_slot[s].append(int(v))
            yield label, [per_slot[s] for s in slots]
        else:  # csv
            parts = ln.split(",")
            label = int(float(parts[0]))
            ids = [int(float(p)) for p in parts[1:]]
            yield label, [ids[i::len(slots)] for i in range(len(slots))]


def _ctr_batch(buf, slots):
    """(labels [b, 1], one [b, max_ids] int64 matrix a slot, 0-padded)."""
    labels = np.asarray([r[0] for r in buf], np.int64).reshape(-1, 1)
    outs = [labels]
    for si in range(len(slots)):
        width = max(max((len(r[1][si]) for r in buf), default=1), 1)
        m = np.zeros((len(buf), width), np.int64)
        for bi, r in enumerate(buf):
            ids = r[1][si]
            m[bi, :len(ids)] = ids
        outs.append(m)
    return tuple(outs)


@register_host_op("create_ctr_reader")
def _create_ctr_reader(op, scope, feed, device):
    """reference: reader/create_ctr_reader_op.cc — parse CTR log files
    (svm/csv, plain or gzip) into (label, per-slot sparse id) batches.
    Dense form, as JAX's: each slot becomes [batch, max_ids] int64 padded
    with 0."""
    out = op.output("Out")[0]
    if _keep(scope, out, root=op):
        return
    files = list(op.attrs.get("file_list", []))
    slots = [str(s) for s in op.attrs.get("sparse_slots",
                                          op.attrs.get("slots", []))]
    batch_size = int(op.attrs.get("batch_size", 32))
    file_format = op.attrs.get("file_format", "csv")
    opener = gzip.open if op.attrs.get("file_type", "plain") == "gzip" \
        else open
    stop = threading.Event()

    def gen():
        buf = []
        for path in files:
            with opener(path, "rt") as f:
                for rec in _parse_ctr_lines(f, file_format, slots):
                    buf.append(rec)
                    if len(buf) == batch_size:
                        yield _ctr_batch(buf, slots)
                        buf = []
        if buf:
            yield _ctr_batch(buf, slots)
        stop.set()   # the epoch's end: the next run's create op starts anew

    names = op.attrs.get("out_names", []) or \
        ["label"] + [f"slot_{s}" for s in slots]
    scope.set_var(out, _ReaderState(gen(), names, root=op, stop=stop))


@register_host_op("read")
def _read(op, scope, feed, device):
    """reference: reader/read_op.cc: pop one batch from the reader var and
    bind it to the out vars; raises EOFError at exhaustion (the reference
    throws EOFException for the train loop to catch)."""
    reader = scope.find_var(op.input("Reader")[0])
    if reader is None:
        raise RuntimeError(
            f"read: reader var {op.input('Reader')[0]!r} not in scope")
    batch = reader.pop()
    if batch is None:
        raise EOFError("read op: reader exhausted (end of epoch)")
    out_names = op.output("Out")
    vals = (list(batch.values()) if isinstance(batch, dict)
            else list(batch))
    if len(vals) < len(out_names):
        raise RuntimeError(
            f"read: reader produced {len(vals)} slots for "
            f"{len(out_names)} out vars")
    for n, v in zip(out_names, vals):
        feed[n] = v if isinstance(v, torch.Tensor) else np.asarray(v)
