"""PyReader: python-generator-fed input pipeline.

Reference: python/paddle/fluid/reader.py:47 PyReader — a generator feeds a
LoDTensorBlockingQueue consumed by an in-graph read op. A copy of
`paddle_tpu/reader/py_reader.py`: the ITERABLE form (the reference's
iterable=True mode, the default) wraps the decorated generator with a
background prefetch queue and yields ready feed dicts; the non-iterable
form appends create_py_reader + read ops, which the executor runs as host
ops before the step (ops/reader_ops.py). `reset()` also stops the reader
threads the in-graph readers built over this reader's queue (a
create_double_buffer_reader's staging thread), so an epoch cut short
leaves no thread behind.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data_feeder import DataFeeder

__all__ = ["PyReader", "create_py_reader_by_data", "read_file",
           "double_buffer"]


class PyReader:
    def __init__(self, feed_list: Sequence, capacity: int = 4,
                 iterable: bool = True, return_list: bool = False):
        self._feeder = DataFeeder(feed_list)
        self._names = [v.name for v in self._feeder.feed_vars]
        self._capacity = capacity
        self._return_list = return_list
        self._source = None
        self._mode = None
        self._iterable = iterable
        if not iterable:
            # NON-iterable (reference reader.py:47 default) form: append
            # create_py_reader + read ops to the current program; the
            # executor's host-op boundary pops a batch per step and
            # raises EOFError at exhaustion (the core.EOFException
            # analog). start() spins the decorated generator into the
            # scope-resident queue.
            from ..framework.core import default_main_program, unique_name

            blk = default_main_program().global_block
            self._queue_name = unique_name("py_reader.queue")
            self._reader_name = unique_name("py_reader.reader")
            blk.create_var(name=self._queue_name, dtype="float32")
            blk.create_var(name=self._reader_name, dtype="float32")
            blk.append_op("create_py_reader",
                          {"blocking_queue": [self._queue_name]},
                          {"Out": [self._reader_name]},
                          {"out_names": list(self._names)},
                          infer_shape=False)
            blk.append_op("read", {"Reader": [self._reader_name]},
                          {"Out": list(self._names)}, {},
                          infer_shape=False)
            self._thread = None

    # -- non-iterable lifecycle (reference start()/reset()) ------------------
    def start(self, scope=None):
        """Begin one epoch: feed the decorated generator into the in-graph
        reader's queue on a background thread. Only for iterable=False.
        (The create_py_reader host op rebinds the reader from the queue on
        every Executor.run — ops/reader_ops.py.)"""
        if self._iterable:
            return  # reference parity no-op: iterable mode feeds per-loop
        if self._source is None:
            raise RuntimeError("call decorate_*_generator first")
        from ..framework.executor import global_scope
        scope = scope or global_scope()
        self._scope = scope
        q: _queue.Queue = _queue.Queue(self._capacity)
        scope.set_var(self._queue_name, q)
        stop = threading.Event()
        self._pump_stop = stop
        self._pump_error = None

        def _put(item) -> bool:
            # timed put so an early-terminated epoch (break before
            # EOFError) cannot pin this thread on a full queue forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def pump():
            try:
                for item in self._source():
                    feed = self._to_feed(item)
                    if not _put(tuple(feed[n] for n in self._names)):
                        return
            except Exception as e:  # surface via reset(), not a hang
                self._pump_error = e
            finally:
                _put(None)  # ALWAYS deliver the end-of-epoch sentinel

        self._thread = threading.Thread(target=pump, daemon=True,
                                        name="py_reader.pump")
        self._thread.start()

    def reset(self, scope=None):
        """Recover after the EOFError that ends an epoch (reference
        reader.reset after catching EOFException). Re-raises any error
        the feeding generator hit mid-epoch."""
        if self._iterable:
            return  # reference parity no-op
        if self._thread is not None:
            self._pump_stop.set()
            self._thread.join(timeout=10)
            self._thread = None
        from ..ops.reader_ops import close_readers
        scope = scope or getattr(self, "_scope", None)
        if scope is not None:
            close_readers(scope, scope.find_var(self._queue_name))
        if self._pump_error is not None:
            err, self._pump_error = self._pump_error, None
            raise err

    # -- decoration (reference API) ------------------------------------------
    def decorate_sample_list_generator(self, reader, places=None):
        """reader() yields lists of samples (one minibatch per item)."""
        self._source = reader
        self._mode = "sample_list"

    def decorate_batch_generator(self, reader, places=None):
        """reader() yields ready feed batches: dicts, or tuples of arrays
        in feed_list order."""
        self._source = reader
        self._mode = "batch"

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        from .decorator import batch as _batch
        self._source = _batch(sample_generator, batch_size,
                              drop_last=drop_last)
        self._mode = "sample_list"

    # -- iteration -----------------------------------------------------------
    def _to_feed(self, item) -> Dict[str, np.ndarray]:
        if self._mode == "sample_list":
            return self._feeder.feed(item)
        if isinstance(item, dict):
            return item
        return dict(zip(self._names, item))

    def __iter__(self):
        if self._source is None:
            raise RuntimeError("call decorate_*_generator first")

        class _End:
            pass

        class _Raise:
            def __init__(self, exc):
                self.exc = exc

        q: _queue.Queue = _queue.Queue(self._capacity)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that aborts when the consumer stopped iterating
            # (early break/exception) — a blocked q.put would pin the
            # thread, the queue, and the source generator forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def fill():
            try:
                for item in self._source():
                    if not _put(self._to_feed(item)):
                        return
                _put(_End)
            except BaseException as e:
                _put(_Raise(e))

        t = threading.Thread(target=fill, daemon=True,
                             name="py_reader.fill")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _End:
                    return
                if isinstance(item, _Raise):
                    raise item.exc
                if self._return_list:
                    yield [item[n] for n in self._names]
                else:
                    yield item
        finally:
            stop.set()

    # (iterable mode: start/reset defined above are no-ops only when
    # iterable=True — handled inside those methods)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """reference: layers/io.py create_py_reader_by_data — a non-iterable
    PyReader over the given feed vars (the program-embedded reader form;
    as in the JAX package, `use_double_buffer` adds no op: a program asks
    for the staging reader with a create_double_buffer_reader op)."""
    return PyReader(feed_list, capacity=capacity, iterable=False)


def read_file(reader):
    """reference: layers/io.py read_file — the data variables a program
    reader fills each step. For our PyReader those are the feed vars it
    was built over (the non-iterable form already appended the read ops)."""
    return list(reader._feeder.feed_vars)


def double_buffer(reader, place=None, name=None):
    """reference: layers/io.py double_buffer — identity, as in the JAX
    package: the PyReader queue already overlaps host fill with the step;
    the create_double_buffer_reader op is the staging reader."""
    return reader
