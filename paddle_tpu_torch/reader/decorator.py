"""Reader decorators (reference: python/paddle/reader/decorator.py).

A copy of `paddle_tpu/reader/decorator.py` (pure Python, no device code).
A *reader creator* is a zero-arg callable returning an iterable of
samples. Decorators wrap reader creators into new ones — identical
contract to the reference so data pipelines port unchanged.
"""

from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading
from typing import Callable, Iterable, List, Sequence

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "batch",
           "multiprocess_reader", "ComposeNotAligned", "PipeReader",
           "Fake"]


class _Raise:
    """Exception carrier: producer threads must not silently truncate the
    stream — the consumer re-raises."""

    def __init__(self, exc):
        self.exc = exc


def map_readers(func, *readers):
    """Apply func to the items of several readers zipped together."""
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)
    return reader


def shuffle(reader, buf_size: int):
    """Shuffle within a sliding buffer (reference decorator.py shuffle)."""
    def shuffled():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return shuffled


def chain(*readers):
    """Concatenate readers back to back."""
    def reader():
        for r in readers:
            yield from r()
    return reader


class ComposeNotAligned(ValueError):
    """Raised when composed readers yield different stream lengths
    (reference: reader/decorator.py:145)."""


def compose(*readers, check_alignment: bool = True):
    """Zip readers into tuples; sample fields are flattened like the
    reference (a tuple sample contributes its elements).  With
    check_alignment, uneven streams raise ComposeNotAligned instead of
    silently truncating."""
    def _flatten(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    _END = object()

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for items in itertools.zip_longest(*rs, fillvalue=_END):
                if any(i is _END for i in items):
                    if not all(i is _END for i in items):
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned")
                    return
                yield sum((_flatten(i) for i in items), ())
        else:
            for items in itertools.zip_longest(*rs):
                items = [i for i in items if i is not None]
                yield sum((_flatten(i) for i in items), ())
    return reader


def buffered(reader, size: int):
    """Prefetch into a bounded queue on a background thread (the
    double-buffering analog of reader/buffered_reader.cc)."""
    class _End:
        pass

    def buffered_reader():
        q: _queue.Queue = _queue.Queue(maxsize=size)

        def fill():
            try:
                for e in reader():
                    q.put(e)
                q.put(_End)
            except BaseException as exc:  # re-raised in the consumer
                q.put(_Raise(exc))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            if isinstance(e, _Raise):
                raise e.exc
            yield e
    return buffered_reader


def firstn(reader, n: int):
    def reader_n():
        return itertools.islice(reader(), n)
    return reader_n


def cache(reader):
    """Materialize the underlying reader once; replay from memory."""
    all_data: List = []
    filled = [False]

    def cached():
        if not filled[0]:
            all_data.extend(reader())
            filled[0] = True
        yield from all_data
    return cached


def xmap_readers(mapper, reader, process_num: int, buffer_size: int,
                 order: bool = False):
    """Parallel map over samples with worker threads (reference
    xmap_readers). order=True preserves input order."""
    class _End:
        pass

    def xreader():
        in_q: _queue.Queue = _queue.Queue(buffer_size)
        out_q: _queue.Queue = _queue.Queue(buffer_size)

        def feed():
            for i, e in enumerate(reader()):
                in_q.put((i, e))
            for _ in range(process_num):
                in_q.put(_End)

        def work():
            while True:
                item = in_q.get()
                if item is _End:
                    out_q.put(_End)
                    return
                i, e = item
                out_q.put((i, mapper(e)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        if order:
            pending = {}
            want = 0
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                i, v = item
                pending[i] = v
                while want in pending:
                    yield pending.pop(want)
                    want += 1
            for i in sorted(pending):
                yield pending[i]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is _End:
                    finished += 1
                    continue
                yield item[1]
    return xreader


def multiprocess_reader(readers, use_pipe: bool = True,
                        queue_size: int = 1000):
    """Interleave several readers concurrently (thread-backed here, as in
    the JAX package; the reference forks processes)."""
    class _End:
        pass

    def reader():
        q: _queue.Queue = _queue.Queue(queue_size)

        def pump(r):
            try:
                for e in r():
                    q.put(e)
                q.put(_End)
            except BaseException as exc:
                q.put(_Raise(exc))

        for r in readers:
            threading.Thread(target=pump, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            e = q.get()
            if e is _End:
                finished += 1
                continue
            if isinstance(e, _Raise):
                raise e.exc
            yield e
    return reader


def batch(reader, batch_size: int, drop_last: bool = False):
    """Group samples into lists (reference: paddle/batch.py)."""
    def batch_reader():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


class PipeReader:
    """Stream lines from a shell command's stdout (reference:
    reader/decorator.py:460 — `hadoop fs -cat`, `curl`, etc.).
    file_type "plain" or "gzip"."""

    def __init__(self, command, bufsize: int = 8192,
                 file_type: str = "plain"):
        if not isinstance(command, str):
            raise TypeError("left_cmd must be a string")
        if file_type not in ("plain", "gzip"):
            raise TypeError(f"file_type {file_type} is not allowed")
        import subprocess
        self.command = command
        self.file_type = file_type
        self.bufsize = bufsize
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)

    def get_line(self, cut_lines: bool = True, line_break: str = "\n"):
        """Yield decoded lines (or raw chunks with cut_lines=False)."""
        if self.file_type == "gzip":
            import zlib
            decomp = zlib.decompressobj(32 + zlib.MAX_WBITS)
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                break
            if self.file_type == "gzip":
                decomp_buff = decomp.decompress(buff).decode()
            else:
                decomp_buff = buff.decode()
            if cut_lines:
                lines = (remained + decomp_buff).split(line_break)
                remained = lines.pop(-1)
                yield from lines
            else:
                yield decomp_buff
        if cut_lines and remained:
            yield remained


class Fake:
    """Cache the first sample and replay it data_num times — a
    fixed-input speed-testing reader (reference: decorator.py:531)."""

    def __init__(self):
        self.data = None
        self.yield_num = 0

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            while self.yield_num < data_num:
                yield self.data
                self.yield_num += 1
            self.yield_num = 0
        return fake_reader
