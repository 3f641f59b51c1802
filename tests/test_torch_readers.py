"""The readers of the PyTorch port against the JAX package's, on the CPU:
`reader/decorator.py`, `reader/py_reader.py`, `data_feeder.py` and the
reader ops (create_py_reader, create_double_buffer_reader,
create_custom_reader, read).

  * every decorator gives JAX's samples, in JAX's order (shuffle under
    the same `random` seed);
  * DataFeeder's batches equal JAX's; given a place they are tensors
    there; an over-long sample raises as JAX's;
  * PyReader, iterable: the same feed dicts as JAX's, an early break
    releases the producer; non-iterable: the read op feeds the step, the
    start / EOFError / reset epoch cycle gives JAX's outputs;
  * the reader ops: py_reader + read feeds each step and raises EOFError
    at the end, as JAX's; the double buffer gives every batch once, in
    order, over many steps (the JAX package's double buffer is rebuilt
    each run and drops the batches its thread staged, so it is held to
    JAX's py_reader sequence, and to JAX's own double buffer on one
    step); a custom reader's sub-block gives JAX's batches;
  * no reader thread is left behind, at the end of the data or after a
    reset mid-epoch.
"""

import queue
import random
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu import reader as jrd
from paddle_tpu_torch import reader as trd
from paddle_tpu_torch.ops import reader_ops

THREADS = ("reader.double_buffer", "py_reader.pump", "py_reader.fill")


def _texe():
    return ptt.Executor(ptt.CPUPlace())


def _reader_threads(wait=3.0):
    """Names of the reader threads still alive after up to `wait` s."""
    end = time.time() + wait
    while True:
        alive = [t.name for t in threading.enumerate()
                 if t.name in THREADS]
        if not alive or time.time() > end:
            return alive
        time.sleep(0.05)


def _r(n):
    def reader():
        yield from range(n)
    return reader


# ---------------------------------------------------------------------------
# decorators
# ---------------------------------------------------------------------------

DECORATOR_CASES = {
    "batch": lambda rd: list(rd.batch(_r(10), 3)()),
    "batch_drop_last": lambda rd: list(rd.batch(_r(10), 3,
                                                drop_last=True)()),
    "firstn": lambda rd: list(rd.firstn(_r(100), 4)()),
    "shuffle": lambda rd: (random.seed(0),
                           list(rd.shuffle(_r(20), 7)()))[1],
    "chain": lambda rd: list(rd.chain(_r(2), _r(3))()),
    "compose": lambda rd: list(rd.compose(_r(3), _r(3))()),
    "map_readers": lambda rd: list(rd.map_readers(lambda a, b: a + b,
                                                  _r(3), _r(3))()),
    "buffered": lambda rd: list(rd.buffered(_r(50), 8)()),
    "cache": lambda rd: (lambda c: list(c()) + list(c()))(
        rd.cache(_r(5))),
    "xmap_ordered": lambda rd: list(rd.xmap_readers(
        lambda x: x * x, _r(30), 4, 8, order=True)()),
    "xmap_unordered": lambda rd: sorted(rd.xmap_readers(
        lambda x: x * x, _r(30), 4, 8, order=False)()),
    "multi_reader": lambda rd: sorted(rd.multiprocess_reader(
        [_r(5), _r(5)])()),
    "fake": lambda rd: list(rd.Fake()(_r(3), 4)()),
}


@pytest.mark.parametrize("case", sorted(DECORATOR_CASES))
def test_decorators_match_jax(case):
    fn = DECORATOR_CASES[case]
    assert fn(trd) == fn(jrd)


def test_compose_not_aligned_raises_as_jax():
    for rd in (jrd, trd):
        with pytest.raises(rd.ComposeNotAligned):
            list(rd.compose(_r(2), _r(3))())
    assert list(trd.compose(_r(2), _r(3), check_alignment=False)()) == \
        list(jrd.compose(_r(2), _r(3), check_alignment=False)())


# ---------------------------------------------------------------------------
# DataFeeder and PyReader
# ---------------------------------------------------------------------------

def _feed_program(pkg, iterable=True, capacity=2):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data("img", [4], dtype="float32")
        label = pkg.layers.data("label", [1], dtype="int64")
        ids = pkg.layers.data("ids", [5], dtype="int64")
        reader = pkg.PyReader(feed_list=[img, label, ids],
                              capacity=capacity, iterable=iterable)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(img, 3), label))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, reader, (img, label, ids), loss


def _samples(seed, n_batches=5, b=8):
    def gen():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            yield [(rng.rand(4).astype(np.float32), rng.randint(0, 3),
                    list(rng.randint(1, 9, rng.randint(1, 6))))
                   for _ in range(b)]
    return gen


def test_data_feeder_matches_jax_and_places_tensors():
    batch = _samples(0, 1)().__next__()
    outs = []
    for pkg in (pt, ptt):
        main, _, _, feed_vars, _ = _feed_program(pkg)
        outs.append(pkg.DataFeeder(feed_list=list(feed_vars),
                                   program=main).feed(batch))
    assert sorted(outs[0]) == sorted(outs[1])
    for k in outs[0]:
        np.testing.assert_array_equal(outs[1][k], outs[0][k])
        assert outs[1][k].dtype == outs[0][k].dtype or k != "img"
    main, _, _, feed_vars, _ = _feed_program(ptt)
    placed = ptt.DataFeeder(list(feed_vars), ptt.CPUPlace(),
                            program=main).feed(batch)
    for k, v in placed.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), outs[1][k])
    with pytest.raises(ValueError, match="shape mismatch"):
        ptt.DataFeeder([feed_vars[0]], program=main).feed(
            [(np.ones(8, np.float32), 1, [1])])


@pytest.mark.parametrize("return_list", [False, True])
def test_iterable_py_reader_feeds_equal_jax_and_train(return_list):
    got = []
    for pkg in (pt, ptt):
        main, startup, reader, _, loss = _feed_program(pkg)
        reader._return_list = return_list
        reader.decorate_sample_list_generator(_samples(1))
        got.append(list(reader))
    assert len(got[0]) == len(got[1]) == 5
    for a, b in zip(*got):
        items = zip(a, b) if return_list else \
            ((a[k], b[k]) for k in a)
        for x, y in items:
            np.testing.assert_array_equal(x, y)
    main, startup, reader, _, loss = _feed_program(ptt)
    reader.decorate_sample_list_generator(_samples(1))
    exe, sc = _texe(), ptt.Scope()
    exe.run(startup, scope=sc)
    losses = [exe.run(main, feed=f, fetch_list=[loss], scope=sc)[0]
              for f in reader]
    assert len(losses) == 5 and np.isfinite(losses).all()


def test_iterable_py_reader_early_break_releases_producer():
    main, _, reader, _, _ = _feed_program(ptt)

    def gen():
        for i in range(1000):
            yield [(np.full(4, i, np.float32), 0, [1])]
    reader.decorate_sample_list_generator(gen)
    for _ in reader:
        break   # the fill thread sees the stop flag and exits
    assert _reader_threads() == []


def _non_iterable(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name_guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name, [3])
        reader = pkg.PyReader(feed_list=[x], capacity=2, iterable=False)
        y = pkg.layers.scale(x, scale=2.0)
    return main, startup, reader, y


def test_non_iterable_py_reader_epochs_match_jax():
    batches = [np.full((2, 3), i, np.float32) for i in range(3)]
    got = []
    for pkg in (pt, ptt):
        main, startup, reader, y = _non_iterable(pkg, "pr_x")
        reader.decorate_batch_generator(lambda: iter([(b,) for b in
                                                      batches]))
        exe = pt.Executor() if pkg is pt else _texe()
        outs = []
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            for _ in range(2):
                reader.start()
                while True:
                    try:
                        out, = exe.run(main, fetch_list=[y])
                    except EOFError:
                        reader.reset()
                        break
                    outs.append(np.asarray(out))
        got.append(outs)
    assert len(got[1]) == 6
    for a, b in zip(*got):
        np.testing.assert_array_equal(b, a)
    assert _reader_threads() == []
    main, _, reader, _ = _non_iterable(ptt, "pr2_x")
    with pytest.raises(RuntimeError, match="decorate"):
        reader.start()


# ---------------------------------------------------------------------------
# the reader ops
# ---------------------------------------------------------------------------

def _reader_op_program(pkg, double_buffer, custom=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        blk = main.global_block
        for nm in ("r_queue", "r_inner", "r_db", "r_custom"):
            blk.create_var(name=nm, shape=None, dtype="float32")
        x = blk.create_var(name="r_x", shape=[2, 3], dtype="float32")
        blk.append_op("create_py_reader", {"blocking_queue": ["r_queue"]},
                      {"Out": ["r_inner"]}, {"out_names": ["r_x"]},
                      infer_shape=False)
        src = "r_inner"
        if double_buffer:
            blk.append_op("create_double_buffer_reader",
                          {"UnderlyingReader": [src]}, {"Out": ["r_db"]},
                          {}, infer_shape=False)
            src = "r_db"
        if custom:
            sub = main.create_block(0)
            sx = sub.create_var(name="c_in", shape=[2, 3], dtype="float32")
            so = sub.create_var(name="c_out", shape=[2, 3],
                                dtype="float32")
            sub.append_op("scale", {"X": [sx.name]}, {"Out": [so.name]},
                          {"scale": 0.5, "bias": 1.0,
                           "bias_after_scale": True}, infer_shape=False)
            blk.append_op("create_custom_reader",
                          {"UnderlyingReader": [src]},
                          {"Out": ["r_custom"]},
                          {"sub_block": sub.idx,
                           "source_var_names": ["c_in"],
                           "sink_var_names": ["c_out"]},
                          infer_shape=False)
            src = "r_custom"
        blk.append_op("read", {"Reader": [src]}, {"Out": ["r_x"]}, {},
                      infer_shape=False)
        y = pkg.layers.scale(x, scale=3.0)
    return main, startup, y


def _queue_of(n):
    q = queue.Queue()
    for i in range(n):
        q.put((np.full((2, 3), i, np.float32) + np.arange(3, dtype="f"),))
    q.put(None)
    return q


def _run_reader_program(pkg, double_buffer, n, steps, custom=False):
    main, startup, y = _reader_op_program(pkg, double_buffer, custom)
    exe = pt.Executor() if pkg is pt else _texe()
    outs = []
    with pkg.scope_guard(pkg.Scope()):
        pkg.global_scope().set_var("r_queue", _queue_of(n))
        exe.run(startup)
        for _ in range(steps):
            try:
                outs.append(np.asarray(exe.run(main, fetch_list=[y])[0]))
            except EOFError:
                outs.append("EOF")
                break
    return outs


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str) or isinstance(y, str):
            assert x == y
        else:
            np.testing.assert_array_equal(y, x)


def test_py_reader_op_read_feeds_each_step_as_jax():
    j = _run_reader_program(pt, False, 3, 5)
    t = _run_reader_program(ptt, False, 3, 5)
    assert t[-1] == "EOF" and len(t) == 4
    _same(j, t)


def test_double_buffer_gives_every_batch_once_in_order():
    t = _run_reader_program(ptt, True, 6, 10)
    _same(_run_reader_program(pt, False, 6, 10), t)
    # one step: the JAX package's own double buffer (a second run of it
    # after the data's end blocks on the drained queue: not run)
    one = _run_reader_program(ptt, True, 1, 3)
    _same(_run_reader_program(pt, True, 1, 1), one[:1])
    assert one[1:] == ["EOF"]
    assert _reader_threads() == []


def test_custom_reader_sub_block_matches_jax():
    j = _run_reader_program(pt, False, 4, 6, custom=True)
    t = _run_reader_program(ptt, False, 4, 6, custom=True)
    _same(j, t)
    _same(j, _run_reader_program(ptt, True, 4, 6, custom=True))


def test_double_buffer_thread_stops_on_reset_mid_epoch():
    """A PyReader whose read goes through a double buffer: reset() after
    two steps of a long epoch stops both the pump and the staging thread;
    the next epoch starts from its first batch."""
    main, startup, reader, y = _non_iterable(ptt, "db_x")
    blk = main.global_block
    read = next(op for op in blk.ops if op.type == "read")
    blk.create_var(name="db_buffered", shape=None, dtype="float32")
    blk.insert_op(blk.ops.index(read), "create_double_buffer_reader",
                  {"UnderlyingReader": read.input("Reader")},
                  {"Out": ["db_buffered"]}, {}, infer_shape=False)
    read.inputs["Reader"] = ["db_buffered"]
    batches = [np.full((2, 3), i, np.float32) for i in range(50)]
    reader.decorate_batch_generator(lambda: iter([(b,) for b in batches]))
    exe, sc = _texe(), ptt.Scope()
    exe.run(startup, scope=sc)
    for epoch in range(2):
        reader.start(sc)
        for i in range(2):
            out, = exe.run(main, fetch_list=[y], scope=sc)
            np.testing.assert_array_equal(out, 2.0 * batches[i])
        assert "reader.double_buffer" in [t.name for t in
                                          threading.enumerate()]
        reader.reset()
        assert _reader_threads() == []


def test_reader_state_close_and_missing_reader():
    q = _queue_of(100)
    main, startup, y = _reader_op_program(ptt, True)
    exe, sc = _texe(), ptt.Scope()
    sc.set_var("r_queue", q)
    exe.run(startup, scope=sc)
    exe.run(main, fetch_list=[y], scope=sc)
    db = sc.find_var("r_db")
    reader_ops.close_readers(sc, q)
    assert db.closed and sc.find_var("r_inner").closed
    assert _reader_threads() == []
    p = ptt.Program()
    p.global_block.append_op("read", {"Reader": ["nope"]}, {"Out": ["o"]},
                             {}, infer_shape=False)
    with pytest.raises(RuntimeError, match="not in scope"):
        _texe().run(p)
