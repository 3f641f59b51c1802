"""Control-flow layers: While / while_loop / cond / Switch / StaticRNN /
DynamicRNN / IfElse.

Copied from `paddle_tpu/layers/control_flow.py` (the DSL holds no device
code). Reference: python/paddle/fluid/layers/control_flow.py (While:644,
StaticRNN:294, ConditionalBlock:1366, Switch:1450, IfElse:1578,
DynamicRNN:1714). Sub-blocks are real IR blocks; the macro ops in
ops/control_flow_ops.py run them as Python loops and branches.

Gradients: While loops are differentiable when built with a static
`max_trip_count` (the grad replays the loop in JAX's bounded form — see
ops/control_flow_ops.py); StaticRNN/DynamicRNN and cond are always
differentiable.
"""

import contextlib

from ..framework.core import (Variable, default_main_program, unique_name)
from ..framework.layer_helper import LayerHelper

__all__ = ["reorder_lod_tensor_by_rank", "is_empty",
           "While", "while_loop", "cond", "Switch", "StaticRNN",
           "DynamicRNN", "IfElse"]


def _outer_writes(sub_block):
    """Names written by sub-block ops that live in an OUTER block (these are
    the vars that persist past the construct)."""
    writes = []
    for op in sub_block.ops:
        for n in op.output_names():
            if n not in sub_block.vars and n not in writes:
                writes.append(n)
    return writes


class While:
    """fluid.layers.While(cond) analog:

        i = layers.fill_constant([1], 'int64', 0)
        loop_cond = layers.less_than(i, limit)
        w = layers.While(loop_cond)
        with w.block():
            ...
            layers.increment(i)
            layers.assign(layers.less_than(i, limit), loop_cond)

    Vars assigned inside the block persist across iterations iff they were
    created outside. Shapes must be loop-invariant.

    Pass `max_trip_count=N` (a static bound on the iteration count) to make
    the loop differentiable: the backward pass replays at most N
    iterations with the carry frozen from the first false condition on
    (the JAX package's masked length-N scan).
    """

    def __init__(self, cond: Variable, name=None, max_trip_count=None):
        self._cond = cond
        self._helper = LayerHelper("while", name=name)
        self._max_trip_count = max_trip_count
        if cond.dtype != "bool":
            raise TypeError("While condition must be bool")

    @contextlib.contextmanager
    def block(self):
        program = default_main_program()
        parent = program.current_block()
        from ..framework.core import _prog_state
        sub = program.create_block()
        _prog_state.current_block_idx = sub.idx
        try:
            yield
        finally:
            _prog_state.current_block_idx = parent.idx
            from ..ops.control_flow_ops import _block_outer_reads
            attrs = {"sub_block": sub.idx}
            if self._max_trip_count is not None:
                attrs["max_trip_count"] = int(self._max_trip_count)
            parent.append_op(
                "while",
                {"Condition": [self._cond.name],
                 "X": _block_outer_reads(program, sub)},
                {"Out": _outer_writes(sub)},
                attrs, infer_shape=False)


def while_loop(cond_fn, body_fn, loop_vars, name=None,
               max_trip_count=None):
    """paddle.static.nn.while_loop-style functional API built on While.
    Pass max_trip_count to make the loop differentiable (see While)."""
    from . import tensor as t_layers
    from . import math as m_layers

    program = default_main_program()
    parent = program.current_block()
    from ..framework.core import _prog_state

    # evaluate cond once outside to create the condition var
    c0 = cond_fn(*loop_vars)
    # loop state vars must be assignable: copy into fresh vars. They keep
    # their source's grad-ability: if a boundless loop ends up on a loss
    # path, backward then RAISES (asking for max_trip_count) instead of
    # silently producing a zero gradient.
    states = []
    for v in loop_vars:
        nv = t_layers.assign(v)
        nv.stop_gradient = v.stop_gradient
        states.append(nv)
    cond_var = t_layers.assign(c0)
    cond_var.stop_gradient = True

    sub = program.create_block()
    _prog_state.current_block_idx = sub.idx
    try:
        new_states = body_fn(*states)
        if not isinstance(new_states, (list, tuple)):
            new_states = [new_states]
        if len(new_states) != len(states):
            raise ValueError(
                f"body_fn returned {len(new_states)} values for "
                f"{len(states)} loop_vars")
        for s, ns in zip(states, new_states):
            t_layers.assign(ns, output=s)
        t_layers.assign(cond_fn(*states), output=cond_var)
    finally:
        _prog_state.current_block_idx = parent.idx

    from ..ops.control_flow_ops import _block_outer_reads
    attrs = {"sub_block": sub.idx}
    if max_trip_count is not None:
        attrs["max_trip_count"] = int(max_trip_count)
    parent.append_op("while",
                     {"Condition": [cond_var.name],
                      "X": _block_outer_reads(program, sub)},
                     {"Out": _outer_writes(sub)},
                     attrs, infer_shape=False)
    return states


def cond(pred: Variable, true_fn, false_fn, name=None):
    """paddle.static.nn.cond analog — both branches built as sub-blocks;
    the run takes one. Branch returns must match in shape/dtype."""
    program = default_main_program()
    parent = program.current_block()
    from ..framework.core import _prog_state
    helper = LayerHelper("cond", name=name)

    def trace(fn):
        sub = program.create_block()
        _prog_state.current_block_idx = sub.idx
        try:
            rets = fn()
        finally:
            _prog_state.current_block_idx = parent.idx
        if rets is None:
            rets = []
        if not isinstance(rets, (list, tuple)):
            rets = [rets]
        return sub, [r.name for r in rets], list(rets)

    tb, t_names, t_vars = trace(true_fn)
    fb, f_names, f_vars = trace(false_fn)
    if len(t_names) != len(f_names):
        raise ValueError("cond branches must return the same structure")

    outs = []
    for tv in t_vars:
        o = parent.create_var(name=unique_name(f"{helper.name}.out"),
                              shape=tv.shape, dtype=tv.dtype)
        outs.append(o)
    from ..ops.control_flow_ops import _block_outer_reads
    reads = _block_outer_reads(program, tb)
    reads += [n for n in _block_outer_reads(program, fb) if n not in reads]
    parent.append_op("conditional_block",
                     {"Cond": [pred.name], "X": reads},
                     {"Out": [o.name for o in outs]},
                     {"sub_block_t": tb.idx, "sub_block_f": fb.idx,
                      "true_rets": t_names, "false_rets": f_names},
                     infer_shape=False)
    return outs[0] if len(outs) == 1 else outs


class Switch:
    """fluid.layers.Switch analog (control_flow.py:1450), built on nested
    cond():

        with Switch() as switch:
            with switch.case(cond1): ...assign lr1 to out...
            with switch.default(): ...assign lr2 to out...

    Implemented at build time by rewriting to where() chains over the
    assigned var — the common fluid use (piecewise LR) writes one var per
    branch via layers.assign.
    """

    def __init__(self, name=None):
        self._cases = []  # (cond_var or None, [captured assigns])
        self._inside = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @contextlib.contextmanager
    def case(self, condition):
        self._pre_case(condition)
        yield
        self._post_case()

    @contextlib.contextmanager
    def default(self):
        self._pre_case(None)
        yield
        self._post_case()

    def _pre_case(self, condition):
        program = default_main_program()
        parent = program.current_block()
        from ..framework.core import _prog_state
        sub = program.create_block()
        self._inside = (condition, sub, parent)
        _prog_state.current_block_idx = sub.idx

    def _post_case(self):
        condition, sub, parent = self._inside
        from ..framework.core import _prog_state
        _prog_state.current_block_idx = parent.idx
        # hoist case body as a conditional_block writing the assigned outer vars
        writes = _outer_writes(sub)
        if condition is None:
            # default: execute only if no prior case matched — build the
            # negation of the OR of previous conditions
            from . import math as m
            prev = None
            for c, _ in self._cases:
                prev = c if prev is None else m.logical_or(prev, c)
            condition = m.logical_not(prev) if prev is not None else None
        self._cases.append((condition, writes))
        if condition is None:
            # unconditional default with no prior case: inline ops
            for op in sub.ops:
                parent.ops.append(op)
            return
        # guarded: conditional_block whose false branch returns current values
        fb = default_main_program().create_block()
        t_rets = writes
        f_rets = writes  # false branch: pass through outer values
        from ..ops.control_flow_ops import _block_outer_reads
        program = default_main_program()
        reads = _block_outer_reads(program, sub)
        reads += [n for n in writes if n not in reads]
        parent.append_op("conditional_block",
                         {"Cond": [condition.name], "X": reads},
                         {"Out": writes},
                         {"sub_block_t": sub.idx, "sub_block_f": fb.idx,
                          "true_rets": t_rets, "false_rets": f_rets},
                         infer_shape=False)


# ---------------------------------------------------------------------------
# StaticRNN — the reference's main RNN-building DSL (control_flow.py:294)
# ---------------------------------------------------------------------------

class StaticRNN:
    """Step-wise RNN over TIME-MAJOR sequences, one `recurrent` op that
    loops over the time axis (reference: layers/control_flow.py:294
    StaticRNN + recurrent_op.cc).

        rnn = layers.StaticRNN()
        with rnn.step():
            word = rnn.step_input(x)          # x: [T, B, D]
            prev = rnn.memory(init=boot)      # or shape=[H], batch_ref=word
            hidden = layers.fc(input=[word, prev], size=H)
            rnn.update_memory(prev, hidden)
            rnn.step_output(hidden)
        out = rnn()                            # [T, B, H]

    Fully differentiable (recurrent_grad replays the loop under
    torch.func.vjp).
    """

    def __init__(self, name=None):
        self._helper = LayerHelper("static_rnn", name=name)
        self._program = default_main_program()
        self._parent = None
        self._sub = None
        self._step_inputs = []    # [outer_name, inner_name]
        self._memories = []       # [boot_name, pre_name, post_name|None]
        self._step_outputs = []   # [inner_name, outer_name]
        self._outputs = []        # Variables returned by __call__
        self._seq_len = None
        self._in_step = False

    @contextlib.contextmanager
    def step(self):
        program = self._program
        self._parent = program.current_block()
        from ..framework.core import _prog_state
        self._sub = program.create_block()
        _prog_state.current_block_idx = self._sub.idx
        self._in_step = True
        try:
            yield
        finally:
            self._in_step = False
            _prog_state.current_block_idx = self._parent.idx
            self._complete()

    def _require_in_step(self, what):
        if not self._in_step:
            raise RuntimeError(f"{what} must be called inside rnn.step()")

    def step_input(self, x: Variable) -> Variable:
        """Register a [T, ...] sequence; returns the per-step slice var."""
        self._require_in_step("step_input")
        if self._seq_len is None:
            self._seq_len = x.shape[0]
        elif x.shape[0] not in (-1, self._seq_len):
            raise ValueError(
                f"step_input length {x.shape[0]} != {self._seq_len}")
        inner = self._sub.create_var(
            name=unique_name(f"{self._helper.name}.step_in"),
            shape=tuple(x.shape[1:]), dtype=x.dtype)
        self._step_inputs.append([x.name, inner.name])
        return inner

    def memory(self, init: Variable = None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        """Loop-carried state. Either `init` (a [B, ...] var from the outer
        block) or `shape` (without batch) + `batch_ref` (a registered
        step_input; its outer var's dim `ref_batch_dim_idx` supplies the
        batch size)."""
        self._require_in_step("memory")
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs init= or shape=+batch_ref=")
            dims = [d for d in shape if d != -1]
            outer_ref = None
            for o, i in self._step_inputs:
                if i == batch_ref.name:
                    outer_ref = o
            if outer_ref is None:
                outer_ref = batch_ref.name  # already an outer var
            boot = self._parent.create_var(
                name=unique_name(f"{self._helper.name}.boot"),
                dtype="float32")
            self._parent.append_op(
                "fill_constant_batch_size_like",
                {"Input": [outer_ref]}, {"Out": [boot.name]},
                {"shape": [-1] + list(dims), "dtype": "float32",
                 "value": float(init_value),
                 "input_dim_idx": ref_batch_dim_idx,
                 "output_dim_idx": init_batch_dim_idx})
        else:
            boot = init
        pre = self._sub.create_var(
            name=unique_name(f"{self._helper.name}.mem"),
            shape=tuple(boot.shape), dtype=boot.dtype)
        self._memories.append([boot.name, pre.name, None])
        return pre

    def update_memory(self, mem: Variable, var: Variable):
        self._require_in_step("update_memory")
        for rec in self._memories:
            if rec[1] == mem.name:
                rec[2] = var.name
                return
        raise ValueError(f"{mem.name!r} is not a memory of this StaticRNN")

    def step_output(self, o: Variable):
        self._require_in_step("step_output")
        T = self._seq_len if self._seq_len is not None else -1
        outer = self._parent.create_var(
            name=unique_name(f"{self._helper.name}.out"),
            shape=(T,) + tuple(o.shape), dtype=o.dtype)
        self._step_outputs.append([o.name, outer.name])
        self._outputs.append(outer)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _extra_attrs(self):
        return {}

    def _complete(self):
        if not self._step_inputs:
            raise RuntimeError("StaticRNN needs at least one step_input")
        for boot, pre, post in self._memories:
            if post is None:
                raise RuntimeError(
                    f"memory {pre!r} was never update_memory()'d")
        from ..ops.control_flow_ops import _block_outer_reads
        reads = [o for o, _ in self._step_inputs]
        reads += [b for b, _, _ in self._memories if b not in reads]
        reads += [n for n in _block_outer_reads(self._program, self._sub)
                  if n not in reads]
        attrs = {"sub_block": self._sub.idx,
                 "step_inputs": self._step_inputs,
                 "memories": self._memories,
                 "step_outputs": self._step_outputs}
        attrs.update(self._extra_attrs())
        if attrs.get("lengths") and attrs["lengths"] not in reads:
            reads.append(attrs["lengths"])
        self._parent.append_op(
            "recurrent", {"X": reads},
            {"Out": [o for _, o in self._step_outputs]},
            attrs, infer_shape=False)

    def __call__(self):
        if not self._outputs:
            raise RuntimeError("StaticRNN has no step outputs")
        return self._outputs[0] if len(self._outputs) == 1 \
            else list(self._outputs)


# ---------------------------------------------------------------------------
# DynamicRNN — variable-length sequences (control_flow.py:1714)
# ---------------------------------------------------------------------------

class DynamicRNN(StaticRNN):
    """RNN over BATCH-MAJOR padded sequences with per-row lengths (the
    LoD-tensor redesign: [B, T, D] + lengths[B] instead of ragged rows;
    reference: layers/control_flow.py:1714 DynamicRNN).

        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, lengths)   # x: [B, T, D]
            prev = drnn.memory(shape=[H], value=0.0)
            h = layers.fc(input=[word, prev], size=H)
            drnn.update_memory(prev, h)
            drnn.output(h)
        out = drnn()                              # [B, T, H], zero-padded

    Memories freeze and outputs are zeroed once t >= length, matching the
    reference's shrink-memory semantics. Fully differentiable.
    """

    def __init__(self, name=None):
        super().__init__(name=name)
        self._lengths_name = None
        self._batch_outer = None  # outer batch-major var for memory boots

    def block(self):
        return self.step()

    def step_input(self, x: Variable, lengths: Variable = None) -> Variable:
        """x: [B, T, ...] padded batch-major; lengths: [B] int (required on
        the first step_input)."""
        from . import tensor as t_layers
        from ..framework.core import _prog_state
        if lengths is not None:
            if self._lengths_name is None:
                self._lengths_name = lengths.name
            elif lengths.name != self._lengths_name:
                raise ValueError("all step_inputs must share one lengths")
        if self._lengths_name is None:
            raise ValueError("DynamicRNN.step_input needs lengths= on the "
                             "first sequence input")
        # transpose to time-major in the PARENT block
        cur = _prog_state.current_block_idx
        _prog_state.current_block_idx = self._parent.idx
        try:
            perm = list(range(len(x.shape)))
            perm[0], perm[1] = perm[1], perm[0]
            tm = t_layers.transpose(x, perm)
        finally:
            _prog_state.current_block_idx = cur
        if self._batch_outer is None:
            self._batch_outer = x.name
        return super().step_input(tm)

    def memory(self, init: Variable = None, shape=None, value=0.0,
               dtype="float32", **kw):
        if init is not None:
            return super().memory(init=init)
        if shape is None:
            raise ValueError("memory() needs init= or shape=")
        dims = [d for d in shape if d != -1]
        boot = self._parent.create_var(
            name=unique_name(f"{self._helper.name}.boot"), dtype=dtype)
        self._parent.append_op(
            "fill_constant_batch_size_like",
            {"Input": [self._batch_outer]}, {"Out": [boot.name]},
            {"shape": [-1] + list(dims), "dtype": dtype,
             "value": float(value), "input_dim_idx": 0,
             "output_dim_idx": 0})
        pre = self._sub.create_var(
            name=unique_name(f"{self._helper.name}.mem"),
            shape=tuple(boot.shape), dtype=boot.dtype)
        self._memories.append([boot.name, pre.name, None])
        return pre

    def _extra_attrs(self):
        return {"lengths": self._lengths_name}

    def _complete(self):
        if self._lengths_name is None:
            raise RuntimeError("DynamicRNN needs a step_input with lengths")
        super()._complete()
        # transpose stacked [T, B, ...] outputs back to batch-major
        from . import tensor as t_layers
        outs = []
        for v in self._outputs:
            perm = list(range(len(v.shape)))
            perm[0], perm[1] = perm[1], perm[0]
            outs.append(t_layers.transpose(v, perm))
        self._outputs = outs


# ---------------------------------------------------------------------------
# IfElse — per-row batch split/merge (control_flow.py:1578)
# ---------------------------------------------------------------------------

class IfElse:
    """Row-wise conditional over a [B, 1] bool mask (reference:
    layers/control_flow.py:1578). The reference gathers true/false rows
    into separate sub-batches, runs each branch, and scatters the results
    back. Here, as in the JAX package: both branches run over the FULL
    batch (static shapes; no gather/scatter) and the results merge
    row-wise with a select — the standard dense-accelerator form. Equivalent whenever the
    branch computation is row-wise (the reference's documented use);
    batch-global reductions inside a branch would see all rows.

        ie = layers.IfElse(cond)              # cond: [B, 1] bool
        with ie.true_block():
            ie.output(layers.scale(ie.input(x), scale=2.0))
        with ie.false_block():
            ie.output(ie.input(x))
        merged, = ie()                         # rows picked by cond

    Fully differentiable (the select is a where op).
    """

    def __init__(self, cond: Variable, name=None):
        self._cond = cond
        self._helper = LayerHelper("ifelse", name=name)
        self._outs = {True: [], False: []}
        self._branch = None

    @contextlib.contextmanager
    def true_block(self):
        self._branch = True
        try:
            yield
        finally:
            self._branch = None

    @contextlib.contextmanager
    def false_block(self):
        self._branch = False
        try:
            yield
        finally:
            self._branch = None

    def input(self, x: Variable) -> Variable:
        if self._branch is None:
            raise RuntimeError("IfElse.input used outside a branch block")
        return x

    def output(self, *outs):
        if self._branch is None:
            raise RuntimeError("IfElse.output used outside a branch block")
        self._outs[self._branch].extend(outs)

    def __call__(self):
        from . import tensor as t_layers
        t, f = self._outs[True], self._outs[False]
        if len(t) != len(f):
            raise ValueError(
                f"IfElse branches returned {len(t)} vs {len(f)} outputs")
        merged = []
        for tv, fv in zip(t, f):
            # align the [B, 1] mask's rank to the output so where() selects
            # row-wise — a [B] output against a [B, 1] mask would silently
            # broadcast to [B, B]
            cond = self._cond
            if len(tv.shape) != len(cond.shape):
                shape = [-1 if cond.shape[0] == -1 else cond.shape[0]]
                shape += [1] * (len(tv.shape) - 1)
                cond = t_layers.reshape(cond, shape)
            merged.append(t_layers.where(cond, tv, fv))
        return merged


def reorder_lod_tensor_by_rank(x, rank_table):
    """reference: layers/control_flow.py reorder_lod_tensor_by_rank."""
    from ..framework.layer_helper import LayerHelper
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reorder_lod_tensor_by_rank",
                     {"X": [x.name], "RankTable": [rank_table.name]},
                     {"Out": [out.name]}, {})
    return out


def is_empty(x, cond=None):
    """reference: layers/control_flow.py is_empty."""
    from ..framework.layer_helper import LayerHelper
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference("bool")
    helper.append_op("is_empty", {"X": [x.name]}, {"Out": [out.name]}, {})
    return out
