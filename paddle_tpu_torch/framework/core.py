"""Program IR: Program -> Block -> Operator / Variable.

A copy of `paddle_tpu/framework/core.py` (the IR holds no device code), so a
`__model__` written by either package parses in the other: `to_dict`,
`serialize_to_string` and `parse_from_string` are byte-compatible.
Mirrors the reference's ProgramDesc/BlockDesc/OpDesc/VarDesc
(reference: paddle/fluid/framework/framework.proto:43,105,165,184 and
python/paddle/fluid/framework.py:383,992,1443,2782). The port's executor
interprets a block op by op, eagerly, on torch tensors (see executor.py).

Shapes use -1 only for the leading (batch) dimension, as in fluid data layers.
Shape/dtype inference runs the op's torch lowering rule on meta-device
tensors (registry.infer_op_shapes) — one rule per op serves both build-time
inference and execution, instead of the reference's separate InferShape
functions (paddle/fluid/framework/operator.h:430).
"""

from __future__ import annotations

import copy
import json
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "Variable", "Operator", "Block", "Program", "Parameter",
    "program_guard", "default_main_program", "default_startup_program",
    "unique_name", "unique_name_guard", "name_scope", "grad_var_name",
    "convert_np_dtype",
]

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "float": "float32",
    "float64": "float64", "fp64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int64": "int64", "bool": "bool",
}


def convert_np_dtype(dtype) -> str:
    """Normalize a dtype spec (str / np.dtype / jnp dtype) to canonical str."""
    if isinstance(dtype, str):
        if dtype not in _DTYPE_ALIASES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return _DTYPE_ALIASES[dtype]
    name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    return convert_np_dtype(str(name))


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# unique names
# ---------------------------------------------------------------------------

class _UniqueNameGenerator:
    def __init__(self):
        self._ids: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._prefix: List[str] = []

    def __call__(self, key: str = "tmp") -> str:
        with self._lock:
            idx = self._ids.get(key, 0)
            self._ids[key] = idx + 1
        prefix = "/".join(self._prefix)
        base = f"{key}_{idx}"
        return f"{prefix}/{base}" if prefix else base


_generator = _UniqueNameGenerator()


def unique_name(key: str = "tmp") -> str:
    return _generator(key)


class unique_name_guard:
    """Swap in a fresh (or given) name-counter state so separately built
    programs get identical var names — required when several trainers build
    the same model in one process (PS tables are keyed by var name).
    Reference: fluid.unique_name.guard (python/paddle/fluid/unique_name.py).
    """

    def __init__(self, state: Optional[Dict[str, int]] = None):
        self._state = {} if state is None else state

    def __enter__(self):
        self._old = _generator._ids
        _generator._ids = self._state
        return self

    def __exit__(self, *exc):
        _generator._ids = self._old
        return False


def _unique_name_switch(new_state: Optional[Dict[str, int]] = None):
    """fluid.unique_name.switch analog: swap the counter state in place,
    returning the old state."""
    old = _generator._ids
    _generator._ids = {} if new_state is None else new_state
    return old


# fluid.unique_name is a MODULE (generate/guard/switch); expose the same
# surface as attributes of the function so `pt.unique_name.generate(...)`
# ports unchanged
unique_name.generate = unique_name
unique_name.guard = unique_name_guard
unique_name.switch = _unique_name_switch


class name_scope:
    """Prefix generated names for readability (fluid.name_scope analog)."""

    def __init__(self, prefix: str):
        self._prefix = prefix

    def __enter__(self):
        _generator._prefix.append(self._prefix)
        return self

    def __exit__(self, *exc):
        _generator._prefix.pop()
        return False


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable:
    """A named tensor in a Block (reference: framework.py:383 / VarDesc).

    Holds static metadata only; values live in a Scope at run time.
    """

    def __init__(self, block: "Block", name: str, shape=None, dtype="float32",
                 persistable: bool = False, stop_gradient: bool = False,
                 is_data: bool = False, type: str = "lod_tensor"):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_np_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        # "lod_tensor" | "selected_rows" (reference: VarType framework.proto)
        self.type = type

    # -- DSL sugar: build ops by operating on Variables ---------------------
    def _binary(self, other, op_type, reverse=False):
        from ..layers import math as _m  # lazy; avoids import cycle
        return _m._elementwise_from_operator(self, other, op_type, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __neg__(self):
        from ..layers import math as _m
        return _m.scale(self, scale=-1.0)

    def __matmul__(self, other):
        from ..layers import math as _m
        return _m.matmul(self, other)

    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    @property
    def program(self) -> "Program":
        return self.block.program

    def astype(self, dtype):
        from ..layers import tensor as _t
        return _t.cast(self, dtype)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
            "type": self.type,
        }


class Parameter(Variable):
    """A persistable, trainable Variable (reference: framework.py:3583)."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable)
        self.trainable = trainable
        self.regularizer = regularizer
        self.optimize_attrs: Dict[str, Any] = {}


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

class Operator:
    """One op in a block: type + slot->var-name maps + attrs.

    Mirrors OpDesc (reference framework.proto:105); lowering/inference rules
    are found in registry.py by `type`.
    """

    def __init__(self, block: "Block", op_type: str,
                 inputs: Optional[Dict[str, Sequence[str]]] = None,
                 outputs: Optional[Dict[str, Sequence[str]]] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = op_type
        self.inputs: Dict[str, List[str]] = {
            k: list(v) for k, v in (inputs or {}).items()}
        self.outputs: Dict[str, List[str]] = {
            k: list(v) for k, v in (outputs or {}).items()}
        self.attrs: Dict[str, Any] = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self) -> List[str]:
        return [n for ns in self.outputs.values() for n in ns]

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return f"Op({self.type}, in={ins}, out={outs})"

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _jsonify_attrs(self.attrs)}


def _jsonify_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _dejsonify_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block:
    """Ordered op list + var map (reference: BlockDesc framework.proto:165)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.ops: List[Operator] = []
        self.vars: Dict[str, Variable] = {}

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- vars ---------------------------------------------------------------
    def create_var(self, name=None, **kw) -> Variable:
        if name is None:
            name = unique_name("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, name=None, shape=None, dtype="float32",
                         **kw) -> Parameter:
        if name is None:
            name = unique_name("param")
        p = Parameter(self, name, shape, dtype=dtype, **kw)
        self.vars[name] = p
        self.program._bump_version()
        return p

    def var(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError(f"variable {name!r} not found in block {self.idx}")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  infer_shape: bool = True) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        if infer_shape:
            from .registry import infer_op_shapes
            infer_op_shapes(op, self)
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None,
                   infer_shape: bool = True) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        if infer_shape:
            from .registry import infer_op_shapes
            infer_op_shapes(op, self)
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None,
                  attrs=None, infer_shape: bool = True) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        if infer_shape:
            from .registry import infer_op_shapes
            infer_op_shapes(op, self)
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

class Program:
    """Top-level IR container (reference: framework.py:2782 Program).

    `_version` increments on every mutation — the Executor keys its
    memoized persistable classification on it, so editing a program
    transparently invalidates that.
    """

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._version = 0
        self._seed: Optional[int] = None
        self.random_seed = 0
        self._pipeline = None  # PipelineMeta when PipelineOptimizer is used
        # Identity for executor compile-cache keys. id(program) would alias a
        # freed Program with a new one at the same address (stale-executable
        # class of bug); a uuid cannot collide across object lifetimes.
        self._uid = uuid.uuid4().hex

    # -- mutation tracking ---------------------------------------------------
    def _bump_version(self):
        self._version += 1

    @property
    def version(self) -> int:
        return self._version

    # -- blocks --------------------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[_prog_state.current_block_idx
                           if _prog_state.current_program is self else 0]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block().idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._bump_version()
        return b

    def all_parameters(self) -> List[Parameter]:
        return [p for b in self.blocks for p in b.all_parameters()]

    # -- clone / prune -------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy. With for_test=True, drop backward/optimizer/lr ops (by
        op_role, like the reference's OpRole-based pruning) and flip
        train-mode attrs (dropout, batch_norm) to inference behavior
        (reference framework.py:3135)."""
        p = Program()
        p.blocks = []
        for b in self.blocks:
            nb = Block(p, b.idx, b.parent_idx)
            for v in b.vars.values():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[v.name] = nv
            for op in b.ops:
                if for_test and op.attrs.get("op_role") in (
                        "backward", "optimize", "lr_sched"):
                    continue
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               copy.deepcopy(op.attrs))
                if for_test and "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.random_seed = self.random_seed
        if not for_test:
            p._pipeline = self._pipeline  # test clones prune backward anyway
            if getattr(self, "_collective_nranks", None) is not None:
                p._collective_nranks = self._collective_nranks
        p._bump_version()
        return p

    def _prune(self, targets: Sequence[str]) -> "Program":
        """Drop ops not needed to produce `targets` (reference prune.cc).

        Control-flow ops (while/cond/recurrent) are kept or dropped as a
        unit; when kept, everything their sub-blocks read from the outer
        scope becomes needed too — otherwise the producers of loop-closure
        vars would be pruned out from under the loop (reference prune.cc
        recurses into sub-blocks for the same reason).
        """
        pruned = self.clone()
        blk = pruned.global_block
        needed = set(targets)
        keep: List[Operator] = []
        sub_keys = ("sub_block", "sub_block_t", "sub_block_f")

        def sub_reads(op):
            from ..ops.control_flow_ops import _block_outer_reads
            reads = []
            for key in sub_keys:
                if key in op.attrs:
                    reads += _block_outer_reads(
                        pruned, pruned.blocks[op.attrs[key]])
            return reads

        for op in reversed(blk.ops):
            if set(op.output_names()) & needed or op.type in ("feed",):
                keep.append(op)
                needed.update(op.input_names())
                if any(k in op.attrs for k in sub_keys):
                    needed.update(sub_reads(op))
        blk.ops = list(reversed(keep))
        # drop vars no surviving op references (reference prune.cc does the
        # same) — keeps inference exports free of optimizer-state vars
        referenced = set(needed)
        for op in blk.ops:
            referenced.update(op.output_names())
        blk.vars = {n: v for n, v in blk.vars.items() if n in referenced}
        pruned._bump_version()
        return pruned

    # -- static verification -------------------------------------------------
    def validate(self, fetch_list=None, feed_names=None, skip_codes=None):
        """Statically verify this program (analysis.verify_program):
        def-use soundness, shape/dtype consistency, gradient soundness,
        liveness and recompile-hazard lints. Read-only — never bumps the
        version or creates vars. Returns a DiagnosticReport."""
        from ..analysis import verify_program  # lazy; analysis imports core
        return verify_program(self, fetch_list=fetch_list,
                              feed_names=feed_names, skip_codes=skip_codes)

    # -- serialization -------------------------------------------------------
    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks],
                "random_seed": self.random_seed}

    def serialize_to_string(self) -> bytes:
        return json.dumps(self.to_dict()).encode("utf-8")

    @staticmethod
    def parse_from_string(data: bytes) -> "Program":
        d = json.loads(data.decode("utf-8"))
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                cls = Parameter if vd.get("is_parameter") else Variable
                if cls is Parameter:
                    v = Parameter(b, vd["name"], vd["shape"], dtype=vd["dtype"],
                                  trainable=bool(vd.get("trainable", True)))
                else:
                    v = Variable(b, vd["name"], shape=vd["shape"],
                                 dtype=vd["dtype"],
                                 persistable=vd["persistable"],
                                 stop_gradient=vd["stop_gradient"],
                                 is_data=vd.get("is_data", False),
                                 type=vd.get("type", "lod_tensor"))
                b.vars[v.name] = v
            for od in bd["ops"]:
                b.ops.append(Operator(b, od["type"], od["inputs"],
                                      od["outputs"],
                                      _dejsonify_attrs(od["attrs"])))
            p.blocks.append(b)
        p.random_seed = d.get("random_seed", 0)
        return p

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={n_ops})"


# ops whose behavior differs between train and eval
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "fake_quantize_dequantize_moving_average_abs_max": ("is_test",),
}


# ---------------------------------------------------------------------------
# default programs / program_guard
# ---------------------------------------------------------------------------

class _ProgramState:
    """Process-global defaults (the reference's module-level default
    programs, framework.py:3678) — shared across threads so worker threads
    building layers see the same program as the main thread."""

    def __init__(self):
        self.current_program: Program = Program()
        self.startup_program: Program = Program()
        self.current_block_idx: int = 0


_prog_state = _ProgramState()


def default_main_program() -> Program:
    return _prog_state.current_program


def default_startup_program() -> Program:
    return _prog_state.startup_program


class program_guard:
    """Switch default main/startup programs (reference framework.py:3791)."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self._main = main_program
        self._startup = startup_program

    def __enter__(self):
        self._old_main = _prog_state.current_program
        self._old_startup = _prog_state.startup_program
        self._old_blk = _prog_state.current_block_idx
        _prog_state.current_program = self._main
        if self._startup is not None:
            _prog_state.startup_program = self._startup
        _prog_state.current_block_idx = 0
        return self

    def __exit__(self, *exc):
        _prog_state.current_program = self._old_main
        _prog_state.startup_program = self._old_startup
        _prog_state.current_block_idx = self._old_blk
        return False
