"""Op registry: one torch lowering rule per op type.

Port of `paddle_tpu/framework/registry.py` with the same surface
(`OpDef`, `register_op`, `get_op_def`, `has_op_def`, `lower_op`,
`infer_op_shapes`, `LowerContext`, `DUMMY_BATCH`). An op is defined by its
rule, a plain function on torch tensors; that one rule gives

  * build-time shape/dtype inference — the rule runs on meta-device tensors
    (in place of `jax.eval_shape`),
  * execution — the executor calls it eagerly, op by op.

Gradient lowering (`_lower_grad_op`), macro (control-flow) ops and host ops
come with the training slice; `OpDef` already carries their fields so op
modules can register grad makers now.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

import torch

from .core import Block, Operator

__all__ = ["OpDef", "register_op", "get_op_def", "has_op_def",
           "infer_op_shapes", "LowerContext", "lower_op", "DUMMY_BATCH",
           "torch_dtype", "dtype_name"]

# Dummy concrete size substituted for -1 (batch) dims during meta-device
# inference; a large prime so a genuine layer dim colliding with it (and
# being wrongly mapped back to -1) is vanishingly unlikely.
DUMMY_BATCH = 8191

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(name: str) -> torch.dtype:
    """Canonical dtype string (core.convert_np_dtype) -> torch dtype."""
    return _TORCH_DTYPES[name]


def dtype_name(dtype: torch.dtype) -> str:
    return _DTYPE_NAMES[dtype]


def concrete_to_batch(shape):
    """Map DUMMY_BATCH dims of an inferred shape back to -1 (apply only
    when some input carried a -1 dim)."""
    return tuple(-1 if d == DUMMY_BATCH else d for d in shape)


@dataclass
class OpDef:
    type: str
    # lower(ctx, ins, attrs) -> {out_slot: [torch tensors]}
    lower: Callable[["LowerContext", Dict[str, List[Any]], Dict[str, Any]],
                    Dict[str, List[Any]]]
    # input slots that never receive gradients (indices, labels, ...)
    no_grad_inputs: Set[str] = field(default_factory=set)
    # output slots that are not differentiable / get zero cotangents
    non_diff_outputs: Set[str] = field(default_factory=set)
    # draws from ctx.rng()
    stateful: bool = False
    # custom grad-op desc maker: (op, block, no_grad_set) -> list[dict]
    grad_maker: Optional[Callable] = None
    # custom grad lowering (lowered by the training slice)
    grad_lower: Optional[Callable] = None
    # if True, op has NO gradient
    not_differentiable: bool = False
    # for not_differentiable ops: a zero/absent gradient is intended
    grad_free: bool = False


_REGISTRY: Dict[str, OpDef] = {}


def register_op(op_type: str, **kw):
    """Decorator: @register_op("relu") def _(ctx, ins, attrs): ..."""
    def deco(fn):
        _REGISTRY[op_type] = OpDef(type=op_type, lower=fn, **kw)
        return fn
    return deco


def get_op_def(op_type: str) -> OpDef:
    if op_type not in _REGISTRY:
        raise NotImplementedError(f"no lowering registered for op {op_type!r}")
    return _REGISTRY[op_type]


def has_op_def(op_type: str) -> bool:
    return op_type in _REGISTRY


# ---------------------------------------------------------------------------
# Lowering context
# ---------------------------------------------------------------------------

class LowerContext:
    """Per-run state handed to lowering rules.

    `device` is where rules create tensors (fill, random, constants);
    `rng()` returns the run's seeded `torch.Generator` (one per run, drawn
    from in op order, so a run is a pure function of scope, feed and seed).
    During meta-device inference `abstract` is True and `rng()` is None.
    """

    def __init__(self, device=None, seed: Optional[int] = None,
                 abstract: bool = False):
        self.device = torch.device(device if device is not None else "cpu")
        self.abstract = abstract
        self._seed = seed
        self._gen: Optional[torch.Generator] = None

    def rng(self) -> Optional[torch.Generator]:
        if self.abstract:
            return None
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(self._seed or 0))
        return self._gen

    def seeded(self, seed: int) -> Optional[torch.Generator]:
        """A generator for an op with its own fixed `seed` attr."""
        if self.abstract:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return g


# ---------------------------------------------------------------------------
# Op lowering given an environment
# ---------------------------------------------------------------------------

def lower_op(ctx: LowerContext, op: Operator, env: Dict[str, Any]) -> None:
    """Run one op: read inputs from env, write outputs into env."""
    if op.type.endswith("_grad"):
        raise NotImplementedError(
            f"op {op.type!r}: gradient ops run in the training slice of "
            "paddle_tpu_torch, which is not ported yet")
    opdef = get_op_def(op.type)
    ins = {slot: [env[n] for n in names]
           for slot, names in op.inputs.items() if names}
    outs = opdef.lower(ctx, ins, op.attrs)
    _bind_outputs(op, outs, env)


def _bind_outputs(op: Operator, outs: Dict[str, List[Any]], env):
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) != len(names):
            raise RuntimeError(
                f"op {op.type}: slot {slot} produced {len(vals)} values for "
                f"{len(names)} output vars")
        for n, v in zip(names, vals):
            env[n] = v


# ---------------------------------------------------------------------------
# Shape inference on the meta device
# ---------------------------------------------------------------------------

def _meta(shape, dtype: str) -> torch.Tensor:
    return torch.empty(tuple(DUMMY_BATCH if d == -1 else d for d in shape),
                       dtype=torch_dtype(dtype), device="meta")


def infer_op_shapes(op: Operator, block: Block) -> None:
    """Set output var shapes/dtypes by running the lowering rule on
    meta-device tensors. -1 (batch) dims are substituted with DUMMY_BATCH
    and mapped back to -1 in the outputs."""
    if op.type in ("feed", "fetch"):
        return
    opdef = get_op_def(op.type)

    ins: Dict[str, List[Any]] = {}
    saw_dummy = False
    for slot, names in op.inputs.items():
        if not names:
            continue
        lst = []
        for n in names:
            v = block.var(n)
            if v.shape is None:
                raise RuntimeError(f"input var {n!r} of op {op.type} has no "
                                   "shape; declare it first")
            saw_dummy = saw_dummy or (-1 in v.shape)
            lst.append(_meta(v.shape, v.dtype))
        ins[slot] = lst

    ctx = LowerContext(device="meta", abstract=True)
    try:
        outs = opdef.lower(ctx, ins, op.attrs)
    except Exception as e:
        raise RuntimeError(
            f"shape inference failed for op {op.type} "
            f"(inputs={{{', '.join(f'{s}:{[block.var(n).shape for n in ns]}' for s, ns in op.inputs.items() if ns)}}}, "
            f"attrs={op.attrs}): {e}") from e

    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, t in zip(names, vals):
            v = block.var(n) if block.has_var(n) else block.create_var(
                name=n)
            shape = tuple(t.shape)
            if saw_dummy:
                shape = concrete_to_batch(shape)
            v.shape = shape
            v.dtype = dtype_name(t.dtype)
