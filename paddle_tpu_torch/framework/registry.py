"""Op registry: one torch lowering rule per op type.

Port of `paddle_tpu/framework/registry.py` with the same surface
(`OpDef`, `register_op`, `get_op_def`, `has_op_def`, `lower_op`,
`infer_op_shapes`, `LowerContext`, `DUMMY_BATCH`). An op is defined by its
rule, a plain function on torch tensors; that one rule gives

  * build-time shape/dtype inference — the rule runs on meta-device tensors
    (in place of `jax.eval_shape`),
  * execution — the executor calls it eagerly, op by op,
  * gradients — `torch.func.vjp` over the rule (in place of `jax.vjp`).
    XLA's CSE removed the forward that jax.vjp replays; in eager mode the
    replay is real work, so ops with a cheaper exact gradient register
    their own grad lowering.

Ops can override the grad-desc maker or the grad lowering when the generic
path is wrong (rng ops like dropout, ops with saved intermediates).
Control-flow ops (while, conditional_block, recurrent and their grads) are
macros (`register_macro_op`): they run with the whole environment and
reach their sub-blocks through the op. Host-boundary ops (save/load, the
readers; `register_host_op`) run outside the op sequence, against the
scope: the executor runs those before the first compute op before the
step, and those after the last compute op after it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import torch

from .core import Block, Operator, GRAD_SUFFIX

__all__ = ["OpDef", "register_op", "get_op_def", "has_op_def",
           "infer_op_shapes", "LowerContext", "lower_op", "DUMMY_BATCH",
           "torch_dtype", "dtype_name", "shape_spec", "resolve_op",
           "register_macro_op", "register_host_op"]

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


def shape_spec(shape, dtype: str) -> torch.Tensor:
    """A meta-device tensor from declared var metadata, -1 (batch) dims
    substituted with DUMMY_BATCH: the one spec convention shared by
    build-time inference here and the static verifier's read-only shape
    walk (analysis/analyzers.py), as `jax.ShapeDtypeStruct` is in JAX."""
    return torch.empty(tuple(DUMMY_BATCH if d == -1 else d for d in shape),
                       dtype=torch_dtype(dtype), device="meta")


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
    # draws from ctx.rng() — requires a custom grad path
    stateful: bool = False
    # in-place update op (optimizer ops): outputs alias inputs by name
    is_optimizer_op: bool = False
    # custom grad-op desc maker: (op, block, no_grad_set) -> list[dict]
    grad_maker: Optional[Callable] = None
    # custom grad lowering: (ctx, ins, attrs) -> {slot: [tensors]}
    grad_lower: Optional[Callable] = None
    # if True, op has NO gradient (grads of its inputs are zeros / skipped)
    not_differentiable: bool = False
    # for not_differentiable ops: True means a zero/absent gradient is
    # intended; False means backward raises if the loss depends on the op
    grad_free: bool = False
    # fn(op) -> set of forward-input slots whose grads are SelectedRows
    # (lookup_table with is_sparse=True); backward marks those grad vars'
    # Variable.type = "selected_rows"
    sparse_grad_slots: Optional[Callable] = None


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


# Macro ops (control flow) run with full context: fn(ctx, op, env), where
# env is the live name->tensor binding and op carries the sub-block attrs
# (`paddle_tpu/framework/registry.py:109`). They reach their sub-blocks
# through op.block.program; ops/control_flow_ops.py runs them as Python
# loops and branches over the sub-block's ops. Passes over a block, such
# as the AMP rewrite's re-inference and build-time shape inference, skip
# macros and host ops alike.
_MACROS: Dict[str, Callable] = {}

# Host-boundary ops (`paddle_tpu/framework/registry.py:129`): file IO
# (save/load) and the reader machinery, side effects that are not a
# function of tensors. The executor runs them against the scope, outside
# the op sequence: ops before the first compute op before the step (loads,
# reads), ops after the last compute op after it, on the post-step scope
# (saves). fn(op, scope, feed, device) mutates scope/feed in place; device
# is the executor's (JAX's fn(op, scope, feed) has one device), where a
# load places its tensors and a double-buffered reader stages its batches.
_HOST_OPS: Dict[str, Callable] = {}


def register_macro_op(op_type: str, aliases: Sequence[str] = (), **opdef_kw):
    """aliases: extra op-type names sharing this rule, reference-IR
    compatibility names (conditional_block_infer is the inference-time
    registration of the same kernel,
    controlflow/conditional_block_infer_op.cc)."""
    def deco(fn):
        opdef_kw.setdefault("not_differentiable",
                            "grad_maker" not in opdef_kw)
        for name in (op_type,) + tuple(aliases):
            _MACROS[name] = fn
            _REGISTRY[name] = OpDef(type=name, lower=None, **opdef_kw)
        return fn
    return deco


def register_host_op(op_type: str, aliases: Sequence[str] = (), **opdef_kw):
    """@register_host_op("save") def _(op, scope, feed, device): ...
    JAX's signature and defaults: a host op is not differentiable and its
    zero gradient is intended; aliases register the same rule under
    reference-IR names (c_gen_nccl_id)."""
    def deco(fn):
        opdef_kw.setdefault("not_differentiable", True)
        opdef_kw.setdefault("grad_free", True)
        for name in (op_type,) + tuple(aliases):
            _HOST_OPS[name] = fn
            _REGISTRY[name] = OpDef(type=name, lower=None, **opdef_kw)
        return fn
    return deco


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
    `differentiable` is True while a macro grad op replays a sub-block
    under `torch.func.vjp`: a While lowered then takes its bounded form.
    `inplace` names the input slots an optimizer rule may overwrite: the
    executor sets it, per op, for a state var that the op writes under its
    own name and that the executor bound in the scope itself (donation).
    """

    def __init__(self, device=None, seed: Optional[int] = None,
                 abstract: bool = False, differentiable: bool = False):
        self.device = torch.device(device if device is not None else "cpu")
        self.abstract = abstract
        self.differentiable = differentiable
        self.inplace: frozenset = frozenset()
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

def resolve_op(op: Operator) -> OpDef:
    """The OpDef whose rules run `op`: its own (a macro's, `while_grad`
    included), or for another `<type>_grad` op the forward type's (its
    grad_lower or the generic vjp)."""
    if op.type.endswith("_grad") and op.type not in _MACROS:
        return get_op_def(op.type[: -len("_grad")])
    return get_op_def(op.type)


def lower_op(ctx: LowerContext, op: Operator, env: Dict[str, Any],
             opdef: Optional[OpDef] = None) -> None:
    """Run one op: read inputs from env, write outputs into env. `opdef`
    is `resolve_op(op)` when the caller resolved it beforehand. Macros
    come first, as in JAX: `while_grad` and the other macro grads are not
    the generic vjp's."""
    if op.type in _MACROS:
        _MACROS[op.type](ctx, op, env)
        return
    if op.type.endswith("_grad"):
        _lower_grad_op(ctx, op, env, opdef)
        return
    opdef = opdef or get_op_def(op.type)
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


def _lower_grad_op(ctx: LowerContext, op: Operator, env: Dict[str, Any],
                   opdef: Optional[OpDef] = None):
    """Run a `<type>_grad` op: the forward op's custom `grad_lower`, or
    the generic path, `torch.func.vjp` over the forward rule."""
    fwd_type = op.type[: -len("_grad")]
    opdef = opdef or get_op_def(fwd_type)

    if opdef.grad_lower is not None:
        ins = {slot: [env[n] for n in names if n]
               for slot, names in op.inputs.items()
               if any(n for n in names)}
        outs = opdef.grad_lower(ctx, ins, op.attrs)
        _bind_outputs(op, outs, env)
        return

    if opdef.stateful:
        raise RuntimeError(
            f"op {fwd_type} uses rng; it must define a custom grad_lower")

    # Split grad-op inputs into forward inputs, forward outputs, out-grads.
    fwd_in_slots: Dict[str, List[str]] = {}
    out_grad_slots: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        if not names:
            continue
        if slot.endswith(GRAD_SUFFIX):
            out_grad_slots[slot[: -len(GRAD_SUFFIX)]] = names
        elif not slot.startswith("__out__"):
            fwd_in_slots[slot] = names

    # Which forward-input slots need grads (appear in grad-op outputs).
    req_slots = [s[: -len(GRAD_SUFFIX)] for s in op.outputs
                 if s.endswith(GRAD_SUFFIX) and op.outputs[s]]
    diff_slots = [s for s in fwd_in_slots
                  if s in req_slots and s not in opdef.no_grad_inputs]

    flat_primals = [env[n] for s in diff_slots for n in fwd_in_slots[s]]
    slot_lens = [len(fwd_in_slots[s]) for s in diff_slots]

    out_index: List = []  # filled by the replay: (slot, idx) per output

    def f(*flat):
        ins: Dict[str, List[Any]] = {}
        it = iter(flat)
        for s, ln in zip(diff_slots, slot_lens):
            ins[s] = [next(it) for _ in range(ln)]
        for s, names in fwd_in_slots.items():
            if s not in ins:
                ins[s] = [env[n] for n in names]
        sub_ctx = LowerContext(device=ctx.device, abstract=ctx.abstract)
        outs = opdef.lower(sub_ctx, ins, op.attrs)
        out_index.clear()
        flat_outs = []
        for slot in sorted(outs):
            if slot in opdef.non_diff_outputs:
                continue
            for i, v in enumerate(outs[slot]):
                if v.is_floating_point() or v.is_complex():
                    out_index.append((slot, i))
                    flat_outs.append(v)
        return tuple(flat_outs)

    primals_out, vjp_fn = torch.func.vjp(f, *flat_primals)

    # Cotangents: out-grad from env when present, else zeros.
    cots = []
    for (slot, i), primal in zip(out_index, primals_out):
        names = out_grad_slots.get(slot)
        g = None
        if names is not None and i < len(names) and names[i] in env:
            g = env[names[i]]
        cots.append(torch.zeros_like(primal) if g is None
                    else g.to(primal.dtype))

    grads = vjp_fn(tuple(cots))

    it = iter(grads)
    grads_by_slot = {s: [next(it) for _ in range(ln)]
                     for s, ln in zip(diff_slots, slot_lens)}
    for slot, names in op.outputs.items():
        if not slot.endswith(GRAD_SUFFIX):
            continue
        vals = grads_by_slot.get(slot[: -len(GRAD_SUFFIX)])
        if vals is None:
            continue
        for n, v in zip(names, vals):
            if n:  # empty name == grad not needed for this var
                env[n] = v


# ---------------------------------------------------------------------------
# Shape inference on the meta device
# ---------------------------------------------------------------------------

def infer_op_shapes(op: Operator, block: Block) -> None:
    """Set output var shapes/dtypes by running the lowering rule on
    meta-device tensors. -1 (batch) dims are substituted with DUMMY_BATCH
    and mapped back to -1 in the outputs. Macros have no rule to run on
    the meta device: their layers declare the outputs."""
    if op.type in ("feed", "fetch") or op.type in _MACROS \
            or op.type in _HOST_OPS:
        return
    if op.type.endswith("_grad"):
        _infer_grad_shapes(op, block)
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
            lst.append(shape_spec(v.shape, v.dtype))
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


def _infer_grad_shapes(op: Operator, block: Block) -> None:
    """Grad var shape == forward var shape; no tracing needed (so a
    forward output whose declared shape is a build-time dummy, like
    fused_attention's Lse, never reaches a grad var)."""
    for slot, names in op.outputs.items():
        if not slot.endswith(GRAD_SUFFIX):
            continue
        fwd_names = op.inputs.get(slot[: -len(GRAD_SUFFIX)], [])
        for i, n in enumerate(names):
            if not n:
                continue
            v = block.var(n) if block.has_var(n) else block.create_var(
                name=n)
            if i < len(fwd_names) and block.has_var(fwd_names[i]):
                fv = block.var(fwd_names[i])
                v.shape = fv.shape
                v.dtype = fv.dtype
