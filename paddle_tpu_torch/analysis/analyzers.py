"""The analyzer suite: each analyzer walks the def-use graph (and the op
registry's OpDef metadata) and emits structured diagnostics.

A copy of `paddle_tpu/analysis/analyzers.py`. Together these are the static
twin of the correctness checks the reference framework spreads across its
C++ layers — per-op InferShape/CheckAttrs at build time (operator.h:430),
ir::Graph validation + HasCircle inside the pass pipeline (framework/ir/),
and the OpRole-based pruning invariants — run *before* any op so a
malformed program surfaces as `PT-Exxx @ op #i` instead of an error from
deep inside an op's torch rule.

Every analyzer is read-only: verifying a program never mutates it (no
version bump, no created vars) — pinned by tests, and the property that
lets Executor.run(validate=True) leave the executor's caches untouched.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..framework.core import GRAD_SUFFIX, Parameter, Program, grad_var_name
from ..framework import registry as _registry
from .defuse import DefUseGraph, OpSite, build_def_use
from .diagnostics import Diagnostic, DiagnosticReport

__all__ = ["AnalysisContext", "register_analyzer", "analyzer_names",
           "run_analyzers"]

VALID_OP_ROLES = ("forward", "backward", "optimize", "lr_sched")

# op types that are effectful regardless of dataflow (never "dead"):
# host-boundary ops do IO, collectives synchronize the mesh, py_func/print
# run host callbacks
_EFFECT_TYPES = {"print", "py_func", "assert", "send", "recv", "barrier"}


def _is_effect_op(op_type: str) -> bool:
    return (op_type in _EFFECT_TYPES or op_type in _registry._HOST_OPS
            or op_type.startswith("c_"))


class AnalysisContext:
    """Shared state handed to every analyzer."""

    def __init__(self, program: Program, graph: DefUseGraph,
                 fetch_targets: Set[str], feed_names: Set[str],
                 report: DiagnosticReport):
        self.program = program
        self.graph = graph
        self.fetch_targets = fetch_targets
        self.feed_names = feed_names
        self.report = report

    def diag(self, code: str, message: str, block_idx: int = 0,
             op_idx: Optional[int] = None, op_type: Optional[str] = None,
             var: Optional[str] = None, hint: str = "") -> None:
        self.report.add(Diagnostic(code=code, message=message,
                                   block_idx=block_idx, op_idx=op_idx,
                                   op_type=op_type, var=var, hint=hint))

    def diag_at(self, code: str, message: str, site: OpSite,
                var: Optional[str] = None, hint: str = "") -> None:
        self.diag(code, message, block_idx=site.block_idx,
                  op_idx=site.op_idx, op_type=site.op.type, var=var,
                  hint=hint)


# name -> (codes emitted, fn(ctx))
_ANALYZERS: Dict[str, Tuple[Tuple[str, ...], Callable]] = {}


def register_analyzer(name: str, codes: Iterable[str]):
    def deco(fn):
        _ANALYZERS[name] = (tuple(codes), fn)
        return fn
    return deco


def analyzer_names() -> List[str]:
    return sorted(_ANALYZERS)


def run_analyzers(ctx: AnalysisContext,
                  skip_codes: Set[str] = frozenset()) -> None:
    for name in sorted(_ANALYZERS):
        codes, fn = _ANALYZERS[name]
        if skip_codes and all(c in skip_codes for c in codes):
            continue
        fn(ctx)
    if skip_codes:
        ctx.report.diagnostics = [d for d in ctx.report.diagnostics
                                  if d.code not in skip_codes]
    ctx.report.sort()


# ---------------------------------------------------------------------------
# PT-E001 / PT-E002 / PT-E003 — def-use soundness + cycle detection
# ---------------------------------------------------------------------------

@register_analyzer("defuse", ("PT-E001", "PT-E002", "PT-E003"))
def _check_defuse(ctx: AnalysisContext) -> None:
    """SSA-style per-block walk: every read must resolve to a feed, a
    scope-bound var (data/persistable), an outer-block capture, or an
    earlier write. Forward references either misorder (PT-E002) or form a
    genuine dependency cycle no op order can satisfy (PT-E003 — the
    ir::Graph HasCircle analog)."""
    g = ctx.graph
    for b_idx, sites in g.block_sites.items():
        available: Set[str] = set(g.block_bound.get(b_idx, ()))
        reported: Set[str] = set()
        # (reader_idx, var) forward references, resolved to later writers
        fwd_refs: List[Tuple[int, str]] = []
        for site in sites:
            for n in site.reads:
                if n in available or n in ctx.feed_names:
                    continue
                v = g.declared(b_idx, n)
                if v is None:
                    if n not in reported:
                        reported.add(n)
                        ctx.diag_at("PT-E001",
                                    f"reads {n!r}, which is not declared "
                                    f"in block {b_idx} or any ancestor",
                                    site, var=n)
                    continue
                if v.is_data or v.persistable:
                    continue  # bound by feed / scope at run time
                if v.block.idx != b_idx:
                    continue  # outer-block capture (parent chain)
                later = [j for bb, j in g.writers_of(n)
                         if bb == b_idx and j > site.op_idx]
                if later:
                    fwd_refs.append((site.op_idx, n))
                elif n not in reported:
                    reported.add(n)
                    written_here = any(bb == b_idx
                                       for bb, _ in g.writers_of(n))
                    ctx.diag_at(
                        "PT-E002",
                        f"reads {n!r} before it is ever written"
                        if not written_here else
                        f"reads {n!r} before any write", site, var=n)
            available.update(site.writes)
        if fwd_refs:
            _report_cycles_or_misorder(ctx, b_idx, sites, fwd_refs)


def _report_cycles_or_misorder(ctx, b_idx, sites, fwd_refs):
    """Forward references: if their dependency closure is cyclic, no
    reordering fixes the block (PT-E003); otherwise the block is merely
    misordered (PT-E002 with the producer named)."""
    g = ctx.graph
    n_ops = len(sites)
    # dependency edges under REACHING-definition semantics: a read served
    # by a prior write depends on the latest such writer (backward edge —
    # can never close a cycle), and only an unserved read falls forward
    # to its first later writer. Depending on EVERY writer would turn
    # ordinary read-modify-write accumulator pairs into bogus cycles.
    deps: List[Set[int]] = [set() for _ in range(n_ops)]
    for site in sites:
        for n in site.reads:
            here = [j for bb, j in g.writers_of(n)
                    if bb == b_idx and j != site.op_idx]
            prior = [j for j in here if j < site.op_idx]
            if prior:
                deps[site.op_idx].add(max(prior))
            else:
                later = [j for j in here if j > site.op_idx]
                if later:
                    deps[site.op_idx].add(min(later))

    # iterative Tarjan SCC
    index = [None] * n_ops
    low = [0] * n_ops
    on_stack = [False] * n_ops
    stack: List[int] = []
    sccs: List[List[int]] = []
    counter = [0]
    for root in range(n_ops):
        if index[root] is not None:
            continue
        work = [(root, iter(sorted(deps[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack[root] = True
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if index[w] is None:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(sorted(deps[w]))))
                    advanced = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    sccs.append(sorted(scc))
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])

    cyclic_ops: Set[int] = set()
    for scc in sccs:
        cyclic_ops.update(scc)
        first = scc[0]
        cyc_var = next((n for i, n in fwd_refs if i in scc), None)
        ctx.diag_at(
            "PT-E003",
            f"ops {scc} form a def-use cycle (via {cyc_var!r}); no op "
            "order can satisfy their dependencies",
            sites[first], var=cyc_var)
    for i, n in fwd_refs:
        if i in cyclic_ops:
            continue
        later = [j for bb, j in g.writers_of(n)
                 if bb == b_idx and j > i]
        ctx.diag_at(
            "PT-E002",
            f"reads {n!r} before its producer (op #{later[0]}) runs — "
            "the block is misordered", sites[i], var=n)


# ---------------------------------------------------------------------------
# PT-E004 — unknown op types
# ---------------------------------------------------------------------------

@register_analyzer("op_registry", ("PT-E004",))
def _check_registry(ctx: AnalysisContext) -> None:
    for sites in ctx.graph.block_sites.values():
        for site in sites:
            t = site.op.type
            if t.endswith("_grad"):
                continue  # generic grad ops are unregistered by design
                # (they lower via torch.func.vjp over the forward rule;
                # the pairing check is PT-E007's)
            if not _registry.has_op_def(t):
                ctx.diag_at("PT-E004",
                            f"no lowering rule registered for op type "
                            f"{t!r}", site)


# ---------------------------------------------------------------------------
# PT-E005 — attr / slot schema
# ---------------------------------------------------------------------------

@register_analyzer("attr_schema", ("PT-E005",))
def _check_attrs(ctx: AnalysisContext) -> None:
    n_blocks = len(ctx.program.blocks)
    for sites in ctx.graph.block_sites.values():
        for site in sites:
            op = site.op
            for kind, slots in (("input", op.inputs),
                                ("output", op.outputs)):
                for slot, names in slots.items():
                    if not isinstance(names, (list, tuple)) or any(
                            not isinstance(n, str) for n in names):
                        ctx.diag_at(
                            "PT-E005",
                            f"{kind} slot {slot!r} must be a list of var "
                            f"names, got {type(names).__name__}", site)
            role = op.attrs.get("op_role")
            if role is not None and role not in VALID_OP_ROLES:
                ctx.diag_at(
                    "PT-E005",
                    f"op_role {role!r} is not one of {VALID_OP_ROLES}",
                    site)
            for key in ("sub_block", "sub_block_t", "sub_block_f"):
                if key not in op.attrs:
                    continue
                si = op.attrs[key]
                if (not isinstance(si, (int, np.integer))
                        or not 0 < int(si) < n_blocks
                        or int(si) == site.block_idx):
                    ctx.diag_at(
                        "PT-E005",
                        f"attr {key}={si!r} is not a valid sub-block "
                        f"index (program has {n_blocks} block(s))", site)


# ---------------------------------------------------------------------------
# PT-E006 — static shape/dtype walk (read-only re-inference)
# ---------------------------------------------------------------------------

def _declared_struct(ctx, block_idx, name):
    """A meta-device tensor from declared metadata via the registry's
    shared spec convention (-1 -> DUMMY_BATCH), or (None, reason) when the
    walk cannot type this input."""
    v = ctx.graph.declared(block_idx, name)
    if v is None:
        return None, "undeclared"  # PT-E001 already covers it
    if v.shape is None:
        return None, "no-shape"
    if v.type == "selected_rows":
        return None, "selected-rows"
    try:
        return _registry.shape_spec(v.shape, v.dtype), None
    except KeyError:
        return None, "bad-dtype"


@register_analyzer("shapes", ("PT-E006",))
def _check_shapes(ctx: AnalysisContext) -> None:
    """Abstract-evaluate every op's lowering rule against the DECLARED
    input metadata (registry.infer_op_shapes' meta-device discipline, but
    read-only) and report the first inconsistent op — the build-time twin
    of the rule's runtime error, with op-level provenance. Grad ops check
    the grad-shape == forward-shape contract instead of evaluating."""
    for b_idx, sites in ctx.graph.block_sites.items():
        for site in sites:
            op = site.op
            t = op.type
            if t in ("feed", "fetch") or t in _registry._HOST_OPS:
                continue
            if t.endswith("_grad"):
                _check_grad_shapes(ctx, site)
                continue
            if t in _registry._MACROS:
                continue  # sub-block interiors are walked as blocks
            opdef = _registry._REGISTRY.get(t)
            if opdef is None or opdef.lower is None:
                continue  # PT-E004's finding

            specs: Dict[str, List] = {}
            skip = False
            for slot, names in op.inputs.items():
                if not names:
                    continue
                lst = []
                for n in names:
                    sds, why = _declared_struct(ctx, b_idx, n)
                    if sds is None:
                        if why == "no-shape":
                            ctx.diag_at(
                                "PT-E006",
                                f"input var {n!r} has no declared shape",
                                site, var=n)
                        skip = True
                        break
                    lst.append(sds)
                if skip:
                    break
                specs[slot] = lst
            if skip:
                continue

            lower_ctx = _registry.LowerContext(device="meta", abstract=True)
            try:
                outs = opdef.lower(lower_ctx, specs, op.attrs)
            except Exception as e:  # noqa: BLE001 — any rule failure
                first_in = next((n for ns in op.inputs.values()
                                 for n in ns if n), None)
                msg = " ".join(str(e).split())
                if len(msg) > 300:
                    msg = msg[:300] + "..."
                ctx.diag_at(
                    "PT-E006",
                    f"lowering rule fails to trace against the declared "
                    f"input shapes "
                    f"({_declared_shapes_str(ctx, b_idx, op)}): {msg}",
                    site, var=first_in)
                continue

            saw_dummy = any(
                -1 in (ctx.graph.declared(b_idx, n).shape or ())
                for ns in op.inputs.values() for n in ns
                if n and ctx.graph.declared(b_idx, n) is not None
                and ctx.graph.declared(b_idx, n).shape is not None)
            for slot, names in op.outputs.items():
                vals = outs.get(slot)
                if vals is None:
                    continue
                for n, sds in zip(names, vals):
                    if not n:
                        continue
                    v = ctx.graph.declared(b_idx, n)
                    if v is None or v.shape is None:
                        continue
                    inferred = tuple(sds.shape)
                    if saw_dummy:
                        inferred = _registry.concrete_to_batch(inferred)
                    if tuple(v.shape) != inferred:
                        ctx.diag_at(
                            "PT-E006",
                            f"output {n!r} declared shape "
                            f"{list(v.shape)} but the lowering rule "
                            f"infers {list(inferred)}", site, var=n)
                    elif v.dtype != _registry.dtype_name(sds.dtype):
                        ctx.diag_at(
                            "PT-E006",
                            f"output {n!r} declared dtype {v.dtype} but "
                            f"the lowering rule infers "
                            f"{_registry.dtype_name(sds.dtype)}", site,
                            var=n)


def _declared_shapes_str(ctx, b_idx, op) -> str:
    parts = []
    for slot, names in op.inputs.items():
        if not names:
            continue
        shapes = []
        for n in names:
            v = ctx.graph.declared(b_idx, n)
            shapes.append(list(v.shape) if v is not None and
                          v.shape is not None else "?")
        parts.append(f"{slot}:{shapes}")
    return ", ".join(parts)


def _check_grad_shapes(ctx: AnalysisContext, site: OpSite) -> None:
    """Grad var shape must equal the forward var's (the
    _infer_grad_shapes contract), checked without mutation."""
    op = site.op
    for slot, names in op.outputs.items():
        if not slot.endswith(GRAD_SUFFIX):
            continue
        fwd_names = op.inputs.get(slot[: -len(GRAD_SUFFIX)], [])
        for i, n in enumerate(names):
            if not n or i >= len(fwd_names) or not fwd_names[i]:
                continue
            gv = ctx.graph.declared(site.block_idx, n)
            fv = ctx.graph.declared(site.block_idx, fwd_names[i])
            if gv is None or fv is None or gv.shape is None \
                    or fv.shape is None:
                continue
            if tuple(gv.shape) != tuple(fv.shape):
                ctx.diag_at(
                    "PT-E006",
                    f"grad var {n!r} shape {list(gv.shape)} != forward "
                    f"var {fwd_names[i]!r} shape {list(fv.shape)}",
                    site, var=n)


# ---------------------------------------------------------------------------
# PT-E007 / PT-W104 / PT-W105 / PT-W106 — gradient soundness audit
# ---------------------------------------------------------------------------

@register_analyzer("grad_soundness",
                   ("PT-E007", "PT-W104", "PT-W105", "PT-W106"))
def _check_gradients(ctx: AnalysisContext) -> None:
    g = ctx.graph
    has_backward = False
    for sites in g.block_sites.values():
        for site in sites:
            op = site.op
            if op.type.endswith("_grad") \
                    or op.attrs.get("op_role") == "backward":
                has_backward = True

            # PT-E007: forward/backward pairing
            if op.type.endswith("_grad") \
                    and not _registry.has_op_def(op.type):
                fwd = op.type[: -len("_grad")]
                if not _registry.has_op_def(fwd):
                    ctx.diag_at(
                        "PT-E007",
                        f"grad op pairs with forward type {fwd!r}, which "
                        "is not registered", site)
                else:
                    fdef = _registry.get_op_def(fwd)
                    if fdef.not_differentiable and fdef.grad_lower is None \
                            and fdef.grad_maker is None:
                        ctx.diag_at(
                            "PT-E007",
                            f"grad op pairs with {fwd!r}, which is "
                            "registered as not differentiable (no "
                            "grad_lower/grad_maker)", site)

            # PT-W104: silently dropped gradient — the static twin of
            # backward.py's GradientDropWarning (they flag the SAME case:
            # a gradient is demanded of an op that cannot produce one)
            opdef = _registry._REGISTRY.get(op.type)
            if (opdef is not None and opdef.not_differentiable
                    and not opdef.grad_free and not opdef.is_optimizer_op
                    and opdef.grad_maker is None
                    and opdef.grad_lower is None):
                for n in op.output_names():
                    if n and g.grad_written(n):
                        ctx.diag_at(
                            "PT-W104",
                            f"a gradient of output {n!r} is computed "
                            f"downstream, but {op.type!r} is not "
                            "differentiable — the gradient is dropped "
                            "here and everything upstream trains wrong",
                            site, var=n)
                        break

    # PT-W105: stop_gradient vars whose gradient is computed anyway
    for b in ctx.program.blocks:
        for v in b.vars.values():
            if not v.stop_gradient or v.name.endswith(GRAD_SUFFIX):
                continue
            if g.grad_written(v.name):
                bb, oi = g.writers_of(grad_var_name(v.name))[0] \
                    if g.writers_of(grad_var_name(v.name)) else (b.idx,
                                                                 None)
                ctx.diag(
                    "PT-W105",
                    f"var {v.name!r} is stop_gradient=True but its "
                    f"gradient {grad_var_name(v.name)!r} is produced",
                    block_idx=bb, op_idx=oi,
                    op_type=(ctx.program.blocks[bb].ops[oi].type
                             if oi is not None else None),
                    var=v.name)

    # PT-W106: trainable params that never receive a gradient although
    # the program HAS a backward pass
    if has_backward:
        for b in ctx.program.blocks:
            for v in b.vars.values():
                if not isinstance(v, Parameter) or not v.trainable:
                    continue
                if not g.readers_of(v.name):
                    continue  # unused param — PT-W102's territory
                if not g.grad_written(v.name):
                    ctx.diag(
                        "PT-W106",
                        f"trainable parameter {v.name!r} is read by the "
                        "program but no gradient for it is ever "
                        "produced — it will silently never train",
                        block_idx=b.idx, var=v.name)


# ---------------------------------------------------------------------------
# PT-W101 / PT-W102 / PT-W103 — liveness
# ---------------------------------------------------------------------------

@register_analyzer("liveness", ("PT-W101", "PT-W102", "PT-W103"))
def _check_liveness(ctx: AnalysisContext) -> None:
    g = ctx.graph
    program = ctx.program

    # -- PT-W101: dead ops in block 0 (needs fetch roots to be meaningful)
    roots: Set[str] = set(ctx.fetch_targets)
    for site in g.block_sites.get(0, []):
        if site.op.type == "fetch":
            roots.update(n for n in site.op.input_names() if n)
    if roots:
        needed = set(roots)
        blk0 = program.global_block
        persist = {v.name for v in blk0.vars.values() if v.persistable}
        for site in reversed(g.block_sites.get(0, [])):
            t = site.op.type
            live = (t in ("feed", "fetch") or _is_effect_op(t)
                    or bool(set(site.writes) & needed)
                    or bool(set(site.writes) & persist))
            if live:
                needed.update(site.reads)
            else:
                out = next((n for n in site.writes), None)
                ctx.diag_at(
                    "PT-W101",
                    "op is unreachable from every fetch target and "
                    "writes no persistable var — it computes dead "
                    "values", site, var=out)

    # -- PT-W102: orphan declared vars
    for b in program.blocks:
        for v in b.vars.values():
            if (v.is_data or v.persistable or isinstance(v, Parameter)
                    or v.name.endswith(GRAD_SUFFIX)):
                continue
            if not g.readers_of(v.name) and not g.writers_of(v.name):
                ctx.diag("PT-W102",
                         f"var {v.name!r} is declared but never produced "
                         "or consumed", block_idx=b.idx, var=v.name)

    # -- PT-W103: write-after-write shadowing
    for b in program.blocks:
        for name, writers in g.writes.items():
            here = [oi for bb, oi in writers if bb == b.idx]
            if len(here) < 2:
                continue
            readers = [oi for bb, oi in g.readers_of(name)
                       if bb == b.idx]
            for w1, w2 in zip(here, here[1:]):
                if any(w1 < r <= w2 for r in readers):
                    continue
                site = g.sites[(b.idx, w1)]
                ctx.diag_at(
                    "PT-W103",
                    f"write to {name!r} is shadowed by op #{w2} with no "
                    "read in between — the first write is dead",
                    site, var=name)


# ---------------------------------------------------------------------------
# PT-W107 — recompile hazard (the static twin of the executor's runtime
# recompile attribution, cause=feed_shape)
# ---------------------------------------------------------------------------

# ops whose `shape` attr concretizes their output independent of the
# input's dynamic (batch) dim
_SHAPE_CONCRETIZING = {"reshape": "shape", "reshape2": "shape"}


@register_analyzer("recompile_hazard", ("PT-W107",))
def _check_recompile_hazards(ctx: AnalysisContext) -> None:
    g = ctx.graph
    dummy = _registry.DUMMY_BATCH

    # (a) leaked dummy-batch dims: a declared static dim that is a
    # multiple of DUMMY_BATCH means a -1 dim was concretized during
    # inference (e.g. reshape([-1]) flattened batch into features) —
    # downstream shapes are poisoned and every batch size recompiles
    for b in ctx.program.blocks:
        for v in b.vars.values():
            if v.shape is None:
                continue
            if any(d != -1 and d != 0 and d % dummy == 0
                   for d in v.shape):
                writers = [oi for bb, oi in g.writers_of(v.name)
                           if bb == b.idx]
                oi = writers[0] if writers else None
                ctx.diag(
                    "PT-W107",
                    f"var {v.name!r} shape {list(v.shape)} contains a "
                    f"concretized batch dim (multiple of the dummy "
                    f"batch {dummy}) — the -1 dim was folded into a "
                    "static dim during inference",
                    block_idx=b.idx, op_idx=oi,
                    op_type=(b.ops[oi].type if oi is not None else None),
                    var=v.name)

    # (b) fully-static target shapes fed by -1-dim vars
    for sites in g.block_sites.values():
        for site in sites:
            attr = _SHAPE_CONCRETIZING.get(site.op.type)
            if attr is None:
                continue
            target = site.op.attrs.get(attr)
            if not isinstance(target, (list, tuple)) or not target \
                    or any(d in (-1, 0) for d in target):
                continue
            for n in site.op.input_names():
                v = g.declared(site.block_idx, n)
                if v is not None and v.shape is not None \
                        and -1 in v.shape:
                    ctx.diag_at(
                        "PT-W107",
                        f"input {n!r} has a dynamic (-1) dim but the "
                        f"target shape {list(target)} is fully static — "
                        "every new batch size forces a recompile (or "
                        "fails)", site, var=n)
                    break
