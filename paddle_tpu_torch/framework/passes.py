"""Generic IR pass framework: Pass + PassRegistry + pattern matcher.

Port of `paddle_tpu/framework/passes.py` (it has no JAX in it, so this is
a copy). Reference: paddle/fluid/framework/ir/pass.h:40 (Pass::Apply over
a Graph), pass.h:118 PassRegistry, and graph_pattern_detector.h:276
(PDPattern / GraphPatternDetector: declarative subgraph patterns with a
rewrite handler, the base of every fuse pass like
fuse_elewise_add_act_pass.cc).

Passes rewrite the PROGRAM (the only IR there is). A pattern is a small
DAG of typed op nodes connected by var-flow edges; the matcher walks the
block's def-use chains. Rewrites edit block.ops in place and bump the
program version (invalidating executor caches automatically).

User extension point: subclass Pass, or call register_pass(name)(fn),
and apply by name; define patterns with Pattern()/OpNode without
touching framework code.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .core import Block, Operator, Program

__all__ = ["Pass", "PassRegistry", "register_pass", "apply_pass",
           "get_pass", "Pattern", "OpNode", "Match"]


# ---------------------------------------------------------------------------
# Pass + registry
# ---------------------------------------------------------------------------

class Pass:
    """Base pass: override apply(program, **kw) (whole-program) or
    apply_block(block, **kw) (called per block)."""

    name: Optional[str] = None

    def apply(self, program: Program, **kw):
        for block in program.blocks:
            self.apply_block(block, **kw)
        program._bump_version()
        return program

    def apply_block(self, block: Block, **kw):
        raise NotImplementedError(
            f"pass {type(self).__name__} implements neither apply nor "
            "apply_block")

    def __call__(self, program: Program, **kw):
        return self.apply(program, **kw)


class _FnPass(Pass):
    def __init__(self, name: str, fn: Callable):
        self.name = name
        self._fn = fn

    def apply(self, program: Program, **kw):
        out = self._fn(program, **kw)
        program._bump_version()
        return out if out is not None else program


class PassRegistry:
    """name -> Pass factory (reference pass.h:118 PassRegistry — a global
    map populated by REGISTER_PASS; here a decorator)."""

    _passes: Dict[str, Callable[[], Pass]] = {}

    @classmethod
    def register(cls, name: str, factory: Callable[[], Pass]):
        if name in cls._passes:
            raise ValueError(f"pass {name!r} already registered")
        cls._passes[name] = factory

    @classmethod
    def get(cls, name: str) -> Pass:
        if name not in cls._passes:
            raise KeyError(
                f"no pass {name!r}; registered: {sorted(cls._passes)}")
        return cls._passes[name]()

    @classmethod
    def has(cls, name: str) -> bool:
        return name in cls._passes


def register_pass(name: str):
    """Decorator for a Pass subclass or a fn(program, **kw)."""
    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Pass):
            obj.name = name
            PassRegistry.register(name, obj)
        else:
            PassRegistry.register(name, lambda: _FnPass(name, obj))
        return obj
    return deco


def get_pass(name: str) -> Pass:
    return PassRegistry.get(name)


def apply_pass(name: str, program: Program, **kw):
    return PassRegistry.get(name).apply(program, **kw)


# ---------------------------------------------------------------------------
# pattern matcher
# ---------------------------------------------------------------------------

class OpNode:
    """One op in a pattern: matches by type, optional attr predicate, and
    var-flow edges declared via inputs={slot: producer_handle_or_None}."""

    def __init__(self, op_type: str,
                 inputs: Optional[Dict[str, "VarHandle"]] = None,
                 attr_pred: Optional[Callable[[Operator], bool]] = None):
        self.op_type = op_type
        self.inputs = inputs or {}
        self.attr_pred = attr_pred
        self.idx = -1  # filled by Pattern


class VarHandle:
    """A var produced by a pattern node's output slot."""

    def __init__(self, node: OpNode, slot: str):
        self.node = node
        self.slot = slot


class Pattern:
    """Build a pattern DAG:

        p = Pattern()
        mul = p.op("mul")
        add = p.op("elementwise_add", inputs={"X": mul.out("Out")})
        act = p.op("relu", inputs={"X": add.out("Out")})

    Nodes are matched in declaration order; every declared edge requires
    the consumer's input var name to equal the producer's output var name,
    and (safety for rewrites) an INTERNAL producer-consumer var must have
    no other consumers outside the matched set unless keep_intermediates.
    """

    def __init__(self):
        self.nodes: List[OpNode] = []

    def op(self, op_type: str, inputs=None, attr_pred=None) -> "PNode":
        node = OpNode(op_type, {}, attr_pred)
        node.idx = len(self.nodes)
        self.nodes.append(node)
        pn = PNode(node)
        if inputs:
            node.inputs = {slot: vh for slot, vh in inputs.items()}
        return pn


class PNode:
    def __init__(self, node: OpNode):
        self._node = node

    def out(self, slot: str) -> VarHandle:
        return VarHandle(self._node, slot)


class Match:
    """One found subgraph: ops[i] is the block op matched to pattern node
    i (declaration order)."""

    def __init__(self, block: Block, ops: List[Operator]):
        self.block = block
        self.ops = ops

    def var(self, handle_owner: "PNode", slot: str) -> str:
        op = self.ops[handle_owner._node.idx]
        return op.output(slot)[0]


def _op_output_var(op: Operator, slot: str) -> Optional[str]:
    names = op.outputs.get(slot) or []
    return names[0] if names else None


def find_matches(block: Block, pattern: Pattern,
                 allow_shared_intermediates: bool = False) -> List[Match]:
    """All non-overlapping matches, scanning in op order (greedy — the
    reference detector is greedy the same way)."""
    ops = block.ops
    consumers: Dict[str, List[int]] = {}
    for i, op in enumerate(ops):
        for n in op.input_names():
            consumers.setdefault(n, []).append(i)

    matches: List[Match] = []
    used: set = set()

    def try_anchor(start_i: int) -> Optional[List[int]]:
        """Anchor pattern node 0 at ops[start_i], then extend greedily."""
        assign: List[int] = []

        def node_ok(node: OpNode, i: int) -> bool:
            op = ops[i]
            if i in used or i in assign or op.type != node.op_type:
                return False
            if node.attr_pred is not None and not node.attr_pred(op):
                return False
            for slot, vh in node.inputs.items():
                prod_i = assign[vh.node.idx]
                want = _op_output_var(ops[prod_i], vh.slot)
                got = op.inputs.get(slot) or []
                if want is None or not got or got[0] != want:
                    return False
            return True

        def extend(k: int) -> bool:
            if k == len(pattern.nodes):
                return True
            node = pattern.nodes[k]
            # candidate ops: consumers of the produced vars (fast path)
            # or any later op
            cand = range(len(ops)) if not node.inputs else sorted({
                i
                for vh in node.inputs.values()
                if (v := _op_output_var(ops[assign[vh.node.idx]],
                                        vh.slot)) is not None
                for i in consumers.get(v, [])})
            for i in cand:
                if node_ok(node, i):
                    assign.append(i)
                    if extend(k + 1):
                        return True
                    assign.pop()
            return False

        if not node_ok(pattern.nodes[0], start_i):
            return None
        assign.append(start_i)
        if not extend(1):
            return None
        if not allow_shared_intermediates:
            # internal vars must not leak outside the match
            matched = set(assign)
            for node in pattern.nodes:
                for vh in node.inputs.values():
                    v = _op_output_var(ops[assign[vh.node.idx]], vh.slot)
                    for ci in consumers.get(v, []):
                        if ci not in matched:
                            return None
        return assign

    for i in range(len(ops)):
        assign = try_anchor(i)
        if assign is not None:
            used.update(assign)
            matches.append(Match(block, [ops[j] for j in assign]))
    return matches


class PatternPass(Pass):
    """Pass built from a pattern + rewrite handler:

        class MyFuse(PatternPass):
            def build_pattern(self, p): ...return handles...
            def rewrite(self, block, match): ...edit block.ops...
    """

    allow_shared_intermediates = False

    def build_pattern(self, p: Pattern):
        raise NotImplementedError

    def rewrite(self, block: Block, match: Match) -> None:
        raise NotImplementedError

    def apply_block(self, block: Block, **kw):
        p = Pattern()
        self.build_pattern(p)
        for match in find_matches(block, p,
                                  self.allow_shared_intermediates):
            self.rewrite(block, match)


def replace_ops(block: Block, old_ops: List[Operator],
                new_ops_desc: List[dict]) -> None:
    """Splice: remove old_ops, insert new ops (as desc dicts with
    type/inputs/outputs/attrs) at the first removed position."""
    pos = min(block.ops.index(o) for o in old_ops)
    for o in old_ops:
        block.ops.remove(o)
    for k, d in enumerate(new_ops_desc):
        op = Operator(block, d["type"], d.get("inputs", {}),
                      d.get("outputs", {}), d.get("attrs", {}))
        block.ops.insert(pos + k, op)
    block.program._bump_version()
