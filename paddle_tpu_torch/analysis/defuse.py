"""Def-use graph over the Program IR.

A copy of `paddle_tpu/analysis/defuse.py`, with its own copy of the
control-flow ops' `_block_outer_reads` (the port has no control-flow ops
yet; a program that carries sub-blocks is still analyzed).

The reference's pass pipeline runs over an SSA ir::Graph whose var nodes
connect producer and consumer op nodes (paddle/fluid/framework/ir/graph.h);
our IR is an ordered op list per block, so the graph is *derived*: for each
block we record, per op, the resolved read/write sets (sub-block capture
folded into the enclosing macro op, like classify_persistables does for the
executor), and per var the ordered write/read sites. Analyzers consume this
one structure instead of re-walking blocks.

Conventions (matching the executor's classification rules):
  * a macro op (while/cond/recurrent — any op carrying sub_block attrs)
    reads its sub-blocks' outer closure AND its own outputs (carry-in /
    untaken-branch pass-through), and writes outer vars its sub-blocks
    write;
  * feed ops write, fetch ops read;
  * host-boundary ops read/write the scope eagerly — same sets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..framework.core import Block, Operator, Program

__all__ = ["OpSite", "DefUseGraph", "build_def_use", "SUB_BLOCK_ATTRS"]

SUB_BLOCK_ATTRS = ("sub_block", "sub_block_t", "sub_block_f")

# macro ops whose outputs are ALSO implicit reads: while carries state in
# through its outputs, and a ONE-armed conditional passes the previous
# value through on the untaken branch. A two-armed cond (both sub_block_t
# and sub_block_f present) produces its outputs purely, as do recurrent
# (scan) and the *_grad macros — treating those as reads would
# false-flag read-before-write.


def _has_carry_semantics(op) -> bool:
    if op.type == "while":
        return True
    if op.type in ("conditional_block", "conditional_block_infer"):
        return not ("sub_block_t" in op.attrs
                    and "sub_block_f" in op.attrs)
    return False


@dataclass
class OpSite:
    """One op occurrence with its resolved def-use sets."""

    block_idx: int
    op_idx: int
    op: Operator
    reads: List[str] = field(default_factory=list)       # ordered, deduped
    writes: List[str] = field(default_factory=list)
    implicit_reads: Set[str] = field(default_factory=set)  # macro carries
    sub_blocks: List[int] = field(default_factory=list)


class DefUseGraph:
    """Per-block ordered op sites + per-var def/use site indices."""

    def __init__(self, program: Program):
        self.program = program
        # (block_idx, op_idx) -> OpSite
        self.sites: Dict[Tuple[int, int], OpSite] = {}
        # per block: ordered site list
        self.block_sites: Dict[int, List[OpSite]] = {}
        # var name -> ordered (block_idx, op_idx) lists
        self.writes: Dict[str, List[Tuple[int, int]]] = {}
        self.reads: Dict[str, List[Tuple[int, int]]] = {}
        # sub-block locals BOUND by the owning macro op at lowering time
        # (recurrent's step_inputs slices + memories carry): reads of
        # these resolve without an in-block write
        self.block_bound: Dict[int, Set[str]] = {}
        # lazy cache for grad_written() — set of "<var>@GRAD" stems with
        # at least one write
        self._grad_write_stems: Optional[Set[str]] = None

    # -- var resolution ------------------------------------------------------
    def declared(self, block_idx: int, name: str):
        """Resolve a declared Variable through the parent chain, or None."""
        b: Optional[Block] = self.program.blocks[block_idx]
        while b is not None:
            v = b.vars.get(name)
            if v is not None:
                return v
            b = b.parent
        return None

    def writers_of(self, name: str) -> List[Tuple[int, int]]:
        return self.writes.get(name, [])

    def readers_of(self, name: str) -> List[Tuple[int, int]]:
        return self.reads.get(name, [])

    def is_written(self, name: str) -> bool:
        return bool(self.writes.get(name))

    def grad_written(self, name: str) -> bool:
        """Is a gradient of `name` produced anywhere? Matches backward.py's
        contribution naming: `n@GRAD` or `n@GRAD@RENAME@k` / `n@GRAD@SEED`.
        O(1) per query via a precomputed set of grad-write stems — the
        gradient audit calls this for every var/param in the program."""
        from ..framework.core import GRAD_SUFFIX
        if self._grad_write_stems is None:
            stems = set()
            n_sfx = len(GRAD_SUFFIX)
            for w in self.writes:
                idx = w.find(GRAD_SUFFIX)
                while idx != -1:
                    # stem up to and including "@GRAD", only at a name
                    # boundary (end or "@...") — covers the exact grad
                    # name and the @RENAME/@SEED decorations without
                    # matching e.g. "x@GRADIENT_FOO"
                    end = idx + n_sfx
                    if end == len(w) or w[end] == "@":
                        stems.add(w[:end])
                    idx = w.find(GRAD_SUFFIX, idx + 1)
            self._grad_write_stems = stems
        from ..framework.core import grad_var_name
        return grad_var_name(name) in self._grad_write_stems


def _sub_outer_writes(program: Program, sub_idx: int,
                      seen: Optional[Set[int]] = None) -> List[str]:
    """Outer-resolving names written (transitively) inside a sub-block —
    the write half of _block_outer_reads."""
    seen = set() if seen is None else seen
    if sub_idx in seen:
        return []
    seen.add(sub_idx)
    sub = program.blocks[sub_idx]
    out: List[str] = []
    for op in sub.ops:
        for n in op.output_names():
            if n and n not in sub.vars and n not in out:
                out.append(n)
        for key in SUB_BLOCK_ATTRS:
            si = op.attrs.get(key)
            if isinstance(si, int) and 0 <= si < len(program.blocks):
                out.extend(n for n in
                           _sub_outer_writes(program, si, seen)
                           if n not in sub.vars and n not in out)
    return out


def _block_outer_reads(program, sub_block):
    """Names read (transitively, through nested macro sub-blocks) by the
    sub-block's ops that resolve OUTSIDE the sub-block — the loop/branch
    closure (a copy of `paddle_tpu/ops/control_flow_ops.py:54`)."""
    reads, seen = [], set()

    def walk(block):
        for op in block.ops:
            for n in op.input_names():
                if n and n not in block.vars and n not in seen:
                    seen.add(n)
                    reads.append(n)
            for key in SUB_BLOCK_ATTRS:
                if key in op.attrs:
                    walk(program.blocks[op.attrs[key]])

    walk(sub_block)
    return [n for n in reads if n not in sub_block.vars]


def build_def_use(program: Program) -> DefUseGraph:
    """Build the graph; read-only — the program is never mutated."""
    g = DefUseGraph(program)
    for b in program.blocks:
        sites: List[OpSite] = []
        for i, op in enumerate(b.ops):
            site = OpSite(b.idx, i, op)
            reads: List[str] = []
            seen: Set[str] = set()

            def _add_read(n: str):
                if n and n not in seen:
                    seen.add(n)
                    reads.append(n)

            for n in op.input_names():
                _add_read(n)
            for key in SUB_BLOCK_ATTRS:
                si = op.attrs.get(key)
                if isinstance(si, int) and 0 <= si < len(program.blocks):
                    site.sub_blocks.append(si)
            if site.sub_blocks:
                for si in site.sub_blocks:
                    for n in _block_outer_reads(program,
                                                program.blocks[si]):
                        site.implicit_reads.add(n)
                        _add_read(n)
                # carry-in / untaken-branch pass-through: outputs are
                # implicit reads too (executor classification rule) —
                # but only for carry-semantics ops, see _has_carry_semantics
                if _has_carry_semantics(op):
                    for n in op.output_names():
                        if n:
                            site.implicit_reads.add(n)
                            _add_read(n)
            site.reads = reads

            writes: List[str] = []
            wseen: Set[str] = set()
            for n in op.output_names():
                if n and n not in wseen:
                    wseen.add(n)
                    writes.append(n)
            for si in site.sub_blocks:
                for n in _sub_outer_writes(program, si):
                    # a sub-block write of an outer var surfaces as a
                    # write of the enclosing macro op
                    if n not in wseen:
                        wseen.add(n)
                        writes.append(n)
            site.writes = writes

            g.sites[(b.idx, i)] = site
            sites.append(site)
            for n in reads:
                g.reads.setdefault(n, []).append((b.idx, i))
            for n in writes:
                g.writes.setdefault(n, []).append((b.idx, i))
            # recurrent's step body reads names the macro BINDS at
            # lowering time (per-step input slices + memory carries);
            # record them so def-use checks don't demand an in-block
            # write (reference: recurrent_op.cc step-scope linking)
            if op.type in ("recurrent", "recurrent_grad"):
                bound: Set[str] = set()
                for key in ("step_inputs", "memories"):
                    # entries are [outer, local(, update)] tuples (or
                    # bare names); every listed name is macro-bound
                    for entry in op.attrs.get(key, ()):
                        if isinstance(entry, str):
                            bound.add(entry)
                        else:
                            bound.update(n for n in entry
                                         if isinstance(n, str))
                for si in site.sub_blocks:
                    g.block_bound.setdefault(si, set()).update(bound)
        g.block_sites[b.idx] = sites
    return g
