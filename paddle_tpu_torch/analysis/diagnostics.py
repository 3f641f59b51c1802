"""Structured diagnostics for the static program verifier (a copy of
`paddle_tpu/analysis/diagnostics.py`: the same codes and hints).

Every finding the analyzers emit is a `Diagnostic` with a *stable* code
(`PT-E...` = error, `PT-W...` = warning), op-level provenance (block
index, op index, op type, offending var) and a remediation hint — the
analog of the reference's enforce messages from per-op InferShape /
CheckAttrs (paddle/fluid/framework/operator.h:430) and the ir::Graph
validation inside the pass pipeline, surfaced as data instead of a C++
abort so every surface (Program.validate, the Executor's pre-flight)
renders the same finding.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["Diagnostic", "DiagnosticReport", "CODES", "severity_of",
           "all_codes"]


# code -> (severity, title, default remediation hint). Codes are STABLE:
# tools and tests key on them; never renumber, only append.
CODES: Dict[str, tuple] = {
    "PT-E001": ("error", "undefined variable",
                "declare the variable (block.create_var / layers.data) "
                "before any op reads it"),
    "PT-E002": ("error", "read before write",
                "insert a producing op (or feed / make it persistable and "
                "initialize it via the startup program) before the first "
                "read"),
    "PT-E003": ("error", "operator cycle",
                "break the cycle: no topological order of these ops can "
                "satisfy their def-use dependencies"),
    "PT-E004": ("error", "unknown operator type",
                "register a lowering rule (framework.registry.register_op) "
                "or fix the op type spelling"),
    "PT-E005": ("error", "attribute schema violation",
                "fix the op's attrs/slots to match the IR schema "
                "(valid op_role, in-range sub_block index, list-of-str "
                "slots)"),
    "PT-E006": ("error", "shape/dtype inconsistency",
                "fix the op's input shapes/attrs, or rebuild the program "
                "with infer_shape=True so declared metadata matches the "
                "lowering rule"),
    "PT-E007": ("error", "unpaired gradient op",
                "grad ops must pair with a registered, differentiable "
                "forward op; rebuild the backward pass with "
                "append_backward"),
    "PT-W101": ("warning", "dead operator",
                "the op is unreachable from any fetch target or "
                "persistable write; prune it (Program._prune) or fetch "
                "its output"),
    "PT-W102": ("warning", "orphan variable",
                "the declared var is never produced or consumed; drop the "
                "declaration"),
    "PT-W103": ("warning", "write-after-write shadowing",
                "the first write is dead — it is overwritten before any "
                "read; remove it or read the value in between"),
    "PT-W104": ("warning", "silently dropped gradient",
                "the op is not differentiable (grad_free=False) but a "
                "gradient flows into it and is dropped; mark inputs "
                "stop_gradient=True if intended, or give the op a "
                "grad_lower"),
    "PT-W105": ("warning", "stop_gradient inconsistency",
                "a var marked stop_gradient=True has its gradient "
                "computed anyway; clear stop_gradient or drop the grad "
                "ops"),
    "PT-W106": ("warning", "trainable parameter receives no gradient",
                "the program has backward ops but this trainable param "
                "gets no grad — it will silently never train; check "
                "stop_gradient / parameter_list / the loss path"),
    "PT-W107": ("warning", "recompile hazard (concretized batch dim)",
                "a -1 (batch) dim flows into a shape-concretizing op: "
                "every new batch size forces a recompile (or a leaked "
                "dummy-batch dim poisons downstream shapes); keep a "
                "-1/0 entry in the target shape"),
}


def severity_of(code: str) -> str:
    return CODES[code][0]


def all_codes() -> List[str]:
    return sorted(CODES)


@dataclass
class Diagnostic:
    """One finding: stable code + op-level provenance + fix hint."""

    code: str
    message: str
    block_idx: int = 0
    op_idx: Optional[int] = None
    op_type: Optional[str] = None
    var: Optional[str] = None
    hint: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.hint:
            self.hint = CODES[self.code][2]

    @property
    def severity(self) -> str:
        return severity_of(self.code)

    @property
    def title(self) -> str:
        return CODES[self.code][1]

    def render(self) -> str:
        where = f"block {self.block_idx}"
        if self.op_idx is not None:
            where += f" op #{self.op_idx}"
            if self.op_type:
                where += f" ({self.op_type})"
        if self.var:
            where += f" var {self.var!r}"
        return (f"{self.code} [{self.severity}] {where}: {self.message}\n"
                f"    hint: {self.hint}")

    def to_dict(self) -> Dict[str, Any]:
        return {"code": self.code, "severity": self.severity,
                "title": self.title, "message": self.message,
                "block_idx": self.block_idx, "op_idx": self.op_idx,
                "op_type": self.op_type, "var": self.var, "hint": self.hint}


@dataclass
class DiagnosticReport:
    """All findings for one program, errors first, in program order."""

    diagnostics: List[Diagnostic] = field(default_factory=list)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def sort(self) -> None:
        self.diagnostics.sort(
            key=lambda d: (d.severity != "error", d.block_idx,
                           -1 if d.op_idx is None else d.op_idx, d.code))

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def has(self, code: str) -> bool:
        return any(d.code == code for d in self.diagnostics)

    def summary(self) -> str:
        return (f"{len(self.errors)} error(s), "
                f"{len(self.warnings)} warning(s)")

    def render(self, max_items: Optional[int] = None) -> str:
        if not self.diagnostics:
            return "program verifies clean (0 diagnostics)"
        items = self.diagnostics if max_items is None \
            else self.diagnostics[:max_items]
        lines = [d.render() for d in items]
        if max_items is not None and len(self.diagnostics) > max_items:
            lines.append(f"... {len(self.diagnostics) - max_items} more")
        lines.append(self.summary())
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok, "errors": len(self.errors),
                "warnings": len(self.warnings),
                "diagnostics": [d.to_dict() for d in self.diagnostics]}
