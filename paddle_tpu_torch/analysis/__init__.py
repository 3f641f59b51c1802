"""paddle_tpu_torch.analysis: static program verifier & lint suite.

A copy of `paddle_tpu/analysis/` (pure IR code, the same diagnostic codes
and messages); its one device call, the abstract evaluation of each op's
rule in the shape walk (PT-E006), runs the torch rule on meta-device
tensors instead of `jax.eval_shape`.

A def-use graph over the Program IR (defuse.py) plus a suite of analyzers
(analyzers.py) emitting structured diagnostics with stable codes
(diagnostics.py): def-use soundness (undefined/read-before-write vars, op
cycles), registry/attr-schema checks, a read-only static shape/dtype walk,
a gradient-soundness audit (dropped grads, stop_gradient consistency,
untrained params), liveness lints (dead ops/vars, write-after-write) and a
recompile-hazard lint — the reference's per-op InferShape/CheckAttrs +
ir::Graph validation rebuilt as one queryable subsystem that runs BEFORE
any op does.

    report = paddle_tpu_torch.analysis.verify_program(prog, fetch_list=[loss])
    report.ok, report.errors, report.render()

or `prog.validate(...)`, or `Executor.run(..., validate=True)`.
"""

from .diagnostics import (CODES, Diagnostic, DiagnosticReport, all_codes,
                          severity_of)
from .defuse import DefUseGraph, OpSite, build_def_use
from .analyzers import analyzer_names
from .verifier import ProgramVerificationError, verify_program

__all__ = ["verify_program", "ProgramVerificationError", "Diagnostic",
           "DiagnosticReport", "CODES", "all_codes", "severity_of",
           "DefUseGraph", "OpSite", "build_def_use", "analyzer_names"]
