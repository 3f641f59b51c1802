"""verify_program: the static program verifier's entry point (a copy of
`paddle_tpu/analysis/verifier.py`).

Runs the full analyzer suite (analyzers.py) over a def-use graph of the
Program IR and returns a DiagnosticReport. Verification is READ-ONLY:
the program's version, blocks, ops and vars are untouched (pinned by
tests), so a pre-flight verify never invalidates executor compile caches.

Two surfaces share this entry point:
  * `Program.validate()` / `paddle_tpu_torch.analysis.verify_program()`
  * `Executor.run(..., validate=True)`  (pre-flight; raises
    ProgramVerificationError with the diagnostic before any op runs)
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Set, Union

from ..framework.core import Program, Variable
from .analyzers import AnalysisContext, run_analyzers
from .defuse import build_def_use
from .diagnostics import CODES, DiagnosticReport

__all__ = ["verify_program", "ProgramVerificationError"]


class ProgramVerificationError(RuntimeError):
    """A program failed static verification. Carries the full report;
    str() leads with the first error's code + op + var provenance."""

    def __init__(self, report: DiagnosticReport,
                 program: Optional[Program] = None):
        self.report = report
        self.program = program
        super().__init__(
            "program verification failed: " + report.summary() + "\n"
            + report.render(max_items=8))


def _resolve_codes(codes) -> Set[str]:
    out: Set[str] = set()
    for c in codes or ():
        if c not in CODES:
            raise ValueError(
                f"unknown diagnostic code {c!r}; known: "
                f"{sorted(CODES)}")
        out.add(c)
    return out


def verify_program(program: Program,
                   fetch_list: Optional[Sequence[Union[str,
                                                       Variable]]] = None,
                   feed_names: Optional[Iterable[str]] = None,
                   skip_codes: Optional[Iterable[str]] = None
                   ) -> DiagnosticReport:
    """Statically verify `program`; returns a DiagnosticReport.

    fetch_list — the run's fetch targets (names or Variables). Needed for
        dead-op analysis (PT-W101): without any fetch root the analyzer
        cannot tell intent and skips that check.
    feed_names — names bound by feed at run time, beyond vars already
        declared is_data (reads of these never flag PT-E001/E002).
    skip_codes — diagnostic codes to suppress (e.g. {"PT-W101"}).
    """
    fetch_targets: Set[str] = set()
    for f in fetch_list or ():
        fetch_targets.add(f.name if isinstance(f, Variable) else str(f))
    feeds: Set[str] = set(feed_names or ())

    version_before = program.version
    graph = build_def_use(program)
    report = DiagnosticReport()
    ctx = AnalysisContext(program, graph, fetch_targets, feeds, report)
    run_analyzers(ctx, skip_codes=_resolve_codes(skip_codes))
    assert program.version == version_before, \
        "verifier mutated the program (version bumped) — analyzer bug"
    return report
