"""Profiling ranges (reference: platform/profiler.h RecordEvent).

Port of `RecordEvent` from `paddle_tpu/profiler.py` (:113): a RAII range
that records a span into the observability tracer and, for the device
timeline, opens a `torch.profiler.record_function` range (the
counterpart of `jax.profiler.TraceAnnotation`), so a `torch.profiler`
trace shows the serving scheduler's prefill and decode dispatches next
to the CUDA kernels they launch. The rest of the JAX module
(start_profiler / stop_profiler / profiler()) is not ported yet.
"""

from __future__ import annotations

from .observability import tracer as _obs_tracer

__all__ = ["RecordEvent", "record_event"]


class RecordEvent:
    """RAII profiling range. Usable as a context manager. Records a span
    into the observability tracer (thread-safe) and opens a
    torch.profiler.record_function range. Extra keyword args become span
    args visible in the chrome trace."""

    __slots__ = ("name", "args", "_ctx", "_span")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args or None
        self._ctx = None
        self._span = None

    def __enter__(self):
        # the range OUTSIDE the tracer span: the span's measured window
        # must not include the range's own setup/teardown cost
        import torch

        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()
        self._span = _obs_tracer.trace_span(self.name, "record_event",
                                            self.args)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._span = None
        self._ctx.__exit__(*exc)
        self._ctx = None
        return False


record_event = RecordEvent
