"""Profiling hooks: per-phase wall-clock plus optional jax.profiler traces.

The reference has no in-repo tracing (SURVEY.md §5 — only PETSc monitor
options and Julia @elapsed); the rebuild adds phase timers
(core/logging.PhaseTimer, threaded through NewtonSolver) and this
device-trace context for TensorBoard-compatible profiles."""

from __future__ import annotations

import contextlib
from collections import Counter
from pathlib import Path
from typing import Iterator, Sequence, Tuple

import jax


@contextlib.contextmanager
def device_trace(logdir: str = "/tmp/pgtpu_trace",
                 enabled: bool = True) -> Iterator[None]:
    """Capture a jax.profiler trace of everything inside the context:

        with device_trace("/tmp/trace"):
            solver.solve()
    """
    if not enabled:
        yield
        return
    Path(logdir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the profile (TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


def busy_seconds(intervals: Sequence[Tuple[int, int]]) -> float:
    """Length in seconds of the union of (start_ns, end_ns) intervals —
    the time in which at least one device operation ran."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-9


def device_kernel_stats(trace_dir: str) -> dict:
    """Reduce the newest jax.profiler trace under `trace_dir` to device
    metrics over the window from the first device event to the last.

    Events are taken from the GPU planes' stream lines (one event per
    kernel or copy); the derived 'XLA Ops'/'XLA Modules' lines that
    overlay them are not counted. Returns kernels (event count), window_s,
    busy_s (union of event intervals), idle_share (1 - busy/window),
    lines (line name -> event count, for inspection) and top (the most
    frequent kernel names)."""
    paths = sorted(Path(trace_dir).glob("plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    data = jax.profiler.ProfileData.from_file(str(paths[-1]))
    intervals, names, lines = [], Counter(), Counter()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines[f"{plane.name} {line.name}"] += len(events)
            if "stream" not in line.name.lower():
                continue
            for ev in events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names[ev.name] += 1
    if not intervals:
        raise ValueError(f"no device stream events in the trace; device "
                         f"lines seen: {dict(lines)}")
    window = (max(e for _, e in intervals)
              - min(s for s, _ in intervals)) * 1e-9
    busy = busy_seconds(intervals)
    return {"kernels": len(intervals), "window_s": window, "busy_s": busy,
            "idle_share": 1.0 - busy / window if window > 0 else 0.0,
            "lines": dict(lines), "top": names.most_common(8)}
