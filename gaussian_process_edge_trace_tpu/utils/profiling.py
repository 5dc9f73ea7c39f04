"""Tracing / profiling utilities (SURVEY.md §5).

The reference's only instrumentation is ``time.time()`` prints
(gpet.py:815,831-835,864-870,897-899). Here:

- :class:`PhaseTimer` — structured host-side wall-clock accumulation per
  phase, for the introspective driver path and preprocessing;
- :func:`device_trace` — context manager around ``jax.profiler.trace`` for
  XLA-level traces viewable in TensorBoard/Perfetto;
- :func:`trace_telemetry` — the per-iteration telemetry of a
  :class:`~..trace.driver.TraceResult` as a plain dict of NumPy arrays
  (costs, observation counts, adaptive thresholds — returned as arrays
  rather than printed, per the SURVEY plan);
- :func:`device_span` — the device-side span and busy time of one call,
  read from a ``jax.profiler`` trace;
- :func:`device_op_breakdown` — the same trace aggregated by op name.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np


class PhaseTimer:
    """Accumulate wall-clock per named phase; ``report()`` returns a dict."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self):
        return {k: {"total_s": self.totals[k], "calls": self.counts[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def device_trace(log_dir):
    """``jax.profiler.trace`` as a context manager (TensorBoard format)."""
    import jax
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def trace_telemetry(result):
    """Per-iteration telemetry of a TraceResult as NumPy arrays."""
    n = int(result.n_iters)
    return {
        "n_iters": n,
        "converged": bool(result.converged),
        "optimal_costs": np.asarray(result.iter_costs[:n]),
        "n_obs": np.asarray(result.iter_nobs[:n]),
        "score_thresholds": np.asarray(result.iter_thresh[:n]),
        "theta": np.exp(np.asarray(result.theta)),
        "log_marginal_likelihood": float(result.lml),
        "final_cost": float(result.final_cost),
    }


def _device_events(fn, args, log_dir=None):
    """Run ``fn(*args)`` once (compiled beforehand, outside the trace)
    under ``jax.profiler`` and return its device events as ``(name,
    start_ns, end_ns)`` tuples, and the host wall time of that traced call
    in ms.

    On a GPU the events are the kernels and copies on the device planes'
    stream lines; the planes' derived lines ("XLA Modules", "XLA Ops",
    ...) repeat the same work and are skipped, so no interval is counted
    twice. On the CPU, which has no device timeline, the XLA runtime's
    host threads stand in. On any other platform, or a GPU trace with no
    stream events, this raises rather than report a host number as a
    device one.
    """
    import glob
    import shutil
    import tempfile

    import jax

    platform = jax.devices()[0].platform
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(f"no device-timeline reader for {platform!r}")
    own = log_dir is None
    if own:
        log_dir = tempfile.mkdtemp(prefix="gpet_prof_")
    try:
        jax.block_until_ready(fn(*args))      # compile outside the trace
        jax.profiler.start_trace(log_dir)
        try:
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            jax.profiler.stop_trace()
        path = sorted(glob.glob(
            f"{log_dir}/plugins/profile/*/*.xplane.pb"))[-1]
        pd = jax.profiler.ProfileData.from_file(path)
        events = []
        for plane in pd.planes:
            if platform == "gpu":
                if not plane.name.startswith("/device:GPU"):
                    continue
                lines = [ln for ln in plane.lines
                         if ln.name.startswith("Stream")]
            else:
                if plane.name != "/host:CPU":
                    continue
                lines = [ln for ln in plane.lines
                         if ln.name.startswith("tf_XLA")]
            for ln in lines:
                for ev in ln.events:
                    if ev.duration_ns > 0:
                        events.append((ev.name, ev.start_ns,
                                       ev.start_ns + ev.duration_ns))
    finally:
        if own:
            shutil.rmtree(log_dir, ignore_errors=True)
    if not events:
        raise RuntimeError(f"no device events in the {platform} trace")
    return events, wall_ms


def span_and_busy(events):
    """``(span_ms, busy_ms)`` of ``(name, start_ns, end_ns)`` events: first
    start to last end, and the length of the union of the intervals."""
    ivs = sorted((s, e) for _, s, e in events)
    busy, cur_s, cur_e = 0.0, ivs[0][0], ivs[0][1]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in ivs) - ivs[0][0]
    return span / 1e6, busy / 1e6


class DeviceTime(NamedTuple):
    span_ms: float   # first kernel start to last kernel end
    busy_ms: float   # union of the kernels' intervals
    wall_ms: float   # host clock around the same (traced) call


def device_span(fn, *args, log_dir=None) -> DeviceTime:
    """Device time of ONE ``fn(*args)`` call, from a profiler trace: the
    span from the first kernel's start to the last kernel's end across
    the device's streams, the time in which any kernel ran, and the host
    wall time of that call (span <= wall; the profiler itself slows a
    program of many short kernels, so the traced call runs slower than an
    untraced one). ``1 - busy/span`` is the device's idle share inside
    the program."""
    events, wall_ms = _device_events(fn, args, log_dir)
    return DeviceTime(*span_and_busy(events), wall_ms)


def device_op_breakdown(fn, *args, top=20, log_dir=None):
    """Per-op device time of one call to ``fn(*args)``: a list of
    ``(total_ms, op_name)`` sorted descending, aggregated by name over
    the events :func:`device_span` reads."""
    import collections

    agg = collections.Counter()
    for name, s, e in _device_events(fn, args, log_dir)[0]:
        agg[name] += e - s
    return [(ns / 1e6, name) for name, ns in agg.most_common(top)]
