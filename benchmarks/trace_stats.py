"""Reduce a ``jax.profiler`` trace of a GPU run to device metrics.

``device_stats(trace_dir)`` reads the newest ``*.xplane.pb`` under
``trace_dir/plugins/profile/`` and returns, per GPU plane, the kernel
events found on its stream lines: how many, their summed time, the busy
time (union of their intervals), the window (first start to last end) and
the idle share (1 - busy / window), plus the kernels that took the most
time. Lines named like XLA's op and module summaries are skipped so that
each kernel counts once.

Used by benchmarks/benchmark_bringup.py; run a traced window in a process
of its own and keep the untraced timings apart, as tracing slows the host.
"""

import glob
import os
from collections import defaultdict

#: per-plane lines that summarize other lines rather than run kernels
_SUMMARY_LINES = ("XLA Ops", "XLA Modules", "Source", "Steps",
                  "TensorFlow", "Framework", "Launch Stats")


def _union_ns(intervals):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def latest_xplane(trace_dir):
    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return paths[-1]


def device_stats(trace_dir, top=8):
    """{plane name: stats dict} for every GPU plane of the newest trace."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(latest_xplane(trace_dir))
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        intervals, per_kernel, lines = [], defaultdict(float), []
        for line in plane.lines:
            if any(k in line.name for k in _SUMMARY_LINES):
                continue
            evs = list(line.events)
            if not evs:
                continue
            lines.append(f"{line.name} ({len(evs)})")
            for e in evs:
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
                per_kernel[e.name] += e.duration_ns
        if not intervals:
            continue
        start = min(s for s, _ in intervals)
        end = max(e for _, e in intervals)
        busy = _union_ns(intervals)
        window = max(end - start, 1.0)
        out[plane.name] = {
            "lines": lines,
            "kernels": len(intervals),
            "kernel_ns": sum(e - s for s, e in intervals),
            "busy_ns": busy,
            "window_ns": window,
            "idle_share": 1.0 - busy / window,
            "top": sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top],
        }
    return out
