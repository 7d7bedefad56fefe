"""The traced run's reading of the device: ``torch.profiler`` (CPU and CUDA
activity) over the measured window, reduced in the process.

- busy seconds: the union of the intervals in which a kernel, a copy or a
  memset ran on the device;
- device seconds by span: the kernels launched (on the host thread, by
  the CUDA runtime call that CUPTI correlates with each kernel) inside each
  benchmark span (``span(name)``, a ``record_function``), summed by the
  span's name, innermost span first;
- the device operations that took most time, by name;
- idle gaps: the device's idle time between operations, summed by the
  innermost host span open at the gap's middle (``host`` where none is).

With tracing off, ``span`` is a null context and nothing is recorded.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self.t0 = self.t1 = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def wrap(self, fn, name: str):
        """``fn`` inside ``span(name)``."""
        if not self.on:
            return fn

        def inner(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        return inner

    def start(self) -> None:
        self.t0 = time.perf_counter()
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> dict | None:
        """Ends the window; with tracing on returns the reduction."""
        if self.on:
            import torch

            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if not self.on:
            return None
        self._prof.__exit__(None, None, None)
        return reduce_events(self._prof.profiler.kineto_results.events())


def reduce_events(events) -> dict:
    dev, launches, spans, runtime = [], {}, [], {}
    for ev in events:
        if str(ev.device_type()).endswith("CUDA"):
            # kernels, copies and memsets; not the device-side copies of
            # the host's annotations
            if not (ev.is_user_annotation()
                    or ev.name().startswith(("pb.", "host."))):
                dev.append((ev.start_ns(), ev.duration_ns(), ev.name(),
                            ev.correlation_id()))
            continue
        name = ev.name()
        if name.startswith(("pb.", "host.")):
            spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                          ev.start_thread_id(), name))
        elif name.startswith("cu") and ev.correlation_id():
            launches[ev.correlation_id()] = (ev.start_ns(),
                                             ev.start_thread_id())
            runtime[name] = runtime.get(name, 0) + 1
    if not dev:
        return {"busy_s": 0.0, "ops": 0, "span_device_s": {},
                "device_ops": [], "idle_gaps": [], "unmatched": 0}
    # the host thread of the window: its idle gaps' labels
    main_tid = next((t for _, _, t, nm in spans if nm == "pb.window"), None)

    iv = sorted([s, s + d] for s, d, _, _ in dev)
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9

    # one sweep in time order: span starts (0), queries (1), span ends (2).
    # A kernel takes the innermost benchmark span open at its launch (the
    # harness opens them on one thread; CUPTI's thread ids are not the
    # profiler's); a gap the innermost span of the window's thread
    ev = []
    for i, (s, e, tid, nm) in enumerate(spans):
        ev.append((s, 0, i))
        ev.append((e, 2, i))
    unmatched = 0
    for k, (_, d, _, corr) in enumerate(dev):
        lt = launches.get(corr)
        if lt is None:
            unmatched += 1
            continue
        ev.append((lt[0], 1, ("k", k, None)))
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        ev.append(((e0 + s1) // 2, 1, ("g", s1 - e0, main_tid)))
    ev.sort(key=lambda x: (x[0], x[1]))
    pb: list = []
    anyspan: dict = defaultdict(list)
    by_span: dict = defaultdict(float)
    gaps: dict = defaultdict(float)
    for _, typ, x in ev:
        if typ == 0:
            s, e, tid, nm = spans[x]
            anyspan[tid].append(x)
            if nm.startswith("pb."):
                pb.append(x)
        elif typ == 2:
            for st in (anyspan[spans[x][2]], pb):
                if x in st:
                    st.remove(x)
        else:
            what, val, tid = x
            if what == "k":
                if pb:
                    by_span[spans[pb[-1]][3]] += dev[val][1] * 1e-9
            else:
                st = anyspan[tid]
                gaps[spans[st[-1]][3] if st else "host"] += val * 1e-9
    by_name: dict = defaultdict(float)
    for _, d, nm, _ in dev:
        by_name[nm] += d * 1e-9
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda x: -x[1])[:10]
    return {"busy_s": busy, "ops": len(dev), "unmatched": unmatched,
            "runtime_calls": sorted(runtime.items(), key=lambda x: -x[1])[:6],
            "span_device_s": dict(by_span), "device_ops": top(by_name),
            "idle_gaps": top(gaps)}
