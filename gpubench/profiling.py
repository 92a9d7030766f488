"""The traced stretch: torch.profiler over a few dispatches, reduced to
what the per-layer readers read.

The device is busy where the union of its work (kernels, copies, sets)
covers the stretch; kernels run side by side count once (the span union of
the port's ``chip_smoke.py::profile_iteration``).  A kernel belongs to a
host range when the runtime call that launched it (same correlation id)
started inside the range.  An idle gap is put down to the innermost host
range open on the driving thread at its middle.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

# the benchmark's host range around each traced dispatch (program.py opens
# one around each host read)
DISPATCH_RANGE = "gpubench.dispatch"
# entries of each list of the breakdown
TOP = 10
# a device record of these kinds is work; "gpu_user_annotation" is a
# range's shadow on the device, not work
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Stretch:
    """One traced stretch: the rounds it ran, the device's work as
    ``(name, start_ns, end_ns, correlation, is_kernel)``, the host's ranges as
    ``(name, start_ns, end_ns)`` on the driving thread, the runtime calls'
    ``(start_ns, correlation)``, and the launches the program counted.  A
    device record's correlation is its launching runtime call's."""

    rounds: int
    start_ns: int
    end_ns: int
    device: List[Tuple[str, int, int, int, bool]]
    host: List[Tuple[str, int, int]]
    runtime: List[Tuple[int, int]]
    launches: Dict[str, int]

    def kernels(self):
        return [d for d in self.device if d[4]]

    def busy_ns(self) -> int:
        spans = sorted((max(s, self.start_ns), min(e, self.end_ns))
                       for _, s, e, _, _ in self.device)
        busy, reach = 0, None
        for s, e in spans:
            if e <= s:
                continue
            if reach is None or s > reach:
                busy += e - s
                reach = e
            elif e > reach:
                busy += e - reach
                reach = e
        return busy

    def kernel_ns(self, match) -> Tuple[int, int]:
        """``(summed device ns, records)`` of the kernels ``match(name)``."""
        hit = [e - s for name, s, e, _, _ in self.kernels() if match(name)]
        return sum(hit), len(hit)

    def range_kernel_ns(self, range_name: str) -> Tuple[int, int]:
        """``(ranges, device ns of the kernels launched inside them)``."""
        spans = sorted((s, e) for name, s, e in self.host if name == range_name)
        starts = [s for s, _ in spans]
        inside = set()
        for t, corr in self.runtime:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                inside.add(corr)
        return len(spans), sum(e - s for _, s, e, c, _ in self.kernels() if c in inside)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Seconds of device idle time by the innermost host range open at
        each gap's middle, longest first."""
        merged = []
        for s, e in sorted((s, e) for _, s, e, _, _ in self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps, prev = [], self.start_ns
        for s, e in merged:
            if s > prev:
                gaps.append((prev, min(s, self.end_ns)))
            prev = max(prev, e)
        if prev < self.end_ns:
            gaps.append((prev, self.end_ns))
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        by_name: Dict[str, float] = {}
        stack: List[Tuple[str, int, int]] = []
        j = 0
        for a, b in sorted(gaps):
            if b <= a:
                continue
            mid = (a + b) // 2
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] < host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no host range)"
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        return sorted(by_name.items(), key=lambda kv: -kv[1])

    def device_ops(self) -> List[Tuple[str, float]]:
        by_name: Dict[str, float] = {}
        for name, s, e, _, _ in self.device:
            by_name[short(name)] = by_name.get(short(name), 0.0) + (e - s) / 1e9
        return sorted(by_name.items(), key=lambda kv: -kv[1])


def base_name(name: str) -> str:
    """A device kernel's function name without its namespace, template
    arguments and parameters."""
    n = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (n.find("<"), n.find("(")) if i >= 0), default=len(n))
    n = n[:cut].split()
    return n[-1].split("::")[-1] if n else ""


def short(name: str) -> str:
    """The head of a kernel's name: templated names run to pages."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:80]


def _kind(ev, cpu) -> str:
    """The kineto activity of an event: ``activity_type()`` where this torch
    has it, else told from the device, the name and the annotation flag."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    if ev.device_type() != cpu:
        if ev.is_user_annotation():
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy")
                else "gpu_memset" if name.startswith("Memset") else "kernel")
    if ev.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def trace(dispatch, n: int, rounds_per_dispatch: int, launches, device) -> Stretch:
    """``n`` dispatches under torch.profiler (CPU and, on the card, CUDA
    activities), each inside :data:`DISPATCH_RANGE`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    before = launches()
    with profile(activities=activities) as prof:
        for _ in range(n):
            with record_function(DISPATCH_RANGE):
                dispatch()
        sync()
    after = launches()
    events = prof.profiler.kineto_results.events()
    device, host, runtime = [], [], []
    threads: Dict[int, int] = {}
    cpu = torch.autograd.DeviceType.CPU
    for ev in events:
        kind = _kind(ev, cpu)
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if ev.device_type() != cpu:
            if kind in DEVICE_WORK:
                device.append((ev.name(), start, end, ev.correlation_id(), kind == "kernel"))
            continue
        if kind in ("cuda_runtime", "cuda_driver"):
            runtime.append((start, ev.correlation_id()))
        host.append((ev.name(), start, end, ev.start_thread_id()))
        if ev.name() == DISPATCH_RANGE:
            threads[ev.start_thread_id()] = threads.get(ev.start_thread_id(), 0) + 1
    main = max(threads, key=threads.get) if threads else None
    host = [(name, s, e) for name, s, e, tid in host if tid == main]
    spans = [(s, e) for name, s, e in host if name == DISPATCH_RANGE]
    if not spans:
        raise RuntimeError(f"the profile holds none of the {n} {DISPATCH_RANGE} ranges")
    start_ns = min(s for s, _ in spans)
    end_ns = max([e for _, e in spans] + [e for _, _, e, _, _ in device])
    return Stretch(rounds=n * rounds_per_dispatch,
                   start_ns=start_ns, end_ns=end_ns, device=device, host=host,
                   runtime=runtime,
                   launches={k: after.get(k, 0) - before.get(k, 0) for k in after})
