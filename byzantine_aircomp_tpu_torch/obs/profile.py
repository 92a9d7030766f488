"""Device traces on ``torch.profiler`` and memory watermarks.

The port's counterpart of ``byzantine_aircomp_tpu/obs/profile.py``:

* **Device traces** — :class:`Profiler` runs ``torch.profiler`` so that a
  run started with ``--profile-dir DIR`` writes a Chrome/Perfetto JSON
  trace into DIR, with every round (every dispatch under
  ``--rounds-per-dispatch``) a ``round`` span (:func:`.span.span`, a
  profiler range) followed by ``prof.step()``, and eval and checkpoint
  spans.
  ``--profile-rounds A:B`` restricts the capture to the half-open round
  window ``[A, B)``.  On the card the profiler asks for
  ``ProfilerActivity.CUDA``; a card run's trace that holds no device
  kernel raises, never writing a CPU-only trace quietly.  With
  ``profile_dir`` unset every method is a no-op returning a shared
  ``nullcontext``.  A CUDA-graph capture (a graphed run's first dispatch)
  runs outside the trace (:meth:`Profiler.suspended`: the trace so far is
  written, and a new segment, ``trace_1.json`` .., opens after it), so the
  profiler never wraps what is captured.

* **Memory watermarks** — :func:`device_memory` reads the CUDA caching
  allocator (``torch.cuda.memory_allocated`` / ``max_memory_allocated``,
  ``source: "device:cuda"``) for a run on the card, and the process RSS
  (``source: "host_rss"``) only for a run the caller put on the CPU.
  Consumers check ``source`` before comparing against the memory model
  (:mod:`.hbm`).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

from .span import span

#: reusable no-op context
_NULL_CTX = contextlib.nullcontext()

#: the profiler range around each round (each dispatch under R > 1), and
#: the named phases
ROUND_RANGE = "round"
PHASES = ("eval", "checkpoint")


def device_kernels(prof) -> list:
    """The device kernels of a closed ``torch.profiler`` profile: its CUDA
    events but copies, memsets and the device-side spans of ranges."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [ev for ev in prof.events()
            if ev.device_type == cuda and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith(("Memcpy", "Memset"))
            and ev.name not in (ROUND_RANGE,) + PHASES]


def parse_rounds(spec: str) -> Tuple[int, int]:
    """Parse a ``--profile-rounds A:B`` half-open window ``[A, B)``.

    Raises ``ValueError`` on anything but ``int:int`` with
    ``0 <= A < B`` — config validation calls this, so a bad spec dies at
    startup, not at round A.
    """
    parts = spec.split(":")
    if len(parts) != 2:
        raise ValueError(
            f"profile_rounds must be 'A:B' (half-open round window), got {spec!r}"
        )
    try:
        a, b = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"profile_rounds bounds must be integers, got {spec!r}")
    if a < 0 or b <= a:
        raise ValueError(f"profile_rounds needs 0 <= A < B, got {spec!r}")
    return a, b


class Profiler:
    """``torch.profiler`` driver for one run.

    Whole-run mode (no window): the harness calls :meth:`start` before the
    training loop and :meth:`close` after.  Window mode: the trainer's
    :meth:`round_start` / :meth:`round_end` hooks open the trace entering
    round A and close it leaving round B-1.  :meth:`step` wraps a round in
    the ``round`` range and steps the profiler; :meth:`phase` names eval
    and checkpoint.  Both return the shared null context while no trace is
    active.  ``device`` is the run's device: on ``cuda`` the trace takes
    the device's activity too, and :meth:`close` raises when that trace
    holds no device kernel.  ``trace_paths`` lists the traces written."""

    def __init__(self, profile_dir: str = "",
                 window: Optional[Tuple[int, int]] = None, device=None) -> None:
        self.profile_dir = profile_dir
        self.window = window
        self.device = device
        self._prof = None
        self._segment = 0
        #: True once any trace was captured (drives the ``profile`` event)
        self.captured = False
        self.trace_paths: List[str] = []
        #: the last closed ``torch.profiler.profile`` (its ``events()``)
        self.last_profile = None

    @property
    def enabled(self) -> bool:
        return bool(self.profile_dir)

    @property
    def _on_card(self) -> bool:
        return self.device is not None and getattr(self.device, "type", self.device) == "cuda"

    # -- trace lifecycle ------------------------------------------------
    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self._on_card:
            activities.append(ProfilerActivity.CUDA)
        try:
            # keep every step's events in events(): a window spans steps
            self._prof = profile(activities=activities, acc_events=True)
        except TypeError:  # a torch without acc_events keeps them anyway
            self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.captured = True

    def _stop_trace(self, drop_empty: bool = False) -> None:
        """Close the trace and write it; on the card a trace with no
        device kernel raises, or with ``drop_empty`` is not written."""
        import torch

        prof, self._prof = self._prof, None
        if self._on_card:
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        if self._on_card and not device_kernels(prof):
            if drop_empty:
                return
            raise RuntimeError(
                "the profiler's trace of a run on the card holds no device kernel "
                "(CUPTI gave no CUDA activity); refusing to write a CPU-only trace"
            )
        name = "trace.json" if self._segment == 0 else f"trace_{self._segment}.json"
        path = os.path.join(self.profile_dir, name)
        prof.export_chrome_trace(path)
        self._segment += 1
        self.trace_paths.append(path)
        self.last_profile = prof

    def start(self) -> None:
        """Whole-run capture: open the trace now (no-op in window mode)."""
        if self.enabled and self.window is None:
            self._start_trace()

    def round_start(self, round_idx: int) -> None:
        """Window mode: open the trace when ``round_idx`` enters [A, B)."""
        if (
            self.enabled
            and self.window is not None
            and self._prof is None
            and self.window[0] <= round_idx < self.window[1]
        ):
            self._start_trace()

    def round_end(self, round_idx: int) -> None:
        """Window mode: close the trace after the last window round."""
        if (
            self._prof is not None
            and self.window is not None
            and round_idx >= self.window[1] - 1
        ):
            self._stop_trace()

    def close(self) -> None:
        """Stop any open trace (a run killed inside the window still
        writes what it captured)."""
        if self._prof is not None:
            self._stop_trace()

    @contextlib.contextmanager
    def suspended(self):
        """No trace inside the body: an open trace is written before it (or
        dropped when it holds no device kernel yet) and a new segment opens
        after it (a CUDA-graph capture runs here)."""
        if self._prof is None:
            yield
            return
        self._stop_trace(drop_empty=True)
        try:
            yield
        finally:
            self._start_trace()

    # -- annotations ----------------------------------------------------
    @contextlib.contextmanager
    def _stepped(self, round_idx: int):
        with span(ROUND_RANGE):
            yield
        if self._prof is not None:
            self._prof.step()

    def step(self, round_idx: int):
        """The ``round`` range around a round, then ``prof.step()``."""
        if self._prof is None:
            return _NULL_CTX
        return self._stepped(round_idx)

    def phase(self, name: str):
        """A named range (``eval`` / ``checkpoint``)."""
        if self._prof is None:
            return _NULL_CTX
        return span(name)


#: the disabled singleton — shared, every method a no-op
NULL_PROFILER = Profiler()


def from_config(cfg, device=None) -> Profiler:
    """The run's Profiler from ``profile_dir`` / ``profile_rounds``
    (:data:`NULL_PROFILER` when profiling is off)."""
    profile_dir = getattr(cfg, "profile_dir", "")
    if not profile_dir:
        return NULL_PROFILER
    spec = getattr(cfg, "profile_rounds", "")
    return Profiler(profile_dir, parse_rounds(spec) if spec else None, device=device)


# -- memory watermarks --------------------------------------------------

def _host_rss() -> Tuple[int, int]:
    """(current, peak) resident-set bytes of this process."""
    page = os.sysconf("SC_PAGE_SIZE")
    try:
        with open("/proc/self/statm") as f:
            current = int(f.read().split()[1]) * page
    except (OSError, ValueError, IndexError):
        current = 0
    try:
        import resource

        # ru_maxrss is KiB on Linux
        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        peak = current
    return current, max(current, peak)


def _cuda_row(dev) -> Dict[str, object]:
    import torch

    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "source": "device:cuda",
    }


def device_memory(device=None) -> Dict[str, object]:
    """Current and peak memory watermarks of the run's ``device``.

    ``{"bytes_in_use", "peak_bytes_in_use", "source"}``: on a CUDA device
    the caching allocator's ``memory_allocated`` / ``max_memory_allocated``
    (``source: "device:cuda"``); on the CPU the process RSS (``source:
    "host_rss"``), which holds the interpreter too and is never judged
    against the memory model.  ``device`` None is the current CUDA device
    where there is one."""
    import torch

    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    if device is not None and torch.device(device).type == "cuda":
        return _cuda_row(torch.device(device))
    current, peak = _host_rss()
    return {"bytes_in_use": current, "peak_bytes_in_use": peak, "source": "host_rss"}


def per_device_memory(devices=None) -> List[Dict[str, object]]:
    """One watermark row per CUDA device (``device``, ``platform``, the
    trio of :func:`device_memory`), every visible one by default; a single
    ``host_rss`` row where there is none."""
    import torch

    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    rows = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda":
            rows.append(dict(device=dev.index, platform="cuda", **_cuda_row(dev)))
    if rows:
        return rows
    current, peak = _host_rss()
    return [{"device": None, "platform": None, "bytes_in_use": current,
             "peak_bytes_in_use": peak, "source": "host_rss"}]
