"""One round of the trainer as a CUDA graph, replayed once per round of a
multi-round dispatch.

The counterpart of the JAX package's single device program for R rounds
(``_build_multi_round_fn``, ``fed/train.py:1801``, a ``lax.scan`` over
``_round_core``): here the round is captured once per trainer and a dispatch
of R rounds is R replays with no host read between them.

* **Static buffers.**  The trainer's carried state (params, server
  optimizer, client momentum, fault, defense, onset counter and service
  state: ``Trainer._state()``) lives in buffers that the graph reads; the
  captured round ends by copying its new state into them.  A state that was
  replaced between dispatches (a resume, a rollback, a hook) is copied in
  before the next replay.
* **Random streams.**  ``run_round`` draws from one generator per
  (iteration slot, stream); each is registered with the graph, and before
  every replay each is seeded for the round it replays, so a replay draws
  what the eager round draws (``Trainer.reseed_slot_generators``).
* **Capture.**  After one eager warm-up round (from a copy of the state,
  thrown away), which loads the kernels, finds their launch plans, allocates
  the Weiszfeld workspaces and creates the generators, the round is
  captured on the warm-up's stream under
  ``torch.cuda.set_sync_debug_mode("error")``: a host read in the round
  raises, and so does any other failure of the capture.  Inside the capture
  a Weiszfeld loop reads nothing on the host
  (``ops.aggregators.weiszfeld_solve``): gm2's runs as a conditional WHILE
  node over chunks of fused steps (:func:`conditional_body`), which the
  device stops at convergence; gm's draws at every step, so it is unrolled
  to ``agg_maxiter`` steps.
* **Outputs.**  Each replay's per-round outputs (the variance, the fault,
  defense and service rows, and the forensic top-M, computed inside the
  graph into a static buffer) are copied into the dispatch's stacked
  buffers on the device.
* **Launch counts.**  The kernel wrappers count at capture, where nothing
  is launched: those counts are taken back out, and every replay adds them
  (``ops.kernels.add_launches``).  A conditional body's launches are left
  out of them: the body counts its runs on the device.
* **Spans.**  A replay opens no profiler range inside the graph, so the
  capture notes where each span of the round (``obs/span.py``) begins and
  ends in the graph: the count of its nodes that the profiler records as
  device work (kernels, copies and sets), at each span's entry and exit,
  read through libcuda's graph calls and adding no node.  :data:`LAST_CAPTURE`
  keeps the last capture's layout.  A replay's device records share the
  correlation id of its ``cudaGraphLaunch``, the runtime call inside its
  ``graph.replay`` span, and the round is one chain of nodes, so sorted by
  start the k-th record is the k-th counted node; a conditional node is not
  counted, and its body's records (as many as its runs) lie among them.

:func:`dispatch_graph` says which configurations are captured, and why not.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..obs.span import Span, capture_marks, span
from ..ops import kernels

#: the graph node types that the profiler records as device work
#: (``CUgraphNodeType``), by the letter :attr:`CaptureLayout.kinds` gives
COUNTED_NODES = {0: "k", 1: "c", 2: "s"}  # kernel, memcpy, memset


@dataclass
class CaptureLayout:
    """Where the spans of a captured round lie in its graph.  ``nodes``
    counts the graph's counted nodes (:data:`COUNTED_NODES`) and ``kinds``
    gives each one's letter, in the graph's order; ``spans`` maps each span
    opened inside the capture to its ``[first, end)`` ranges of counted
    node indices, one per entry in the order entered (a stage's, one per
    iteration).  ``nodes``, ``kinds`` and ``spans`` are None where the
    libcuda did not answer.  ``warmup_seconds`` and ``capture_seconds`` are
    the durations of the ``graph.warmup`` and ``graph.capture`` spans."""

    warmup_seconds: float
    capture_seconds: float
    nodes: Optional[int]
    kinds: Optional[str]
    spans: Optional[Dict[str, List[Tuple[int, int]]]]


#: the layout of this process's last capture (None before any)
LAST_CAPTURE: Optional[CaptureLayout] = None

_LIBCUDA: Optional[ctypes.CDLL] = None


def _libcuda():
    """libcuda with the three calls the node marks make, or None where
    there is none."""
    global _LIBCUDA
    if _LIBCUDA is None:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            calls = (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes,
                     lib.cuGraphNodeGetType)
        except (OSError, AttributeError):
            return None
        p, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        calls[0].argtypes = [p, i32, p, ctypes.POINTER(p), p, p]
        calls[1].argtypes = [p, ctypes.POINTER(p), ctypes.POINTER(ctypes.c_size_t)]
        calls[2].argtypes = [p, i32]
        for fn in calls:
            fn.restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


class _NodeMarks:
    """The marker of one capture (:func:`..obs.span.capture_marks`): at
    each span's entry and exit the number of counted nodes the graph that
    ``stream`` captures into holds.  libcuda lists a graph's nodes in
    the order they were added; a node seen once keeps its place, which
    each look checks.  Any failed call stops the marks, never the
    capture."""

    def __init__(self, stream: int):
        self.stream = stream
        self.lib = _libcuda()
        self.failed = self.lib is None
        self.seen = 0  # the graph's nodes looked at so far
        self.last: Optional[int] = None  # the last of them
        self.kinds: List[str] = []
        self.spans: Dict[str, List[Tuple[int, int]]] = {}
        self._open: Dict[str, List[int]] = {}

    def count(self, graph: Optional[int] = None) -> Optional[int]:
        """The counted nodes of ``graph`` (default: the one being captured
        into), or None once a call failed."""
        lib = self.lib
        if self.failed:
            return None
        if graph is None:
            handle = ctypes.c_void_p()
            status = ctypes.c_int()
            if lib.cuStreamGetCaptureInfo_v2(self.stream, ctypes.byref(status), None,
                                             ctypes.byref(handle), None, None) != 0:
                self.failed = True
                return None
            graph = handle.value
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
            self.failed = True
            return None
        if n.value > self.seen:
            nodes = (ctypes.c_void_p * n.value)()
            kind = ctypes.c_int()
            if (lib.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0
                    or (self.seen and nodes[self.seen - 1] != self.last)):
                self.failed = True
                return None
            for node in nodes[self.seen:n.value]:
                if lib.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
                    self.failed = True
                    return None
                if kind.value in COUNTED_NODES:
                    self.kinds.append(COUNTED_NODES[kind.value])
            self.seen, self.last = n.value, nodes[n.value - 1]
        return len(self.kinds)

    def __call__(self, name: str, entering: bool) -> None:
        at = self.count()
        if at is None:
            return
        if entering:
            self._open.setdefault(name, []).append(at)
        else:
            self.spans.setdefault(name, []).append((self._open[name].pop(), at))


# libcuda's constants of a conditional node (cuda.h, CUDA 12.3 on)
_NODE_TYPE_CONDITIONAL = 13  # CU_GRAPH_NODE_TYPE_CONDITIONAL
_COND_IF, _COND_WHILE = 0, 1  # CUgraphConditionalNodeType
_COND_ASSIGN_DEFAULT = 1  # CU_GRAPH_COND_ASSIGN_DEFAULT
_SET_CAPTURE_DEPENDENCIES = 1  # CU_STREAM_SET_CAPTURE_DEPENDENCIES
_CAPTURE_THREAD_LOCAL = 1  # CU_STREAM_CAPTURE_MODE_THREAD_LOCAL
_STREAM_NON_BLOCKING = 1  # CU_STREAM_NON_BLOCKING


class _ConditionalNodeParams(ctypes.Structure):
    """``CUgraphNodeParams`` with its union's ``conditional`` member
    (``CUDA_CONDITIONAL_NODE_PARAMS``): 256 bytes."""

    _fields_ = [
        ("type", ctypes.c_int), ("reserved0", ctypes.c_int * 3),
        ("handle", ctypes.c_ulonglong), ("cond_type", ctypes.c_int), ("size", ctypes.c_uint),
        ("graph_out", ctypes.POINTER(ctypes.c_void_p)), ("ctx", ctypes.c_void_p),
        ("reserved1", ctypes.c_longlong * 25), ("reserved2", ctypes.c_longlong),
    ]


_VOID_P, _SIZE = ctypes.c_void_p, ctypes.c_size_t
_OUT = ctypes.POINTER(ctypes.c_void_p)
# the libcuda calls of a conditional node, with their argument types
_CU_CALLS = {
    "cuStreamGetCaptureInfo_v3": [_VOID_P, ctypes.POINTER(ctypes.c_int), _VOID_P, _OUT, _OUT,
                                  _OUT, ctypes.POINTER(_SIZE)],
    "cuCtxGetCurrent": [_OUT],
    "cuGraphConditionalHandleCreate": [ctypes.POINTER(ctypes.c_ulonglong), _VOID_P, _VOID_P,
                                       ctypes.c_uint, ctypes.c_uint],
    "cuGraphAddNode_v2": [_OUT, _VOID_P, _VOID_P, _VOID_P, _SIZE,
                          ctypes.POINTER(_ConditionalNodeParams)],
    "cuStreamUpdateCaptureDependencies": [_VOID_P, _OUT, _SIZE, ctypes.c_uint],
    "cuStreamCreate": [_OUT, ctypes.c_uint],
    "cuStreamBeginCaptureToGraph": [_VOID_P, _VOID_P, _VOID_P, _VOID_P, _SIZE, ctypes.c_int],
    "cuStreamEndCapture": [_VOID_P, _OUT],
    "cuMemcpyDtoDAsync_v2": [ctypes.c_uint64, ctypes.c_uint64, _SIZE, _VOID_P],
}


def _cu(name: str, *args, check: bool = True) -> int:
    """Call libcuda's ``name`` (one of :data:`_CU_CALLS`) with ``args``;
    raises on an error where ``check``, else returns it."""
    lib = _libcuda()
    if lib is None:
        raise RuntimeError("a conditional graph node needs libcuda.so.1, which did not load")
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = _CU_CALLS[name], ctypes.c_int
    err = fn(*args)
    if check and err != 0:
        raise RuntimeError(f"{name} failed: libcuda error {err}")
    return err


def _capture_graph(stream: int):
    """``(graph, dependencies, edge data, their count)`` of the capture
    running on ``stream``."""
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    deps, edges, n = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    _cu("cuStreamGetCaptureInfo_v3", stream, ctypes.byref(status), None,
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(edges), ctypes.byref(n))
    if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("a conditional node is added only inside a CUDA-graph capture")
    return graph, deps, edges, n


# a stream per device on which conditional bodies are captured
_BODY_STREAMS: Dict[int, torch.cuda.ExternalStream] = {}


def _body_stream(device: torch.device) -> torch.cuda.ExternalStream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _BODY_STREAMS.get(index)
    if stream is None:
        handle = ctypes.c_void_p()
        with torch.cuda.device(index):
            _cu("cuStreamCreate", ctypes.byref(handle), _STREAM_NON_BLOCKING)
        stream = _BODY_STREAMS[index] = torch.cuda.ExternalStream(handle.value,
                                                                  device=f"cuda:{index}")
    return stream


def conditional_handle(default: int) -> int:
    """A condition (``CUgraphConditionalHandle``) of the graph that the
    current stream captures, set to ``default`` at each launch of the
    graph; a kernel sets it on the device (``cudaGraphSetConditional``)."""
    graph = _capture_graph(torch.cuda.current_stream().cuda_stream)[0]
    ctx, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
    _cu("cuCtxGetCurrent", ctypes.byref(ctx))
    _cu("cuGraphConditionalHandleCreate", ctypes.byref(handle), graph, ctx, default,
            _COND_ASSIGN_DEFAULT)
    return handle.value


@contextlib.contextmanager
def conditional_body(handle: int, loop: bool):
    """Add a conditional node on ``handle`` (a WHILE node where ``loop``,
    else an IF node) after the work the current stream has captured, and
    capture the block's launches into its body: on a stream of its own,
    torch's current stream inside the block.  The body may hold only what
    a conditional body can (kernels, copies, sets) and no torch op, whose
    memory the caching allocator would take from outside the graph's
    pool.  The current stream's capture goes on after the node, which the
    node marks (:class:`_NodeMarks`) do not count."""
    parent = torch.cuda.current_stream()
    graph, deps, edges, n = _capture_graph(parent.cuda_stream)
    ctx = ctypes.c_void_p()
    _cu("cuCtxGetCurrent", ctypes.byref(ctx))
    params = _ConditionalNodeParams(type=_NODE_TYPE_CONDITIONAL, handle=handle,
                                    cond_type=_COND_WHILE if loop else _COND_IF, size=1,
                                    ctx=ctx.value)
    node = ctypes.c_void_p()
    _cu("cuGraphAddNode_v2", ctypes.byref(node), graph, deps, edges, n,
            ctypes.byref(params))
    _cu("cuStreamUpdateCaptureDependencies", parent.cuda_stream, ctypes.byref(node), 1,
            _SET_CAPTURE_DEPENDENCIES)
    body = _body_stream(parent.device)
    _cu("cuStreamBeginCaptureToGraph", body.cuda_stream, params.graph_out[0], None, None, 0,
            _CAPTURE_THREAD_LOCAL)
    end = (body.cuda_stream, ctypes.byref(ctypes.c_void_p()))
    try:
        with torch.cuda.stream(body):
            yield
    except BaseException:
        _cu("cuStreamEndCapture", *end, check=False)  # leaves the stream usable
        raise
    _cu("cuStreamEndCapture", *end)


def copy_async(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` (same bytes, both on the card) on the
    current stream through libcuda, with no torch op: a conditional
    body may hold it."""
    _cu("cuMemcpyDtoDAsync_v2", dst.data_ptr(), src.data_ptr(),
            src.numel() * src.element_size(), torch.cuda.current_stream(src.device).cuda_stream)


def dispatch_graph(cfg, device) -> Tuple[bool, str]:
    """Whether a dispatch of ``cfg`` on ``device`` replays a CUDA graph of
    the round, and why (or why not), for the run's banner.  A rule or a
    model is captured where its registration says ``graphable=True`` (an
    alias shares its entry's metadata): each such one is held bitwise
    against its eager round on the card."""
    from .. import models  # noqa: F401  (registers the models)
    from ..ops import aggregators  # noqa: F401  (registers the rules)
    from ..ops import attacks as attack_lib
    from ..registry import AGGREGATORS, MODELS

    device = torch.device(device)
    if cfg.rounds_per_dispatch == 1:
        return False, "one round per dispatch: the per-round loop"
    if device.type != "cuda":
        return False, "CUDA graphs need the card: each round runs eagerly"
    if cfg.agg_impl == "xla":
        return False, ("--agg-impl xla runs the plain torch versions, the referee the "
                       "kernels are held against: its rounds run eagerly (a graph of them "
                       "is not held bitwise against its eager round on the card)")
    # the configurations with a host read inside their round
    if cfg.service == "on":
        return False, ("service rounds key the per-id link with a host int drawn every "
                       "iteration (link_key), which a capture would freeze")
    if cfg.cohort_size > 0:
        return False, ("a cohort-streamed round reads its rule's stopping test on the host "
                       "every pass")
    if cfg.defense == "adaptive":
        return False, "the adaptive defense reads its rung on the host every iteration"
    # the configurations not held against their eager round on the card
    if cfg.fault is not None:
        return False, ("fault rounds are not captured (the fault channel copies its "
                       "constants to the card, and the degraded rules are not held bitwise)")
    if cfg.participation < 1.0 or cfg.bucket_size > 1:
        return False, ("the participants' and the buckets' permutations (torch.randperm) "
                       "are not captured")
    rule = AGGREGATORS.meta(cfg.agg)
    if not rule.get("graphable", False):
        return False, (f"the rule {cfg.agg} is not captured: its round is not held bitwise "
                       "against its eager round")
    if not MODELS.meta(cfg.model).get("graphable", False):
        return False, (f"the model {cfg.model} is not captured: its round is not held "
                       "bitwise against its eager round")
    attack = attack_lib.resolve(cfg.attack)
    if attack is not None and attack.defense_aware:
        return False, "the defense-aware attacks are not captured"
    if rule.get("unrolled_solve", False):
        return True, (f"one CUDA graph of the round, replayed once per round; the graph "
                      f"runs all {cfg.agg_maxiter} Weiszfeld steps of every solve (a step "
                      "draws, so the device cannot loop over steps; a step after "
                      "convergence only copies the guess), so a solve that converges "
                      "early can run slower than eagerly")
    return True, "one CUDA graph of the round, replayed once per round"


def _copy_into(dst, src):
    """Copy the tensors of the state tree ``src`` into ``dst``'s, leaf for
    leaf (a leaf that already is its buffer is left alone)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class RoundGraph:
    """The CUDA graph of one round of ``trainer``: captured at the first
    :meth:`run`, replayed once per round after.  ``captures`` counts the
    captures (one per trainer), ``warmup_seconds`` and ``capture_seconds``
    time the warm-up round and the capture with its instantiation (the
    spans ``graph.warmup`` and ``graph.capture``; the capture's
    :class:`CaptureLayout` becomes :data:`LAST_CAPTURE`),
    ``replay_launches`` holds the kernel launches of one replay and
    ``replays`` counts them.  The graph is kept after instantiation
    (``keep_graph=True``), so that a measurement can count its nodes
    (``graph.raw_cuda_graph()``)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static = None
        self.outputs = None
        self.replay_launches: Dict[str, int] = {}
        self.captures = 0
        self.replays = 0
        self.warmup_seconds: Optional[float] = None
        self.capture_seconds: Optional[float] = None

    def capture(self, round_idx: int):
        """Warm up and capture the round (for the generators of round
        ``round_idx``); :meth:`run` calls it at its first dispatch."""
        from .train import _clone_state as _clone

        global LAST_CAPTURE
        t = self.trainer
        dev = t.device
        self.static = _clone(t._state())
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with Span("graph.warmup") as warmup:
            with torch.cuda.stream(side):
                t._set_state(_clone(self.static))
                t.run_round(round_idx)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)

        with Span("graph.capture") as capture:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            for g in t._slot_generators.values():
                graph.register_generator_state(g)
            t._set_state(self.static)
            before = dict(kernels.LAUNCHES)
            mode = torch.cuda.get_sync_debug_mode()
            marks = _NodeMarks(side.cuda_stream)
            # a trainer and its RoundGraph form a reference cycle, so an
            # earlier trainer's graph and pinned buffers are freed by the
            # cyclic collector, and a free that lands inside this capture
            # invalidates it: collect first, and keep the collector off
            # until the capture ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, stream=side):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        with capture_marks(marks):
                            variance = t.run_round(round_idx)
                        self.outputs = (variance, t.last_fault_metrics,
                                        t.last_defense_metrics, t.last_service_metrics,
                                        t.last_forensic_metrics)
                        _copy_into(self.static, t._state())
                    finally:
                        torch.cuda.set_sync_debug_mode(mode)
            finally:
                if collecting:
                    gc.enable()
            nodes = marks.count(graph.raw_cuda_graph())
            graph.instantiate()
            torch.cuda.synchronize(dev)
        self.replay_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        kernels.LAUNCHES.update(before)
        t._set_state(self.static)
        self.graph = graph
        self.captures += 1
        self.warmup_seconds = warmup.seconds
        self.capture_seconds = capture.seconds
        whole = nodes is not None
        LAST_CAPTURE = CaptureLayout(
            self.warmup_seconds, self.capture_seconds, nodes,
            "".join(marks.kinds) if whole else None, marks.spans if whole else None)

    def run(self, start_round: int, num_rounds: int):
        """Replay rounds ``start_round ..`` ``num_rounds`` times (capturing
        first if need be); returns the stacked per-round outputs as
        ``Trainer.run_rounds_stacked`` does, with no host read."""
        from .train import DispatchOutputs

        t = self.trainer
        if self.graph is None:
            self.capture(start_round)
        with span("graph.prepare"):
            _copy_into(self.static, t._state())
            t._set_state(self.static)
            stacked = [None if o is None else
                       torch.empty((num_rounds,) + tuple(o.shape), dtype=o.dtype,
                                   device=o.device)
                       for o in self.outputs]
        for i in range(num_rounds):
            with span("graph.replay"):
                t.reseed_slot_generators(start_round + i)
                self.graph.replay()
            kernels.add_launches(self.replay_launches)
            with span("graph.outputs"):
                for buf, out in zip(stacked, self.outputs):
                    if buf is not None:
                        buf[i].copy_(out)
        self.replays += num_rounds
        return DispatchOutputs(*stacked)
