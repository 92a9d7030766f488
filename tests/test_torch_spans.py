"""The port's spans (``obs/span.py``) at the training path's layer
boundaries, the capture's node marks (``fed/graphs.py``) and the live
Weiszfeld-step count (``ops/kernels.py``), on the CPU.  This file imports
no JAX."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from byzantine_aircomp_tpu_torch import obs as tobs
from byzantine_aircomp_tpu_torch.data import datasets
from byzantine_aircomp_tpu_torch.fed import graphs
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.obs import sinks
from byzantine_aircomp_tpu_torch.obs import span as span_lib
from byzantine_aircomp_tpu_torch.ops import aggregators, kernels

#: the stages of an iteration of the trainer below, in order (the last
#: iteration adds the variance)
STAGES = span_lib.STAGES[:-1]


@pytest.fixture(scope="module")
def trainer():
    ds = datasets.load("mnist", synthetic_train=600, synthetic_val=100)
    cfg = FedConfig(agg="trimmed_mean", noise_var=1e-2, attack="classflip", honest_size=8,
                    byz_size=2, rounds=4, display_interval=2, eval_train=False)
    t = Trainer(cfg, dataset=ds, device="cpu")
    t.run_round(0)
    return t


def _ranges(prof, names):
    """``(name, start_ns, end_ns)`` of the profile's host events named in
    ``names``, by start."""
    evs = prof.profiler.kineto_results.events()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
                   if e.name() in names), key=lambda x: x[1])


def test_spans_are_named_once_each():
    assert len(set(span_lib.SPANS)) == len(span_lib.SPANS)
    assert set(span_lib.STAGES) | {"dispatch", "graph.replay"} <= set(span_lib.SPANS)


def test_without_a_profiler_a_round_enters_no_range(trainer, monkeypatch):
    """The off path: no profiler range is made, and every span is one
    shared no-op."""
    made = []

    class Counted(torch.profiler.record_function):
        def __init__(self, *a, **kw):
            made.append(a)
            super().__init__(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counted)
    trainer.run_round(1)
    trainer.run_rounds_stacked(2, 2)
    assert made == []
    assert span_lib.span("batch") is span_lib.span("dispatch")


def test_under_the_profiler_the_stages_nest_in_order_under_dispatch(trainer):
    names = set(span_lib.SPANS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_round(1)
    got = _ranges(prof, names)
    (dispatch,) = [g for g in got if g[0] == "dispatch"]
    stages = [g for g in got if g[0] != "dispatch"]
    interval = trainer.cfg.display_interval
    assert [g[0] for g in stages] == list(STAGES) * interval + ["variance"]
    assert all(dispatch[1] <= s <= e <= dispatch[2] for _, s, e in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))  # one after another


def test_a_stacked_dispatch_is_one_range_and_the_loop_span_opens_none(trainer):
    """``dispatch`` ranges the eager stacked rounds once (not once more a
    round), and the training loop's own ``dispatch`` event opens no range
    around it."""
    obs = tobs.Observability(sinks.MemorySink())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("dispatch", ranged=False, round=1, rounds=2):
            trainer.run_rounds_stacked(1, 2)
    got = _ranges(prof, {"dispatch", "batch"})
    assert [g[0] for g in got].count("dispatch") == 1
    assert [g[0] for g in got].count("batch") == 2 * trainer.cfg.display_interval
    (event,) = obs.sink.events
    assert event["name"] == "dispatch" and event["start_ns"] <= got[0][1] <= event["end_ns"]


def test_span_events_lie_on_the_profilers_clock(trainer):
    """A span event's ``start_ns`` / ``end_ns`` fall within 1 ms of its
    profiler range's bounds."""
    obs = tobs.Observability(sinks.MemorySink())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm"):  # the first range's set-up
            pass
        with obs.span("eval", round=1):
            trainer.evaluate("val")
        with obs.span("checkpoint", round=1):
            torch.ones(3).sum()
    ranges = {name: (s, e) for name, s, e in _ranges(prof, {"eval", "checkpoint"})}
    assert set(ranges) == {"eval", "checkpoint"}
    for event in obs.sink.events:
        tobs.validate_event(event)
        s, e = ranges[event["name"]]
        assert abs(event["start_ns"] - s) < 1e6 and abs(event["end_ns"] - e) < 1e6
        assert event["ms"] == round((event["end_ns"] - event["start_ns"]) / 1e6, 3)


def test_the_live_step_count_sums_the_solves_steps():
    rng = np.random.default_rng(5)
    w = torch.from_numpy((0.01 + 1e-3 * rng.standard_normal((12, 300))).astype(np.float32))
    kernels.reset_launches()
    steps = []
    for tol in (1e-7, 1e-5):
        steps.append(aggregators.gm2_solve(w, maxiter=60, tol=tol)[1])
        for unrolled in (False, True):
            steps.append(aggregators.gm_solve(
                w, noise_var=1e-2, maxiter=40, tol=tol, unrolled=unrolled,
                generator=torch.Generator().manual_seed(3))[1])
    ran = [int(n) for n in steps]
    assert all(0 < n for n in ran) and any(n < 60 for n in ran)
    assert kernels.live_steps() == sum(ran)
    kernels.reset_launches()
    assert kernels.live_steps() == 0


class _FakeLibcuda:
    """The three libcuda calls of the node marks over a list of
    ``(handle, CUgraphNodeType)`` that a test grows as a capture would."""

    def __init__(self):
        self.nodes = []
        self.cuStreamGetCaptureInfo_v2 = self.capture_info
        self.cuGraphGetNodes = self.get_nodes
        self.cuGraphNodeGetType = self.node_type

    def capture_info(self, stream, status, _id, graph, _deps, _n):
        graph._obj.value = 77
        return 0

    def get_nodes(self, graph, nodes, n):
        if nodes is not None:
            for i, (handle, _) in enumerate(self.nodes[:n._obj.value]):
                nodes[i] = handle
        n._obj.value = len(self.nodes)
        return 0

    def node_type(self, node, kind):
        kind._obj.value = dict(self.nodes)[node]
        return 0


def test_node_marks_give_each_spans_counted_node_ranges():
    """Kernels, copies and sets count; empty and event nodes do not; a
    span's range is ``[count at entry, count at exit)``."""
    fake = _FakeLibcuda()
    marks = graphs._NodeMarks(stream=1)
    marks.lib, marks.failed = fake, False

    def add(*types):
        fake.nodes += [(len(fake.nodes) + i + 100, t) for i, t in enumerate(types)]

    with span_lib.capture_marks(marks):
        with span_lib.span("dispatch"):
            for _ in range(2):
                add(5)  # an empty node: not device work
                with span_lib.span("client_step"):
                    add(0, 0, 1)
                with span_lib.span("aggregate"):
                    add(2, 7, 0)  # a memset, an event record, a kernel
            add(1)
    assert span_lib.span("x") is span_lib.span("y")  # the marks are off again
    assert marks.count() == 11 and "".join(marks.kinds) == "kkcskkkcskc"
    assert marks.spans == {"client_step": [(0, 3), (5, 8)], "aggregate": [(3, 5), (8, 10)],
                           "dispatch": [(0, 11)]}


def test_node_marks_stop_when_the_graph_reorders_or_a_call_fails():
    fake = _FakeLibcuda()
    marks = graphs._NodeMarks(stream=1)
    marks.lib, marks.failed = fake, False
    fake.nodes = [(1, 0), (2, 0)]
    assert marks.count() == 2
    fake.nodes = [(2, 0), (1, 0), (3, 0)]
    assert marks.count() is None and marks.failed
    marks = graphs._NodeMarks(stream=1)
    marks.lib, marks.failed = fake, False
    fake.cuGraphGetNodes = lambda *a: 1
    marks("client_step", True)
    marks("client_step", False)
    assert marks.failed and marks.spans == {}

