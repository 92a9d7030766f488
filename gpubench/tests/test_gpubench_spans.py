"""The readers of the port's spans and counters (``replays.py`` and the
metrics that read it) on synthetic stretches and capture layouts."""

from types import SimpleNamespace

import pytest

from gpubench import cells, replays
from gpubench.profiling import Stretch
from gpubench.readings import Readings

MS = 1_000_000


def _layout(**kw):
    spans = {"client_step": [(0, 2), (4, 6)], "channel": [(2, 3), (6, 7)],
             "aggregate": [(3, 4), (7, 8)]}
    return SimpleNamespace(**dict(dict(warmup_seconds=1.5, capture_seconds=2.25, nodes=8,
                                       kinds="kkkkkkkk", spans=spans), **kw))


#: the records of a graphed gm2 solve's loop body: its steps and its test
STEP = "void weiszfeld::step_kernel<float, true, true>(float const*, float*, int, int)"
TEST = "weiszfeld::loop_condition_kernel(int const*, long long const*, long long*, int)"


def _replay(t0, corr, durations, gap=0, names=None):
    """A replay's host ranges, its launch's runtime call and its device
    records: ``durations`` in ms, one record after another, named
    ``names`` (default ``kernel<i>``)."""
    host = [("dispatch", t0, t0 + 100 * MS), ("graph.replay", t0 + MS, t0 + 3 * MS),
            ("cudaGraphLaunch", t0 + 2 * MS, t0 + 3 * MS)]
    names = names or [f"kernel{i}" for i in range(len(durations))]
    device, t = [], t0 + 4 * MS
    for name, d in zip(names, durations):
        device.append((name, t, t + d * MS, corr, True))
        t += d * MS + gap
    return host, [(t0 + 2 * MS, corr)], device


def _with_bodies(t0, corr, after):
    """A replay of the 8 counted nodes (node i lasts i + 1 ms) with loop
    body records after the nodes ``after`` maps to them: ``[(name, ms)]``."""
    names, durations = [], []
    for i in range(8):
        names.append(f"kernel{i}")
        durations.append(i + 1)
        for name, ms in after.get(i, []):
            names.append(name)
            durations.append(ms)
    return _replay(t0, corr, durations, names=names)


def _stretch(*replays_, rounds=1):
    host, runtime, device = [], [], []
    for h, r, d in replays_:
        host += h
        runtime += r
        device += d
    return Stretch(rounds=rounds, start_ns=0, end_ns=10**12, device=device, host=host,
                   runtime=runtime, launches={})


def _readings(stretch, cell="mlp.trimmed_mean-var.k1000.r10"):
    _, config, traffic = cells.cell(cell)
    return Readings(cell=traffic, config=config, device_kind="NVIDIA H100 80GB HBM3",
                    window_s=1.0, rounds=1, host_s=[0.001], stretch=stretch,
                    kernels_whole=True)


def _read(metric, r):
    return cells.module("metrics", metric).read(r)


@pytest.fixture
def layout(monkeypatch):
    lay = _layout()
    monkeypatch.setattr(replays, "capture_layout", lambda: lay)
    return lay


def test_stage_device_ms_an_iteration_over_the_qualifying_replays(layout):
    s = _stretch(_replay(0, 7, [1, 2, 3, 4, 5, 6, 7, 8]),
                 _replay(10**9, 9, [1, 2, 1, 4, 5, 6, 1, 8]))
    r = _readings(s)
    # client_step: nodes 0-1 and 4-5 of each replay, two iterations a replay
    assert _read("client_step.replay_device_ms", r) == pytest.approx((3 + 11 + 3 + 11) / 4)
    assert _read("channel.device_ms", r) == pytest.approx((3 + 7 + 1 + 1) / 4)
    assert replays.stage_ms(s, "weiszfeld_loop") is None  # not captured
    assert _read("graph.capture_s", r) == pytest.approx(3.75)


def test_records_within_the_timers_jitter_still_qualify(layout):
    recs = _replay(0, 7, [1] * 8, gap=-replays.JITTER_NS)
    assert len(replays.replay_records(_stretch(recs), layout)) == 1


def test_a_copy_kernel_counts_as_the_copy_node_it_runs(layout, monkeypatch):
    host, runtime, device = _replay(0, 7, [1] * 8)
    device[7] = ("memcpy32_post",) + device[7][1:]
    device[0] = ("Memset (Device)",) + device[0][1:4] + (False,)
    monkeypatch.setattr(layout, "kinds", "skkkkkkc")
    assert len(replays.replay_records(_stretch((host, runtime, device)), layout)) == 1


@pytest.mark.parametrize("case", ["missing", "overlapping", "extra", "past_the_jitter",
                                  "another_kind"])
def test_a_replay_that_does_not_qualify_is_left_out(layout, case):
    good = _replay(0, 7, [1] * 8)
    durations, gap = {"missing": ([1] * 7, 0), "overlapping": ([1] * 8, -MS // 2),
                      "extra": ([1] * 9, 0), "past_the_jitter": ([1] * 8, -replays.JITTER_NS - 1),
                      "another_kind": ([1] * 8, 0)}[case]
    bad = _replay(10**9, 9, [5] * len(durations), gap=gap)
    if case == "another_kind":
        # a copy where the capture counted a kernel: the records are not its nodes
        host, runtime, device = bad
        device[3] = ("Memcpy DtoD (Device -> Device)",) + device[3][1:4] + (False,)
        bad = host, runtime, device
    assert len(replays.replay_records(_stretch(good, bad), layout)) == 1
    assert replays.stage_ms(_stretch(good, bad), "client_step") == pytest.approx(2.0)
    # with no qualifying replay: nothing to read
    assert replays.stage_ms(_stretch(bad), "client_step") is None
    assert _read("client_step.replay_device_ms", _readings(_stretch(bad))) is None


def test_a_replay_with_loop_bodies_puts_them_down_to_the_node_before(layout):
    """A WHILE node's bodies run among the counted nodes: their records go,
    and their time goes to the counted node before them (the aggregate
    stage's, nodes 3 and 7), so the stages read as if the loop were one
    node of the round."""
    body3 = [(STEP, 0.25), (STEP, 0.25), (TEST, 0.125)]
    body7 = [(STEP, 0.5), (TEST, 0.25)]
    s = _stretch(_with_bodies(0, 7, {3: body3, 7: body7}),
                 _with_bodies(10**9, 9, {3: body3}))
    recs = replays.replay_records(s, layout)
    assert [len(r) for r in recs] == [8, 8]
    assert [r[0] for r in recs[0]] == [f"kernel{i}" for i in range(8)]
    r = _readings(s)
    # client_step: nodes 0-1 and 4-5, two iterations a replay
    assert _read("client_step.replay_device_ms", r) == pytest.approx((3 + 11) / 2)
    # aggregate: nodes 3 and 7 with the bodies after them
    assert replays.stage_ms(s, "aggregate") == pytest.approx(
        ((4 + 0.625 + 8 + 0.75) + (4 + 0.625 + 8)) / 4)
    assert _read("channel.device_ms", r) == pytest.approx((3 + 7) / 2)


def test_an_unrolled_loop_keeps_its_counted_step_records(layout):
    """Where the loop is unrolled its steps are counted nodes of the same
    kernels, and a replay that holds exactly the counted records keeps
    them all (gm's graphed rounds)."""
    s = _stretch(_replay(0, 7, [1] * 8, names=[STEP] * 7 + [TEST]))
    assert [len(r) for r in replays.replay_records(s, layout)] == [8]
    assert replays.stage_ms(s, "aggregate") == pytest.approx(2 / 2)


@pytest.mark.parametrize("case", ["not_a_body", "body_first", "short_after_thinning"])
def test_a_replay_that_does_not_thin_to_its_nodes_is_left_out(layout, case):
    good = _with_bodies(0, 7, {3: [(STEP, 1), (TEST, 1)]})
    if case == "not_a_body":
        bad = _with_bodies(10**9, 9, {3: [("void other_kernel<float>(float*)", 1)]})
    elif case == "body_first":
        host, runtime, device = _with_bodies(10**9, 9, {})
        device = [(STEP, device[0][1] - 2 * MS, device[0][1] - MS, 9, True)] + device
        bad = host, runtime, device
    else:
        host, runtime, device = _with_bodies(10**9, 9, {3: [(STEP, 1), (TEST, 1)]})
        del device[6]  # node 4's record lost: 9 records, 7 once thinned
        bad = host, runtime, device
    assert len(replays.replay_records(_stretch(good, bad), layout)) == 1
    assert replays.replay_records(_stretch(bad), layout) == []


def test_without_a_layout_the_graphed_readers_find_nothing(monkeypatch):
    monkeypatch.setattr(replays, "capture_layout", lambda: None)
    r = _readings(_stretch(_replay(0, 7, [1] * 8)))
    assert _read("client_step.replay_device_ms", r) is None
    assert _read("graph.capture_s", r) is None
    assert _read("channel.device_ms", r) is None  # and no eager channel range
    monkeypatch.setattr(replays, "capture_layout", lambda: _layout(spans=None, nodes=None))
    assert _read("client_step.replay_device_ms", r) is None


def test_eager_channel_ms_from_the_programs_ranges(monkeypatch):
    monkeypatch.setattr(replays, "capture_layout", lambda: None)
    host = [("channel", 0, 5 * MS), ("cudaLaunchKernel", MS, 2 * MS),
            ("channel", 10 * MS, 15 * MS), ("cudaLaunchKernel", 11 * MS, 12 * MS),
            ("client_step", 20 * MS, 30 * MS), ("cudaLaunchKernel", 21 * MS, 22 * MS)]
    runtime = [(MS, 1), (11 * MS, 2), (21 * MS, 3)]
    device = [("draw", 3 * MS, 5 * MS, 1, True), ("draw", 13 * MS, 16 * MS, 2, True),
              ("gemm", 23 * MS, 40 * MS, 3, True)]
    s = Stretch(rounds=1, start_ns=0, end_ns=50 * MS, device=device, host=host,
                runtime=runtime, launches={})
    r = _readings(s, "cnn.median-var.k50.r1")
    assert _read("channel.device_ms", r) == pytest.approx(5 / r.iterations(1))


def test_dispatch_idle_ms_counts_only_the_device_idle_inside_dispatch():
    host = [("dispatch", 0, 10 * MS), ("graph.replay", MS, 2 * MS),
            ("dispatch", 20 * MS, 30 * MS), ("dispatch", 21 * MS, 22 * MS)]
    device = [("a", 2 * MS, 6 * MS, 1, True), ("b", 5 * MS, 8 * MS, 2, True),
              ("c", 12 * MS, 25 * MS, 3, True)]  # busy outside dispatch too
    s = Stretch(rounds=2, start_ns=0, end_ns=40 * MS, device=device, host=host, runtime=[],
                launches={})
    # first dispatch idle 0-1 and 8-10 ms (1-2 inside the replay's launch is
    # left out), the second 25-30 (its nested range once)
    assert _read("dispatch.idle_ms", _readings(s)) == pytest.approx((3 + 5) / 2)
    # a stretch with no device record has nothing to read
    empty = Stretch(rounds=2, start_ns=0, end_ns=40 * MS, device=[], host=host, runtime=[],
                    launches={})
    assert _read("dispatch.idle_ms", _readings(empty)) is None
    no_spans = Stretch(rounds=2, start_ns=0, end_ns=40 * MS, device=device, host=[],
                       runtime=[], launches={})
    assert _read("dispatch.idle_ms", _readings(no_spans)) is None


def test_live_step_pct_reads_the_ports_counters(monkeypatch):
    from byzantine_aircomp_tpu_torch.ops import kernels

    r = _readings(_stretch())
    monkeypatch.setattr(kernels, "LAUNCHES", {"weiszfeld_step": 9000,
                                              "aircomp_weiszfeld_step": 1000})
    monkeypatch.setattr(kernels, "live_steps", lambda: 41)
    assert _read("weiszfeld.live_step_pct", r) == pytest.approx(0.41)
    monkeypatch.setattr(kernels, "LAUNCHES", {"weiszfeld_step": 0})
    assert _read("weiszfeld.live_step_pct", r) is None  # nothing launched
    monkeypatch.delattr(kernels, "live_steps")
    monkeypatch.setattr(kernels, "LAUNCHES", {"weiszfeld_step": 10})
    assert _read("weiszfeld.live_step_pct", r) is None  # a program without the count


def test_the_layout_is_read_from_the_port():
    from byzantine_aircomp_tpu_torch.fed import graphs

    assert replays.capture_layout() is graphs.LAST_CAPTURE
