"""The port's client forensics (``obs/forensics.py``) against the JAX
package's on the CPU: the candidate rows, the top-M (ties included), the
streamed merge, the interval merge, the host records, the ``client_flag``
events and the flight recorder, on numpy inputs from a seed; then the
forensic matrix of chained resident and service iterations of both
trainers from the same params and draws.

Tolerances: ids, flags and the rung exactly; the matrix's floats within
1e-6 on shared inputs (the same f32 expressions); through the trainers,
the distance term's Gram form limits agreement to ~1e-4 relative on real
stacks (``tests/test_torch_defense.py``), so the floats there are held
within 1e-3 relative and the ids and flags exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_service import _service_draws
from test_torch_training_options import jax_carry, jax_iteration_draws

from byzantine_aircomp_tpu.data import datasets as jdata
from byzantine_aircomp_tpu.defense.scores import DetectorParams as JaxDetectorParams
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.fed.train import FedTrainer
from byzantine_aircomp_tpu.obs import events as jevents
from byzantine_aircomp_tpu.obs import forensics as jf
from byzantine_aircomp_tpu_torch.defense.scores import DetectorParams
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.fed.train import Trainer
from byzantine_aircomp_tpu_torch.obs import MemorySink, Observability
from byzantine_aircomp_tpu_torch.obs import forensics as tf


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: many small ops, and the test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, k, ties=False):
    rng = np.random.default_rng(seed)
    score = rng.random(k, dtype=np.float32) * 3
    if ties:
        # runs of equal scores: the top-M must keep the lowest index first
        score = np.round(score).astype(np.float32)
    comps = rng.random((k, 3), dtype=np.float32)
    ema = rng.random(k, dtype=np.float32)
    dev = rng.random(k, dtype=np.float32) * 0.5
    cus = rng.random(k, dtype=np.float32) * 10
    flags = rng.random(k) < 0.3
    ids = rng.permutation(5 * k)[:k].astype(np.int32)
    return ids, score, comps, ema, dev, cus, flags


_P = dict(z_thresh=3.0, cusum_thresh=6.5)


def _both_rows(inp):
    ids, score, comps, ema, dev, cus, flags = inp
    j = jf.candidate_rows(jnp.asarray(ids), jnp.asarray(score), jnp.asarray(comps),
                          jnp.asarray(ema), jnp.asarray(dev), jnp.asarray(cus),
                          jnp.asarray(flags), JaxDetectorParams(**_P))
    t = tf.candidate_rows(_t(ids), _t(score), _t(comps), _t(ema), _t(dev), _t(cus),
                          _t(flags), DetectorParams(**_P))
    return np.asarray(j), t


def _same_matrix(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    for col in ("client", "flagged", "rung"):
        c = tf.COLUMNS.index(col)
        assert np.array_equal(got[:, c], want[:, c]), col
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_columns_are_the_jax_columns():
    assert tf.COLUMNS == jf.COLUMNS and tf.NUM_COLS == jf.NUM_COLS


@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_rows_match_jax(seed):
    want, got = _both_rows(_inputs(seed, 17))
    _same_matrix(got.numpy(), want)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("k,m", [(17, 5), (12, 12), (20, 1)])
def test_top_m_matches_lax_top_k(ties, k, m):
    want, got = _both_rows(_inputs(k, k, ties=ties))
    _same_matrix(tf.top_m(got, m).numpy(), jf.top_m(jnp.asarray(want), m))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_streamed_merge_and_interval_merge_match_jax(ties):
    m, carry_t, carry_j = 6, tf.stream_init(6), jf.stream_init(6)
    assert np.array_equal(carry_t.numpy(), np.asarray(carry_j))
    mats_t, mats_j = [], []
    for c in range(4):
        want, got = _both_rows(_inputs(10 + c, 8, ties=ties))
        carry_t = tf.merge_top_m(carry_t, got, m)
        carry_j = jf.merge_top_m(carry_j, jnp.asarray(want), m)
        _same_matrix(carry_t.numpy(), carry_j)
        mats_t.append(tf.with_rung(carry_t, torch.tensor(c % 3)))
        mats_j.append(jf.with_rung(carry_j, c % 3))
    _same_matrix(tf.merge_interval(torch.stack(mats_t), m).numpy(),
                 jf.merge_interval(jnp.stack(mats_j), m))


class _JaxObs:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append(jevents.make_event(kind, **fields))


def _records_equal(got, want):
    assert [r["client"] for r in got] == [r["client"] for r in want]
    for a, b in zip(got, want):
        assert a["flagged"] == b["flagged"] and a["rung"] == b["rung"]
        for key in tf.COLUMNS:
            assert a[key] == pytest.approx(b[key], abs=1e-6), key


@pytest.mark.parametrize("mode", ["top", "full"])
def test_records_and_client_flags_match_jax(mode):
    # a matrix with a repeated client (two iterations) and one sentinel row
    want, got = _both_rows(_inputs(3, 10, ties=True))
    mat = np.concatenate([want[:6], want[2:4], jf.stream_init(2)])
    mat_t = torch.from_numpy(mat)
    _records_equal(tf.rows_to_records(mat_t), jf.rows_to_records(mat))
    jobs, sink = _JaxObs(), MemorySink()
    n_t = tf.emit_round_flags(Observability(sink), 5, mat_t, mode=mode)
    n_j = jf.emit_round_flags(jobs, 5, mat, mode=mode)
    assert n_t == n_j == len(sink.events)
    strip = lambda e: {k: v for k, v in e.items() if k not in ("ts", "seq")}  # noqa: E731
    _records_equal([strip(e) for e in sink.events], [strip(e) for e in jobs.events])
    for e in sink.events:
        jevents.validate_event(e)


def test_flight_recorder_writes_what_the_jax_one_writes(tmp_path):
    out = {}
    for name, mod, conv in (("jax", jf, np.asarray), ("port", tf, _t)):
        rec = mod.FlightRecorder(2, str(tmp_path / name))
        for r in range(3):
            want, _ = _both_rows(_inputs(r, 6))
            det = (conv(np.int32(r + 1)), conv(np.arange(6, dtype=np.float32) + r),
                   conv(np.ones(6, np.float32)), conv(np.full(6, 0.5, np.float32)))
            pol = tuple(conv(np.asarray(v, np.int32)) for v in (r, 0, 1))
            rec.record(r, detector_state=det, policy_state=pol,
                       defense_metrics=conv(np.arange(6, dtype=np.float32)),
                       forensic_rows=conv(want[:3]), summary={"val_loss": 0.5 * r})
        sink = _JaxObs() if name == "jax" else MemorySink()
        obs = sink if name == "jax" else Observability(sink)
        path = rec.dump(2, "run_end", obs=obs)
        assert path.endswith("flight_run_end.json")
        assert rec.dump(1, "loss_spike").endswith("flight_1.json")
        with open(path) as f:
            out[name] = json.load(f)
        assert len(sink.events) == 1 and sink.events[0]["kind"] == "forensic_dump"
    assert out["port"] == out["jax"]
    assert [r["round"] for r in out["port"]["rounds"]] == [1, 2]


@pytest.fixture(scope="module")
def mnist():
    return jdata.load("mnist", synthetic_train=600, synthetic_val=100)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(service="on", population=20, straggler_prob=0.1, rollback="off"),
], ids=["resident", "service"])
def test_trainer_forensic_matrices_match_jax(mnist, kw):
    """Four chained iterations of gm2 under signflip, monitor defense with
    the detector armed after one, forensics top with M=4: each iteration's
    matrix (ids and flags exactly, the floats within 1e-3 relative)."""
    cfg = dict(honest_size=8, byz_size=2, attack="signflip", agg="gm2", batch_size=8,
               defense="monitor", defense_warmup=1, forensics="top", forensics_top=4,
               seed=5, agg_maxiter=30, **kw)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **cfg), dataset=mnist)
    tt = Trainer(FedConfig(**cfg), dataset=mnist, device="cpu", params=_t(jt.flat_params))
    carry, flat = jax_carry(jt), tt.flat_params
    for i in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(3), i)
        draws = (_service_draws(jt, key, tt.cfg, np.asarray(carry[6][0]), tt.dim) if kw
                 else jax_iteration_draws(tt.cfg, key, tt.dim))
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, False)
        flat, _ = tt.iteration(flat, draws=draws)
        want, got = np.asarray(outs[-1], np.float64), tt.iteration_forensic.numpy()
        for col in ("client", "flagged", "rung"):
            c = tf.COLUMNS.index(col)
            assert np.array_equal(got[:, c], want[:, c]), (i, col)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(service="on", population=48, straggler_prob=0.2),
], ids=["streamed", "streamed_service"])
def test_streamed_forensic_matrices_match_jax(mnist, kw):
    """Three chained cohort-streamed iterations (gm2, signflip, cohort 4,
    K=16, monitor defense armed after one, forensics top M=5): the running
    top-M merged chunk by chunk, ids and flags exactly, the floats within
    1e-3 relative.  The runs start from zero params: the distance term's
    Gram form loses ~sqrt(d) eps |w|^2 to cancellation, which from the
    seeded params (|w|^2 = 37) is ~1e-2 of a 4-client chunk's distances,
    and from zero is of their own order."""
    cfg = dict(honest_size=12, byz_size=4, attack="signflip", agg="gm2", batch_size=16,
               cohort_size=4, defense="monitor", defense_warmup=1, forensics="top",
               forensics_top=5, agg_maxiter=100, seed=7, **kw)
    jt = FedTrainer(JaxFedConfig(agg_impl="xla", **cfg), dataset=mnist)
    jt.flat_params = jnp.zeros_like(jt.flat_params)
    tt = Trainer(FedConfig(**cfg), dataset=mnist, device="cpu", params=_t(jt.flat_params))
    carry, flat = jax_carry(jt), tt.flat_params
    for i in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(4), i)
        if kw:
            draws = _service_draws(jt, key, tt.cfg, np.asarray(carry[6][0]), tt.dim)
        else:
            k_batch = jax.random.split(key, 4)[0]
            draws = {"u": _t(jax.random.uniform(k_batch, (16, 16)))}
        carry, outs = jt._iteration(carry, key, jt.x_train, jt.y_train, False)
        flat, _ = tt.iteration(flat, draws=draws)
        want, got = np.asarray(outs[-1], np.float64), tt.iteration_forensic.numpy()
        for col in ("client", "flagged", "rung"):
            c = tf.COLUMNS.index(col)
            assert np.array_equal(got[:, c], want[:, c]), (i, col)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
