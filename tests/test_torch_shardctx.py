"""Population shards of the port (``ops/shardctx.py``, ``--pop-shards``) on
the CPU, against the JAX package's ``ops/shardctx.py`` and streamed rules.

Tolerances: integer leaves, keys and counts bitwise; the folds of float
leaves within 1e-6 (JAX's XLA may contract or reorder an add; the fold's
order is the same); the streamed rules with ``SeqShardCtx(2)`` and ``(4)``
against JAX's with its ``SeqShardCtx`` on the same numpy chunks: the
medians bitwise, the trimmed mean 1e-6, the mean 1e-6, gm2 1e-5 (its
Weiszfeld sums add in another order).  ``pop_shards`` 1 is bitwise the
streamed round that predates population shards: on one thread it
reproduces the params, variance and detector of a run pinned on the tree
before them.  The config's checks, the title and the hash follow JAX's.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.fed import harness as jharness
from byzantine_aircomp_tpu.fed.config import FedConfig as JaxFedConfig
from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import shardctx as jctx
from byzantine_aircomp_tpu_torch.fed import harness as tharness
from byzantine_aircomp_tpu_torch.fed.config import FedConfig
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
from byzantine_aircomp_tpu_torch.ops import shardctx as tctx


def _chunks(seed, n_chunks=8, cohort=2, d=300, nan_rows=(2, 9)):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_chunks * cohort, d)).astype(np.float32)
    w[3] = w[5]
    w[:, :10] = np.round(w[:, :10])  # ties, and -0.0 beside +0.0
    w[list(nan_rows)] = np.nan
    jw = jnp.asarray(w).reshape(n_chunks, cohort, d)
    tw = torch.from_numpy(w).reshape(n_chunks, cohort, d)
    return (lambda c: jw[c]), (lambda c: tw[c]), w


# ---------------------------------------------------------------------------
# the algebra and the wire


@pytest.mark.parametrize("tag", ["sum", "min", "max", "stack"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_fold_leaves_is_jax_s(tag, dtype):
    parts = (np.random.default_rng(1).normal(size=(4, 33)) * 1e3).astype(dtype)
    want = np.asarray(jctx.fold_leaves(jnp.asarray(parts), tag, 4))
    got = tctx.fold_leaves(torch.from_numpy(parts), tag, 4).numpy()
    if dtype is np.int32 or tag != "sum":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # numpy in, the same left fold out
    assert np.array_equal(tctx.fold_leaves(parts, tag, 4), got)


def test_an_unknown_tag_is_refused():
    with pytest.raises(ValueError, match="unknown shard merge tag"):
        tctx.fold_leaves([torch.zeros(2)] * 2, "mean", 2)


def test_wire_helpers_are_jax_s():
    leaves = [np.arange(-5, 300, dtype=np.int32), np.array([True, False]),
              np.linspace(-1, 1, 7).astype(np.float32), np.zeros((0,), np.int64),
              np.array(70000, dtype=np.int64)]
    spec = ("sum", (), ("max", "stack"), "min", "sum")
    tags = tctx.flat_tags(spec, leaves)
    assert tags == jctx.flat_tags(spec, leaves) == ["sum", "max", "stack", "min", "sum"]
    assert tctx.flat_tags("sum", leaves) == jctx.flat_tags("sum", leaves)
    with pytest.raises(ValueError, match="tags for"):
        tctx.flat_tags(("sum", "sum"), leaves)
    for x in leaves + [torch.arange(3, dtype=torch.int32)]:
        jx = np.asarray(x)
        assert tctx.encode_leaf(x) == jctx.encode_leaf(jx)
        back = tctx.decode_leaf(tctx.encode_leaf(x))
        assert back.dtype == jx.dtype and np.array_equal(back, jx)
    wire = tctx.partial_to_wire(leaves, tags)
    assert wire == jctx.partial_to_wire(leaves, tags)
    got, got_tags = tctx.partial_from_wire(wire)
    assert got_tags == tags and all(np.array_equal(a, b) for a, b in zip(got, leaves))
    for bad in ({"wire": 0}, "x", {"wire": tctx.WIRE_VERSION, "tags": ["sum"], "leaves": []}):
        with pytest.raises(ValueError):
            tctx.partial_from_wire(bad)
    stacked = [np.stack([np.arange(4, dtype=np.int32) * p for p in range(3)]),
               np.stack([np.full(2, p, np.float32) for p in range(3)])]
    want = jctx.fold_partials([jnp.asarray(s) for s in stacked], ["sum", "max"], 3)
    got = tctx.fold_partials(stacked, ["sum", "max"], 3)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(want, got))


def test_engines_merge_by_tag():
    carry0 = (torch.zeros(3), torch.zeros((), dtype=torch.int32), (), torch.zeros(2))

    def body(carry, c):
        s, n, e, st = carry
        st = st.clone()
        st[c % 2] += c
        return (s + float(c), n + c, e, st)

    spec = ("sum", "sum", (), "stack")
    local = tctx.LOCAL.scan_idx_merge(8, body, carry0)
    seq = tctx.SeqShardCtx(4).scan_idx_merge(8, body, carry0, spec)
    assert torch.equal(local[0], seq[0]) and int(local[1]) == int(seq[1]) == 28
    assert seq[2] == () and seq[3].shape == (4, 2)
    assert seq[3].tolist() == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0], [6.0, 7.0]]
    with pytest.raises(ValueError, match="not divisible by pop_shards 3"):
        tctx.SeqShardCtx(3).scan_idx_merge(8, body, carry0, spec)
    with pytest.raises(ValueError, match="use LOCAL"):
        tctx.SeqShardCtx(1)
    assert tctx.make_ctx(1) is tctx.LOCAL


# ---------------------------------------------------------------------------
# the streamed rules under SeqShardCtx against JAX's


@pytest.mark.parametrize("shards,degraded", [(2, True), (4, False)])
def test_streamed_rules_with_sequential_shards_match_jax(shards, degraded):
    jreb, treb, w = _chunks(shards + int(degraded), nan_rows=(2, 9) if degraded else ())
    n = int(np.isfinite(w).all(axis=1).sum())
    kw = dict(k=16, d=300, n_chunks=8, degraded=degraded)
    jn, tn = (jnp.int32(n), torch.tensor(n, dtype=torch.int32)) if degraded else (None, None)
    jc, tc = jctx.SeqShardCtx(shards), tctx.SeqShardCtx(shards)
    for quantile in ("exact", "sketch"):
        want = np.asarray(jagg.stream_median(jreb, n_finite=jn, quantile=quantile,
                                             sketch_bins=64, ctx=jc, **kw))
        got = tagg.stream_median(treb, n_finite=tn, quantile=quantile, sketch_bins=64,
                                 ctx=tc, device="cpu", **kw).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), quantile
    want = np.asarray(jagg.stream_trimmed_mean(jreb, n_finite=jn, trim_ratio=0.2, ctx=jc, **kw))
    got = tagg.stream_trimmed_mean(treb, n_finite=tn, trim_ratio=0.2, ctx=tc, device="cpu",
                                   **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    want = np.asarray(jagg.stream_mean(jreb, ctx=jc, **kw))
    got = tagg.stream_mean(treb, ctx=tc, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    guess = (np.random.default_rng(8).normal(size=300) * 0.1).astype(np.float32)
    want = np.asarray(jagg.stream_gm2(jreb, guess=jnp.asarray(guess), maxiter=40, ctx=jc, **kw))
    got = tagg.stream_gm2(treb, guess=torch.from_numpy(guess), maxiter=40, ctx=tc,
                          device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,extra", [("median", {}), ("trimmed_mean", {}), ("mean", {}),
                                        ("gm2", dict(maxiter=30)),
                                        ("median", dict(quantile="sketch"))])
def test_one_shard_is_bitwise_local(name, extra):
    """A one-shard sequential fold is the plain chunk loop: S = 1 adds the
    partials in chunk order, as LOCAL does."""
    _, treb, _ = _chunks(11)
    kw = dict(k=16, d=300, n_chunks=8, device="cpu", degraded=True, **extra)
    local = tagg.stream_aggregate(name, treb, ctx=tctx.LOCAL, **kw)
    assert torch.equal(local, tagg.stream_aggregate(name, treb, **kw))


def _streamed_round_digest():
    import hashlib

    from byzantine_aircomp_tpu_torch.data import datasets as dl
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = dl.load("mnist", synthetic_train=400, synthetic_val=100)
    h = hashlib.sha256()
    for agg, defense in (("gm2", "monitor"), ("median", "off")):
        cfg = FedConfig(honest_size=6, byz_size=2, attack="signflip", agg=agg, rounds=1,
                        display_interval=2, batch_size=8, service="on", population=16,
                        cohort_size=2, straggler_prob=0.1, defense=defense,
                        noise_var=1e-3 if agg == "median" else None, agg_maxiter=20,
                        eval_train=False)
        t = Trainer(cfg, dataset=ds, device="cpu")
        v = t.run_round(0)
        h.update(t.flat_params.numpy().tobytes())
        h.update(v.numpy().tobytes())
        if t.defense_state is not None:
            for x in t.defense_state[0]:
                h.update(x.numpy().tobytes())
    return h.hexdigest()


# the streamed service round's params, variance and detector, gm2 with the
# monitor defense and median under --var, on the tree before population
# shards existed (one thread)
_PINNED_SHA256 = "7e06d8b140b51b95903781e40ffeeca91f0b80ddb516f08032d9e5439c665385"


def test_pop_shards_one_is_bitwise_the_streamed_round_before_it():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        digest = _streamed_round_digest()
    finally:
        torch.set_num_threads(threads)
    assert digest == _PINNED_SHA256


def test_sequential_shards_move_a_streamed_round_within_float_rounding(tmp_path):
    """The sequential engine at S = 4 against the single loop on the same
    draws: the median bitwise (integer counts), gm2 within 1e-5 (its float
    partial sums fold in another order)."""
    from byzantine_aircomp_tpu_torch.data import datasets as tdata
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = tdata.load("mnist", synthetic_train=300, synthetic_val=50)
    for agg, bitwise in (("median", True), ("gm2", False)):
        out = []
        for shards in (1, 4):
            cfg = FedConfig(honest_size=6, byz_size=2, attack="signflip", agg=agg, rounds=1,
                            display_interval=1, batch_size=8, service="on", population=16,
                            cohort_size=2, pop_shards=shards, agg_maxiter=20,
                            eval_train=False)
            t = Trainer(cfg, dataset=ds, device="cpu")
            t.run_round(0)
            out.append(t.flat_params)
        if bitwise:
            assert torch.equal(out[0], out[1])
        else:
            torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the config, the title and the hash


_BASE = dict(honest_size=6, byz_size=2, attack="signflip", agg="median")


@pytest.mark.parametrize("kw", [
    dict(pop_shards=0),
    dict(pop_shards=2),
    dict(pop_shards=2, service="on", population=16),
    dict(pop_shards=3, service="on", population=16, cohort_size=2),
    dict(pop_shards=2, service="on", population=16, cohort_size=2, defense="monitor",
         forensics="top"),
])
def test_pop_shard_refusals_are_jax_s(kw):
    with pytest.raises((ValueError, AssertionError)) as want:
        JaxFedConfig(**_BASE, **kw, sharded=False).validate()
    with pytest.raises(ValueError) as got:
        FedConfig(**_BASE, **kw).validate()
    assert str(got.value) == str(want.value)


def test_title_and_hash_follow_jax():
    base = dict(_BASE, service="on", population=16, cohort_size=2)
    one, two = FedConfig(**base), FedConfig(**base, pop_shards=2)
    jone, jtwo = JaxFedConfig(**base), JaxFedConfig(**base, pop_shards=2)
    assert tharness.run_title(two) == tharness.run_title(one) + "_ps2"
    assert jharness.run_title(jtwo) == jharness.run_title(jone) + "_ps2"
    assert tharness.run_title(two).endswith("_ps2")
    # S = 1 (and the layout fields at their defaults) hash as before the
    # fields existed (the digests of the tree that predates them); S > 1
    # and a forced layout fork the hash
    assert tharness.config_hash(one) == "4ed88f2e"
    assert tharness.config_hash(FedConfig()) == "fb10ef9d"
    assert tharness.config_hash(two) != tharness.config_hash(one)
    assert tharness.config_hash(FedConfig(**base, sharded=True)) != tharness.config_hash(one)
    assert tharness.config_hash(FedConfig(**base, model_parallel=2)) != tharness.config_hash(one)
