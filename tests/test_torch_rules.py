"""The port's remaining aggregation rules vs the JAX package's, on the CPU:
multi_krum, bulyan, cclip, dnc, bev, signmv at 8/16 bits, and the degraded
(fault-mode) variants of mean, median, trimmed_mean, krum, multi_krum and
bulyan.

Inputs come from numpy with a seed (K=10 or 12, B=2, d from 300 to 7850).
Tolerances: selected index sets and medians bitwise; f32 means (multi_krum,
bulyan, cclip, dnc given the same draws, the degraded mean and trimmed
mean) within atol 1e-6, their sums running in other orders; the +-eta
steps of bev and signmv bitwise.  Stacks with exact ties (duplicate rows,
values symmetric about the median) check that every selection takes ties
lowest index first, as ``lax.top_k`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg
from byzantine_aircomp_tpu_torch.ops import channel as tchannel

ATOL = 1e-6


def _stack(k, d, seed, spread=1e-3):
    rng = np.random.default_rng(seed)
    base = 0.01 * rng.standard_normal((1, d))
    w = (base + spread * rng.standard_normal((k, d))).astype(np.float32)
    g = (w.mean(axis=0) + spread * rng.standard_normal(d)).astype(np.float32)
    return w, g


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same(got, want):
    return np.array_equal(_bits(got), _bits(want))


def _case(kind, k=10, d=300, seed=0):
    """Stacks of K rows, the last two Byzantine: ``plain``; ``outlier``
    (far rows); ``dup`` (the Byzantine rows and one honest row equal, so
    scores tie); ``nan_row`` (a NaN row and an Inf entry); ``saturate``
    (a finite row whose squared norm overflows)."""
    w, g = _stack(k, d, seed)
    if kind == "outlier":
        w[-2:] += 1e3
    elif kind == "dup":
        w[-3:] = w[-3]
    elif kind == "nan_row":
        w[1] = np.nan
        w[4, 3] = np.inf
    elif kind == "saturate":
        w[2] = 3.0e38
    return w, g


def _jt(w):
    return jnp.asarray(w), torch.from_numpy(w)


KINDS = ["plain", "outlier", "dup", "nan_row", "saturate"]


@pytest.mark.parametrize("degraded", [False, True])
@pytest.mark.parametrize("m", [None, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_multi_krum_matches_jax(kind, m, degraded):
    w, _ = _case(kind)
    wj, wt = _jt(w)
    honest = 8
    if degraded:
        scores = tagg.krum_scores_degraded(wt, honest)
        want_scores = jagg.krum_scores_degraded(wj, honest)
    else:
        scores = tagg.krum_scores(wt, honest)
        want_scores = jagg.krum_scores(wj, honest)
    m_sel = honest if m is None else m
    _, want_idx = jax.lax.top_k(-want_scores, m_sel)
    assert np.array_equal(tagg.lowest(scores, m_sel).numpy(), np.asarray(want_idx))
    got = tagg.multi_krum(wt, honest_size=honest, m=m, degraded=degraded).numpy()
    want = np.asarray(jagg.multi_krum(wj, honest_size=honest, m=m, degraded=degraded))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_degraded_krum_picks_the_jax_row(kind):
    w, _ = _case(kind)
    wj, wt = _jt(w)
    got = tagg.krum(wt, honest_size=8, degraded=True).numpy()
    assert _same(got, jagg.krum(wj, honest_size=8, degraded=True))


def test_lowest_takes_ties_lowest_index_first():
    scores = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0, float("inf"), 2.0])
    want = jax.lax.top_k(-jnp.asarray(scores.numpy()), 5)[1]
    assert tagg.lowest(scores, 5).tolist() == np.asarray(want).tolist() == [1, 3, 4, 2, 6]


@pytest.mark.parametrize("degraded", [False, True])
@pytest.mark.parametrize("kind,d", [("plain", 300), ("plain", 7850), ("dup", 300),
                                    ("outlier", 300), ("nan_row", 300)])
def test_bulyan_matches_jax(kind, d, degraded):
    w, _ = _case(kind, k=10, d=d, seed=d)
    wj, wt = _jt(w)
    got = tagg.bulyan(wt, honest_size=8, degraded=degraded).numpy()
    want = np.asarray(jagg.bulyan(wj, honest_size=8, degraded=degraded))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bulyan_tail_ties_and_median_match_jax_bitwise():
    """theta = 6 rows whose values tie around the median (med + x and
    med - x) and across rows: the beta closest values are the ones
    ``lax.top_k`` picks, in its order, so the mean is bitwise."""
    rng = np.random.default_rng(1)
    d = 257
    med = rng.standard_normal(d).astype(np.float32)
    x = np.abs(rng.standard_normal(d)).astype(np.float32)
    sel = np.stack([med - x, med, med + x, med + x, med - x, med + 2 * x]).astype(np.float32)
    sel[:, ::5] = 0.25  # whole tied columns
    selj, selt = _jt(sel)
    assert _same(tagg.median(selt), jagg.median(selj))
    dist = torch.abs(selt - tagg.median(selt)[None, :])
    rows = torch.sort(dist, dim=0, stable=True).indices[:2]
    _, want_rows = jax.lax.top_k(-jnp.abs(selj - jagg.median(selj)[None, :]).T, 2)
    assert np.array_equal(rows.T.numpy(), np.asarray(want_rows))
    for beta in (1, 2, 4):
        assert _same(tagg.bulyan_tail(selt, beta), jagg.bulyan_tail(selj, beta))


def test_bulyan_sizes_raise_unless_k_above_4b():
    assert tagg.bulyan_sizes(10, 2) == jagg.bulyan_sizes(10, 2) == (6, 2)
    for k, b in ((8, 2), (4, 1), (12, 3)):
        with pytest.raises(ValueError, match="K > 4B"):
            tagg.bulyan_sizes(k, b)
    with pytest.raises(ValueError, match="K > 4B"):
        tagg.bulyan(torch.zeros(8, 5), honest_size=6)


@pytest.mark.parametrize("clip_tau,clip_iters", [(None, 3), (None, 1), (1e-3, 3), (10.0, 2)])
@pytest.mark.parametrize("kind", ["plain", "outlier", "nan_row"])
def test_cclip_matches_jax(kind, clip_tau, clip_iters):
    w, g = _case(kind, k=12, d=300, seed=5)
    wj, wt = _jt(w)
    got = tagg.centered_clip(wt, guess=torch.from_numpy(g), clip_tau=clip_tau,
                             clip_iters=clip_iters).numpy()
    want = np.asarray(jagg.centered_clip(wj, guess=jnp.asarray(g), clip_tau=clip_tau,
                                         clip_iters=clip_iters))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # no guess: the walk starts from the finite centroid.  The far rows of
    # "outlier" put it near 165, and its clipped steps of norm ~2800 carry
    # the norms' f32 rounding (1e-7 relative, summed in other orders) into
    # the result at 1e-6 relative: held within rtol 1e-5 there
    rtol = 1e-5 if kind == "outlier" else 0
    np.testing.assert_allclose(
        tagg.centered_clip(wt, clip_tau=clip_tau).numpy(),
        np.asarray(jagg.centered_clip(wj, clip_tau=clip_tau)), rtol=rtol, atol=ATOL)


def test_cclip_with_inf_tau_takes_no_step():
    # six of ten rows non-finite: the adaptive tau (lower-middle median of
    # the norms, non-finite rows +Inf) is Inf, and every step is a no-op
    w, g = _stack(10, 50, seed=2)
    w[4:] = np.nan
    got = tagg.centered_clip(torch.from_numpy(w), guess=torch.from_numpy(g))
    assert _same(got.numpy(), g)
    assert _same(got.numpy(), jagg.centered_clip(jnp.asarray(w), guess=jnp.asarray(g)))


def _dnc_draws(key, d, iters, sub_dim):
    out = []
    r = min(d, sub_dim)
    for it in range(iters):
        k_cols, k_v = jax.random.split(jax.random.fold_in(key, it))
        out.append((torch.from_numpy(np.array(jax.random.randint(k_cols, (r,), 0, d))).long(),
                    torch.from_numpy(np.array(jax.random.normal(k_v, (r,), jnp.float32)))))
    return out


@pytest.mark.parametrize("kind,d,sub_dim,iters,c,honest", [
    ("outlier", 300, 10000, 3, 1.0, 8),
    ("dup", 300, 100, 3, 1.0, 8),
    ("nan_row", 7850, 10000, 3, 1.0, 8),
    ("plain", 300, 50, 2, 1.5, 8),
    ("plain", 300, 50, 1, 1.0, 10),  # B = 0: nothing removed
])
def test_dnc_matches_jax_with_its_draws(kind, d, sub_dim, iters, c, honest):
    w, _ = _case(kind, k=10, d=d, seed=d + iters)
    if kind == "dup":
        w[-2:] += 0.05  # the tied rows are the outliers
    wj, wt = _jt(w)
    key = jax.random.PRNGKey(7)
    kw = dict(honest_size=honest, dnc_iters=iters, dnc_sub_dim=sub_dim, dnc_c=c)
    want = np.asarray(jagg.dnc(wj, key=key, **kw))
    got = tagg.dnc(wt, dnc_draws=_dnc_draws(key, d, iters, sub_dim), **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_dnc_falls_back_to_the_finite_centroid_and_bounds_removals():
    w, _ = _case("nan_row", k=6, d=40)
    wt = torch.from_numpy(w)
    # 2 removals per round x 2 rounds leave at most the 5 - 4 finite rows;
    # all of them removed -> the finite centroid
    draws = [(torch.arange(40), torch.ones(40)), (torch.arange(40), -torch.ones(40))]
    got = tagg.dnc(wt, honest_size=5, dnc_iters=2, dnc_c=2.0, dnc_draws=draws)
    assert torch.isfinite(got).all()
    with pytest.raises(ValueError, match="dnc removes"):
        tagg.dnc(wt, honest_size=4, dnc_iters=3)
    with pytest.raises(ValueError, match="dnc removes"):
        jagg.dnc(jnp.asarray(w), honest_size=4, dnc_iters=3)
    gen = torch.Generator().manual_seed(0)
    a = tagg.dnc(wt, honest_size=5, generator=gen)
    b = tagg.dnc(wt, honest_size=5, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def _sign_case(k, d, seed):
    w, g = _stack(k, d, seed=seed)
    w[2] = g  # an all-zero delta row
    w[-1, 5] = np.nan  # a non-finite client
    w[3, :7] = g[:7] + 3e-3  # ties in the row maxima
    return w, g


@pytest.mark.parametrize("sign_bits,sign_eta", [
    (1, 0.01), (8, None), (8, 0.01), (16, None), (16, 0.5), (32, None), (32, 0.01),
])
def test_bev_matches_jax_bitwise(sign_bits, sign_eta):
    w, g = _sign_case(11, 7850, seed=sign_bits)
    got = tagg.best_effort_voting(torch.from_numpy(w), guess=torch.from_numpy(g),
                                  sign_bits=sign_bits, sign_eta=sign_eta).numpy()
    want = jagg.best_effort_voting(jnp.asarray(w), guess=jnp.asarray(g),
                                   sign_bits=sign_bits, sign_eta=sign_eta)
    assert not np.array_equal(got, g)  # it moved
    assert _same(got, want)


@pytest.mark.parametrize("sign_bits", [8, 16])
@pytest.mark.parametrize("sign_eta,noise_var", [(None, 1e-2), (0.01, 1e-2), (None, None)])
def test_signmv_quantized_matches_jax_bitwise(sign_bits, sign_eta, noise_var):
    k, d = 11, 7850
    w, g = _sign_case(k, d, seed=sign_bits + 1)
    key = jax.random.PRNGKey(17)
    want = jagg.sign_majority_vote(jnp.asarray(w), guess=jnp.asarray(g), key=key,
                                   noise_var=noise_var, sign_eta=sign_eta,
                                   sign_bits=sign_bits)
    z = torch.from_numpy(np.array(jax.random.normal(key, (d,), dtype=jnp.float32)))
    got = tagg.sign_majority_vote(torch.from_numpy(w), guess=torch.from_numpy(g),
                                  noise_var=noise_var, sign_eta=sign_eta,
                                  sign_bits=sign_bits, vote_noise=z).numpy()
    assert _same(got, want)


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_stack_matches_jax_bitwise(bits):
    """The dequantized stack itself: XLA on the CPU and torch round the
    same ops in the same order (``round`` half to even on both sides), so
    it agrees bit for bit, the non-finite row passed through and the zero
    row exactly the guess."""
    w, g = _sign_case(9, 300, seed=bits)
    w[4, :10] = g[:10] + np.float32(2.0 ** -12) * np.arange(10)  # exact .5 levels
    got = tagg._quantize_deltas(torch.from_numpy(w), torch.from_numpy(g), bits).numpy()
    want = np.asarray(jagg._quantize_deltas(jnp.asarray(w), jnp.asarray(g), bits))
    assert _same(got, want)
    assert _same(got[2], g) and _same(got[-1], w[-1])


# ---------------------------------------------------------------------------
# degraded variants: the cases of tests/test_faults.py, against the JAX
# package's degraded rules and against the plain rules on the cleaned stack


def _poisoned(k=12, d=300):
    w, _ = _stack(k, d, seed=3)
    w[1] = np.nan
    w[4] = np.inf
    clean = np.concatenate([w[:1], w[2:4], w[5:]], axis=0)
    return w, clean


@pytest.mark.parametrize("name,kw", [
    ("mean", {}), ("median", {}), ("trimmed_mean", {}), ("trimmed_mean", {"beta": 2}),
    ("trimmed_mean", {"trim_ratio": 0.25}), ("trimmed_mean", {"beta": 9}),
    ("krum", {"honest_size": 8}), ("multi_krum", {"honest_size": 8}),
    ("bulyan", {"honest_size": 10}),
])
def test_degraded_rules_match_jax(name, kw):
    w, clean = _poisoned()
    wj, wt = _jt(w)
    got = tagg.resolve(name)(wt, degraded=True, **kw).numpy()
    want = np.asarray(jagg.AGGREGATORS.get(name)(wj, degraded=True, **kw))
    assert np.isfinite(got).all()
    if name in ("median", "krum"):
        assert _same(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if name in ("mean", "median", "trimmed_mean", "krum", "multi_krum") and "beta" not in kw \
            and "trim_ratio" not in kw:
        # the degraded rule is the plain rule on the stack without the dead rows
        np.testing.assert_allclose(
            got, tagg.resolve(name)(torch.from_numpy(clean), **kw).numpy(),
            rtol=1e-6, atol=1e-9)


def test_degraded_median_with_the_channel_is_oma_first():
    w, _ = _poisoned(10, 200)
    key = jax.random.PRNGKey(9)
    terms = tchannel.OmaTerms(
        *(torch.from_numpy(np.array(t)) for t in jchannel.oma_terms(key, 10, 200, 1e-2)))
    got = tagg.median(torch.from_numpy(w), channel=terms, degraded=True).numpy()
    want = jagg.median(jnp.asarray(w), oma_key=key, noise_var=1e-2, degraded=True)
    assert _same(got, want)
    got = tagg.trimmed_mean(torch.from_numpy(w), channel=terms, degraded=True).numpy()
    want = jagg.trimmed_mean(jnp.asarray(w), oma_key=key, noise_var=1e-2, degraded=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def test_degraded_median_orders_signed_zeros_as_jax_sorts():
    w = np.zeros((5, 4), np.float32)
    w[0] = -0.0
    w[1] = -0.0
    w[2, :2] = -0.0
    w[3] = np.nan
    got = tagg.median(torch.from_numpy(w), degraded=True).numpy()
    assert _same(got, jagg.median(jnp.asarray(w), degraded=True))


def test_degraded_krum_never_selects_dead_row():
    w, _ = _stack(10, 60, seed=4)
    w[3:] = np.nan  # only 3 finite rows remain
    wj, wt = _jt(w)
    for fn in (tagg.krum, tagg.multi_krum):
        out = fn(wt, honest_size=8, degraded=True).numpy()
        assert np.isfinite(out).all(), fn.__name__
    np.testing.assert_allclose(
        tagg.multi_krum(wt, honest_size=8, degraded=True).numpy(),
        np.asarray(jagg.multi_krum(wj, honest_size=8, degraded=True)), rtol=0, atol=ATOL)


def test_degraded_all_dead_triggers_guard_convention():
    # zero finite rows: every degraded rule returns a non-finite vector (the
    # trainer's finite guard then keeps the previous params)
    wt = torch.full((10, 20), float("nan"))
    for name, kw in [("mean", {}), ("median", {}), ("trimmed_mean", {}),
                     ("multi_krum", {"honest_size": 8}), ("bulyan", {"honest_size": 10})]:
        out = tagg.resolve(name)(wt, degraded=True, **kw)
        assert not torch.isfinite(out).all(), name


def test_blocked_columns_equal_the_dense_rules(monkeypatch):
    """Above the dense budget the rules run over column blocks; the blocks
    give the dense result bit for bit (same per-column work)."""
    w, g = _case("dup", k=10, d=700, seed=8)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)
    rules = (lambda t: tagg.bulyan(t, honest_size=8),
             lambda t: tagg.multi_krum(t, honest_size=8, m=3),
             lambda t: tagg.best_effort_voting(t, guess=gt, sign_bits=8))
    dense = [fn(wt) for fn in rules]
    monkeypatch.setattr(tagg, "_DENSE_MAX_ELEMS", 10)
    for fn, want in zip(rules, dense):
        assert torch.equal(fn(wt), want)
    got = tagg._blocked_columns((wt, gt), lambda c, v: c[0] + v, max_block_elems=2560)
    assert torch.equal(got, wt[0] + gt)
