"""The port's aggregators vs the JAX package's (impl="xla").

Stacks are realistic (rows one local SGD step apart, spread 1e-3): the
AirComp geometric median's noisy denominator is only noise-robust there.
For gm the test reproduces the JAX key chain (``split(k) -> sub``,
``split(sub) -> key_h, key_n``, ``rayleigh_fade``, ``normal(key_n, d+1)``)
and passes those draws into the port.  Both sides must stop at the same
Weiszfeld step; final guesses agree within rtol=1e-4 (f32 sums in
different orders, compounded over the steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.ops import aggregators as jagg
from byzantine_aircomp_tpu.ops import channel as jchannel
from byzantine_aircomp_tpu_torch.ops import aggregators as tagg

RTOL = 1e-4


def _stack(k, d, seed, spread=1e-3):
    rng = np.random.default_rng(seed)
    base = 0.01 * rng.standard_normal((1, d))
    w = (base + spread * rng.standard_normal((k, d))).astype(np.float32)
    g = (w.mean(axis=0) + spread * rng.standard_normal(d)).astype(np.float32)
    return w, g


def _jax_steps(run, maxiter):
    """Weiszfeld steps the JAX solver ran: the smallest maxiter m whose
    output equals the full run's bit for bit (the prefix of the iterate
    sequence is the same for every maxiter)."""
    full = np.asarray(run(maxiter))
    lo, hi = 1, maxiter
    while lo < hi:
        mid = (lo + hi) // 2
        if np.array_equal(np.asarray(run(mid)), full):
            hi = mid
        else:
            lo = mid + 1
    return lo, full


def _jax_gm_draws(key, k, d, steps):
    """The fades and receiver normals JAX's gm draws at each step."""
    h_r, h_i, z = [], [], []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        key_h, key_n = jax.random.split(sub)
        hr, hi = jchannel.rayleigh_fade(key_h, k)
        h_r.append(np.asarray(hr))
        h_i.append(np.asarray(hi))
        z.append(np.asarray(jax.random.normal(key_n, (d + 1,), dtype=jnp.float32)))
    return (torch.from_numpy(np.stack(h_r)), torch.from_numpy(np.stack(h_i))), \
        torch.from_numpy(np.stack(z))


@pytest.mark.parametrize("k,d,tol,maxiter", [
    (13, 300, 1e-7, 60),
    (24, 1000, 1e-6, 40),
])
def test_gm2_matches_jax(k, d, tol, maxiter):
    w, g = _stack(k, d, seed=k)
    n_jax, out_jax = _jax_steps(
        lambda m: jagg.gm2(jnp.asarray(w), guess=jnp.asarray(g), maxiter=m,
                           tol=tol, impl="xla"),
        maxiter,
    )
    out, n_port = tagg.gm2_solve(
        torch.from_numpy(w), guess=torch.from_numpy(g), maxiter=maxiter, tol=tol
    )
    assert 1 < n_jax < maxiter, "the case must stop on the tolerance"
    assert n_port == n_jax
    np.testing.assert_allclose(out.numpy(), out_jax, rtol=RTOL, atol=1e-7)


# gm's fades are redrawn every step, so its iterates keep moving by ~1e-3
# even without receiver noise: these tolerances make the solve stop on
# `movement <= tol` partway, which is what the same-step check needs
@pytest.mark.parametrize("noise_var,tol,maxiter", [
    (None, 2e-3, 60),
    (1e-2, 2.5e-3, 120),
])
def test_gm_matches_jax_with_its_draws(noise_var, tol, maxiter):
    k, d = 13, 300
    w, g = _stack(k, d, seed=5)
    key = jax.random.PRNGKey(42)
    n_jax, out_jax = _jax_steps(
        lambda m: jagg.gm(jnp.asarray(w), key=key, noise_var=noise_var,
                          guess=jnp.asarray(g), maxiter=m, tol=tol, impl="xla"),
        maxiter,
    )
    fades, noise = _jax_gm_draws(key, k, d, maxiter)
    out, n_port = tagg.gm_solve(
        torch.from_numpy(w), noise_var=noise_var, guess=torch.from_numpy(g),
        maxiter=maxiter, tol=tol, fades=fades, noise=noise,
    )
    assert 1 < n_jax < maxiter, "the case must stop on the tolerance"
    assert n_port == n_jax
    np.testing.assert_allclose(out.numpy(), out_jax, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("agg", ["gm2", "gm", "gm_generator"])
def test_chunked_loop_equals_per_step_loop_bitwise(agg):
    k, d, maxiter = 11, 200, 120
    w, g = _stack(k, d, seed=3)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)

    def solve(chunk):
        if agg == "gm2":
            return tagg.gm2_solve(wt, guess=gt, maxiter=maxiter, tol=1e-7, chunk=chunk)
        if agg == "gm":
            fades, noise = _jax_gm_draws(jax.random.PRNGKey(1), k, d, maxiter)
            return tagg.gm_solve(wt, noise_var=1e-2, guess=gt, maxiter=maxiter,
                                 tol=2.5e-3, fades=fades, noise=noise, chunk=chunk)
        gen = torch.Generator().manual_seed(7)
        return tagg.gm_solve(wt, noise_var=1e-2, guess=gt, maxiter=maxiter,
                             tol=2.5e-3, generator=gen, chunk=chunk)

    out_1, n_1 = solve(1)
    for chunk in (4, 16, 64):
        out_c, n_c = solve(chunk)
        assert n_c == n_1
        assert torch.equal(out_c, out_1)
    assert 1 < n_1 < maxiter


def _per_step_torch_solve(agg, wt, gt, maxiter, tol, chunk, noise_var=None,
                          generator=None, fades=None, noise=None):
    """The CPU Weiszfeld loop written out step by step in plain torch: the
    num/den plain versions, then the update, the stopping rule and the
    done flag read once per chunk.  The solve, which now runs each step
    through the fused step's plain version on the CPU, must equal it bit
    for bit."""
    from byzantine_aircomp_tpu_torch.ops import channel as tchannel
    from byzantine_aircomp_tpu_torch.ops import kernels as tk

    k, d = wt.shape
    g = gt
    active = torch.ones((), dtype=torch.bool)
    steps = torch.zeros((), dtype=torch.int64)
    scale = None if noise_var is None else torch.sqrt(
        torch.tensor(noise_var, dtype=torch.float32) / 2.0)
    i = 0
    while i < maxiter:
        for _ in range(min(chunk, maxiter - i)):
            if agg == "gm2":
                num, den = tk.weiszfeld_step_ref(wt, g)
                g_next = num / den
            else:
                h_r, h_i = (tchannel.rayleigh_fade(k, generator=generator)
                            if fades is None else (fades[0][i], fades[1][i]))
                scaler = torch.sqrt(torch.mean(g**2)).reshape(1)
                num, den = tk.aircomp_weiszfeld_step_ref(
                    wt, g, tchannel.floored_hsq(h_r, h_i), scaler)
                if scale is not None:
                    z = torch.randn(d + 1, generator=generator) if noise is None else noise[i]
                    n = scale * z
                    num, den = num + n[:-1], den + n[-1]
                g_next = num / den * scaler
            movement = torch.linalg.vector_norm(g - g_next)
            g = torch.where(active, g_next, g)
            steps = steps + active.to(torch.int64)
            active = active & (movement > tol)
            i += 1
        if not bool(active):
            break
    return g, int(steps)


@pytest.mark.parametrize("agg", ["gm2", "gm_draws", "gm_generator", "gm_noiseless"])
@pytest.mark.parametrize("chunk", [1, 16])
def test_cpu_solve_is_bitwise_the_per_step_torch_loop(agg, chunk):
    k, d, maxiter = 11, 200, 120
    w, g = _stack(k, d, seed=3)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)
    if agg == "gm2":
        kw = dict(tol=1e-7)
        got = tagg.gm2_solve(wt, guess=gt, maxiter=maxiter, chunk=chunk, **kw)
    else:
        kw = dict(tol=2.5e-3, noise_var=None if agg == "gm_noiseless" else 1e-2)
        if agg == "gm_draws":
            kw["fades"], kw["noise"] = _jax_gm_draws(jax.random.PRNGKey(1), k, d, maxiter)
        got = tagg.gm_solve(
            wt, guess=gt, maxiter=maxiter, chunk=chunk,
            generator=torch.Generator().manual_seed(7), **kw)
        kw["generator"] = torch.Generator().manual_seed(7)
    want = _per_step_torch_solve("gm2" if agg == "gm2" else "gm", wt, gt, maxiter,
                                 chunk=chunk, **kw)
    assert got[1] == want[1] and 1 < got[1] <= maxiter
    assert torch.equal(got[0], want[0])


def test_weiszfeld_loop_runs_inside_one_profiler_range():
    """A profile can tell the loop's steps from the solve's set-up: one
    ``WEISZFELD_LOOP_RANGE`` range per solve, holding the steps' ops and
    not the state's allocation."""
    from torch.profiler import ProfilerActivity, profile

    w, g = _stack(11, 200, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, n = tagg.gm2_solve(torch.from_numpy(w), guess=torch.from_numpy(g),
                              maxiter=120, tol=1e-7)
    events = list(prof.events())
    loops = [ev for ev in events if ev.name == tagg.WEISZFELD_LOOP_RANGE]
    assert len(loops) == 1 and n > 1
    start, end = loops[0].time_range.start, loops[0].time_range.end

    def inside(name):
        return [start <= ev.time_range.start <= end for ev in events if ev.name == name]

    assert inside("aten::linalg_vector_norm").count(True) >= 2 * n  # distances, movement
    assert inside("aten::ones") and not any(inside("aten::ones"))  # the active flag


def test_gm2_excludes_non_finite_rows_like_jax():
    w, g = _stack(10, 120, seed=9)
    w[2, 5] = np.nan
    w[6, 0] = np.inf
    out_jax = jagg.gm2(jnp.asarray(w), maxiter=50, tol=1e-7, impl="xla")
    out = tagg.gm2(torch.from_numpy(w), maxiter=50, tol=1e-7)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(out_jax), rtol=RTOL, atol=1e-7)


def test_mean_matches_jax():
    w, _ = _stack(9, 77, seed=2)
    np.testing.assert_allclose(
        tagg.mean(torch.from_numpy(w)).numpy(),
        np.asarray(jagg.mean(jnp.asarray(w))), rtol=1e-6, atol=1e-8,
    )


def test_unported_aggregator_raises_clear_keyerror():
    with pytest.raises(KeyError, match="not ported"):
        tagg.resolve("bulyan")
    with pytest.raises(KeyError, match="unknown aggregator"):
        tagg.resolve("no_such_rule")
    assert tagg.needs_oma_prepass("gm2") and not tagg.needs_oma_prepass("gm")


# ---------------------------------------------------------------------------
# median, trimmed_mean, krum, signmv


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("k,d", [(13, 300), (10, 7850), (24, 100)])
def test_median_matches_jax_bitwise(k, d):
    w, _ = _stack(k, d, seed=k + d)
    w[-1] = np.nan  # a poisoned row ranks last, as in the sort
    got = tagg.median(torch.from_numpy(w)).numpy()
    assert np.array_equal(_bits(got), _bits(jagg.median(jnp.asarray(w))))


@pytest.mark.parametrize("beta", [None, 0, 2, 5])
def test_trimmed_mean_matches_jax_with_boundary_ties(beta):
    k, d = 12, 200
    w, _ = _stack(k, d, seed=7)
    # ties that straddle the trim boundaries
    w[:4, ::2] = w[4, ::2]
    w[-3:, 1::3] = w[0, 1::3]
    got = tagg.trimmed_mean(torch.from_numpy(w), beta=beta).numpy()
    want = np.asarray(jagg.trimmed_mean(jnp.asarray(w), beta=beta))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_trimmed_mean_channel_fold_equals_oma_first():
    from byzantine_aircomp_tpu_torch.ops import channel as tchannel

    k, d = 10, 300
    w, _ = _stack(k, d, seed=1)
    key = jax.random.PRNGKey(9)
    terms = tchannel.OmaTerms(
        *(torch.from_numpy(np.array(t)) for t in jchannel.oma_terms(key, k, d, 1e-2))
    )
    wt = torch.from_numpy(w)
    folded = tagg.trimmed_mean(wt, channel=terms)
    two_pass = tagg.trimmed_mean(tchannel.oma(wt, 1e-2, terms=terms))
    assert torch.equal(folded, two_pass)
    want = np.asarray(jagg.trimmed_mean(jchannel.oma(key, jnp.asarray(w), 1e-2)))
    np.testing.assert_allclose(folded.numpy(), want, rtol=1e-5, atol=1e-6)


def _krum_stack(kind):
    k, d, honest = 12, 300, 8
    w, _ = _stack(k, d, seed=11)
    if kind == "outlier":
        w[honest:] += 1e3  # distances of ~1e9 dwarf the honest ~1e-4
    elif kind == "nan_row":
        w[honest] = np.nan
        w[honest + 1, 3] = np.inf
    return w, honest


@pytest.mark.parametrize("kind", ["plain", "outlier", "nan_row"])
def test_krum_selects_the_jax_row(kind):
    w, honest = _krum_stack(kind)
    scores = tagg.krum_scores(torch.from_numpy(w), honest).numpy()
    want_scores = np.asarray(jagg.krum_scores(jnp.asarray(w), honest))
    assert int(np.argmin(scores)) == int(np.argmin(want_scores))
    fin = np.isfinite(want_scores)
    assert np.array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], want_scores[fin], rtol=1e-3)
    got = tagg.krum(torch.from_numpy(w), honest_size=honest).numpy()
    want = np.asarray(jagg.krum(jnp.asarray(w), honest_size=honest))
    assert np.array_equal(_bits(got), _bits(want))
    assert tagg.resolve("Krum") is tagg.krum


def test_krum_poisoned_row_never_wins_at_honest_size_two():
    w, _ = _krum_stack("nan_row")
    w = w[6:10]  # rows 2 and 3 poisoned
    dist = tagg.pairwise_sq_dists(torch.from_numpy(w))
    assert torch.isinf(dist[2, 2]) and dist[0, 0] == 0
    got = tagg.krum(torch.from_numpy(w), honest_size=2).numpy()
    assert np.array_equal(_bits(got), _bits(jagg.krum(jnp.asarray(w), honest_size=2)))


def _sign_case(k, d, seed):
    w, g = _stack(k, d, seed=seed)
    w[2] = g  # zero deltas vote +1 on the packed wire
    w[-1, 5] = np.nan  # a non-finite client
    return w, g


@pytest.mark.parametrize("sign_bits,sign_eta,noise_var", [
    (1, 0.01, 1e-2), (1, 0.5, None), (32, 0.01, 1e-2), (32, None, 1e-2),
    (32, None, None),
])
def test_signmv_matches_jax_bitwise(sign_bits, sign_eta, noise_var):
    k, d = 11, 7850
    w, g = _sign_case(k, d, seed=sign_bits)
    key = jax.random.PRNGKey(17)
    want = np.asarray(jagg.sign_majority_vote(
        jnp.asarray(w), guess=jnp.asarray(g), key=key, noise_var=noise_var,
        sign_eta=sign_eta, sign_bits=sign_bits,
    ))
    z = torch.from_numpy(np.array(jax.random.normal(key, (d,), dtype=jnp.float32)))
    got = tagg.sign_majority_vote(
        torch.from_numpy(w), guess=torch.from_numpy(g), noise_var=noise_var,
        sign_eta=sign_eta, sign_bits=sign_bits, vote_noise=z,
    ).numpy()
    assert not np.array_equal(got, g)  # it moved
    assert np.array_equal(_bits(got), _bits(want))


def test_pack_signs_matches_jax_words():
    from byzantine_aircomp_tpu_torch.interop import sign_words_to_jax

    k, d = 9, 300
    w, g = _sign_case(k, d, seed=4)
    w[0] = g + 1.0  # every ballot +1: bit 31 set in every word
    words, k_valid = tagg.pack_signs(torch.from_numpy(w), torch.from_numpy(g))
    want_words, want_valid = jagg.pack_signs(jnp.asarray(w), jnp.asarray(g))
    assert words.dtype == torch.int32 and words.shape == (k, tagg.packed_words(d))
    assert np.array_equal(sign_words_to_jax(words), np.asarray(want_words))
    assert int(k_valid) == int(want_valid) == k - 1
    assert np.all(sign_words_to_jax(words)[-1] == 0)
    counts = tagg.packed_sign_votes(words, d)
    assert np.array_equal(counts.numpy(), np.asarray(jagg._packed_vote_counts_xla(want_words, d)))


def test_signmv_unported_widths_and_missing_eta_raise():
    w, g = _sign_case(5, 40, seed=1)
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)
    with pytest.raises(ValueError, match="not ported"):
        tagg.sign_majority_vote(wt, guess=gt, sign_bits=8, sign_eta=0.1)
    with pytest.raises(ValueError, match="sign_eta"):
        tagg.sign_majority_vote(wt, guess=gt, sign_bits=1)
    assert not tagg.needs_oma_prepass("signmv")
    assert tagg.supports_fused_epilogue("median") and not tagg.supports_fused_epilogue("krum")
