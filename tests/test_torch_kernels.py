"""The port's Weiszfeld-step kernels (plain versions) vs the JAX package's
Pallas kernels, run in interpret mode on the CPU.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there).  Tolerance
rtol=1e-5, atol=1e-6: the two sides sum in different orders.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from byzantine_aircomp_tpu.ops import pallas_kernels as pk
from byzantine_aircomp_tpu_torch.ops import kernels as tk

RTOL, ATOL = 1e-5, 1e-6


def _stack(k, d, seed, bad=None):
    """A realistic stack (rows one local step apart) with row 3 poisoned
    by ``bad`` (NaN or Inf) when given."""
    rng = np.random.default_rng(seed)
    base = 0.01 * rng.standard_normal((1, d))
    w = (base + 1e-3 * rng.standard_normal((k, d))).astype(np.float32)
    if bad is not None:
        w[3, 7] = bad
    finite = np.isfinite(w).all(axis=1)
    g = (w[finite].mean(axis=0) + 1e-4 * rng.standard_normal(d)).astype(np.float32)
    h_sq = (0.5 * (rng.standard_normal(k) ** 2 + rng.standard_normal(k) ** 2)
            ).astype(np.float32)
    return w, g, np.maximum(h_sq, 1e-6)


CASES = [
    pytest.param(13, 300, None, "f32", id="ragged"),
    pytest.param(13, 300, np.nan, "f32", id="nan_row"),
    pytest.param(9, 130, np.inf, "f32", id="inf_row"),
    pytest.param(13, 300, None, "bf16", id="bf16"),
    pytest.param(13, 300, -np.inf, "bf16", id="bf16_inf_row"),
]


def _pair(w, dtype):
    """The same stack for both sides; bf16 rounding is the same
    round-to-nearest-even in both frameworks."""
    if dtype == "f32":
        return jnp.asarray(w), torch.from_numpy(w)
    w16 = w.astype(ml_dtypes.bfloat16)
    wt = torch.from_numpy(w16.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return jnp.asarray(w16), wt


@pytest.mark.parametrize("k,d,bad,dtype", CASES)
def test_weiszfeld_step_ref_matches_pallas(k, d, bad, dtype):
    w, g, _ = _stack(k, d, seed=k + d, bad=bad)
    wj, wt = _pair(w, dtype)
    num_j, den_j = pk.weiszfeld_step(wj, jnp.asarray(g))
    num_t, den_t = tk.weiszfeld_step_ref(wt, torch.from_numpy(g))
    assert np.isfinite(num_t.numpy()).all()
    np.testing.assert_allclose(num_t.numpy(), np.asarray(num_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(den_t), float(den_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p_max", [1.0, 10.0])
@pytest.mark.parametrize("k,d,bad,dtype", CASES)
def test_aircomp_weiszfeld_step_ref_matches_pallas(k, d, bad, dtype, p_max):
    w, g, h_sq = _stack(k, d, seed=k * d, bad=bad)
    scaler = np.sqrt(np.mean(g.astype(np.float64) ** 2)).astype(np.float32)
    wj, wt = _pair(w, dtype)
    num_j, den_j = pk.aircomp_weiszfeld_step(
        wj, jnp.asarray(g), jnp.asarray(h_sq), jnp.asarray(scaler), p_max=p_max
    )
    num_t, den_t = tk.aircomp_weiszfeld_step_ref(
        wt, torch.from_numpy(g), torch.from_numpy(h_sq),
        torch.tensor([scaler]), p_max,
    )
    assert np.isfinite(num_t.numpy()).all()
    np.testing.assert_allclose(num_t.numpy(), np.asarray(num_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(den_t), float(den_j), rtol=RTOL, atol=ATOL)


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    w, g, h_sq = _stack(7, 50, seed=1)
    wt, gt, ht = torch.from_numpy(w), torch.from_numpy(g), torch.from_numpy(h_sq)
    s = torch.sqrt(torch.mean(gt**2)).reshape(1)
    active = torch.ones((), dtype=torch.int32)
    steps = torch.zeros((), dtype=torch.int64)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal(51).astype(np.float32))
    ns = torch.tensor(0.07, dtype=torch.float32)
    before = dict(tk.LAUNCHES)
    for got, want in (
        (tk.weiszfeld_step(wt, gt), tk.weiszfeld_step_ref(wt, gt)),
        (tk.aircomp_weiszfeld_step(wt, gt, ht, s, 1.0),
         tk.aircomp_weiszfeld_step_ref(wt, gt, ht, s, 1.0)),
        (tk.weiszfeld_step_fused(wt, gt, None, active, steps, 0.0),
         tk.weiszfeld_step_fused_ref(wt, gt, active, steps, 0.0)),
        (tk.aircomp_weiszfeld_step_fused(wt, gt, None, active, steps, 0.0, ht, ht, s,
                                         fade_scale=0.5, z=z, noise_scale=ns),
         tk.aircomp_weiszfeld_step_fused_ref(wt, gt, active, steps, 0.0, ht, ht, s,
                                             fade_scale=0.5, z=z, noise_scale=ns)),
    ):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tk.LAUNCHES == before


def test_launches_is_a_mapping_that_adds_the_device_counts(monkeypatch):
    """``LAUNCHES`` reads as a dict of the host counts plus each device's
    count of a kernel's steps in graphed loop bodies (a CPU tensor stands
    in for a card's); setting an entry sets what it reads, and
    ``reset_launches`` zeroes both."""
    from collections.abc import MutableMapping

    assert isinstance(tk.LAUNCHES, MutableMapping)
    launches = tk.Launches(["weiszfeld_step", "select_columns"])
    monkeypatch.setattr(tk, "LAUNCHES", launches)
    assert dict(launches) == {"weiszfeld_step": 0, "select_columns": 0}
    launches["weiszfeld_step"] += 1
    launches.add("select_columns", 3)
    tk.add_launches({"weiszfeld_step": 2, "select_columns": 0})
    assert launches.get("weiszfeld_step") == 3 and launches.get("other", 7) == 7
    count = launches.device_count("weiszfeld_step", torch.device("cpu"))
    assert launches.device_count("weiszfeld_step", "cpu") is count
    count.add_(16)  # one body run of 16 steps
    assert dict(launches) == {"weiszfeld_step": 19, "select_columns": 3}
    before = dict(launches)
    launches["weiszfeld_step"] += 1
    assert launches["weiszfeld_step"] == 20
    count.add_(8)
    assert launches["weiszfeld_step"] == 28
    launches.update(before)
    assert launches == before and int(count) == 24
    with pytest.raises(TypeError):
        del launches["select_columns"]
    assert len(launches) == 2
    tk.reset_launches()
    assert dict(launches) == {"weiszfeld_step": 0, "select_columns": 0} and int(count) == 0


def test_fused_step_forms_the_fades_as_float32_products():
    """The fused kernel forms h_sq as f32(draw * f32(FADE_STD)), squares,
    adds and floors, each op rounded once; torch's rayleigh_fade and
    floored_hsq round the same ops the same way."""
    from byzantine_aircomp_tpu_torch.ops import channel as tchannel

    gen = torch.Generator().manual_seed(0)
    draws = torch.randn(2, 4096, generator=gen)
    draws[0, :4] = torch.tensor([0.0, 1e-4, -3e-4, 7.0])  # under and over the floor
    h_r, h_i = tchannel.FADE_STD * draws[0], tchannel.FADE_STD * draws[1]
    got = tchannel.floored_hsq(h_r, h_i).numpy()
    f = draws.numpy() * np.float32(tchannel.FADE_STD)
    want = np.maximum(f[0] * f[0] + f[1] * f[1], np.float32(tchannel.HSQ_FLOOR))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert "kHsqFloor = 1e-6f" in (tk.CSRC / "weiszfeld_common.cuh").read_text()


def test_weiszfeld_advance_stops_like_the_jax_cond():
    g = torch.tensor([1.0, 2.0])
    nxt = torch.tensor([1.0, 2.5])
    one, zero = torch.ones((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    steps = torch.tensor(3)
    out, active, n = tk.weiszfeld_advance(g, nxt, one, steps, 0.4)
    assert torch.equal(out, nxt) and int(active) == 1 and int(n) == 4
    out, active, n = tk.weiszfeld_advance(g, nxt, one, steps, 0.5)  # movement <= tol
    assert torch.equal(out, nxt) and int(active) == 0 and int(n) == 4
    out, active, n = tk.weiszfeld_advance(g, nxt, zero, steps, 0.0)  # already stopped
    assert torch.equal(out, g) and int(active) == 0 and int(n) == 3
    nan = torch.tensor([float("nan"), 0.0])
    assert int(tk.weiszfeld_advance(g, nan, one, steps, 0.0)[1]) == 0


def test_kernel_sources_and_constants_agree():
    """The CUDA sources carry the same clamp and threshold as the JAX
    package (and the port's plain versions)."""
    assert tk.DIST_CLAMP == pk.DIST_CLAMP
    assert tk.GM_THRESHOLD_FACTOR == pk.GM_THRESHOLD_FACTOR
    src = (tk.CSRC / "weiszfeld_common.cuh").read_text()
    assert "kDistClamp = 1e-4f" in src and "kThresholdFactor = 500.0f" in src
    assert set(tk._SOURCES) == set(tk.LAUNCHES)
    for name, path in tk._SOURCES.items():
        assert f"{name}_launch" in (tk.CSRC / path).read_text()
    # every C entry point has its ctypes signature, so that no pointer goes
    # through ctypes as a 32-bit int
    for name in tk._SOURCES:
        text = "".join((tk.CSRC / f).read_text() for f in tk._source_files(name))
        entries = {f"{name}_launch": tk._ARGTYPES[name]}
        entries.update({q: a for q, (a, _) in tk._QUERIES.get(name, {}).items()})
        for qname, argtypes in entries.items():
            assert f"{qname}(" in text
            assert len(argtypes) == text.split(f"{qname}(")[1].split(")")[0].count(",") + 1


# ---------------------------------------------------------------------------
# selection (median / trimmed mean) and popcount: plain versions vs the JAX
# package's Pallas kernels in interpret mode and its XLA realizations


def _select_stack(k, d, seed, adversarial=False):
    w, _, _ = _stack(k, d, seed)
    if adversarial:
        w[1] = np.inf
        w[2] = -np.inf
        w[4] = np.nan  # a positive NaN row
        w[5, : d // 2] = 0.0
        w[6, : d // 2] = -0.0
        w[7] = w[8]  # ties
        w[9, ::3] = w[10, ::3]
    return w


SELECT_CASES = [
    pytest.param(13, 300, False, id="13x300"),
    pytest.param(25, 300, False, id="25x300"),
    pytest.param(25, 300, True, id="adversarial"),
]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_terms(k, d, seed, noise_var=1e-2):
    import jax

    from byzantine_aircomp_tpu.ops import channel as jchannel
    from byzantine_aircomp_tpu_torch.ops import channel as tchannel

    key = jax.random.PRNGKey(seed)
    terms = jchannel.oma_terms(key, k, d, noise_var)
    return key, terms, tchannel.OmaTerms(*(torch.from_numpy(np.array(t)) for t in terms))


@pytest.mark.parametrize("k,d,adversarial", SELECT_CASES)
def test_fused_median_ref_matches_jax_bitwise(k, d, adversarial):
    from byzantine_aircomp_tpu.ops import aggregators as jagg

    w = _select_stack(k, d, seed=k + d, adversarial=adversarial)
    got = tk.fused_median_ref(torch.from_numpy(w)).numpy()
    pallas = pk.fused_median(jnp.asarray(w), interpret=True)
    sort = np.asarray(jagg.median(jnp.asarray(w)))
    assert np.array_equal(_bits(got), _bits(pallas))
    # jnp.sort holds -0.0 == +0.0, so where the median is a zero the sort
    # path may return the other sign; everywhere else the bits agree
    zero = (got == 0.0) & (sort == 0.0)
    assert np.array_equal(_bits(got)[~zero], _bits(sort)[~zero])
    assert zero.any() == adversarial


@pytest.mark.parametrize("k,d,adversarial", SELECT_CASES)
def test_fused_trimmed_mean_ref_matches_pallas(k, d, adversarial):
    w = _select_stack(k, d, seed=3 * k + d, adversarial=adversarial)
    b = int(0.1 * k)
    got = tk.fused_trimmed_mean_ref(torch.from_numpy(w), b).numpy()
    want = np.asarray(pk.fused_trimmed_mean(jnp.asarray(w), b, interpret=True))
    # the adversarial stack's +-Inf/NaN columns come out the same non-finite
    # value; the finite ones within the stated tolerance
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.array_equal(_bits(got)[~np.isfinite(got)], _bits(want)[~np.isfinite(want)])
    fin = np.isfinite(got)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-5 if adversarial else 1e-6)


@pytest.mark.parametrize("k,d", [(13, 300), (25, 300)])
def test_fused_median_ref_channel_fold_matches_jax(k, d):
    """The fold is bitwise JAX's ``oma`` followed by either median (the sort
    path and the XLA key bisection).  JAX's interpret-mode Pallas fold lets
    XLA contract ``h_r*n_r + h_i*n_i`` into an FMA, a few ULP off its own
    ``oma`` (its test_channel_fused_pallas_close_to_two_pass says so), so
    that one is held within the JAX package's own atol."""
    from byzantine_aircomp_tpu.ops import aggregators as jagg
    from byzantine_aircomp_tpu.ops import channel as jchannel

    w = _select_stack(k, d, seed=k * d)
    key, jterms, tterms = _jax_terms(k, d, seed=k)
    got = tk.fused_median_ref(torch.from_numpy(w), tterms).numpy()
    sort = jagg.median(jchannel.oma(key, jnp.asarray(w), 1e-2))
    bisect = jagg.median(jnp.asarray(w), fused_epilogue=True, oma_key=key, noise_var=1e-2)
    pallas = np.asarray(pk.fused_median(jnp.asarray(w), channel=jterms, interpret=True))
    assert np.array_equal(_bits(got), _bits(sort))
    assert np.array_equal(_bits(got), _bits(bisect))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,d", [(13, 300), (25, 300)])
def test_fused_trimmed_mean_ref_channel_fold_matches_pallas(k, d):
    w = _select_stack(k, d, seed=k * d + 1)
    _, jterms, tterms = _jax_terms(k, d, seed=k + 1)
    b = int(0.1 * k)
    got = tk.fused_trimmed_mean_ref(torch.from_numpy(w), b, tterms).numpy()
    want = np.asarray(pk.fused_trimmed_mean(jnp.asarray(w), b, channel=jterms, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_total_order_keys_match_jax_and_round_trip():
    v = np.array([-np.inf, -1.5, -0.0, 0.0, 1e-38, 2.5, np.inf, np.nan,
                  np.finfo(np.float32).max, -np.finfo(np.float32).tiny],
                 np.float32)
    keys = tk.total_order_keys(torch.from_numpy(v))
    assert np.array_equal(keys.numpy(), np.asarray(pk.total_order_keys(jnp.asarray(v))))
    assert np.array_equal(_bits(tk.total_order_vals(keys).numpy()), _bits(v))
    assert keys[2] < keys[3] < keys[4]  # -0.0 < +0.0 < denormal
    assert keys[6] < keys[7]  # +Inf < NaN


def _words(k, w_cnt, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(k, w_cnt), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF  # bit 31 set in every word
    words[1] = 0  # a non-finite client's all-zero row
    words[2] = 0x80000000
    return words


@pytest.mark.parametrize("k,d", [(9, 300), (13, 7850), (4, 32), (3, 1)])
def test_packed_vote_counts_ref_matches_jax_bitwise(k, d):
    from byzantine_aircomp_tpu.ops import aggregators as jagg
    from byzantine_aircomp_tpu_torch.interop import sign_words_from_jax, sign_words_to_jax

    words = _words(k, -(-d // 32), seed=d)
    wt = sign_words_from_jax(words)
    assert wt.dtype == torch.int32 and np.array_equal(sign_words_to_jax(wt), words)
    got = tk.packed_vote_counts_ref(wt, d).numpy()
    assert got.dtype == np.int32 and got.shape == (d,)
    assert np.array_equal(got, np.asarray(pk.packed_vote_counts(jnp.asarray(words), d, interpret=True)))
    assert np.array_equal(got, np.asarray(jagg._packed_vote_counts_xla(jnp.asarray(words), d)))


def test_new_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    w = torch.from_numpy(_select_stack(11, 70, seed=2, adversarial=True))
    _, _, terms = _jax_terms(11, 70, seed=4)
    words = torch.from_numpy(_words(5, 3, seed=1).view(np.int32))
    before = dict(tk.LAUNCHES)
    for got, want in (
        (tk.fused_median(w), tk.fused_median_ref(w)),
        (tk.fused_median(w, terms), tk.fused_median_ref(w, terms)),
        (tk.fused_trimmed_mean(w, 1), tk.fused_trimmed_mean_ref(w, 1)),
        (tk.fused_trimmed_mean(w, 2, terms), tk.fused_trimmed_mean_ref(w, 2, terms)),
        (tk.packed_vote_counts(words, 70), tk.packed_vote_counts_ref(words, 70)),
    ):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert tk.LAUNCHES == before
    with pytest.raises(ValueError, match="K - 2b"):
        tk.fused_trimmed_mean(w, 6)


def test_every_kernel_source_is_registered():
    for name in ("select_columns", "packed_vote_counts"):
        src = (tk.CSRC / tk._SOURCES[name]).read_text()
        assert f"{name}_launch" in src
        assert tk._source_files(name) == [tk._SOURCES[name]]
    assert tk._source_files("weiszfeld_step") == ["weiszfeld_step.cu", "weiszfeld_common.cuh"]
    # the channel fold must not be contracted into an FMA
    src = (tk.CSRC / "select_columns.cu").read_text()
    assert "__fmul_rn" in src and "__fdiv_rn" in src


# ---------------------------------------------------------------------------
# the radix select of select_columns (K > 64 on the card), rehearsed on the
# CPU through its plain mirror

_TIE_BITS = np.array([
    0x3F800000, 0x3F7FFFFF, 0x3F800001, 0x3F8000FF, 0x3F800100, 0x3F810000,
    0x3FFFFFFF, 0x40000000, 0xBF800000, 0xBF800001, 0x00000000, 0x80000000,
    0x7F800000, 0xFF800000, 0x7FC00000, 0x00FFFFFF, 0x01000000,
], np.uint32)


def _radix_stack(case, k, d, seed):
    rng = np.random.default_rng(seed)
    if case == "digit_ties":  # ties whose keys differ only in one digit, +-0, +-Inf, NaN
        return _TIE_BITS[rng.integers(0, _TIE_BITS.size, (k, d))].view(np.float32)
    if case == "all_equal":
        return np.full((k, d), 0.37, np.float32)
    if case == "part_first_digit":  # half the column below 0, half above
        w = np.abs(_select_stack(k, d, seed)) + np.float32(1e-3)
        w[: k // 2] *= -1
        return w
    if case == "part_last_digit":  # consecutive keys: only the last digit differs
        steps = rng.permuted(np.tile(np.arange(k, dtype=np.uint32)[:, None], (1, d)), axis=0)
        return (np.uint32(0x3F800000) + steps).view(np.float32)
    return _select_stack(k, d, seed, adversarial=case == "adversarial")


RADIX_CASES = [
    pytest.param("digit_ties", 65, 40, id="digit_ties_65"),
    pytest.param("digit_ties", 300, 17, id="digit_ties_300"),
    pytest.param("adversarial", 25, 60, id="signed_zero_inf_nan"),
    pytest.param("all_equal", 9, 5, id="all_equal"),
    pytest.param("realistic", 1, 30, id="k1"),
    pytest.param("realistic", 2, 30, id="k2"),
    pytest.param("realistic", 3, 30, id="k3"),
    pytest.param("realistic", 64, 30, id="k64"),
    pytest.param("realistic", 65, 30, id="k65"),
    pytest.param("part_first_digit", 40, 20, id="ranks_part_at_first_digit"),
    pytest.param("part_last_digit", 40, 20, id="ranks_part_at_last_digit"),
]


@pytest.mark.parametrize("case,k,d", RADIX_CASES)
def test_radix_select_mirror_matches_bisection_and_jax(case, k, d):
    """The radix mirror picks, bit for bit, the keys of the key bisection
    (the port's and JAX's), the median of JAX's Pallas kernel (interpret
    mode) and of its XLA key bisection, with exact #(<) and #(<=)."""
    from byzantine_aircomp_tpu.ops import aggregators as jagg

    w = _radix_stack(case, k, d, seed=k * d)
    keys = tk.total_order_keys(torch.from_numpy(w))
    jkeys = pk.total_order_keys(jnp.asarray(w))
    b = int(0.1 * k)
    for ranks in (((k - 1) // 2,), (b, k - b - 1)):
        sel, n_lt, n_le, passes = tk.nth_smallest_keys_radix(keys, ranks)
        for i, n in enumerate(ranks):
            assert torch.equal(sel[i], tk.nth_smallest_keys(keys, n))
            assert np.array_equal(sel[i].numpy(), np.asarray(jagg._nth_smallest_keys(jkeys, n)))
            assert torch.equal(n_lt[i], torch.sum(keys < sel[i][None, :], dim=0))
            assert torch.equal(n_le[i], torch.sum(keys <= sel[i][None, :], dim=0))
        if len(ranks) == 1:
            assert torch.equal(passes, torch.full_like(passes, 4))
            med = _bits(tk.total_order_vals(sel[0]).numpy())
            assert np.array_equal(med, _bits(pk.fused_median(jnp.asarray(w), interpret=True)))
            assert np.array_equal(med, _bits(jagg.median(jnp.asarray(w), fused_epilogue=True)))
        elif case == "part_first_digit":
            assert torch.equal(passes, torch.full_like(passes, 7))
        elif case == "part_last_digit":
            assert torch.equal(passes, torch.full_like(passes, 4))
        else:
            assert bool(((passes >= 4) & (passes <= 7)).all())


def test_radix_select_mirror_rejects_three_ranks():
    keys = tk.total_order_keys(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="one or two ranks"):
        tk.nth_smallest_keys_radix(keys, (0, 1, 2))
