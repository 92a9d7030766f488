"""Tests of the port's CUDA kernels; they need an NVIDIA GPU and skip
without one.  This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from byzantine_aircomp_tpu_torch.ops import aggregators, kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    kernels.build()
    return torch.device("cuda")


def _stack(k, d, dtype, cuda, bad=float("nan")):
    g = torch.Generator(device=cuda).manual_seed(k * d)
    w = 0.01 * torch.randn(1, d, device=cuda, generator=g) + 1e-3 * torch.randn(
        k, d, device=cuda, generator=g
    )
    if k > 1:
        w[k // 2, d // 3] = bad
    guess = w[torch.isfinite(w).all(dim=1)].mean(dim=0).contiguous()
    h_sq = torch.clamp(torch.randn(k, device=cuda, generator=g) ** 2, min=1e-6)
    return w.to(dtype).contiguous(), guess, h_sq, torch.sqrt(torch.mean(guess**2)).reshape(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(13, 300), (1000, 7850), (1, 1), (50, 16500)])
def test_kernels_match_plain_versions(cuda, k, d, dtype):
    w, guess, h_sq, s = _stack(k, d, dtype, cuda, bad=float("inf"))
    before = dict(kernels.LAUNCHES)
    for kern, ref, args in (
        (kernels.weiszfeld_step, kernels.weiszfeld_step_ref, (w, guess)),
        (kernels.aircomp_weiszfeld_step, kernels.aircomp_weiszfeld_step_ref,
         (w, guess, h_sq, s, 1.0)),
    ):
        num_k, den_k = kern(*args)
        num_r, den_r = ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(num_k, num_r, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(den_k, den_r, rtol=1e-4, atol=1e-6)
        again = kern(*args)
        assert torch.equal(again[0], num_k) and torch.equal(again[1], den_k)
    for n in ("weiszfeld_step", "aircomp_weiszfeld_step"):
        assert kernels.LAUNCHES[n] == before[n] + 2


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w, guess, h_sq, s = _stack(8, 64, torch.float32, cuda)
    with pytest.raises(TypeError):
        kernels.weiszfeld_step(w.double(), guess)
    with pytest.raises(ValueError):
        kernels.weiszfeld_step(w.t(), guess)  # not contiguous
    with pytest.raises(ValueError):
        kernels.weiszfeld_step(w, guess.cpu())
    with pytest.raises(ValueError):
        kernels.aircomp_weiszfeld_step(w, guess, h_sq[:-1], s)


def test_chunked_solve_equals_per_step_on_the_card(cuda):
    w, guess, _, _ = _stack(60, 7850, torch.float32, cuda)
    before = kernels.LAUNCHES["weiszfeld_step"]
    out_1, n_1 = aggregators.gm2_solve(w, guess=guess, maxiter=300, tol=1e-6, chunk=1)
    assert kernels.LAUNCHES["weiszfeld_step"] - before == n_1  # one launch per step
    out_16, n_16 = aggregators.gm2_solve(w, guess=guess, maxiter=300, tol=1e-6)
    assert n_1 == n_16 and torch.equal(out_1, out_16)


NOISE_SCALE = torch.sqrt(torch.tensor(1e-2, dtype=torch.float32) / 2.0)


def _fused_args(k, d, dtype, cuda, air):
    """A stack, a fresh loop state and (for gm) the step's draws."""
    w, guess, _, _ = _stack(k, d, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(k + d)
    state = (torch.ones((), dtype=torch.int32, device=cuda),
             torch.zeros((), dtype=torch.int64, device=cuda))
    if not air:
        return w, guess, state, {}
    draws = dict(
        h_r=torch.randn(k, device=cuda, generator=g),
        h_i=torch.randn(k, device=cuda, generator=g),
        scaler=kernels.guess_rms(guess),
        fade_scale=1 / 2**0.5,
        z=torch.randn(d + 1, device=cuda, generator=g),
        noise_scale=NOISE_SCALE,
    )
    return w, guess, state, draws


def _fused(air, w, g_in, g_out, active, steps, tol, draws):
    """The fused step on fresh copies of the state; (g, active, steps, scaler)."""
    active, steps = active.clone(), steps.clone()
    if not air:
        return (*kernels.weiszfeld_step_fused(w, g_in, g_out, active, steps, tol), None)
    draws = dict(draws, scaler=draws["scaler"].clone())
    h_r, h_i, scaler = draws.pop("h_r"), draws.pop("h_i"), draws.pop("scaler")
    return kernels.aircomp_weiszfeld_step_fused(
        w, g_in, g_out, active, steps, tol, h_r, h_i, scaler, **draws)


def _fused_ref(air, w, g_in, active, steps, tol, draws):
    if not air:
        return (*kernels.weiszfeld_step_fused_ref(w, g_in, active, steps, tol), None)
    draws = dict(draws)
    h_r, h_i, scaler = draws.pop("h_r"), draws.pop("h_i"), draws.pop("scaler")
    return kernels.aircomp_weiszfeld_step_fused_ref(
        w, g_in, active, steps, tol, h_r, h_i, scaler, **draws)


# d = 7850, 301 and 9001: every other row starts off a 16-byte boundary
# (f32 and bf16); K = 2000: 15-16 rows per block.  Rows wider than 8192
# columns split across blocks, with a grid barrier between the distances
# and the weighted sums: d = 9001 in 2 tiles, 16500 in 3; at (300, 9001)
# a block's rows do not fit its registers at once and are read again.
@pytest.mark.parametrize("air", [False, True], ids=["gm2", "gm"])
@pytest.mark.parametrize("k,d,dtype", [
    (50, 7850, torch.float32), (50, 7850, torch.bfloat16),
    (13, 301, torch.bfloat16), (2000, 7850, torch.float32), (1, 1, torch.float32),
    (1000, 7850, torch.bfloat16), (13, 9001, torch.bfloat16),
    (50, 16500, torch.float32), (300, 9001, torch.float32),
])
def test_fused_step_matches_plain_version(cuda, k, d, dtype, air):
    w, guess, (active, steps), draws = _fused_args(k, d, dtype, cuda, air)
    name = "aircomp_weiszfeld_step" if air else "weiszfeld_step"
    for tol in (0.0, 1e9):  # the step stays active / stops
        before = kernels.LAUNCHES[name]
        g_out = torch.empty_like(guess)
        got = _fused(air, w, guess, g_out, active, steps, tol, draws)
        want = _fused_ref(air, w, guess, active, steps, tol, draws)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES[name] == before + 1
        assert got[0].data_ptr() == g_out.data_ptr()
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-6)
        assert int(got[1]) == int(want[1])
        if tol > 0:
            assert int(got[1]) == 0
        assert int(got[2]) == int(want[2]) == 1
        if air:
            torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=1e-6)
        again = _fused(air, w, guess, torch.empty_like(guess), active, steps, tol, draws)
        assert all(torch.equal(a, b) for a, b in zip(again, got) if a is not None)


@pytest.mark.parametrize("air", [False, True], ids=["gm2", "gm"])
def test_inactive_fused_step_leaves_the_state_bitwise(cuda, air):
    w, guess, (active, steps), draws = _fused_args(50, 7850, torch.float32, cuda, air)
    active.zero_()
    steps.fill_(7)
    g_out = torch.full_like(guess, float("nan"))
    got = _fused(air, w, guess, g_out, active, steps, 0.0, draws)
    torch.cuda.synchronize()
    assert _same_bits(got[0], guess)
    assert int(got[1]) == 0 and int(got[2]) == 7
    if air:
        assert _same_bits(got[3], draws["scaler"])


def test_fused_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w, guess, (active, steps), draws = _fused_args(8, 64, torch.float32, cuda, True)
    with pytest.raises(ValueError):
        kernels.weiszfeld_step_fused(w, guess, guess, active, steps, 0.0)  # in place
    with pytest.raises(ValueError):
        kernels.weiszfeld_step_fused(w, guess, torch.empty_like(guess), active.bool(), steps, 0.0)
    with pytest.raises(ValueError):
        _fused(True, w, guess, torch.empty_like(guess), active, steps, 0.0,
               dict(draws, z=draws["z"][:-1]))


@pytest.mark.parametrize("noise_var", [None, 1e-2])
def test_gm_chunked_solve_equals_per_step_on_the_card(cuda, noise_var):
    w, guess, _, _ = _stack(60, 7850, torch.float32, cuda)
    outs = []
    for chunk in (1, 16):
        before = kernels.LAUNCHES["aircomp_weiszfeld_step"]
        gen = torch.Generator(device=cuda).manual_seed(5)
        outs.append(aggregators.gm_solve(w, guess=guess, noise_var=noise_var, maxiter=200,
                                         tol=2e-3, generator=gen, chunk=chunk))
        if chunk == 1:  # one launch per Weiszfeld step, nothing else
            assert kernels.LAUNCHES["aircomp_weiszfeld_step"] - before == outs[0][1]
    assert outs[0][1] == outs[1][1] and torch.equal(outs[0][0], outs[1][0])
    assert torch.isfinite(outs[0][0]).all()


def _select_inputs(k, d, cuda, adversarial=True, seed=0):
    from byzantine_aircomp_tpu_torch.ops import channel

    g = torch.Generator(device=cuda).manual_seed(seed + k * d)
    w = 0.01 * torch.randn(1, d, device=cuda, generator=g) + 1e-3 * torch.randn(
        k, d, device=cuda, generator=g
    )
    if adversarial and k >= 12:
        w[1] = float("inf")
        w[2] = float("-inf")
        w[4] = float("nan")  # a positive NaN row
        w[5, : d // 2] = 0.0
        w[6, : d // 2] = -0.0
        w[7] = w[8]  # ties
        w[9, ::3] = w[10, ::3]
    terms = channel.oma_terms(k, d, 1e-2, generator=g, device=cuda)
    return w.contiguous(), channel.OmaTerms(*(t.contiguous() for t in terms))


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _tie_stack(k, d, cuda, seed=0):
    """A stack drawn from a few values whose keys tie often and differ only
    in their first or their last 8-bit digit (or straddle one), with +-0,
    +-Inf and a positive NaN among them."""
    bits = torch.tensor([
        0x3F800000, 0x3F7FFFFF, 0x3F800001, 0x3F8000FF, 0x3F800100, 0x3F810000,
        0x3FFFFFFF, 0x40000000, 0xBF800000, 0xBF800001, 0x00000000, 0x80000000,
        0x7F800000, 0xFF800000, 0x7FC00000, 0x00FFFFFF, 0x01000000,
    ], dtype=torch.int64).to(torch.int32)
    vals = bits.view(torch.float32).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed + k * d)
    idx = torch.randint(0, vals.numel(), (k, d), device=cuda, generator=g)
    if d > 1:
        idx[:, 0] = 0  # an all-equal column
    return vals[idx].contiguous()


def _check_select(w, ch, b):
    med = kernels.fused_median(w, ch)
    assert _same_bits(med, kernels.fused_median_ref(w, ch))
    assert _same_bits(kernels.fused_median(w, ch), med)  # rerun
    tm = kernels.fused_trimmed_mean(w, b, ch)
    ref = kernels.fused_trimmed_mean_ref(w, b, ch)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(tm), fin)
    assert _same_bits(tm[~fin], ref[~fin])
    torch.testing.assert_close(tm[fin], ref[fin], rtol=1e-5, atol=1e-5)
    assert _same_bits(kernels.fused_trimmed_mean(w, b, ch), tm)  # rerun


# K <= 64 ranks by count in registers (path 0); up to ~3470 rows the keys
# of a 16-column strip fit shared memory (path 1); at (4000, 300) they do
# not, and the kernel selects from a global scratch of keys (path 2)
# (30, 7850): bulyan's median of its theta rows at K=50; (50, 1) and
# (1000, 1): cclip's median of the client delta norms
@pytest.mark.parametrize("k,d,path", [
    (13, 300, 0), (50, 7850, 0), (1000, 7850, 1), (2000, 300, 1), (1, 7850, 0),
    (2, 300, 0), (64, 300, 0), (65, 300, 1), (2000, 7850, 1), (4000, 300, 2),
    (30, 7850, 0), (50, 1, 0), (1000, 1, 1),
])
def test_select_columns_matches_plain_versions(cuda, k, d, path):
    w, terms = _select_inputs(k, d, cuda)
    b = int(0.1 * k)
    assert kernels.select_plan(w.device, k, d)["path"] == path
    before = kernels.LAUNCHES["select_columns"]
    for ch in (None, terms):
        _check_select(w, ch, b)
    assert kernels.LAUNCHES["select_columns"] == before + 8


@pytest.mark.parametrize("k,d,b", [
    (3, 40, 1), (50, 300, 5), (64, 300, 0), (65, 300, 6), (300, 257, 30), (1000, 300, 100),
    (1000, 300, 499), (4000, 99, 400),
])
def test_select_columns_ties_across_digits(cuda, k, d, b):
    w = _tie_stack(k, d, cuda)
    _check_select(w, None, b)


def test_select_columns_channel_fold_equals_oma_first(cuda):
    from byzantine_aircomp_tpu_torch.ops import channel

    w, terms = _select_inputs(50, 7850, cuda, adversarial=False)
    two_pass = kernels.fused_median(channel.oma(w, 1e-2, terms=terms))
    assert _same_bits(kernels.fused_median(w, terms), two_pass)


@pytest.mark.parametrize("k,d", [(13, 300), (50, 7850), (1000, 7850), (70, 33), (1, 1),
                                 (3000, 1000)])
def test_packed_vote_counts_matches_plain_version(cuda, k, d):
    g = torch.Generator(device=cuda).manual_seed(k + d)
    w_cnt = -(-d // 32)
    words = torch.randint(-(2**31), 2**31 - 1, (k, w_cnt), dtype=torch.int32,
                          device=cuda, generator=g)
    words[0] = -1  # every bit set, bit 31 included
    words[min(1, k - 1)] = 0  # a non-finite client's row (the only row at K=1)
    before = kernels.LAUNCHES["packed_vote_counts"]
    got = kernels.packed_vote_counts(words, d)
    assert torch.equal(got, kernels.packed_vote_counts_ref(words, d))
    assert torch.equal(kernels.packed_vote_counts(words, d), got)
    assert kernels.LAUNCHES["packed_vote_counts"] == before + 2


def test_packed_vote_counts_is_one_kernel_and_no_memset(cuda):
    from torch.profiler import ProfilerActivity, profile

    words = torch.randint(-(2**31), 2**31 - 1, (1000, 246), dtype=torch.int32, device=cuda)
    kernels.packed_vote_counts(words, 7850)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernels.packed_vote_counts(words, 7850)
        torch.cuda.synchronize()
    device = [ev.name for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1 and "count_kernel" in device[0], device


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w, terms = _select_inputs(20, 64, cuda, adversarial=False)
    with pytest.raises(ValueError):
        kernels.fused_median(w.double())
    with pytest.raises(ValueError):
        kernels.fused_median(w, terms._replace(n_r=terms.n_r[:, :-1].contiguous()))
    with pytest.raises(ValueError):
        kernels.fused_trimmed_mean(w, 10)
    with pytest.raises(ValueError):
        kernels.packed_vote_counts(torch.zeros(4, 3, dtype=torch.int32, device=cuda), 200)


def _tied_stack(k, d, cuda):
    """A stack whose rows spread from the center by 1e-3 to 3e-3 in index
    order, whose last three rows are equal (their Krum scores tie), with
    one non-finite row, and its pre-round params.  The graded spread keeps
    the K Krum scores well apart: with equal spreads, at K=1000 adjacent
    scores sit closer than the f32 rounding by which cuBLAS's Gram product
    and the CPU's differ, and the rows picked at the selection boundary
    are then the device's choice."""
    g = torch.Generator(device=cuda).manual_seed(k * d)
    spread = 1e-3 * (1.0 + 2.0 * torch.arange(k, device=cuda) / k)
    w = 0.01 * torch.randn(1, d, device=cuda, generator=g) + spread[:, None] * torch.randn(
        k, d, device=cuda, generator=g)
    w[k // 2, d // 3] = float("nan")
    w[-3:] = w[-3].clone()
    guess = w[torch.isfinite(w).all(dim=1)].mean(dim=0).contiguous()
    return w.contiguous(), guess


def _picked_rows(w, idx):
    """The picked rows in index order: equal rows picked in another order
    (cuBLAS may score equal rows a few ulp apart) are the same rows."""
    return w.cpu()[torch.sort(idx.cpu()).values]


@pytest.mark.parametrize("k", [50, 1000])
def test_selection_rules_on_the_card_equal_the_cpu(cuda, k):
    """multi_krum, bulyan and bev at one bit on one stack with ties.  The
    card picks the CPU's rows (Krum's theta and m winners compared by their
    bits), and bev's +-eta step is the CPU's bit for bit.  The means over
    the picked rows agree within 1e-6: cuBLAS and the CPU's BLAS sum the
    [K]-weight matvec, and CUDA and the CPU reduce bulyan's beta values, in
    other orders."""
    w, guess = _tied_stack(k, 7850, cuda)
    honest = int(0.8 * k)
    theta = k - 2 * (k - honest)
    for m, scores in ((honest, aggregators.krum_scores),
                      (theta, aggregators.krum_scores),
                      (honest, aggregators.krum_scores_degraded)):
        on_card = aggregators.lowest(scores(w, honest), m)
        on_cpu = aggregators.lowest(scores(w.cpu(), honest), m)
        assert _same_bits(_picked_rows(w, on_card), _picked_rows(w, on_cpu))
    for name, fn in (
        ("multi_krum", lambda t, g: aggregators.multi_krum(t, honest_size=honest)),
        ("bulyan", lambda t, g: aggregators.bulyan(t, honest_size=honest)),
        ("bev1", lambda t, g: aggregators.best_effort_voting(
            t, guess=g, sign_bits=1, sign_eta=0.01)),
        ("multi_krum_degraded", lambda t, g: aggregators.multi_krum(
            t, honest_size=honest, degraded=True)),
    ):
        before = dict(kernels.LAUNCHES)
        on_card = fn(w, guess)
        after = dict(kernels.LAUNCHES)
        on_cpu = fn(w.cpu(), guess.cpu())
        if name == "bev1":
            assert _same_bits(on_card.cpu(), on_cpu), name
            assert after["packed_vote_counts"] == before["packed_vote_counts"] + 1
        else:
            torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=1e-6)
        if name == "bulyan":  # its median of the theta rows is the kernel's
            assert after["select_columns"] == before["select_columns"] + 1


def test_cclip_launches_one_select_per_step_at_d_1(cuda):
    w, guess = _tied_stack(50, 7850, cuda)
    before = kernels.LAUNCHES["select_columns"]
    got = aggregators.centered_clip(w, guess=guess, clip_iters=3)
    assert kernels.LAUNCHES["select_columns"] == before + 3
    torch.testing.assert_close(got.cpu(), aggregators.centered_clip(
        w.cpu(), guess=guess.cpu(), clip_iters=3), rtol=0, atol=1e-6)


def test_chaos_round_on_the_card_keeps_params_finite(cuda):
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = datasets.load("mnist", synthetic_train=2000, synthetic_val=200)
    cfg = FedConfig(honest_size=40, byz_size=10, attack="classflip", agg="gm2",
                    display_interval=5, fault="chaos", fade_floor=0.3, corrupt_prob=0.5)
    tr = Trainer(cfg, dataset=ds, device="cuda")
    before = kernels.LAUNCHES["weiszfeld_step"]
    tr.run_round(0)
    assert kernels.LAUNCHES["weiszfeld_step"] > before
    assert torch.isfinite(tr.flat_params).all()
    dropped, erased, corrupt, eff_k = tr.last_fault_metrics.tolist()
    assert erased > 0 and corrupt > 0 and eff_k < cfg.node_size


# the EMNIST MLP's width (784 x 62 + 62): rows split across 6 blocks in the
# Weiszfeld steps, 1521 words per client in the popcount
EMNIST_D = 48670


@pytest.mark.parametrize("k", [50, 1000])
def test_kernels_at_emnist_width(cuda, k):
    d = EMNIST_D
    w, guess, h_sq, s = _stack(k, d, torch.float32, cuda, bad=float("inf"))
    for kern, ref, args in (
        (kernels.weiszfeld_step, kernels.weiszfeld_step_ref, (w, guess)),
        (kernels.aircomp_weiszfeld_step, kernels.aircomp_weiszfeld_step_ref,
         (w, guess, h_sq, s, 1.0)),
    ):
        num_k, den_k = kern(*args)
        num_r, den_r = ref(*args)
        torch.testing.assert_close(num_k, num_r, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(den_k, den_r, rtol=1e-4, atol=1e-6)
    for air in (False, True):
        w, guess, (active, steps), draws = _fused_args(k, d, torch.float32, cuda, air)
        for tol in (0.0, 1e9):
            got = _fused(air, w, guess, torch.empty_like(guess), active, steps, tol, draws)
            want = _fused_ref(air, w, guess, active, steps, tol, draws)
            torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-6)
            assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2]) == 1
    w, terms = _select_inputs(k, d, cuda)
    for ch in (None, terms):
        _check_select(w, ch, int(0.1 * k))
    g = torch.Generator(device=cuda).manual_seed(k)
    words = torch.randint(-(2**31), 2**31 - 1, (k, -(-d // 32)), dtype=torch.int32,
                          device=cuda, generator=g)
    words[1] = 0
    assert torch.equal(kernels.packed_vote_counts(words, d),
                       kernels.packed_vote_counts_ref(words, d))


def test_message_attacks_need_no_host_sync_on_the_card(cuda):
    """The static message attacks (minmax's and minsum's 25 bisection steps
    included) read nothing back to the host, and agree with the CPU."""
    from byzantine_aircomp_tpu_torch.ops import attacks

    g = torch.Generator(device=cuda).manual_seed(3)
    w = 0.1 * torch.randn(50, 7850, device=cuda, generator=g)
    noise = torch.randn(10, 7850, device=cuda, generator=g)
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {name: attacks.resolve(name).apply_message(
                    w, 10, None, noise=noise if name == "gaussian" else None)
                for name in ("signflip", "gaussian", "alie", "ipm", "minmax", "minsum")}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for name, out in outs.items():
        want = attacks.resolve(name).apply_message(
            w.cpu(), 10, None, noise=noise.cpu() if name == "gaussian" else None)
        torch.testing.assert_close(out.cpu(), want, rtol=0, atol=1e-5)
