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
@pytest.mark.parametrize("k,d", [(13, 300), (1000, 7850), (1, 1), (50, 16500),
                                 (13, 1081345), (50, 3274634)])
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


def test_wide_plan_reads_twice_with_a_small_workspace(cuda):
    """Past SMs x 8192 columns (kTileMax in weiszfeld_common.cuh) the step
    takes the wide plan, which reads the stack twice: its workspace holds
    K x tiles partials, where the one-pass plan holds a slice's num, d
    floats, per slice."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    tile_max = 16 * 512
    edge = sms * tile_max
    lib = kernels._LIBS["weiszfeld_step"]
    assert lib.weiszfeld_workspace_bytes(1, edge) >= 4 * edge  # one pass
    assert 0 < lib.weiszfeld_workspace_bytes(1, edge + 1) < 4 * edge  # wide
    for k, d in ((50, 3274634), (50, 11173962), (1000, 11173962)):
        tiles = -(-(-(-d // tile_max)) // sms) * sms
        assert 0 < lib.weiszfeld_workspace_bytes(k, d) <= 12 * k * tiles + 4 * k + 16 * sms + 64


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


@pytest.mark.parametrize("d", [7850, 1081345])
def test_chunked_solve_equals_per_step_on_the_card(cuda, d):
    w, guess, _, _ = _stack(60, d, torch.float32, cuda)
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
    (13, 1081345, torch.bfloat16), (50, 3274634, torch.float32),
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


@pytest.mark.parametrize("k,d,path", [(250, 7850, 1), (50, 3274634, 0)])
def test_select_columns_at_the_option_runs_shapes(cuda, k, d, path):
    """Run (v)'s 250 bucket means at d = 7850 and run (y)'s CNN width."""
    w, terms = _select_inputs(k, d, cuda)
    assert kernels.select_plan(w.device, k, d)["path"] == path
    for ch in (None, terms):
        _check_select(w, ch, int(0.1 * k))


def _option_iteration(cfg_kw, prepare=None):
    """One iteration of a training-option or defense config on the card and
    on the CPU from the same params and draws; returns both new params and
    the card trainer."""
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.ops import channel

    ds = datasets.load("mnist", synthetic_train=2000, synthetic_val=200)
    cfg = FedConfig(**cfg_kw)
    cpu = Trainer(cfg, dataset=ds, device="cpu")
    gpu = Trainer(cfg, dataset=ds, device="cuda", params=cpu.flat_params)
    for t in (cpu, gpu):
        if prepare is not None:
            prepare(t)
    g = torch.Generator().manual_seed(5)
    m_h, m_b = cfg.participant_counts()
    m = m_h + m_b
    draws = {"u": torch.rand(m, cfg.local_steps * cfg.batch_size, generator=g),
             "oma": channel.oma_terms(m, cpu.dim, 1e-2, generator=g)}
    if cfg.participation < 1.0:
        draws["part"] = cpu.draw_participants(g)
    if cfg.bucket_size > 1:
        draws["bucket"] = torch.randperm(m, generator=g)
    new_cpu, _ = cpu.iteration(cpu.flat_params, draws=draws)
    on_card = {key: (channel.OmaTerms(*(x.cuda() for x in v)) if key == "oma" else v.cuda())
               for key, v in draws.items()}
    new_gpu, _ = gpu.iteration(gpu.flat_params, draws=on_card)
    torch.cuda.synchronize()
    return new_cpu, new_gpu.cpu(), gpu


def test_participation_buckets_median_var_on_the_card_equal_the_cpu(cuda):
    before = kernels.LAUNCHES["select_columns"]
    new_cpu, new_gpu, _ = _option_iteration(dict(
        agg="median", attack="signflip", noise_var=1e-2, honest_size=36, byz_size=4,
        participation=0.5, bucket_size=2))
    assert kernels.LAUNCHES["select_columns"] == before + 1
    torch.testing.assert_close(new_gpu, new_cpu, rtol=0, atol=1e-4)


def test_client_momentum_cclip_on_the_card_equals_the_cpu(cuda):
    before = kernels.LAUNCHES["select_columns"]
    new_cpu, new_gpu, gpu = _option_iteration(dict(
        agg="cclip", attack="alie", honest_size=40, byz_size=10, client_momentum=0.9,
        server_opt="momentum"))
    assert kernels.LAUNCHES["select_columns"] == before + 3
    assert gpu.client_m.shape == (50, 7850) and bool(torch.isfinite(gpu.client_m).all())
    torch.testing.assert_close(new_gpu, new_cpu, rtol=0, atol=1e-4)


def test_adaptive_rung_one_launches_select_columns(cuda):
    """The adaptive defense at rung 1 aggregates with trimmed_mean:
    select_columns on the card, within 1e-4 of the CPU."""
    def rung_one(t):
        det, (rung, up, down, budget) = t.defense_state
        t.defense_state = (det, (torch.ones_like(rung), up, down, budget))

    before = kernels.LAUNCHES["select_columns"]
    new_cpu, new_gpu, gpu = _option_iteration(dict(
        agg="mean", attack="signflip", defense="adaptive", honest_size=40, byz_size=10),
        prepare=rung_one)
    assert kernels.LAUNCHES["select_columns"] == before + 1
    torch.testing.assert_close(new_gpu, new_cpu, rtol=0, atol=1e-4)
    assert gpu.iteration_defense_metrics.shape == (5,)


def test_defense_aware_attacks_need_no_host_sync_on_the_card(cuda):
    """under_radar's 25 bisection steps, mimic and duty_cycle read nothing
    back to the host, and agree with the CPU within 1e-5."""
    from byzantine_aircomp_tpu_torch import defense
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.ops import attacks

    spec = defense.from_config(FedConfig(defense="adaptive", agg="mean"))
    g = torch.Generator(device=cuda).manual_seed(4)
    guess = 0.1 * torch.randn(7850, device=cuda, generator=g)
    w = guess + 0.01 * torch.randn(50, 7850, device=cuda, generator=g)

    def view(dev):
        gen = torch.Generator().manual_seed(1)
        return attacks.DefenseView(
            step=torch.tensor(9, dtype=torch.int32, device=dev),
            ema=torch.rand(50, generator=gen).to(dev),
            dev=(0.1 + torch.rand(50, generator=gen)).to(dev),
            cusum=(3 * torch.rand(50, generator=gen)).to(dev),
            rung=torch.tensor(0, dtype=torch.int32, device=dev),
            detector=spec.detector, policy=spec.policy, guess=guess.to(dev))

    card_view = view(cuda)  # made before the guard: a copy to the card syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = {name: attacks.resolve(name).apply_message(w, 10, None, defense=card_view)
                for name in ("mimic", "under_radar", "duty_cycle")}
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for name, out in outs.items():
        want = attacks.resolve(name).apply_message(w.cpu(), 10, None, defense=view("cpu"))
        torch.testing.assert_close(out.cpu(), want, rtol=1e-5, atol=1e-5)


def test_oma_by_id_on_the_card(cuda):
    """The per-id link's integer draws are the CPU's bit for bit, its normals
    within a few ULP (log, cos and sin are the card's own), and a chunked
    application is bitwise the resident one on the card too."""
    from byzantine_aircomp_tpu_torch.ops import channel

    ids = torch.tensor([3, 40, 7, 3, 11, 12, 0, 47], device=cuda)
    key = 0x1234_5678_9ABC
    assert torch.equal(channel.link_row_words(key, ids).cpu(),
                       channel.link_row_words(key, ids.cpu()))
    card = channel.oma_by_id_terms(key, ids, 7850, 1e-2)
    host = channel.oma_by_id_terms(key, ids.cpu(), 7850, 1e-2)
    for a, b in zip(card, host):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    w = torch.randn(8, 7850, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    full = channel.oma_by_id(w, ids, 1e-2, key=key)
    chunks = torch.cat([channel.oma_by_id(w[c:c + 2], ids[c:c + 2], 1e-2, key=key)
                        for c in range(0, 8, 2)])
    assert torch.equal(full, chunks)


def test_degraded_trimmed_mean_reads_the_trim_ratio_on_the_device(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    w = torch.randn(50, 7850, device=cuda, generator=g)
    w[[3, 30]] = float("nan")
    widen = torch.tensor(2.25, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ratio = torch.clamp(torch.tensor(0.1, dtype=torch.float32) * widen, max=0.45)
        out = aggregators.trimmed_mean(w, degraded=True, trim_ratio=ratio)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = aggregators.trimmed_mean(w.cpu(), degraded=True, trim_ratio=ratio.cpu())
    torch.testing.assert_close(out.cpu(), want, rtol=0, atol=1e-6)


def test_stream_gm2_launches_the_kernel_per_chunk_per_step(cuda):
    """The streamed gm2 launches ``weiszfeld_step`` (num/den mode) once per
    chunk per Weiszfeld step and agrees with its plain version on the CPU
    and with the resident solve."""
    g = torch.Generator(device=cuda).manual_seed(3)
    w = 0.01 * torch.randn(1, 7850, device=cuda, generator=g) + 1e-3 * torch.randn(
        400, 7850, device=cuda, generator=g)
    w[[5, 250]] = float("nan")
    chunks = w.reshape(4, 100, 7850)
    guess = torch.zeros(7850, device=cuda)
    before = kernels.LAUNCHES["weiszfeld_step"]
    got, steps = aggregators.stream_gm2_solve(lambda c: chunks[c], k=400, d=7850, n_chunks=4,
                                              device=cuda, guess=guess, maxiter=200, tol=1e-6)
    assert kernels.LAUNCHES["weiszfeld_step"] - before == 4 * steps and steps > 1
    host = chunks.cpu()
    want, steps_cpu = aggregators.stream_gm2_solve(lambda c: host[c], k=400, d=7850,
                                                   n_chunks=4, device="cpu",
                                                   guess=guess.cpu(), maxiter=200, tol=1e-6)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
    resident = aggregators.gm2(w, guess=guess, maxiter=200, tol=1e-6)
    torch.testing.assert_close(got, resident, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", cohort_size=5, noise_var=1e-2),
    dict(agg="median", cohort_size=5),
    # a few steps: a noisy gm solve at a small K random-walks, and two
    # devices' last bits part within tens of steps
    dict(agg="gm", noise_var=1e-2, agg_maxiter=5),
], ids=["streamed_gm2_var", "streamed_median", "resident_gm_var"])
def test_service_iteration_on_the_card_equals_the_cpu(cuda, kw):
    """One service iteration (straggler deadline, per-id link) on the card
    and on the CPU from the same params and draws (the link's key is a
    seed, the same on both), within 1e-4."""
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = datasets.load("mnist", synthetic_train=2000, synthetic_val=200)
    cfg = FedConfig(honest_size=15, byz_size=5, attack="signflip", service="on",
                    population=100, straggler_prob=0.2, **kw)
    cpu = Trainer(cfg, dataset=ds, device="cpu")
    gpu = Trainer(cfg, dataset=ds, device="cuda", params=cpu.flat_params)
    g = torch.Generator().manual_seed(6)
    draws = {"u": torch.rand(20, cfg.batch_size, generator=g),
             "service_u": (torch.rand(75, generator=g), torch.rand(25, generator=g)),
             "churn": (torch.rand(100, generator=g) < 0.5, torch.rand(100, generator=g) < 0.5),
             "late": torch.rand(20, generator=g) < 0.2}
    if cfg.agg == "gm":  # gm's per-step fades and receiver noise
        draws["fades"] = tuple(0.7071 * torch.randn(5, 20, generator=g) for _ in range(2))
        draws["noise"] = torch.randn(5, 7851, generator=g)
    gens = cpu.iteration_generators(0, 0)._replace(batch=None, draw=None, churn=None,
                                                   deadline=None, cohort=None)
    new_cpu, _ = cpu.iteration(cpu.flat_params, gens, draws=draws)
    gens_gpu = gpu.iteration_generators(0, 0)._replace(batch=None, draw=None, churn=None,
                                                       deadline=None, cohort=None)
    card = {key: (tuple(x.cuda() for x in v) if isinstance(v, tuple) else v.cuda())
            for key, v in draws.items()}
    new_gpu, _ = gpu.iteration(gpu.flat_params, gens_gpu, draws=card)
    torch.cuda.synchronize()
    assert gens.link_key == gens_gpu.link_key
    torch.testing.assert_close(new_gpu.cpu(), new_cpu, rtol=0, atol=1e-4)
    assert torch.equal(gpu.iteration_service_metrics.cpu(), cpu.iteration_service_metrics)


# ---------------------------------------------------------------------------
# multi-round dispatch: each round one replay of a CUDA graph of the round


def _dispatch_ds():
    from byzantine_aircomp_tpu_torch.data import datasets

    return datasets.load("mnist", synthetic_train=20000, synthetic_val=1000)


def _bits_equal(a, b):
    """Two float lists equal bit for bit, NaN included."""
    import struct

    return len(a) == len(b) and all(
        struct.pack("<d", x) == struct.pack("<d", y) for x, y in zip(a, b))


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", honest_size=900, byz_size=100),
    dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10),
    dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10),
    dict(agg="mean", attack="signflip", defense="monitor", honest_size=40, byz_size=10),
    dict(agg="gm2", local_steps=2, fedprox_mu=0.01, server_opt="adam", server_lr=0.01,
         honest_size=40, byz_size=10),
    dict(agg="trimmed_mean", noise_var=1e-2, attack="gradascent@1", client_momentum=0.9,
         server_opt="momentum", honest_size=40, byz_size=10),
    dict(agg="median", noise_var=1e-2, model="ResNet18", resnet_width=8, honest_size=8,
         byz_size=2),
    dict(agg="gm2", model="resnet18", resnet_width=8, remat=True, honest_size=8, byz_size=2),
], ids=["gm2_K1000", "gm_var_K50", "median_var_K50", "mean_monitor", "gm2_fedavg_prox_adam",
        "trimmed_mean_onset_client_momentum", "resnet18_median_var", "resnet18_remat_gm2"])
def test_graphed_dispatch_is_bitwise_the_eager_dispatch(cuda, kw):
    """Two rounds in one dispatch, replayed from one CUDA graph and run
    eagerly (``graphs=False``) from the same seed: every round's variance
    (and defense rows), the evals and the final params bit for bit, and the
    run's kernel launched from the graph."""
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = _dispatch_ds()
    cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=2, rounds_per_dispatch=2,
                    display_interval=5, eval_train=False)
    graphed = Trainer(cfg, dataset=ds, device="cuda")
    eager = Trainer(cfg, dataset=ds, device="cuda", graphs=False)
    assert graphed.dispatch_graph[0] and not eager.dispatch_graph[0]
    before = dict(kernels.LAUNCHES)
    pg = graphed.train()
    launched = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    before = dict(kernels.LAUNCHES)
    pe = eager.train()
    torch.cuda.synchronize()
    eager_launched = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    rg = graphed.round_graph
    assert rg.captures == 1 and rg.replays == 2 and eager.round_graph is None
    assert set(pg) == set(pe)
    for key in pg:
        if key != "roundsPerSec":
            assert _bits_equal(pg[key], pe[key]), (key, pg[key], pe[key])
    assert torch.equal(graphed.flat_params, eager.flat_params)
    # the warm-up round's launches and two replays' (the capture's own are
    # taken back out); gm runs all agg_maxiter steps in the graph, gm2's
    # loop bodies the eager loop's chunks, counted on the device
    kernel = {"gm2": "weiszfeld_step", "gm": "aircomp_weiszfeld_step",
              "median": "select_columns", "trimmed_mean": "select_columns"}.get(cfg.agg)
    if kernel == "weiszfeld_step":
        assert rg.replay_launches[kernel] == 0
        # the eager run's rounds 0 and 1, and the warm-up's round 0 again:
        # its launches are an eager round 0's
        first = Trainer(cfg, dataset=ds, device="cuda", graphs=False)
        before = kernels.LAUNCHES[kernel]
        first.run_rounds_stacked(0, 1)
        round0 = kernels.LAUNCHES[kernel] - before
        assert 0 < round0 < eager_launched[kernel]
        assert launched[kernel] == eager_launched[kernel] + round0
    elif kernel is not None:
        per_round = cfg.display_interval * (cfg.agg_maxiter if cfg.agg == "gm" else 1)
        assert rg.replay_launches[kernel] == per_round
        assert launched[kernel] >= 2 * per_round


@pytest.mark.parametrize("maxiter", [1000, 50, 16, 7])
@pytest.mark.parametrize("case", ["first_chunk", "never", "nan_rows"])
def test_graphed_gm2_solve_is_bitwise_the_chunked_loop(cuda, case, maxiter):
    """Captured in a CUDA graph, gm2's solve is a WHILE node over 16-step
    chunks and an IF node over the rest: every replay gives the chunked
    loop's guess and steps bit for bit, and ``LAUNCHES`` counts on the
    device the steps the chunked loop launched.  Cases: converging in the
    first chunk, never converging (``tol=0``) and a stack with NaN rows."""
    w, guess, _, _ = _stack(50, 7850, torch.float32, cuda)
    tol = {"first_chunk": 1.0, "never": 0.0, "nan_rows": 1e-5}[case]
    if case == "nan_rows":
        w[[3, 11, 19, 27]] = float("nan")

    def solve():
        return aggregators.gm2_solve(w, guess=guess, maxiter=maxiter, tol=tol)

    before = kernels.LAUNCHES["weiszfeld_step"]
    want, n = solve()
    eager_launched = kernels.LAUNCHES["weiszfeld_step"] - before
    assert n <= eager_launched <= maxiter
    if case == "first_chunk":
        assert n < min(16, maxiter)
    elif case == "never":
        assert n == eager_launched == maxiter
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, steps = solve()
    assert kernels.LAUNCHES["weiszfeld_step"] - before == eager_launched  # the capture's out
    for _ in range(2):
        before = kernels.LAUNCHES["weiszfeld_step"]
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want) and int(steps) == n
        assert kernels.LAUNCHES["weiszfeld_step"] - before == eager_launched


@pytest.mark.parametrize("kw,nodes", [
    (dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10), 40646),
    (dict(agg="trimmed_mean", noise_var=1e-2, honest_size=900, byz_size=100), 701),
    (dict(agg="gm2", honest_size=900, byz_size=100), None),
], ids=["gm_var_K50", "trimmed_mean_var_K1000", "gm2_K1000"])
def test_captured_round_nodes(cuda, kw, nodes):
    """The counted nodes of the benchmark's graphed rounds: gm's unrolled
    loop and the trimmed mean's round as before; gm2's loop nodes leave it
    under 1,000 (10,606 unrolled), with the spans still marked."""
    from byzantine_aircomp_tpu_torch.fed import graphs
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    cfg = FedConfig(**kw, attack="classflip", rounds=2, rounds_per_dispatch=2,
                    display_interval=10, eval_train=False)
    t = Trainer(cfg, dataset=_dispatch_ds(), device="cuda")
    t.run_rounds_stacked(0, 2)
    layout = graphs.LAST_CAPTURE
    assert layout.spans is not None and len(layout.kinds) == layout.nodes
    if nodes is None:
        assert 0 < layout.nodes < 1000
    else:
        assert layout.nodes == nodes


def test_capture_runs_with_the_cyclic_collector_off(cuda):
    """A trainer and its RoundGraph form a reference cycle, so an abandoned
    graphed trainer is freed by the cyclic collector, and a free inside
    another trainer's capture invalidates it: the capture collects first
    and runs with the collector off, and the run stays bitwise eager."""
    import gc
    import weakref

    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = _dispatch_ds()
    cfg = FedConfig(agg="median", noise_var=1e-2, attack="classflip", honest_size=40,
                    byz_size=10, rounds=2, rounds_per_dispatch=2, display_interval=5,
                    eval_train=False)
    first = Trainer(cfg, dataset=ds, device="cuda")
    first.run_rounds_stacked(0, 2)
    gone = weakref.ref(first)
    del first
    graphed = Trainer(cfg, dataset=ds, device="cuda")
    seen, run_round = [], graphed.run_round

    def watched(r):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled(),
                     gone() is None))
        return run_round(r)

    graphed.run_round = watched
    outs = graphed.run_rounds_stacked(0, 2)
    assert gc.isenabled()
    assert [s for s in seen if s[0]] == [(True, False, True)]
    eager = Trainer(cfg, dataset=ds, device="cuda", graphs=False)
    want = eager.run_rounds_stacked(0, 2)
    torch.cuda.synchronize()
    assert torch.equal(outs.variances, want.variances)
    assert torch.equal(graphed.flat_params, eager.flat_params)


def test_one_capture_per_trainer_across_dispatches_and_an_alignment(cuda, tmp_path):
    """A run resumed at round 3 under R=2 opens with a one-round alignment
    dispatch: it and the next dispatch replay the one graph, as does a
    further dispatch of the same trainer; the params at round 6 are the
    eager per-round run's bit for bit."""
    import dataclasses

    from byzantine_aircomp_tpu_torch.fed import checkpoint, harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = _dispatch_ds()
    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=40, byz_size=10, rounds=6,
                    rounds_per_dispatch=2, display_interval=5, eval_train=False)
    straight = Trainer(dataclasses.replace(cfg, rounds_per_dispatch=1), dataset=ds,
                       device="cuda")
    straight.train()
    cut = dataclasses.replace(cfg, rounds=3, rounds_per_dispatch=1,
                              checkpoint_dir=str(tmp_path))
    harness.run_with_trainer(cut, device="cuda", record_in_file=False, dataset=ds)
    t = Trainer(cfg, dataset=ds, device="cuda")
    start = harness.restore_trainer(t, checkpoint.load(str(tmp_path), harness.ckpt_title(cut)))
    lines = []
    t.train(log_fn=lines.append, start_round=start)
    assert start == 3 and ["dispatch: 1" in lines[1], "dispatch: 2" in lines[2]] == [True] * 2
    assert t.round_graph.captures == 1 and t.round_graph.replays == 3
    assert torch.equal(t.flat_params, straight.flat_params)
    t.run_rounds_stacked(6, 2)
    assert t.round_graph.captures == 1 and t.round_graph.replays == 5


def test_reseeded_generators_replay_the_eager_draws(cuda):
    """Generators registered with a graph and seeded before each replay
    draw what new generators of those seeds draw eagerly, bit for bit."""
    g1, g2 = torch.Generator(device=cuda), torch.Generator(device=cuda)
    g1.manual_seed(1)
    g2.manual_seed(2)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g1)
    graph.register_generator_state(g2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.randn(10, generator=g1, device=cuda)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = (torch.randn(7851, generator=g1, device=cuda),
               torch.rand((50, 16), generator=g2, device=cuda),
               torch.randn(50, generator=g1, device=cuda))
    for seed in (11, 2**62 + 12345, 3):
        g1.manual_seed(seed)
        g2.manual_seed(seed + 1)
        graph.replay()
        e1 = torch.Generator(device=cuda).manual_seed(seed)
        e2 = torch.Generator(device=cuda).manual_seed(seed + 1)
        want = (torch.randn(7851, generator=e1, device=cuda),
                torch.rand((50, 16), generator=e2, device=cuda),
                torch.randn(50, generator=e1, device=cuda))
        for got, w in zip(out, want):
            assert torch.equal(got, w)


def test_graphed_prefetch_is_bitwise_no_prefetch(cuda):
    """``--dispatch-prefetch on`` queues the next dispatch's replays before
    folding the last one's rows (pinned copies behind an event): the
    records are bitwise those without it, but for the rate."""
    import dataclasses

    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = _dispatch_ds()
    cfg = FedConfig(agg="median", noise_var=1e-2, attack="classflip", honest_size=40,
                    byz_size=10, rounds=8, rounds_per_dispatch=2, eval_interval=8,
                    display_interval=5, eval_train=False)
    runs = [Trainer(c, dataset=ds, device="cuda") for c in
            (cfg, dataclasses.replace(cfg, dispatch_prefetch="on"))]
    paths = [t.train() for t in runs]
    for key in paths[0]:
        if key != "roundsPerSec":
            assert _bits_equal(paths[0][key], paths[1][key]), key
    assert torch.equal(runs[0].flat_params, runs[1].flat_params)
    assert [t.round_graph.replays for t in runs] == [8, 8]


def test_capture_layout_maps_a_profiled_replay_and_counts_live_steps(cuda):
    """The capture's node marks (``fed/graphs.py``): the stage ranges of the
    gm2 round are disjoint, in order and within its counted nodes, and one
    profiled replay holds exactly the counted records, kind for kind, one
    after another, besides its loop bodies' records; those hold as many
    Weiszfeld steps as ``LAUNCHES`` counted, and the replay's outputs are
    the eager round's bit for bit.  A graphed dispatch counts the live and
    launched Weiszfeld steps its eager twin counts.

    It runs in a fresh process (:func:`_capture_layout`), whose one
    profiler session is its first: in a process that profiled much before,
    torch.profiler drops some of a loop body's kernel records while the
    replay still gives the eager round's bits (``PERF.md`` §7)."""
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path[:0] = sys.argv[1:]; import test_torch_cuda as t; "
            "t.kernels.build(); t._capture_layout()")
    proc = subprocess.run([sys.executable, "-c", code, os.path.dirname(tests), tests],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-6000:]


def _capture_layout():
    """The body of the test above, run in its own process."""
    from torch.profiler import ProfilerActivity, profile

    from byzantine_aircomp_tpu_torch.fed import graphs
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.obs.span import STAGES

    ds = _dispatch_ds()
    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=40, byz_size=10, rounds=4,
                    rounds_per_dispatch=2, display_interval=5, eval_train=False)
    graphed = Trainer(cfg, dataset=ds, device="cuda")
    eager = Trainer(cfg, dataset=ds, device="cuda", graphs=False)
    graphed.run_rounds_stacked(0, 2)
    eager.run_rounds_stacked(0, 2)
    layout = graphs.LAST_CAPTURE
    assert layout.nodes == len(layout.kinds) > 0
    assert layout.warmup_seconds > 0 and layout.capture_seconds > 0
    stages = sorted((a, b, name) for name, ranges in layout.spans.items()
                    if name in STAGES for a, b in ranges)
    assert [s[2] for s in stages] == (
        ["batch", "client_step", "attack", "aggregate", "server_step"] * 5 + ["variance"])
    assert all(0 <= a <= b <= layout.nodes for a, b, _ in stages)
    assert all(b > a for a, b, name in stages if name in ("client_step", "aggregate"))
    assert all(x[1] <= y[0] for x, y in zip(stages, stages[1:]))

    # the graphed loops launch the steps that the eager chunked loops do
    live = []
    for t in (graphed, eager):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t.run_rounds_stacked(2, 2)
        live.append((kernels.live_steps(), kernels.LAUNCHES["weiszfeld_step"]))
    assert live[0] == live[1] and 0 < live[0][0] <= live[0][1] < 2 * 5 * cfg.agg_maxiter

    cpu = torch.autograd.DeviceType.CPU
    torch.cuda.synchronize()
    before = kernels.LAUNCHES["weiszfeld_step"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = graphed.run_rounds_stacked(4, 1)
        torch.cuda.synchronize()
    launched = kernels.LAUNCHES["weiszfeld_step"] - before
    # the profiled replay ran the eager round's steps, to its bits
    before = kernels.LAUNCHES["weiszfeld_step"]
    want = eager.run_rounds_stacked(4, 1)
    assert kernels.LAUNCHES["weiszfeld_step"] - before == launched > 0
    assert torch.equal(got.variances, want.variances)
    assert torch.equal(graphed.flat_params, eager.flat_params)
    events = prof.profiler.kineto_results.events()
    (launch,) = [e.correlation_id() for e in events
                 if e.device_type() == cpu and e.name().startswith("cudaGraphLaunch")]
    # the loop bodies' kernels: as many records as the bodies' runs
    body = ("step_kernel<", "wide_kernel<", "loop_condition_kernel")
    steps = [e for e in events if e.device_type() != cpu and not e.is_user_annotation()
             and any(b in e.name() for b in body[:2])]
    assert len(steps) == launched
    recs = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                   if e.device_type() != cpu and e.correlation_id() == launch
                   and not e.is_user_annotation() and not any(b in e.name() for b in body)))
    # a copy node may run as a copy kernel (``memcpy32_post``)
    kinds = "".join("c" if "memcpy" in n.lower() else "s" if "memset" in n.lower() else "k"
                    for _, _, n in recs)
    assert len(recs) == layout.nodes and kinds == layout.kinds
    # one after another, but for the ~1 us by which a node may start before
    # the last one's end is stamped (gpubench/replays.py::JITTER_NS)
    assert all(x[1] - 1500 <= y[0] for x, y in zip(recs, recs[1:]))


# ---------------------------------------------------------------------------
# observability: the event stream, forensics, the profiler and the memory
# watermarks on the card


def _forensics_cfg(**kw):
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig

    return FedConfig(**dict(dict(agg="gm2", attack="signflip", honest_size=40, byz_size=10,
                                 rounds=4, rounds_per_dispatch=2, display_interval=5,
                                 eval_train=False, defense="monitor", defense_warmup=1,
                                 forensics="full", forensics_top=8), **kw))


def test_graphed_forensics_are_bitwise_the_eager_run(cuda):
    """Each round's forensic top-M, computed inside the CUDA graph into a
    static buffer, bitwise the eager dispatch's, as are the records."""
    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = _dispatch_ds()
    cfg = _forensics_cfg()
    graphed = Trainer(cfg, dataset=ds, device="cuda")
    eager = Trainer(cfg, dataset=ds, device="cuda", graphs=False)
    assert graphed.dispatch_graph[0]
    outs_g = graphed.run_rounds_stacked(0, 2)
    outs_e = eager.run_rounds_stacked(0, 2)
    torch.cuda.synchronize()
    assert outs_g.forensic.shape == (2, 8, 11)
    assert torch.equal(outs_g.forensic, outs_e.forensic)
    assert torch.equal(outs_g.defense, outs_e.defense)
    assert harness._retrace(graphed, 2).snapshot() == dict(round_fn=0, multi_round_fn=1,
                                                           eval_fn=0)
    assert harness._retrace(eager, 2).snapshot() == dict(round_fn=1, multi_round_fn=0,
                                                         eval_fn=0)
    pg, pe = graphed.train(), eager.train()
    for key in pg:
        if key != "roundsPerSec":
            assert _bits_equal(pg[key], pe[key]), key


def test_prefetched_run_with_the_stream_on_defers_its_folds(cuda, tmp_path, monkeypatch):
    """With the stream on, a prefetched run still queues dispatch i+1
    before it reads dispatch i's rows, and adds no device sync between."""
    import dataclasses

    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed import train as train_mod

    order = []
    stacked, get = train_mod.Trainer.run_rounds_stacked, train_mod._HostRows.get
    sync = torch.cuda.synchronize

    def run_stacked(self, r, n):
        order.append(("dispatch", r))
        return stacked(self, r, n)

    def host_get(self):
        order.append(("fold",))
        return get(self)

    def counted_sync(*a, **k):
        order.append(("sync",))
        return sync(*a, **k)

    cfg = _forensics_cfg(forensics="off", defense="off", defense_warmup=5, rounds=8,
                         eval_interval=8,
                         dispatch_prefetch="on", obs_dir=str(tmp_path / "obs"),
                         cache_dir=str(tmp_path / "rec"))
    monkeypatch.setattr(train_mod.Trainer, "run_rounds_stacked", run_stacked)
    monkeypatch.setattr(train_mod._HostRows, "get", host_get)
    monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
    _, record = harness.run_with_trainer(cfg, device="cuda", dataset=_dispatch_ds())
    marks = [e for e in order if e != ("sync",)]
    i = marks.index(("dispatch", 0))
    assert marks[i:i + 4] == [("dispatch", 0), ("dispatch", 2), ("fold",), ("dispatch", 4)]
    # (the first dispatch's capture syncs; none between queueing dispatch 2
    # and folding dispatch 0)
    assert ("sync",) not in order[order.index(("dispatch", 2)):order.index(("fold",))]
    monkeypatch.undo()
    _, plain = harness.run_with_trainer(
        dataclasses.replace(cfg, obs_dir="", dispatch_prefetch="off"), device="cuda",
        dataset=_dispatch_ds())
    for key in plain:
        if key != "roundsPerSec":
            assert record[key] == plain[key] or _bits_equal(record[key], plain[key]), key


def test_device_memory_reads_the_cuda_allocator(cuda):
    from byzantine_aircomp_tpu_torch.obs import profile

    x = torch.ones(1 << 20, device=cuda)
    row = profile.device_memory(cuda)
    assert row["source"] == "device:cuda"
    assert row["peak_bytes_in_use"] >= row["bytes_in_use"] >= x.numel() * 4
    assert profile.per_device_memory()[0]["source"] == "device:cuda"


def test_profiled_run_traces_device_kernels(cuda, tmp_path):
    """A --profile-dir run on the card: the trace holds the round range and
    device kernels, the Weiszfeld kernel among them."""
    import json

    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig

    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=40, byz_size=10, rounds=2,
                    display_interval=2, eval_train=False, profile_dir=str(tmp_path / "p"),
                    profile_rounds="1:2", obs_dir=str(tmp_path / "o"),
                    cache_dir=str(tmp_path / "r"))
    harness.run_with_trainer(cfg, device="cuda", dataset=_dispatch_ds())
    trace = json.load(open(tmp_path / "p" / "trace.json"))["traceEvents"]
    kernels_seen = [ev["name"] for ev in trace if ev.get("cat") == "kernel"]
    assert kernels_seen and any("step_kernel" in n for n in kernels_seen)
    assert [ev.get("name") for ev in trace].count("round") >= 1
    (stream,) = [p for p in (tmp_path / "o").iterdir() if p.name.endswith(".events.jsonl")]
    end = [json.loads(line) for line in open(stream)][-1]
    assert end["kind"] == "run_end" and end["memory"]["source"] == "device:cuda"
    assert end["memory"]["exceeds_model"] is False


def test_whole_run_profile_of_a_graphed_run_leaves_the_capture_out(cuda, tmp_path):
    """A whole-run trace of a graphed R=2 run: the capture runs outside it
    (a segment before, one after), the segment after holds the replays'
    Weiszfeld kernels, and the run is bitwise its unprofiled twin."""
    import json
    import os

    from byzantine_aircomp_tpu_torch.fed import harness

    ds = _dispatch_ds()
    cfg = _forensics_cfg(defense="off", forensics="off", defense_warmup=5,
                         cache_dir=str(tmp_path / "r"))
    plain_t, plain = harness.run_with_trainer(cfg, device="cuda", dataset=ds)
    import dataclasses

    prof_cfg = dataclasses.replace(cfg, profile_dir=str(tmp_path / "p"),
                                   obs_dir=str(tmp_path / "o"))
    t, record = harness.run_with_trainer(prof_cfg, device="cuda", dataset=ds)
    assert torch.equal(t.flat_params, plain_t.flat_params)
    for key in plain:
        if key != "roundsPerSec":
            assert record[key] == plain[key] or _bits_equal(record[key], plain[key]), key
    paths = t.profiler.trace_paths
    assert [os.path.basename(p) for p in paths] == ["trace.json", "trace_1.json"]
    after = json.load(open(paths[1]))["traceEvents"]
    assert any("step_kernel" in ev.get("name", "") for ev in after
               if ev.get("cat") == "kernel")
    assert t.round_graph.captures == 1
    assert harness._retrace(t, cfg.rounds).snapshot()["multi_round_fn"] == 1


@pytest.mark.parametrize("rd", [1, 2], ids=["eager", "graphed"])
def test_telemetry_on_the_card_serves_live_and_leaves_the_run_bitwise(cuda, tmp_path, rd):
    """gm2 K=50 with ``--metrics-port`` (a free port) and ``--alerts
    default``, eager and graphed R=2: ``/metrics`` and ``/healthz`` scraped
    after each round's (dispatch's) fold show the round counter; the
    exporter's thread ends with the run and its port refuses; records and
    params bitwise the run without telemetry, with the kernel launched."""
    import dataclasses
    import socket
    import threading
    import urllib.request

    from byzantine_aircomp_tpu_torch.fed import harness

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    seen = []

    def scrape(r, _t):
        url = f"http://127.0.0.1:{port}"
        body = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
        total = [float(line.split()[-1]) for line in body.splitlines()
                 if line.startswith("aircomp_rounds_total ")]
        health = urllib.request.urlopen(url + "/healthz", timeout=10).read().decode()
        seen.append((r, total, '"ok": true' in health))

    ds = _dispatch_ds()
    cfg = _forensics_cfg(defense="off", forensics="off", forensics_top=8, defense_warmup=5,
                         rounds_per_dispatch=rd, cache_dir=str(tmp_path / "off"))
    plain_t, plain = harness.run_with_trainer(cfg, device="cuda", dataset=ds)
    on = dataclasses.replace(cfg, metrics_port=port, alerts="default",
                             cache_dir=str(tmp_path / "on"))
    kernels.reset_launches()
    t, record = harness.run_with_trainer(on, device="cuda", dataset=ds, on_round=scrape)
    assert kernels.LAUNCHES["weiszfeld_step"] >= cfg.rounds * cfg.display_interval
    assert (t.round_graph is not None) == (rd > 1)
    assert seen == [(r, [float(r)], True) for r in range(rd, cfg.rounds + 1, rd)]
    assert not any(th.name == "aircomp-metrics-exporter" for th in threading.enumerate())
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=5)
    assert torch.equal(t.flat_params, plain_t.flat_params)
    for key in plain:
        if key != "roundsPerSec":
            assert record[key] == plain[key] or _bits_equal(record[key], plain[key]), key


# ---------------------------------------------------------------------------
# the implementation knobs: --agg-impl, --stack-dtype


def _impl_iteration(cfg_kw, impl):
    """One iteration of a fresh trainer at ``impl`` from the seeded params
    and one set of draws: (trainer, new params, the four wrappers' launch
    counts)."""
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    cfg = FedConfig(**dict(dict(attack="classflip", display_interval=1, batch_size=16),
                           **cfg_kw), agg_impl=impl)
    t = Trainer(cfg, dataset=_dispatch_ds(), device="cuda")
    gens = t.iteration_generators(0, 0)
    before = dict(kernels.LAUNCHES)
    new, _ = t.iteration(t.flat_params, gens)
    torch.cuda.synchronize()
    return t, new, {n: kernels.LAUNCHES[n] - before[n] for n in before}


@pytest.mark.parametrize("kw,kernel,exact", [
    (dict(agg="gm2", honest_size=40, byz_size=10), "weiszfeld_step", False),
    (dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10, agg_maxiter=200),
     "aircomp_weiszfeld_step", False),
    (dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10), "select_columns", True),
    (dict(agg="signmv", sign_bits=1, sign_eta=0.01, noise_var=1e-2, honest_size=40,
          byz_size=10), "packed_vote_counts", True),
], ids=["gm2", "gm_var", "median_var", "signmv1"])
def test_pallas_and_xla_iterations_agree_and_only_pallas_launches(cuda, kw, kernel, exact):
    """--agg-impl pallas launches the rule's kernel, xla launches none of the
    four on the same card, and one iteration from the same params and draws
    agrees: within 1e-4 (the Weiszfeld sums run in other orders), the same
    bits for the selections and the votes."""
    tp, p_new, p_launches = _impl_iteration(kw, "pallas")
    tx, x_new, x_launches = _impl_iteration(kw, "xla")
    assert tp._agg_impl == "pallas" and tx._agg_impl == "xla"
    assert p_launches[kernel] >= 1
    assert not any(x_launches.values()), x_launches
    if exact:
        assert torch.equal(p_new, x_new)
    else:
        torch.testing.assert_close(p_new, x_new, rtol=0, atol=1e-4)


def test_auto_on_the_card_is_pallas(cuda):
    kw = dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10)
    ta, a_new, a_launches = _impl_iteration(kw, "auto")
    tp, p_new, p_launches = _impl_iteration(kw, "pallas")
    assert ta._agg_impl == "pallas" and ta.channel_fused and tp.channel_fused
    assert a_launches == p_launches and a_launches["select_columns"] == 1
    assert torch.equal(a_new, p_new)


def test_xla_on_the_card_is_refused_a_graph(cuda):
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=8, byz_size=2, rounds=2,
                    rounds_per_dispatch=2, agg_impl="xla")
    t = Trainer(cfg, dataset=_dispatch_ds(), device="cuda")
    assert not t.dispatch_graph[0] and "plain torch versions" in t.dispatch_graph[1]


@pytest.mark.parametrize("kw", [
    dict(agg="gm2", honest_size=900, byz_size=100),
    dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10),
], ids=["gm2_K1000", "gm_var_K50"])
def test_bf16_graphed_dispatch_is_bitwise_the_eager_dispatch(cuda, kw):
    """--stack-dtype bf16: two rounds replayed from one CUDA graph against
    the eager dispatch, bit for bit, the Weiszfeld kernel reading the bf16
    stack from the graph."""
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    ds = _dispatch_ds()
    cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=2, rounds_per_dispatch=2,
                    display_interval=5, eval_train=False, stack_dtype="bf16")
    graphed = Trainer(cfg, dataset=ds, device="cuda")
    eager = Trainer(cfg, dataset=ds, device="cuda", graphs=False)
    assert graphed.dispatch_graph[0] and graphed._stack_dtype == torch.bfloat16
    pg = graphed.train()
    pe = eager.train()
    torch.cuda.synchronize()
    assert graphed.round_graph.captures == 1
    for key in pg:
        if key != "roundsPerSec":
            assert _bits_equal(pg[key], pe[key]), (key, pg[key], pe[key])
    assert torch.equal(graphed.flat_params, eager.flat_params)
    kernel = "weiszfeld_step" if cfg.agg == "gm2" else "aircomp_weiszfeld_step"
    # gm2's loop bodies count their launches on the device instead
    per_round = 0 if cfg.agg == "gm2" else cfg.display_interval * cfg.agg_maxiter
    assert graphed.round_graph.replay_launches[kernel] == per_round


@pytest.fixture
def nccl_rank(cuda):
    """A one-rank NCCL process group on this card (a TCPStore on 127.0.0.1
    at a free port), torn down after the test."""
    import socket

    from byzantine_aircomp_tpu_torch.parallel import multihost

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    multihost.initialize(coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0,
                         device="cuda", timeout_s=120)
    try:
        yield cuda
    finally:
        multihost.shutdown()


@pytest.mark.parametrize("kw,kernel", [
    (dict(agg="gm2", honest_size=900, byz_size=100), "weiszfeld_step"),
    (dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10), "aircomp_weiszfeld_step"),
    (dict(agg="signmv", sign_bits=1, sign_eta=0.01, noise_var=1e-2, honest_size=40,
          byz_size=10), "packed_vote_counts"),
], ids=["gm2_K1000", "gm_var_K50", "signmv1_K50"])
def test_one_rank_nccl_sharded_round_matches_the_trainer(nccl_rank, kw, kernel):
    """ShardedFedTrainer on a one-rank NCCL group keeps the stack split and
    runs the rule's collective form: its kernel launches on the rank's rows,
    and one round lands within 1e-4 of the one-device trainer."""
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.parallel import ShardedFedTrainer

    ds = _dispatch_ds()
    cfg = dict(attack="classflip", rounds=1, display_interval=2, eval_train=False, **kw)
    single = Trainer(FedConfig(**cfg), dataset=ds, device="cuda")
    sharded = ShardedFedTrainer(FedConfig(**cfg), dataset=ds, device="cuda")
    assert sharded.mesh.distributed and sharded.gathers is None
    single.run_round(0)
    before = dict(kernels.LAUNCHES)
    sharded.run_round(0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernel] > before[kernel]
    torch.testing.assert_close(sharded.flat_params, single.flat_params, rtol=0, atol=1e-4)


def test_dcp_round_trip_of_card_params_is_bitwise(cuda, tmp_path):
    from byzantine_aircomp_tpu_torch.utils import checkpoint as tckpt

    g = torch.Generator(device=cuda).manual_seed(3)
    params = {"w": torch.randn(1000, 7850, device=cuda, generator=g),
              "b": {"bias": torch.randn(7850, device=cuda, generator=g).to(torch.bfloat16)}}
    tckpt.save(str(tmp_path), "card", 3, params)
    template = {"w": torch.zeros(1000, 7850, device=cuda),
                "b": {"bias": torch.zeros(7850, device=cuda, dtype=torch.bfloat16)}}
    round_idx, back = tckpt.load(str(tmp_path), "card", template)
    assert round_idx == 3 and back["w"].device.type == "cuda"
    assert torch.equal(back["w"], params["w"]) and torch.equal(back["b"]["bias"],
                                                                params["b"]["bias"])


@pytest.mark.parametrize("backend", ["vmap", "map"])
def test_seed_lanes_on_the_card_are_bitwise_their_solo_runs(cuda, backend):
    """Two seed lanes of gm2 classflip K=50 (the experiment server's
    group, serve/batch.py) on the card: each lane's record is bitwise its
    solo ``Trainer.train`` on the card, ``roundsPerSec`` aside, with one
    build for the group and the Weiszfeld kernel launched by both."""
    import dataclasses
    import pickle

    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.serve.batch import BatchRunner

    ds = datasets.load("mnist")
    cfgs = [FedConfig(agg="gm2", attack="classflip", honest_size=40, byz_size=10, rounds=2,
                      display_interval=5, eval_train=False, seed=s) for s in (2021, 2022)]
    kernels.reset_launches()
    batch = BatchRunner(cfgs, dataset=ds, backend=backend)
    lanes = batch.train()
    torch.cuda.synchronize()
    served = kernels.LAUNCHES["weiszfeld_step"]
    assert batch.retrace.count("batch_round_fn") == 1 and batch.device == "cuda"
    kernels.reset_launches()
    for cfg, got in zip(cfgs, lanes):
        solo = Trainer(dataclasses.replace(cfg), dataset=ds, device="cuda").train()
        for paths in (solo, got):
            paths.pop("roundsPerSec")
        assert pickle.dumps(got) == pickle.dumps(solo)
    torch.cuda.synchronize()
    assert served == kernels.LAUNCHES["weiszfeld_step"] >= 2 * 2 * 5
