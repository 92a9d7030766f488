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
@pytest.mark.parametrize("k,d", [(13, 300), (1000, 7850), (1, 1)])
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
    out_1, n_1 = aggregators.gm2_solve(w, guess=guess, maxiter=300, tol=1e-6, chunk=1)
    out_16, n_16 = aggregators.gm2_solve(w, guess=guess, maxiter=300, tol=1e-6)
    assert n_1 == n_16 and torch.equal(out_1, out_16)


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


# (2000, 300): the [K, 33] keys of a strip exceed shared memory, so the
# kernel selects from a global scratch of keys
@pytest.mark.parametrize("k,d", [(13, 300), (50, 7850), (1000, 7850), (2000, 300)])
def test_select_columns_matches_plain_versions(cuda, k, d):
    w, terms = _select_inputs(k, d, cuda)
    b = int(0.1 * k)
    before = kernels.LAUNCHES["select_columns"]
    for ch in (None, terms):
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
    assert kernels.LAUNCHES["select_columns"] == before + 8


def test_select_columns_channel_fold_equals_oma_first(cuda):
    from byzantine_aircomp_tpu_torch.ops import channel

    w, terms = _select_inputs(50, 7850, cuda, adversarial=False)
    two_pass = kernels.fused_median(channel.oma(w, 1e-2, terms=terms))
    assert _same_bits(kernels.fused_median(w, terms), two_pass)


@pytest.mark.parametrize("k,d", [(13, 300), (50, 7850), (1000, 7850), (70, 33)])
def test_packed_vote_counts_matches_plain_version(cuda, k, d):
    g = torch.Generator(device=cuda).manual_seed(k + d)
    w_cnt = -(-d // 32)
    words = torch.randint(-(2**31), 2**31 - 1, (k, w_cnt), dtype=torch.int32,
                          device=cuda, generator=g)
    words[0] = -1  # every bit set, bit 31 included
    words[1] = 0  # a non-finite client's row
    before = kernels.LAUNCHES["packed_vote_counts"]
    got = kernels.packed_vote_counts(words, d)
    assert torch.equal(got, kernels.packed_vote_counts_ref(words, d))
    assert torch.equal(kernels.packed_vote_counts(words, d), got)
    assert kernels.LAUNCHES["packed_vote_counts"] == before + 2


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
