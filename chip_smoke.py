#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi``), builds every kernel from
   ``byzantine_aircomp_tpu_torch/ops/csrc`` with nvcc (one process per
   source, in parallel) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card and
   times both: the Weiszfeld steps at the main path's shapes and a ragged
   one, in f32 and bf16, with one non-finite row; the selection kernel
   (median, trimmed mean, each with and without the channel fold; its
   launch plan printed) at (13, 300), (50, 7850), (1000, 7850), (1, 7850),
   (2, 300), (64, 300), (65, 300) and (2000, 7850), with +-Inf, NaN, tied
   and signed-zero rows, and on stacks whose keys tie across 8-bit digit
   boundaries at (65, 300) and (1000, 7850) (medians bitwise, trimmed
   means within 1e-5), all four modes timed at K=50 and K=1000 beside
   ``torch.median``; the popcount kernel at (1, 1), (70, 33), (13, 300),
   (50, 7850) and (1000, 7850), bitwise, and one call of it must issue one
   device kernel and no memset (torch.profiler); every kernel is rerun for
   identical bits;
   The Weiszfeld kernels' fused mode (a whole step of the loop in one
   launch) is held against its plain version (the plain num/den plus the
   torch update and stopping rule) at (1, 1), (13, 300), (50, 7850),
   (60, 7850), (1000, 7850), (2000, 7850), and (13, 9001) and (50, 16500)
   (rows wider than 8192 columns, split across blocks), f32 and bf16,
   with one non-finite row: active, stopping, and inactive (the guess left
   bit for bit); every case rerun for identical bits; timed at K=50 and
   K=1000;
   At the EMNIST MLP's width, d = 48,670 (784 x 62 + 62), each of the four
   kernels is held the same way at K=50 and K=1000 (f32 and bf16 for the
   Weiszfeld steps, both modes; the selection on plain and adversarial
   stacks; the popcount at W = 1521) and timed beside its bound and, for
   the median, ``torch.median``;
3. checks one iteration on the card against the same iteration on the CPU
   (plain versions), from the same params and draws: gm2, gm, median + var,
   trimmed_mean + var, cclip, and under ``--fault chaos`` (its draws shared)
   mean, median + var, trimmed_mean + var and gm2, within 1e-4; the
   discontinuous rules on one shared stack (rows of graded spread, three
   of them equal) at K=50 and K=1000: krum, signmv at 1, 8, 16 and 32
   bits, bev at 1 and 32 bits, and the degraded krum and median on a
   faulted copy bitwise; multi_krum, bulyan and dnc (its draws shared),
   the degraded mean, trimmed_mean and multi_krum, and degraded bulyan as
   its imputation and bulyan on the imputed stack, with the same rows
   picked and the means within 1e-6; with the share of coordinates that
   differ after a whole iteration reported; and one iteration (mean) under
   each static message or gradient attack (signflip, gradascent, gaussian
   with its draws shared, alie, ipm, minmax, minsum) within 1e-4;
4. drives each path through ``harness.run_with_trainer`` (the CLI's
   entry) on synthetic MNIST with the full MLP, classflip:
   (a) gm, var 1e-2, K=50 (B=10), 2 rounds x interval 10;
   (b) gm2, K=1000 (B=100), 1 round x interval 10;
   (c) median, var 1e-2, K=50 (B=10), 2 rounds x interval 10;
   (d) trimmed_mean, var 1e-2, K=1000 (B=100), 1 round x interval 10;
   (e) signmv --sign-bits 1 --sign-eta 0.01, var 1e-2, K=1000 (B=100),
       1 round x interval 10;
   (f) bulyan, var 1e-2, K=50 (B=10), 1 round x interval 10: one
       ``select_columns`` median at [30, 7850] per iteration;
   (g) bev --sign-bits 1 --sign-eta 0.01, K=1000 (B=100), 1 round x
       interval 10: one ``packed_vote_counts`` per iteration;
   (h) cclip, weightflip, K=50 (B=10), 1 round x interval 10: three
       ``select_columns`` medians at [50, 1] per iteration (the adaptive
       radius);
   (i) gm2 --fault chaos, K=50 (B=10), 2 rounds x interval 10: the
       Weiszfeld kernel on stacks with erased and corrupted NaN rows; the
       effective K must drop below 50 in some round, the params stay
       finite and the val accuracy pass 0.3;
   (j) resume on mnist_hard, gm2, K=50 (B=5): 2 rounds straight, and 1
       round with ``checkpoint_dir`` then ``inherit`` to round 2 in a fresh
       Trainer; the final params and the paths must be bitwise equal;
   (k) alie against bulyan, var 1e-2, K=50 (B=10), 1 round;
   (l) minsum against median, var 1e-2, K=50 (B=10), 1 round, the
       message attack (its 25-step bisection) under
       ``torch.cuda.set_sync_debug_mode("error")``: a host sync fails it;
   (m) gradascent@1 against gm, var 1e-2, K=50 (B=10), 2 rounds: round 0's
       Byzantine rows must be bitwise what the same clients send with no
       attack set, round 1's not, and the onset counter must end at 20;
   (n) emnist_hard (d = 48,670), gm2, K=1000 (B=100), 1 round;
   (o) emnist_hard, median, var 1e-2, gaussian, K=50 (B=10), 1 round;
   (p) emnist_hard, signmv --sign-bits 1 --sign-eta 0.01, ipm, K=1000
       (B=100), 1 round;
   with the kernels' launch counters set to 0 before each run and read
   after it; each run must launch its kernel in every iteration.  One more
   iteration of each run is profiled (device busy ms, idle share, and the
   device ms of the run's own kernel); for (a) and (b) the CUDA kernels
   launched inside its Weiszfeld loop (the ``aggregators.WEISZFELD_LOOP_RANGE``
   profiler range), over that iteration's launches of the step kernel, give
   the CUDA kernels per Weiszfeld step (at most 4 for gm, 1 for gm2), and
   the range's host time over the same launches the host ms per step.

5. times the degraded median and trimmed mean (a ``torch.sort`` of the
   [1000, 7850] stack and a gather at a device rank, the path every
   ``--fault`` round of those rules takes) beside the kernel's.

Any failed check raises, so the exit code is not 0 and the result line is
not printed.  The last two lines of standard output are the ``kernels``
JSON line and the ``ok`` JSON line, the card's name and power limit before
them.  Details go to ``chiprun_out/chip_smoke.json``.  Exits with code 2
and prints nothing on standard output when no GPU is visible.
"""

import json
import math
import os
import struct
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 (non
# tensor core) flop/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# kernel vs plain version on the same inputs: the sums run in other orders
KERNEL_RTOL = 1e-4
KERNEL_ATOL = 1e-6
# one iteration on the card vs on the CPU, same params and draws
ITER_ATOL = 1e-4
# trimmed mean kernel vs its plain version: the sums run in other orders
SELECT_RTOL = 1e-5
SELECT_ATOL = 1e-5
# a mean over selected rows, card vs CPU on one stack with the same
# selection: the sums run in other orders
SHARED_ATOL = 1e-6
# the EMNIST MLP's width: 784 x 62 + 62 (emnist, emnist_hard)
EMNIST_D = 48670
# the select_columns shapes timed: the main path's, with bulyan's median of
# its theta = 30 rows at K=50 and cclip's median of the K=50 delta norms,
# and the EMNIST width's
SELECT_TIMED = ((50, 7850), (1000, 7850), (30, 7850), (50, 1), (50, EMNIST_D),
                (1000, EMNIST_D))
# (K, d) at which the Weiszfeld steps' fused mode and the popcount are timed
TIMED = ((50, 7850), (1000, 7850), (50, EMNIST_D), (1000, EMNIST_D))


def _fail(msg):
    raise RuntimeError(msg)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def _reps(k, d):
    """Calls per graph and graph replays for :func:`_time_ms`: fewer at the
    largest stacks, whose plain versions take tens of ms a call."""
    return dict(iters=50, reps=5) if k * d <= 8_000_000 else dict(iters=10, reps=3)


def _time_ms(torch, fn, iters=50, reps=5):
    """(device ms, host ms) per call.  Device: ``iters`` calls captured in
    one CUDA graph, replayed ``reps`` times between CUDA events, so the
    host's launch cost is out of the number.  Host: the same calls issued
    eagerly back to back, which is what the Weiszfeld loop pays today.  The
    stack stays in L2 between calls, as it does between the steps of a
    Weiszfeld solve, which re-reads the same stack every step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / (reps * iters)
    del graph
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_ms, start.elapsed_time(end) / iters


def _inputs(torch, k, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = 0.01 * torch.randn(1, d, device="cuda", generator=g)
    w = base + 1e-3 * torch.randn(k, d, device="cuda", generator=g)
    if k > 1:
        w[min(3, k - 1), min(7, d - 1)] = float("nan")  # one non-finite row
    finite = torch.isfinite(w).all(dim=1)
    guess = (w[finite].mean(dim=0) + 1e-4 * torch.randn(d, device="cuda", generator=g)).contiguous()
    h_r = torch.randn(k, device="cuda", generator=g) / 2**0.5
    h_i = torch.randn(k, device="cuda", generator=g) / 2**0.5
    h_sq = torch.clamp(h_r**2 + h_i**2, min=1e-6)
    scaler = torch.sqrt(torch.mean(guess**2)).reshape(1)
    return w.to(dtype).contiguous(), guess, h_sq, scaler


def _bound(k, d, elem_bytes, aircomp):
    """Least time for one step: read the stack, g (and h_sq, s) once,
    write num and den; flops: diff, square-add and weighted add per
    element (+ the norm's square-add for the AirComp step)."""
    nbytes = k * d * elem_bytes + 2 * d * 4 + 4 + (k * 4 + 4 if aircomp else 0)
    flops = k * d * (6 if aircomp else 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, kernels):
    rows = []
    shapes = [(50, 7850), (60, 7850), (1000, 7850), (13, 300), (50, EMNIST_D),
              (1000, EMNIST_D)]
    for name, kern, ref in (
        ("weiszfeld_step", kernels.weiszfeld_step, kernels.weiszfeld_step_ref),
        ("aircomp_weiszfeld_step", kernels.aircomp_weiszfeld_step,
         kernels.aircomp_weiszfeld_step_ref),
    ):
        air = name.startswith("aircomp")
        for k, d in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                w, guess, h_sq, s = _inputs(torch, k, d, dtype, seed=k + d)
                args = (w, guess, h_sq, s, 1.0) if air else (w, guess)
                num_k, den_k = kern(*args)
                num_r, den_r = ref(*args)
                torch.cuda.synchronize()
                err = max(
                    float((num_k - num_r).abs().max()), float((den_k - den_r).abs())
                )
                scale = max(float(num_r.abs().max()), float(den_r.abs()))
                ok = (
                    bool(torch.isfinite(num_k).all())
                    and err <= KERNEL_RTOL * scale + KERNEL_ATOL
                )
                again = kern(*args)
                deterministic = torch.equal(again[0], num_k) and torch.equal(again[1], den_k)
                ms, host_ms = _time_ms(torch, lambda: kern(*args), **_reps(k, d))
                plain_ms, plain_host_ms = _time_ms(torch, lambda: ref(*args), **_reps(k, d))
                bound_ms, bound_by = _bound(k, d, w.element_size(), air)
                row = dict(
                    name=name, mode="num_den", k=k, d=d, dtype=str(dtype).replace("torch.", ""),
                    max_abs_err=err, scale=scale, ok=ok, deterministic=deterministic,
                    ms=ms, plain_ms=plain_ms, host_ms=host_ms,
                    plain_host_ms=plain_host_ms, bound_ms=bound_ms, bound_by=bound_by,
                )
                rows.append(row)
                print(
                    f"kernel {name} K={k} d={d} {row['dtype']}: max_abs_err={err:.3e} "
                    f"(|ref|max {scale:.3e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"host_ms={host_ms:.4f} plain_host_ms={plain_host_ms:.4f} "
                    f"bound_ms={bound_ms:.5f} ({bound_by}) ok={ok} "
                    f"deterministic={deterministic}"
                )
                if not ok:
                    _fail(f"{name} disagrees with its plain version at K={k} d={d} {dtype}")
                if not deterministic:
                    _fail(f"{name} gave different bits on a rerun at K={k} d={d} {dtype}")
    return rows


def _fused_bound(k, d, elem_bytes, aircomp):
    """Least time for one fused step: read the stack, g_in (and the fades,
    z and the scaler) once, write g_out and the state; flops as
    :func:`_bound` plus the update's few per column."""
    nbytes = k * d * elem_bytes + 2 * d * 4 + 12 + (
        2 * k * 4 + (d + 1) * 4 + 8 if aircomp else 0)
    flops = k * d * (6 if aircomp else 4) + d * (8 if aircomp else 5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fused_call(torch, kernels, air, w, g_in, g_out, state, tol, draws):
    """The fused step on copies of the loop state: (g, active, steps, scaler)."""
    active, steps, scaler = (t.clone() for t in state)
    if not air:
        return (*kernels.weiszfeld_step_fused(w, g_in, g_out, active, steps, tol), None)
    return kernels.aircomp_weiszfeld_step_fused(
        w, g_in, g_out, active, steps, tol, draws["h_r"], draws["h_i"], scaler,
        fade_scale=draws["fade_scale"], z=draws["z"], noise_scale=draws["noise_scale"])


def _fused_ref_call(kernels, air, w, g_in, state, tol, draws):
    active, steps, scaler = state
    if not air:
        return (*kernels.weiszfeld_step_fused_ref(w, g_in, active, steps, tol), None)
    return kernels.aircomp_weiszfeld_step_fused_ref(
        w, g_in, active, steps, tol, draws["h_r"], draws["h_i"], scaler,
        fade_scale=draws["fade_scale"], z=draws["z"], noise_scale=draws["noise_scale"])


def check_fused(torch, kernels):
    """The fused mode of both Weiszfeld kernels against its plain version."""
    from byzantine_aircomp_tpu_torch.ops import channel

    rows = []
    noise_scale = torch.sqrt(torch.tensor(1e-2, dtype=torch.float32) / 2.0)
    # rows wider than 8192 columns split across blocks: 2 tiles at d = 9001,
    # 3 at d = 16500
    shapes = [(1, 1), (13, 300), (50, 7850), (60, 7850), (1000, 7850), (2000, 7850),
              (13, 9001), (50, 16500), (50, EMNIST_D), (1000, EMNIST_D)]
    for name, air in (("weiszfeld_step", False), ("aircomp_weiszfeld_step", True)):
        for k, d in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                w, guess, _, _ = _inputs(torch, k, d, dtype, seed=k + d)
                g = torch.Generator(device="cuda").manual_seed(k * d)
                draws = dict(
                    h_r=torch.randn(k, device="cuda", generator=g),
                    h_i=torch.randn(k, device="cuda", generator=g),
                    fade_scale=channel.FADE_STD,
                    z=torch.randn(d + 1, device="cuda", generator=g),
                    noise_scale=noise_scale,
                )
                state = (torch.ones((), dtype=torch.int32, device="cuda"),
                         torch.zeros((), dtype=torch.int64, device="cuda"),
                         kernels.guess_rms(guess))
                errs, ok, deterministic = [], True, True
                for tol in (0.0, 1e9):  # stays active / stops at this step
                    got = _fused_call(torch, kernels, air, w, guess, torch.empty_like(guess),
                                      state, tol, draws)
                    want = _fused_ref_call(kernels, air, w, guess, state, tol, draws)
                    torch.cuda.synchronize()
                    for a, b in zip(got[::3], want[::3]):  # the guess and the scaler
                        if a is None:
                            continue
                        err = float((a - b).abs().max())
                        errs.append(err)
                        ok &= bool(torch.isfinite(a).all()) and (
                            err <= KERNEL_RTOL * float(b.abs().max()) + KERNEL_ATOL)
                    ok &= int(got[1]) == int(want[1]) and int(got[2]) == int(want[2]) == 1
                    ok &= tol == 0.0 or int(got[1]) == 0
                    again = _fused_call(torch, kernels, air, w, guess, torch.empty_like(guess),
                                        state, tol, draws)
                    deterministic &= all(torch.equal(a, b) for a, b in zip(again, got)
                                         if a is not None)
                # inactive: the guess, the step count and the scaler stay as they are
                idle = (torch.zeros_like(state[0]), state[1] + 7, state[2])
                got = _fused_call(torch, kernels, air, w, guess,
                                  torch.full_like(guess, float("nan")), idle, 0.0, draws)
                torch.cuda.synchronize()
                inactive_ok = (_same_bits(torch, got[0], guess) and int(got[1]) == 0
                               and int(got[2]) == 7
                               and (got[3] is None or _same_bits(torch, got[3], state[2])))
                row = dict(name=name, mode="fused", k=k, d=d,
                           dtype=str(dtype).replace("torch.", ""), max_abs_err=max(errs),
                           ok=ok, inactive_ok=inactive_ok, deterministic=deterministic)
                if (k, d) in TIMED and dtype == torch.float32:
                    # tol = -1 keeps every timed call active; the state is
                    # updated in place, with no copy inside the timed calls
                    active, steps, scaler = (t.clone() for t in state)
                    g_out = torch.empty_like(guess)

                    def step():
                        if not air:
                            return kernels.weiszfeld_step_fused(
                                w, guess, g_out, active, steps, -1.0)
                        return kernels.aircomp_weiszfeld_step_fused(
                            w, guess, g_out, active, steps, -1.0, draws["h_r"], draws["h_i"],
                            scaler, fade_scale=draws["fade_scale"], z=draws["z"],
                            noise_scale=draws["noise_scale"])

                    row["ms"], row["host_ms"] = _time_ms(torch, step, **_reps(k, d))
                    row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, lambda: _fused_ref_call(
                        kernels, air, w, guess, state, -1.0, draws), **_reps(k, d))
                    row["bound_ms"], row["bound_by"] = _fused_bound(k, d, w.element_size(), air)
                rows.append(row)
                print(f"kernel {name} fused K={k} d={d} {row['dtype']}: "
                      f"max_abs_err={row['max_abs_err']:.3e} "
                      + " ".join(f"{key}={row[key]:.5f}" for key in row if key.endswith("ms"))
                      + f" ok={ok} inactive_ok={inactive_ok} deterministic={deterministic}")
                if not (ok and inactive_ok):
                    _fail(f"{name} fused step disagrees with its plain version at K={k} "
                          f"d={d} {dtype}")
                if not deterministic:
                    _fail(f"{name} fused step gave different bits on a rerun at K={k} d={d}")
    return rows


def _select_inputs(torch, k, d, seed, adversarial):
    """A realistic [K, d] stack and OMA terms on the card; with
    ``adversarial``, +-Inf rows, a positive-NaN row, signed zeros and ties."""
    from byzantine_aircomp_tpu_torch.ops import channel

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = 0.01 * torch.randn(1, d, device="cuda", generator=g) + 1e-3 * torch.randn(
        k, d, device="cuda", generator=g)
    if adversarial:
        w[1] = float("inf")
        w[2] = float("-inf")
        w[4] = float("nan")
        w[5, : d // 2] = 0.0
        w[6, : d // 2] = -0.0
        w[7] = w[8]
        w[9, ::3] = w[10, ::3]
    terms = channel.oma_terms(k, d, 1e-2, generator=g, device="cuda")
    return w.contiguous(), channel.OmaTerms(*(t.contiguous() for t in terms))


def _bytes_bound(nbytes):
    """Least time for work bound by bytes: the comparisons and bit counts
    are integer work far below the compute roof."""
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def _same_bits(torch, a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


# float32 bit patterns whose keys tie often and differ in only their first
# or their last 8-bit digit (or straddle one), with +-0, +-Inf and a NaN
TIE_BITS = (0x3F800000, 0x3F7FFFFF, 0x3F800001, 0x3F8000FF, 0x3F800100, 0x3F810000,
            0x3FFFFFFF, 0x40000000, 0xBF800000, 0xBF800001, 0x00000000, 0x80000000,
            0x7F800000, 0xFF800000, 0x7FC00000, 0x00FFFFFF, 0x01000000)


def _tie_stack(torch, k, d, seed):
    vals = torch.tensor(TIE_BITS, dtype=torch.int64).to(torch.int32).view(torch.float32).cuda()
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, vals.numel(), (k, d), device="cuda", generator=g)
    idx[:, 0] = 0  # an all-equal column
    return vals[idx].contiguous()


def _device_kernel_names(torch, fn):
    """The device kernels, copies and memsets one call of ``fn`` issues."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [ev.name for ev in _device_events(torch, prof)]


def check_select_and_popcount(torch, kernels, card):
    """Both kernels of the second slice against their plain versions on the
    card; times at the main path's shapes (K=50 and K=1000, d=7850)."""
    rows = []
    # (K, d, stack): K <= 64 ranks by count in registers, K > 64 radix
    # selects from shared memory; "ties" draws from TIE_BITS
    cases = [(13, 300, "adversarial"), (13, 300, "plain"), (50, 7850, "adversarial"),
             (50, 7850, "plain"), (1000, 7850, "adversarial"), (1000, 7850, "plain"),
             (1, 7850, "plain"), (2, 300, "plain"), (64, 300, "adversarial"),
             (65, 300, "adversarial"), (2000, 7850, "adversarial"), (65, 300, "ties"),
             (1000, 7850, "ties"), (30, 7850, "adversarial"), (30, 7850, "plain"),
             (50, 1, "adversarial"), (50, 1, "plain"), (1000, 1, "ties"),
             (50, EMNIST_D, "adversarial"), (50, EMNIST_D, "plain"),
             (1000, EMNIST_D, "adversarial"), (1000, EMNIST_D, "plain")]
    for k, d, stack in cases:
        timed = (k, d) in SELECT_TIMED and stack == "plain"
        adversarial = stack == "adversarial"
        w, terms = _select_inputs(torch, k, d, seed=k + d + adversarial, adversarial=adversarial)
        if stack == "ties":
            w = _tie_stack(torch, k, d, seed=k * d)
        plan = kernels.select_plan(w.device, k, d)
        print(f"select_columns plan K={k} d={d}: {plan}")
        b = int(0.1 * k)
        for mode, ch in (("median", None), ("median", terms),
                         ("trimmed_mean", None), ("trimmed_mean", terms)):
            if mode == "median":
                kern = lambda: kernels.fused_median(w, ch)  # noqa: E731
                ref = lambda: kernels.fused_median_ref(w, ch)  # noqa: E731
            else:
                kern = lambda: kernels.fused_trimmed_mean(w, b, ch)  # noqa: E731
                ref = lambda: kernels.fused_trimmed_mean_ref(w, b, ch)  # noqa: E731
            got, want = kern(), ref()
            torch.cuda.synchronize()
            fin = torch.isfinite(want)
            if mode == "median":
                ok = _same_bits(torch, got, want)
                err = 0.0 if ok else float("inf")
            else:
                err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
                ok = (torch.equal(torch.isfinite(got), fin)
                      and _same_bits(torch, got[~fin], want[~fin])
                      and bool(torch.allclose(got[fin], want[fin], rtol=SELECT_RTOL,
                                              atol=SELECT_ATOL)))
            deterministic = _same_bits(torch, kern(), got)
            row = dict(name="select_columns", mode=mode, channel=ch is not None,
                       k=k, d=d, b=b if mode == "trimmed_mean" else None,
                       adversarial=adversarial, stack=stack, path=plan["path"],
                       max_abs_err=err, ok=ok, deterministic=deterministic)
            if timed:
                row["ms"], row["host_ms"] = _time_ms(torch, kern, **_reps(k, d))
                row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, ref, **_reps(k, d))
                nbytes = k * d * 4 * (3 if ch is not None else 1) + d * 4 + (
                    3 * k * 4 if ch is not None else 0)
                row["bound_ms"], row["bound_by"] = _bytes_bound(nbytes)
                row["library_ms"] = None
                if mode == "median":
                    # torch.median's own time on the same (received) stack;
                    # the port never calls it (its NaN and signed-zero
                    # rules differ)
                    recv = w if ch is None else w + kernels.oma_residual(ch)
                    row["library_ms"] = _time_ms(
                        torch, lambda: torch.median(recv, dim=0).values, **_reps(k, d))[0]
            rows.append(row)
            print(f"kernel select_columns {mode}{'+channel' if ch is not None else ''} "
                  f"K={k} d={d} stack={stack} path={plan['path']}: max_abs_err={err:.3e} "
                  + " ".join(f"{key}={row[key]:.5f}" for key in
                             ("ms", "host_ms", "plain_ms", "bound_ms", "library_ms")
                             if row.get(key) is not None)
                  + f" ok={ok} deterministic={deterministic}"
                  + (f" [{card}]" if timed else ""))
            if not ok:
                _fail(f"select_columns {mode} disagrees with its plain version "
                      f"at K={k} d={d} channel={ch is not None} stack={stack}")
            if not deterministic:
                _fail(f"select_columns {mode} gave different bits on a rerun at K={k} d={d}")

    for k, d in ((1, 1), (70, 33), (13, 300), (50, 7850), (1000, 7850), (50, EMNIST_D),
                 (1000, EMNIST_D)):
        g = torch.Generator(device="cuda").manual_seed(k * d)
        w_cnt = -(-d // 32)
        words = torch.randint(-(2**31), 2**31 - 1, (k, w_cnt), dtype=torch.int32,
                              device="cuda", generator=g)
        words[0] = -1  # bit 31 set in every word
        words[min(1, k - 1)] = 0  # a non-finite client packs all-zero
        kern = lambda: kernels.packed_vote_counts(words, d)  # noqa: E731
        ref = lambda: kernels.packed_vote_counts_ref(words, d)  # noqa: E731
        got = kern()
        ok = torch.equal(got, ref())
        deterministic = torch.equal(kern(), got)
        # one call is one device kernel: no memset, no second launch
        issued = _device_kernel_names(torch, kern)
        one_kernel = len(issued) == 1 and "count_kernel" in issued[0]
        row = dict(name="packed_vote_counts", k=k, d=d, words=w_cnt,
                   max_abs_err=0.0 if ok else float("inf"), ok=ok,
                   deterministic=deterministic, device_ops_per_call=[_short(n) for n in issued],
                   library_ms=None)
        if (k, d) in TIMED:
            row["ms"], row["host_ms"] = _time_ms(torch, kern, **_reps(k, d))
            row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, ref, **_reps(k, d))
            row["bound_ms"], row["bound_by"] = _bytes_bound(k * w_cnt * 4 + d * 4)
        rows.append(row)
        print(f"kernel packed_vote_counts K={k} d={d} W={w_cnt}: ok={ok} "
              f"deterministic={deterministic} device ops per call={row['device_ops_per_call']} "
              + " ".join(f"{key}={row[key]:.5f}" for key in
                         ("ms", "host_ms", "plain_ms", "bound_ms") if key in row)
              + (f" [{card}]" if (k, d) in TIMED else ""))
        if not ok or not deterministic:
            _fail(f"packed_vote_counts wrong or not repeatable at K={k} d={d}")
        if not one_kernel:
            _fail(f"packed_vote_counts issued {issued} for one call, not one kernel")
    return rows


def check_solver_and_iteration(torch):
    """The chunked Weiszfeld loop on the card equals its per-step loop bit
    for bit, and one main-path iteration on the card agrees with the same
    iteration on the CPU (plain versions), from the same params and draws."""
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.ops import aggregators

    w, guess, _, _ = _inputs(torch, 60, 7850, torch.float32, seed=1)
    for solve, kw in (
        (aggregators.gm2_solve, dict(tol=1e-6)),
        (aggregators.gm_solve, dict(tol=2e-3, noise_var=1e-2)),
    ):
        outs = []
        for chunk in (1, 16):
            gen = torch.Generator(device="cuda").manual_seed(5)
            if solve is aggregators.gm_solve:
                kw["generator"] = gen
            outs.append(solve(w, guess=guess, maxiter=200, chunk=chunk, **kw))
        if outs[0][1] != outs[1][1] or not torch.equal(outs[0][0], outs[1][0]):
            _fail(f"{solve.__name__}: chunked loop differs from per-step loop")
        print(f"{solve.__name__}: chunk 16 == chunk 1 bitwise, {outs[0][1]} steps")

    from byzantine_aircomp_tpu_torch.ops import channel

    ds = datasets.load("mnist", synthetic_train=3000, synthetic_val=500)
    errs = {}
    chaos = dict(fault="chaos", dropout_prob=0.3, fade_floor=0.3, corrupt_prob=0.5,
                 corrupt_size=2)
    for kw in (dict(agg="gm2"), dict(agg="gm", noise_var=1e-2, agg_maxiter=5),
               dict(agg="median", noise_var=1e-2), dict(agg="trimmed_mean", noise_var=1e-2),
               dict(agg="krum"),
               dict(agg="signmv", noise_var=1e-2, sign_bits=1, sign_eta=0.01),
               dict(agg="cclip"), dict(agg="mean", **chaos),
               dict(agg="median", noise_var=1e-2, **chaos),
               dict(agg="trimmed_mean", noise_var=1e-2, **chaos), dict(agg="gm2", **chaos),
               *(dict(agg="mean", attack=a) for a in STATIC_ATTACKS)):
        cfg = FedConfig(honest_size=8, byz_size=2, **dict(dict(attack="classflip"), **kw))
        label = kw["agg"] + ("_chaos" if "fault" in kw else "") + (
            f"_{kw['attack']}" if "attack" in kw else "")
        cpu = Trainer(cfg, dataset=ds, device="cpu")
        gpu = Trainer(cfg, dataset=ds, device="cuda", params=cpu.flat_params)
        g = torch.Generator().manual_seed(3)
        k, d = cfg.node_size, cpu.dim
        draws = {
            "u": torch.rand(k, cfg.batch_size, generator=g),
            "fades": (torch.randn(cfg.agg_maxiter, k, generator=g) / 2**0.5,
                      torch.randn(cfg.agg_maxiter, k, generator=g) / 2**0.5),
            "noise": torch.randn(cfg.agg_maxiter, d + 1, generator=g),
            "oma": channel.oma_terms(k, d, 1e-2, generator=g),
            "vote_noise": torch.randn(d, generator=g),
            "fault": _fault_draws(torch, cpu.fault, k, g) if "fault" in kw else None,
            # the gaussian attack's normals; the other attacks draw none
            "message": (torch.randn(cfg.byz_size, d, generator=g)
                        if cfg.attack == "gaussian" else None),
        }
        new_cpu, var_cpu = cpu.iteration(cpu.flat_params, draws=draws, want_variance=True)
        new_gpu, var_gpu = gpu.iteration(gpu.flat_params, draws=_to(draws, "cuda"),
                                         want_variance=True)
        diff = (new_gpu.cpu() - new_cpu).abs()
        err = float(diff.max())
        differ = float((diff > 0).float().mean())
        errs[label] = dict(max_abs_err=err, share_of_coords_differing=differ,
                           variance_card=float(var_gpu), variance_cpu=float(var_cpu))
        fault_str = ""
        if "fault" in kw:
            counts_cpu = cpu.iteration_fault_metrics.tolist()
            counts_gpu = gpu.iteration_fault_metrics.cpu().tolist()
            errs[label]["fault_counts"] = counts_gpu
            fault_str = f" fault counts card {counts_gpu} CPU {counts_cpu}"
            if counts_gpu != counts_cpu or counts_cpu[3] >= k:
                _fail(f"{label}: fault counts differ or nothing was faulted: {fault_str}")
        print(f"one {label} iteration, card vs CPU: max_abs_err={err:.3e} (tolerance "
              f"{ITER_ATOL:.0e}) share of coordinates differing={differ:.3e} "
              f"variance {float(var_gpu):.6e} vs {float(var_cpu):.6e} (rtol 1e-4){fault_str}")
        if new_gpu.shape != (d,) or not bool(torch.isfinite(new_gpu).all()):
            _fail(f"{label} iteration on the card gave non-finite params")
        # krum and signmv are discontinuous: a 1e-7 difference in the
        # client stack can flip a ballot or the argmin, so those two are
        # held bitwise on one shared stack below instead
        if kw["agg"] not in ("krum", "signmv") and err > ITER_ATOL:
            _fail(f"{label} iteration on the card disagrees with the CPU: {err}")
        # an erased or corrupted honest row makes the variance NaN on both
        same_nan = math.isnan(float(var_gpu)) and math.isnan(float(var_cpu))
        if not same_nan and not abs(float(var_gpu) - float(var_cpu)) <= 1e-4 * abs(float(var_cpu)):
            _fail(f"{label} honest variance on the card disagrees with the CPU")

    errs.update(check_shared_stacks(torch))
    return errs


def _fault_draws(torch, spec, k, g):
    """The fault channel's draws for one iteration, from ``g`` on the CPU."""
    return {
        "dropped": torch.rand(k, generator=g) < spec.dropout_prob,
        "crash": torch.rand(k, generator=g) < spec.corrupt_prob,
        "fade": (torch.randn(k, generator=g) / 2**0.5, torch.randn(k, generator=g) / 2**0.5),
        "ge_recover": torch.rand(k, generator=g) < spec.ge_p_bg,
        "ge_degrade": torch.rand(k, generator=g) < spec.ge_p_gb,
        "csi_z": torch.randn(k, generator=g),
    }


def _to(obj, dev):
    """``obj`` with every tensor in it moved to ``dev``."""
    if hasattr(obj, "to") and not isinstance(obj, (dict, tuple, list)):
        return obj.to(dev)
    if isinstance(obj, dict):
        return {key: _to(v, dev) for key, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, dev) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(v, dev) for v in obj)
    return obj


def _graded_stack(torch, k, d, seed):
    """A [K, d] stack whose rows spread from the center by 1e-3 to 3e-3 in
    index order, so that the Krum scores of its K rows sit well apart: with
    equal spreads, at K=1000 adjacent scores sit closer than the f32
    rounding by which cuBLAS's Gram product and the CPU's differ, and the
    rows picked at the selection boundary are then the device's choice.
    Row 3 holds a NaN, and the last three rows are equal (their scores
    tie)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    spread = 1e-3 * (1.0 + 2.0 * torch.arange(k, device="cuda") / k)
    w = 0.01 * torch.randn(1, d, device="cuda", generator=g) + spread[:, None] * torch.randn(
        k, d, device="cuda", generator=g)
    w[3, 7] = float("nan")
    w[-3:] = w[-3].clone()
    finite = torch.isfinite(w).all(dim=1)
    guess = (w[finite].mean(dim=0) + 1e-4 * torch.randn(d, device="cuda", generator=g))
    return w.contiguous(), guess.contiguous()


def check_shared_stacks(torch):
    """The discontinuous rules on one stack, card vs CPU: a 1e-7 difference
    in the stack can flip a ballot, an argmin or a removal, so they are
    held on the same bits (:func:`_graded_stack`, at K=50 and 1000), and a
    faulted copy (a NaN row, an Inf entry) feeds the degraded rules.  Rules
    that return a row or a +-eta step, and medians, must agree bit for bit;
    a mean over selected rows must pick the same rows and agree within
    ``SHARED_ATOL``, its sum running in another order.  The same rows: the
    picked rows, in index order, hold the same bits (cuBLAS may score the
    equal rows a few ulp apart, and then picks another of them).  Degraded
    bulyan is held in two parts: its imputation (a column sum, so within
    ``SHARED_ATOL``) and bulyan on the CPU's imputed stack, whose three
    imputed rows are equal and sit at the median (values ``med + x`` and
    ``med - x`` tie there); on the card's own imputed stack an ulp of the
    centroid could decide such a tie."""
    from byzantine_aircomp_tpu_torch.ops import aggregators

    errs = {}
    for k in (50, 1000):
        honest = int(0.8 * k)
        w, guess = _graded_stack(torch, k, 7850, seed=k)
        faulted = w.clone()
        faulted[1] = float("nan")
        faulted[5, 11] = float("inf")
        imputed = aggregators.impute_non_finite(faulted.cpu())
        err = float((aggregators.impute_non_finite(faulted).cpu() - imputed).abs().max())
        errs[f"impute_non_finite_K{k}"] = dict(max_abs_err=err)
        print(f"impute_non_finite on one K={k} stack, card vs CPU: max_abs_err={err:.3e} "
              f"(tolerance {SHARED_ATOL:.0e})")
        if not err <= SHARED_ATOL:
            _fail(f"degraded bulyan's imputation differs between card and CPU at K={k}")
        z = torch.randn(7850, device="cuda", generator=torch.Generator(device="cuda").manual_seed(k))
        g = torch.Generator().manual_seed(k)
        dnc_draws = [(torch.randint(0, 7850, (7850,), generator=g), torch.randn(7850, generator=g))
                     for _ in range(3)]

        def vote(fn, bits, eta, noise=True):
            return lambda t, dev: fn(t, guess=guess.to(dev), sign_bits=bits, sign_eta=eta,
                                     **(dict(noise_var=1e-2, vote_noise=z.to(dev))
                                        if noise else {}))

        signmv, bev = aggregators.sign_majority_vote, aggregators.best_effort_voting
        bitwise = {
            "krum": lambda t, dev: aggregators.krum(t, honest_size=honest),
            "signmv1": vote(signmv, 1, 0.01), "signmv32": vote(signmv, 32, None),
            "signmv8": vote(signmv, 8, None), "signmv16": vote(signmv, 16, 0.01),
            "bev1": vote(bev, 1, 0.01, noise=False), "bev32": vote(bev, 32, None, noise=False),
            "krum_degraded": lambda t, dev: aggregators.krum(
                t, honest_size=honest, degraded=True),
            "median_degraded": lambda t, dev: aggregators.median(t, degraded=True),
        }
        selection = lambda t, dev: aggregators.lowest(  # noqa: E731
            aggregators.krum_scores(t, honest), honest)
        theta_rows = lambda t, dev: aggregators.lowest(  # noqa: E731
            aggregators.krum_scores(t, honest), k - 2 * (k - honest))
        close = {
            "multi_krum": (lambda t, dev: aggregators.multi_krum(t, honest_size=honest),
                           selection),
            "bulyan": (lambda t, dev: aggregators.bulyan(t, honest_size=honest), theta_rows),
            "dnc": (lambda t, dev: aggregators.dnc(t, honest_size=honest,
                                                   dnc_draws=_to(dnc_draws, dev)), None),
            "mean_degraded": (lambda t, dev: aggregators.mean(t, degraded=True), None),
            "trimmed_mean_degraded": (
                lambda t, dev: aggregators.trimmed_mean(t, degraded=True), None),
            "multi_krum_degraded": (
                lambda t, dev: aggregators.multi_krum(t, honest_size=honest, degraded=True),
                lambda t, dev: aggregators.lowest(
                    aggregators.krum_scores_degraded(t, honest), honest)),
            "bulyan_imputed": (lambda t, dev: aggregators.bulyan(t, honest_size=honest),
                               theta_rows),
        }
        for name, fn in list(bitwise.items()) + list(close.items()):
            exact = name in bitwise
            fn, select = (fn, None) if exact else fn
            stack = (faulted if name.endswith("_degraded")
                     else imputed.cuda() if name.endswith("_imputed") else w)
            on_card = fn(stack, dev="cuda")
            on_cpu = fn(stack.cpu(), dev="cpu")
            same = _same_bits(torch, on_card.cpu(), on_cpu)
            err = float((on_card.cpu() - on_cpu).abs().max())
            picked = None
            if select is not None:
                rows_card = stack.cpu()[torch.sort(select(stack, "cuda").cpu()).values]
                rows_cpu = stack.cpu()[torch.sort(select(stack.cpu(), "cpu")).values]
                picked = _same_bits(torch, rows_card, rows_cpu)
            errs[f"{name}_same_stack_K{k}"] = dict(bitwise=same, max_abs_err=err,
                                                   same_selection=picked)
            print(f"{name} on one K={k} stack, card vs CPU: bitwise equal={same} "
                  f"max_abs_err={err:.3e}"
                  + ("" if exact else f" (tolerance {SHARED_ATOL:.0e})")
                  + ("" if picked is None else f" same rows selected={picked}"))
            if not bool(torch.isfinite(on_card).all()):
                _fail(f"{name} on the card gave non-finite values on the K={k} stack")
            if (exact and not same) or picked is False or not err <= SHARED_ATOL:
                _fail(f"{name} differs between card and CPU on the same K={k} stack")
    return errs


def _short(kernel_name):
    """The head of a kernel's name: templated names run to pages."""
    return kernel_name.replace("(anonymous namespace)::", "").split("(")[0][:80]


def _device_events(torch, prof):
    """The device work of a profile: kernels, copies and memsets, without
    the device-side spans of profiler ranges."""
    from byzantine_aircomp_tpu_torch.ops.aggregators import WEISZFELD_LOOP_RANGE

    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.name != WEISZFELD_LOOP_RANGE]


def _device_kernels(torch, prof):
    """The device kernels of a profile (copies and memsets left out)."""
    return [ev for ev in _device_events(torch, prof)
            if not ev.name.startswith(("Memcpy", "Memset"))]


def _weiszfeld_loop_kernels(torch, prof):
    """The Weiszfeld loops of a profile (``aggregators.WEISZFELD_LOOP_RANGE``
    ranges): their number, their host ms, and the device kernels launched
    inside them (copies and memsets left out).  A kernel belongs to a loop
    when the runtime call that launched it (``cudaLaunchKernel``,
    ``cudaLaunchCooperativeKernel``, ...; the same correlation id) started
    on the host inside the loop's range."""
    from byzantine_aircomp_tpu_torch.ops.aggregators import WEISZFELD_LOOP_RANGE

    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    loops = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.device_type == cpu and ev.name == WEISZFELD_LOOP_RANGE]
    launched = {ev.id for ev in events
                if ev.device_type == cpu and ev.name.startswith("cu")
                and any(s <= ev.time_range.start <= e for s, e in loops)}
    inside = [ev.name for ev in _device_kernels(torch, prof) if ev.id in launched]
    host_ms = sum(e - s for s, e in loops) / 1e3
    return len(loops), host_ms, inside


# each wrapper's device kernel, as the profiler names it
DEVICE_NAMES = {"weiszfeld_step": "step_kernel", "aircomp_weiszfeld_step": "step_kernel",
                "select_columns": "select_kernel", "packed_vote_counts": "count_kernel"}


def profile_iteration(torch, kernels, trainer, kernel):
    """One more global iteration of a finished run under torch.profiler:
    wall time, summed device kernel time and the idle share, and the
    kernels that take the most device time.  Where the iteration runs a
    Weiszfeld loop, also the CUDA kernels per Weiszfeld step (kernels
    launched inside the loop over the iteration's launches of ``kernel``,
    one per step) and the loop's host ms per step (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    gens = trainer.iteration_generators(10**6, 0)
    torch.cuda.synchronize()
    before = kernels.LAUNCHES[kernel]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.iteration(trainer.flat_params, gens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = kernels.LAUNCHES[kernel] - before
    per_kernel = {}
    for ev in _device_events(torch, prof):
        name = _short(ev.name)
        per_kernel[name] = per_kernel.get(name, 0.0) + ev.device_time_total / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    # the run's own kernel: its device ms and launches in this iteration
    own = [ev for ev in _device_kernels(torch, prof) if DEVICE_NAMES[kernel] in ev.name]
    out = dict(
        kernel_device_ms=sum(ev.device_time_total for ev in own) / 1e3,
        kernel_device_launches=len(own),
        wall_ms=wall_ms,
        device_busy_ms=busy_ms if busy_ms > 0 else None,
        idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        device_kernels=len(_device_kernels(torch, prof)),
        top_kernels_ms=top,
    )
    loops, host_ms, inside = _weiszfeld_loop_kernels(torch, prof)
    if loops:
        # the step kernel's own launches, found in the profile, must be the
        # ones the counter saw: else the profile missed launches
        found = sum("step_kernel" in name for name in inside)
        if steps < 1 or found != steps:
            _fail(f"the profile holds {found} Weiszfeld step kernels in {loops} loops, "
                  f"the counter {steps}: cannot count the kernels of a step")
        out["weiszfeld_per_step"] = dict(
            loops=loops, steps_launched=steps, kernels_in_loops=len(inside),
            kernels_per_step=len(inside) / steps, host_ms_per_step=host_ms / steps,
            loop_host_ms=host_ms, kernel_names=sorted(set(_short(n) for n in inside)))
    return out


# the static message and gradient attacks (ops/attacks.py), each held card vs
# CPU for one iteration with shared draws
STATIC_ATTACKS = ("signflip", "gradascent", "gaussian", "alie", "ipm", "minmax", "minsum")

# each run: label, config, rounds, its kernel, the kernel's launches per
# iteration at least
RUNS = (
    ("a_gm_var", dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10), 2,
     "aircomp_weiszfeld_step", 1),
    ("b_gm2", dict(agg="gm2", honest_size=900, byz_size=100), 1, "weiszfeld_step", 1),
    ("c_median_var", dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10), 2,
     "select_columns", 1),
    ("d_trimmed_mean_var", dict(agg="trimmed_mean", noise_var=1e-2, honest_size=900,
                                byz_size=100), 1, "select_columns", 1),
    ("e_signmv1_var", dict(agg="signmv", noise_var=1e-2, sign_bits=1, sign_eta=0.01,
                           honest_size=900, byz_size=100), 1, "packed_vote_counts", 1),
    ("f_bulyan_var", dict(agg="bulyan", noise_var=1e-2, honest_size=40, byz_size=10), 1,
     "select_columns", 1),
    ("g_bev1", dict(agg="bev", sign_bits=1, sign_eta=0.01, honest_size=900, byz_size=100), 1,
     "packed_vote_counts", 1),
    ("h_cclip_weightflip", dict(agg="cclip", attack="weightflip", honest_size=40,
                                byz_size=10), 1, "select_columns", 3),
    ("i_gm2_chaos", dict(agg="gm2", fault="chaos", honest_size=40, byz_size=10), 2,
     "weiszfeld_step", 1),
    ("j_resume_gm2", dict(agg="gm2", honest_size=45, byz_size=5, dataset="mnist_hard"), 2,
     "weiszfeld_step", 1),
    ("k_alie_bulyan_var", dict(agg="bulyan", attack="alie", noise_var=1e-2, honest_size=40,
                               byz_size=10), 1, "select_columns", 1),
    ("l_minsum_median_var", dict(agg="median", attack="minsum", noise_var=1e-2,
                                 honest_size=40, byz_size=10), 1, "select_columns", 1),
    ("m_gradascent_onset_gm_var", dict(agg="gm", attack="gradascent@1", noise_var=1e-2,
                                       honest_size=40, byz_size=10), 2,
     "aircomp_weiszfeld_step", 1),
    ("n_emnist_gm2", dict(agg="gm2", dataset="emnist_hard", honest_size=900, byz_size=100), 1,
     "weiszfeld_step", 1),
    ("o_emnist_median_var_gaussian", dict(agg="median", attack="gaussian", noise_var=1e-2,
                                          dataset="emnist_hard", honest_size=40, byz_size=10),
     1, "select_columns", 1),
    ("p_emnist_signmv1_ipm", dict(agg="signmv", attack="ipm", sign_bits=1, sign_eta=0.01,
                                  dataset="emnist_hard", honest_size=900, byz_size=100), 1,
     "packed_vote_counts", 1),
)
# runs whose accuracy after 2 rounds must pass 0.3
ACCURACY_BAR = ("a_gm_var", "i_gm2_chaos", "j_resume_gm2")
# the run whose message attack runs under torch.cuda.set_sync_debug_mode("error")
SYNC_GUARDED = "l_minsum_median_var"


def _same_record(a, b):
    """Two records equal in every entry but ``roundsPerSec`` (host clock);
    floats compared as bits, NaN included."""
    for key in a:
        if key == "roundsPerSec":
            continue
        x, y = a[key], b[key]
        if isinstance(x, list):
            if len(x) != len(y) or any(
                    struct.pack("<d", u) != struct.pack("<d", v) for u, v in zip(x, y)):
                return False
        elif x != y:
            return False
    return set(a) == set(b)


def run_resume(torch, kernels, harness, cfg):
    """Run (j): ``cfg`` straight through, and again as one round with a
    checkpoint per round and then ``inherit`` to the end in a fresh
    Trainer; the final params and the paths (all but ``roundsPerSec``) must
    be bitwise equal.  Returns the resumed run's (trainer, record), with the
    launches of all three runs."""
    import dataclasses
    import shutil

    ck = os.path.join(cfg.cache_dir, "ckpt_j")
    shutil.rmtree(ck, ignore_errors=True)
    straight_t, straight = harness.run_with_trainer(cfg, device="cuda")
    harness.run_with_trainer(dataclasses.replace(cfg, rounds=1, checkpoint_dir=ck),
                             device="cuda")
    resumed_t, resumed = harness.run_with_trainer(
        dataclasses.replace(cfg, checkpoint_dir=ck, inherit=True), device="cuda")
    torch.cuda.synchronize()
    same_params = torch.equal(straight_t.flat_params, resumed_t.flat_params)
    same_paths = _same_record(straight, resumed)
    print(f"run j resume: 2 rounds straight vs 1 round + --inherit to 2 in a fresh Trainer: "
          f"params bitwise equal={same_params}, paths bitwise equal={same_paths} "
          f"(valAccPath {straight['valAccPath']} vs {resumed['valAccPath']})")
    if not (same_params and same_paths):
        diff = float((straight_t.flat_params - resumed_t.flat_params).abs().max())
        _fail(f"run j: the resumed run differs from the straight run (params max abs "
              f"diff {diff}; paths equal {same_paths})")
    return resumed_t, resumed


def check_onset_rows(torch, trainer):
    """Run (m)'s onset: in round 0 the Byzantine rows under ``gradascent@1``
    are bitwise what the same clients send with no attack set; in round 1
    they are not.  Each trainer starts from the seeded initial params, as
    the run's first iteration did."""
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    cfg = trainer.cfg
    rows = {}
    for attacked, r in ((True, 0), (False, 0), (True, 1), (False, 1)):
        t = Trainer(cfg, dataset=trainer.dataset, device="cuda")
        if not attacked:
            t.attack = None
        else:
            t.attack_iter.fill_(r * cfg.display_interval)
        seen, agg = {}, t.agg_fn

        def capture(w, **kw):
            seen["w"] = w[-cfg.byz_size:].clone()
            return agg(w, **kw)

        t.agg_fn = capture
        t.iteration(t.flat_params, t.iteration_generators(r, 0))
        rows[(attacked, r)] = seen["w"]
    before = _same_bits(torch, rows[(True, 0)], rows[(False, 0)])
    after = _same_bits(torch, rows[(True, 1)], rows[(False, 1)])
    print(f"run m onset: round 0 Byzantine rows bitwise the unattacked ones={before}; "
          f"round 1 (onset) equal={after}; attack_iter at the end={int(trainer.attack_iter)}")
    if not before or after:
        _fail("run m: gradascent@1 acted before its onset, or not at it")
    if int(trainer.attack_iter) != 2 * cfg.display_interval:
        _fail(f"run m: attack_iter ended at {int(trainer.attack_iter)}, not 20")
    return dict(round0_rows_bitwise_unattacked=before, round1_rows_equal=after,
                attack_iter=int(trainer.attack_iter))


class _SyncGuard:
    """Runs every message attack under ``torch.cuda.set_sync_debug_mode
    ("error")``: a host sync inside it (an ``.item()``, a ``bool()`` of a
    device value) raises.  Counts the guarded calls."""

    def __init__(self, torch, attacks):
        self.torch, self.spec, self.calls = torch, attacks.AttackSpec, 0

    def __enter__(self):
        self.orig = self.spec.apply_message
        guard = self

        def guarded(spec, *a, **kw):
            guard.torch.cuda.set_sync_debug_mode("error")
            try:
                out = guard.orig(spec, *a, **kw)
            finally:
                guard.torch.cuda.set_sync_debug_mode("default")
            guard.calls += 1
            return out

        self.spec.apply_message = guarded
        return self

    def __exit__(self, *exc):
        self.spec.apply_message = self.orig


def run_main_path(torch, kernels, harness, FedConfig, card, cache_dir, labels=None):
    from byzantine_aircomp_tpu_torch.ops import attacks

    runs = {}
    for label, kw, rounds, kernel, per_iteration in RUNS:
        if labels is not None and label not in labels:
            continue
        cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=rounds,
                        display_interval=10, cache_dir=cache_dir)
        kernels.reset_launches()
        t0 = time.perf_counter()
        guard, extra = None, {}
        if label == "j_resume_gm2":
            # three runs: straight, one round checkpointed, the resume
            trainer, record = run_resume(torch, kernels, harness, cfg)
            iterations = 2 * rounds * cfg.display_interval
        elif label == SYNC_GUARDED:
            with _SyncGuard(torch, attacks) as guard:
                trainer, record = harness.run_with_trainer(cfg, device="cuda")
            iterations = rounds * cfg.display_interval
        else:
            trainer, record = harness.run_with_trainer(cfg, device="cuda")
            iterations = rounds * cfg.display_interval
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if launches[kernel] < per_iteration * iterations:
            _fail(f"run {label} did not launch {kernel} {per_iteration} time(s) in every "
                  f"iteration: {launches}")
        if guard is not None:
            print(f"run {label}: {guard.calls} message-attack calls under "
                  f"torch.cuda.set_sync_debug_mode('error'), no host sync")
            if guard.calls != iterations:
                _fail(f"run {label}: {guard.calls} guarded attack calls, not {iterations}")
            extra["sync_guarded_attack_calls"] = guard.calls
        if cfg.attack.startswith("gradascent@"):
            extra["onset"] = check_onset_rows(torch, trainer)
        if cfg.dataset.startswith("emnist") and trainer.dim != EMNIST_D:
            _fail(f"run {label}: d = {trainer.dim}, not {EMNIST_D}")
        if not bool(torch.isfinite(trainer.flat_params).all()):
            _fail(f"run {label} ended with non-finite params")
        val_acc = record["valAccPath"][-1]
        if label in ACCURACY_BAR and not val_acc > 0.3:
            _fail(f"run {label}: val accuracy {val_acc} not above 0.3")
        if cfg.fault is not None:
            eff_k = record["effectiveKPath"]
            print(f"run {label} fault paths: effectiveK={eff_k} "
                  f"dropped={record['faultDroppedPath']} erased={record['faultErasedPath']} "
                  f"corrupt={record['faultCorruptPath']}")
            if not min(eff_k) < cfg.node_size:
                _fail(f"run {label}: the effective K never dropped below {cfg.node_size}")
        rps = record["roundsPerSec"]
        prof = profile_iteration(torch, kernels, trainer, kernel)
        print(f"run {label} profiled iteration: wall {prof['wall_ms']:.1f} ms, "
              f"device busy {prof['device_busy_ms']} ms, idle share "
              f"{prof['idle_share']}, {prof['device_kernels']} device kernels; "
              f"{kernel} {prof['kernel_device_ms']:.4f} device ms in "
              f"{prof['kernel_device_launches']} launch(es); "
              f"top kernels {prof['top_kernels_ms'][:4]} [{card}]")
        per_step = prof.pop("weiszfeld_per_step", None)
        if kw["agg"] in ("gm", "gm2"):
            if per_step is None:
                _fail(f"run {label}: no Weiszfeld loop in the profiled iteration")
            print(f"run {label} Weiszfeld loop of the profiled iteration: "
                  f"{per_step['steps_launched']} steps launched, "
                  f"{per_step['kernels_per_step']:.3f} CUDA kernels per step "
                  f"({per_step['kernels_in_loops']} in {per_step['loops']} loop(s): "
                  f"{per_step['kernel_names']}), host {per_step['host_ms_per_step']:.4f} "
                  f"ms per step (profiler on) [{card}]")
            most = 4 if kw["agg"] == "gm" else 1
            if per_step["kernels_per_step"] > most + 1e-9:
                _fail(f"run {label}: {per_step['kernels_per_step']} CUDA kernels per "
                      f"Weiszfeld step, more than {most}")
        runs[label] = dict(
            profiled_iteration=prof, weiszfeld_per_step=per_step, d=trainer.dim, **extra,
            config=dict(dict(attack="classflip"), **kw, rounds=rounds, display_interval=10,
                        batch_size=cfg.batch_size),
            fault_paths={key: record[key] for key in record
                         if key.startswith("fault") or key == "effectiveKPath"},
            launches=launches,
            launches_per_round={n: c * cfg.display_interval / iterations
                                for n, c in launches.items()},
            val_acc=val_acc, val_acc_path=record["valAccPath"],
            rounds_per_sec=rps, wall_seconds=wall, card=card,
        )
        print(f"run {label}: launches={launches} val_acc={val_acc:.4f} "
              f"rounds/sec per round={['%.4f' % r for r in rps]} wall={wall:.1f}s "
              f"variance={record['variencePath']} [{card}]")
    return runs


def time_degraded_sort(torch, kernels, card):
    """The degraded median and trimmed mean at [1000, 7850] (a sort of the
    stack's total-order keys and a gather at the device rank (n-1)//2, or a
    masked sum of the ranks [b, n-b)), a ``torch.sort`` of the keys alone,
    and the kernel's static-K median and trimmed mean on the same stack;
    device ms from CUDA-graph replay.  The stack has 3 non-finite rows."""
    from byzantine_aircomp_tpu_torch.ops import aggregators

    w, _ = _select_inputs(torch, 1000, 7850, seed=5, adversarial=False)
    w[[7, 70, 700]] = float("nan")
    keys = kernels.total_order_keys(w)
    got = aggregators.median(w, degraded=True)
    want = aggregators.median(w.cpu(), degraded=True)
    if not _same_bits(torch, got.cpu(), want):
        _fail("degraded median on the card differs from the CPU")
    rows = {}
    for name, fn in (
        ("median_degraded", lambda: aggregators.median(w, degraded=True)),
        ("trimmed_mean_degraded", lambda: aggregators.trimmed_mean(w, degraded=True)),
        ("torch_sort_keys", lambda: torch.sort(keys, dim=0)),
        ("select_columns_median", lambda: kernels.fused_median(w)),
        ("select_columns_trimmed_mean", lambda: kernels.fused_trimmed_mean(w, 100)),
    ):
        ms, host_ms = _time_ms(torch, fn, iters=20, reps=3)
        rows[name] = dict(ms=ms, host_ms=host_ms)
        print(f"degraded path K=1000 d=7850 {name}: ms={ms:.4f} host_ms={host_ms:.4f} "
              f"[{card}]")
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    from byzantine_aircomp_tpu_torch.device import resolve_device
    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.ops import kernels

    resolve_device("cuda")  # TF32 off for matmuls and convolutions
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"built kernels in {time.perf_counter() - t0:.1f}s: {build_s}")

    rows = check_kernels(torch, kernels)
    rows += check_fused(torch, kernels)
    rows += check_select_and_popcount(torch, kernels, card)
    iter_errs = check_solver_and_iteration(torch)
    root = os.path.dirname(os.path.abspath(__file__))
    runs = run_main_path(torch, kernels, harness, FedConfig, card,
                         os.path.join(root, "build", "chip_smoke"))
    degraded_sort = time_degraded_sort(torch, kernels, card)

    # each kernel's row: the shape its main-path run gives it
    # (the Weiszfeld kernels in their fused mode, which the main path runs)
    picks = {
        "weiszfeld_step": ("b_gm2", dict(k=1000, d=7850, dtype="float32", mode="fused")),
        "aircomp_weiszfeld_step": ("a_gm_var", dict(k=50, d=7850, dtype="float32",
                                                    mode="fused")),
        "select_columns": ("c_median_var", dict(k=50, d=7850, mode="median", channel=True,
                                                adversarial=False)),
        "packed_vote_counts": ("e_signmv1_var", dict(k=1000, d=7850)),
    }
    csrc = "byzantine_aircomp_tpu_torch/ops/csrc/"
    tpu = "byzantine_aircomp_tpu/ops/pallas_kernels.py:"
    sources = {
        "weiszfeld_step": (csrc + "weiszfeld_step.cu", tpu + "126"),
        "aircomp_weiszfeld_step": (csrc + "aircomp_weiszfeld_step.cu", tpu + "200"),
        "select_columns": (csrc + "select_columns.cu", tpu + "361"),
        "packed_vote_counts": (csrc + "packed_vote_counts.cu", tpu + "478"),
    }
    line = []
    for name, (run_label, want) in picks.items():
        row = next(r for r in rows if r["name"] == name
                   and all(r.get(key) == v for key, v in want.items()))
        line.append(dict(
            name=name, route="cuda", source=sources[name][0],
            replaces=sources[name][1], launches=runs[run_label]["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in rows if r["name"] == name),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row.get("library_ms"),
        ))
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       build_seconds=build_s, kernel_rows=rows,
                       iteration_vs_cpu_max_abs_err=iter_errs, runs=runs,
                       degraded_sort=degraded_sort, kernels=line), f, indent=1)
    print(json.dumps({"kernels": line}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
