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
3. checks one iteration on the card against the same iteration on the CPU
   (plain versions), from the same params and draws: gm2, gm, median + var
   and trimmed_mean + var within 1e-4; krum and signmv (discontinuous
   rules) bitwise on one shared stack, with the share of coordinates that
   differ after a whole iteration reported;
4. drives each path through ``harness.run_with_trainer`` (the CLI's
   entry) on synthetic MNIST with the full MLP, classflip:
   (a) gm, var 1e-2, K=50 (B=10), 2 rounds x interval 10;
   (b) gm2, K=1000 (B=100), 1 round x interval 10;
   (c) median, var 1e-2, K=50 (B=10), 2 rounds x interval 10;
   (d) trimmed_mean, var 1e-2, K=1000 (B=100), 1 round x interval 10;
   (e) signmv --sign-bits 1 --sign-eta 0.01, var 1e-2, K=1000 (B=100),
       1 round x interval 10;
   with the kernels' launch counters set to 0 before each run and read
   after it; each run must launch its kernel in every iteration.  One more
   iteration of each run is profiled (device busy ms, idle share, and the
   device ms of the run's own kernel); for (a) and (b) the CUDA kernels
   launched inside its Weiszfeld loop (the ``aggregators.WEISZFELD_LOOP_RANGE``
   profiler range), over that iteration's launches of the step kernel, give
   the CUDA kernels per Weiszfeld step (at most 4 for gm, 1 for gm2), and
   the range's host time over the same launches the host ms per step.

Any failed check raises, so the exit code is not 0 and the result line is
not printed.  The last two lines of standard output are the ``kernels``
JSON line and the ``ok`` JSON line, the card's name and power limit before
them.  Details go to ``chiprun_out/chip_smoke.json``.  Exits with code 2
and prints nothing on standard output when no GPU is visible.
"""

import json
import os
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
    shapes = [(50, 7850), (60, 7850), (1000, 7850), (13, 300)]
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
                ms, host_ms = _time_ms(torch, lambda: kern(*args))
                plain_ms, plain_host_ms = _time_ms(torch, lambda: ref(*args))
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
              (13, 9001), (50, 16500)]
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
                if d == 7850 and k in (50, 1000) and dtype == torch.float32:
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

                    row["ms"], row["host_ms"] = _time_ms(torch, step)
                    row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, lambda: _fused_ref_call(
                        kernels, air, w, guess, state, -1.0, draws))
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
             (1000, 7850, "ties")]
    for k, d, stack in cases:
        timed = d == 7850 and k in (50, 1000) and stack == "plain"
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
                row["ms"], row["host_ms"] = _time_ms(torch, kern)
                row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, ref)
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
                        torch, lambda: torch.median(recv, dim=0).values)[0]
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

    for k, d in ((1, 1), (70, 33), (13, 300), (50, 7850), (1000, 7850)):
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
        if d == 7850:
            row["ms"], row["host_ms"] = _time_ms(torch, kern)
            row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, ref)
            row["bound_ms"], row["bound_by"] = _bytes_bound(k * w_cnt * 4 + d * 4)
        rows.append(row)
        print(f"kernel packed_vote_counts K={k} d={d} W={w_cnt}: ok={ok} "
              f"deterministic={deterministic} device ops per call={row['device_ops_per_call']} "
              + " ".join(f"{key}={row[key]:.5f}" for key in
                         ("ms", "host_ms", "plain_ms", "bound_ms") if key in row)
              + (f" [{card}]" if d == 7850 else ""))
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
    for kw in (dict(agg="gm2"), dict(agg="gm", noise_var=1e-2, agg_maxiter=5),
               dict(agg="median", noise_var=1e-2), dict(agg="trimmed_mean", noise_var=1e-2),
               dict(agg="krum"),
               dict(agg="signmv", noise_var=1e-2, sign_bits=1, sign_eta=0.01)):
        cfg = FedConfig(honest_size=8, byz_size=2, attack="classflip", **kw)
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
        }
        new_cpu, var_cpu = cpu.iteration(cpu.flat_params, draws=draws, want_variance=True)
        on_gpu = {
            "u": draws["u"].cuda(),
            "fades": tuple(f.cuda() for f in draws["fades"]),
            "noise": draws["noise"].cuda(),
            "oma": channel.OmaTerms(*(t.cuda() for t in draws["oma"])),
            "vote_noise": draws["vote_noise"].cuda(),
        }
        new_gpu, var_gpu = gpu.iteration(gpu.flat_params, draws=on_gpu, want_variance=True)
        diff = (new_gpu.cpu() - new_cpu).abs()
        err = float(diff.max())
        differ = float((diff > 0).float().mean())
        errs[kw["agg"]] = dict(max_abs_err=err, share_of_coords_differing=differ,
                               variance_card=float(var_gpu), variance_cpu=float(var_cpu))
        print(f"one {kw['agg']} iteration, card vs CPU: max_abs_err={err:.3e} "
              f"share of coordinates differing={differ:.3e} "
              f"variance {float(var_gpu):.6e} vs {float(var_cpu):.6e}")
        if new_gpu.shape != (d,) or not bool(torch.isfinite(new_gpu).all()):
            _fail(f"{kw['agg']} iteration on the card gave non-finite params")
        # krum and signmv are discontinuous: a 1e-7 difference in the
        # client stack can flip a ballot or the argmin, so those two are
        # held bitwise on one shared stack below instead
        if kw["agg"] not in ("krum", "signmv") and err > ITER_ATOL:
            _fail(f"{kw['agg']} iteration on the card disagrees with the CPU: {err}")
        if abs(float(var_gpu) - float(var_cpu)) > 1e-4 * abs(float(var_cpu)):
            _fail(f"{kw['agg']} honest variance on the card disagrees with the CPU")

    # krum and signmv on the same stack, card vs CPU, bitwise
    from byzantine_aircomp_tpu_torch.ops import aggregators

    for k in (50, 1000):
        w, guess, _, _ = _inputs(torch, k, 7850, torch.float32, seed=k)
        z = torch.randn(7850, device="cuda", generator=torch.Generator(device="cuda").manual_seed(k))
        cases = {
            "krum": lambda t, **_: aggregators.krum(t, honest_size=int(0.8 * k)),
            "signmv1": lambda t, dev: aggregators.sign_majority_vote(
                t, guess=guess.to(dev), noise_var=1e-2, sign_bits=1, sign_eta=0.01,
                vote_noise=z.to(dev)),
            "signmv32": lambda t, dev: aggregators.sign_majority_vote(
                t, guess=guess.to(dev), noise_var=1e-2, vote_noise=z.to(dev)),
        }
        for name, fn in cases.items():
            on_card = fn(w, dev="cuda")
            on_cpu = fn(w.cpu(), dev="cpu")
            same = _same_bits(torch, on_card.cpu(), on_cpu)
            errs[f"{name}_same_stack_K{k}"] = dict(bitwise=same)
            print(f"{name} on one K={k} stack, card vs CPU: bitwise equal={same}")
            if not same:
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


def run_main_path(torch, kernels, harness, FedConfig, card, cache_dir):
    runs = {}
    for label, kw, rounds, kernel in (
        ("a_gm_var", dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10), 2,
         "aircomp_weiszfeld_step"),
        ("b_gm2", dict(agg="gm2", honest_size=900, byz_size=100), 1, "weiszfeld_step"),
        ("c_median_var", dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10), 2,
         "select_columns"),
        ("d_trimmed_mean_var", dict(agg="trimmed_mean", noise_var=1e-2, honest_size=900,
                                    byz_size=100), 1, "select_columns"),
        ("e_signmv1_var", dict(agg="signmv", noise_var=1e-2, sign_bits=1, sign_eta=0.01,
                               honest_size=900, byz_size=100), 1, "packed_vote_counts"),
    ):
        cfg = FedConfig(attack="classflip", rounds=rounds, display_interval=10,
                        cache_dir=cache_dir, **kw)
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer, record = harness.run_with_trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if launches[kernel] < rounds * cfg.display_interval:
            _fail(f"run {label} did not launch {kernel} in every iteration: {launches}")
        if not bool(torch.isfinite(trainer.flat_params).all()):
            _fail(f"run {label} ended with non-finite params")
        val_acc = record["valAccPath"][-1]
        if label == "a_gm_var" and not val_acc > 0.3:
            _fail(f"run {label}: val accuracy {val_acc} not above 0.3")
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
            profiled_iteration=prof, weiszfeld_per_step=per_step,
            config=dict(kw, attack="classflip", rounds=rounds, display_interval=10,
                        batch_size=cfg.batch_size),
            launches=launches, launches_per_round={n: c / rounds for n, c in launches.items()},
            val_acc=val_acc, val_acc_path=record["valAccPath"],
            rounds_per_sec=rps, wall_seconds=wall, card=card,
        )
        print(f"run {label}: launches={launches} val_acc={val_acc:.4f} "
              f"rounds/sec per round={['%.4f' % r for r in rps]} wall={wall:.1f}s "
              f"variance={record['variencePath']} [{card}]")
    return runs


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
                       kernels=line), f, indent=1)
    print(json.dumps({"kernels": line}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
