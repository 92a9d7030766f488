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
   Past one pass of the Weiszfeld steps (d > 132 x 8192, the wide plan),
   both kernels, both modes, f32 and bf16, one non-finite row, at
   [13, 1,081,345] and [50, 3,274,634] (the MNIST CNN), the ideal step also
   at [50, 11,173,962] (ResNet-18), each rerun for identical bits and
   timed beside its bound (two reads of the stack where it does not fit
   on chip, one where it does); the selection's median
   (with and without the channel fold) at [50, 11,173,962] beside
   ``torch.median``; the popcount at [200, 133,103 words] (the CIFAR-10
   CNN);
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
   (q) the reference's CNN (fc 1024, d = 3,274,634), gm2, K=50 (B=10);
   (r) the CNN, gm --var 1e-2, K=50 (B=10): 1000 Weiszfeld steps per
       aggregation, the paper's AirComp mode on the reference's own CNN;
       its solve diverges (as in the JAX package), so its params are not
       held finite: the kernel is held against its plain version on the
       run's first real stack instead (``MAY_DIVERGE``);
   (s) cifar10, ResNet-18 at width 64 (d = 11,173,962) with remat, median
       --var 1e-2, signflip, K=50 (B=5), no train-set eval;
   (t) cifar10_hard, the CNN (d = 4,259,274), --partition dirichlet
       --dirichlet-alpha 0.3, signmv --sign-bits 1 --sign-eta 0.01 --var
       1e-2, K=200 (B=40), no train-set eval; 1 round each;
   with the kernels' launch counters set to 0 before each run and read
   after it; each run must launch its kernel in every iteration.  One more
   iteration of each run is profiled (device busy ms, idle share, and the
   device ms of the run's own kernel); for (a) and (b) the CUDA kernels
   launched inside its Weiszfeld loop (the ``aggregators.WEISZFELD_LOOP_RANGE``
   profiler range), over that iteration's launches of the step kernel, give
   the CUDA kernels per Weiszfeld step (at most 4 for gm, 1 for gm2), and
   the range's host time over the same launches the host ms per step.
   Each run prints ``torch.cuda.max_memory_allocated`` too.
   Then ResNet-18 at full width, K=10: one iteration with remat on and
   one with it off from the same params and draws (params within 1e-6,
   both peak memories, the one with remat lower; the iteration without
   remat rerun for identical bits); one iteration on the card against the
   CPU for the CNN (gm2) and ResNet-18 (median --var), K=4, within 1e-4;
   and a CNN resume at K=10, 2 rounds straight against 1 round plus
   ``inherit``, bitwise;
   (u) the CNN, gm2, K=50 (B=10), 5 local steps (FedAvg), FedProx 0.01,
       server Adam 0.01: ``weiszfeld_step`` at [50, 3,274,634];
   (v) median --var, signflip, K=1000 (B=100), participation 0.5 (450 +
       50 drawn), buckets of 2: ``select_columns`` at [250, 7850];
   (w) cclip against alie, K=50 (B=10), client momentum 0.9, FedAvgM;
   (x) mean, --defense adaptive (the default ladder), signflip@1, K=50
       (B=10), 3 rounds: the rung must leave 0 and the trimmed_mean rung
       launch ``select_columns``; then duty_cycle and mimic 1 round each,
       finite params;
   (y) the CNN, median --var, under_radar, --defense monitor, K=50
       (B=10); under_radar needs a defense to read, so its twin against
       alie runs under monitor and under off, which must be bitwise equal;
   run (j) also resumes a second config (MLP K=50, client momentum, server
   Adam, buckets of 2, trimmed_mean, --defense adaptive with the ladder
   trimmed_mean,multi_krum), bitwise; and one iteration card vs CPU for
   the configs of (u) (the CNN at full width, K=4; under Adam the
   pseudo-gradient, see ``iteration_card_vs_cpu``), (v), (w) and (x) (at
   rung 1) at small K, within 1e-4;

   service rounds and cohort streaming: (z1) service gm2, K=50 (B=10),
   population 500, stragglers 0.1, 3 rounds, the params poisoned after
   round 1: exactly one warm rollback, ``weiszfeld_step`` every iteration
   on stacks with NaN rows, the effective K below 50 in every round, full
   finite paths, val accuracy above 0.3; (z2) streamed service gm2, K=1000
   (B=100), cohort 100, population 5000, stragglers 0.05, var 1e-2:
   ``weiszfeld_step`` at [100, 7850] once per chunk per Weiszfeld step, its
   steps per solve and host ms per step printed, and its resident twin
   within 1e-4 with equal effective-K and availability paths; (z3) the CNN,
   one iteration each: the streamed mean's peak memory at K=200 and K=1000
   (cohort 50) within 10%, beside the resident K=1000 mean's (or its out
   of memory), the streamed median at K=200 bitwise ``select_columns`` on
   the same rows, and the streamed gm2 at [50, 3,274,634] per chunk; and
   one iteration card vs CPU for service gm --var (``aircomp_weiszfeld_step``
   on NaN rows), service trimmed_mean --var under --defense adaptive at
   rung 1, and streamed gm2 at cohort 4, with the service draws shared;

   multi-round dispatch, each round one replay of a CUDA graph of the
   round: (z4) gm2 K=1000 (B=100), (z5) gm --var 1e-2 K=50 (B=10), (z6)
   median --var K=50 and trimmed_mean --var K=1000, (z7) the CNN gm2 K=50,
   (z8) gm2 under signflip with two local steps, FedProx, server Adam and
   the monitor defense, K=50, each 2 rounds as one R=2 dispatch through ``harness.run_with_trainer``
   beside its eager R=1 twin from the same seed: the record must be the
   twin's (evals repeated within the dispatch) and the params the twin's,
   bit for bit, from one capture, the run's kernel launched every round
   from the graph; printed: capture and warm-up seconds, the graph's nodes,
   rounds/sec of both, the idle share over one more dispatch, launches per
   round (the Weiszfeld steps after convergence apart) and both memory
   peaks; and (j3) run (j)'s resume under R=2 with ``--async-writer on``,
   bitwise;

   the event stream, forensics, the profiler and the memory model
   (``run_obs``): (z9) gm2 K=1000, eager, 7 rounds, with ``--obs-dir``,
   ``--defense monitor --forensics full --forensics-top 8`` and a
   ``torch.profiler`` trace of round 1, beside its twin with the stream
   and forensics off (records and params bitwise; the stream's kinds in
   order, every event valid; the trace's Weiszfeld kernels); (z10) the
   same as one graphed R=2 run of 8 rounds with the writer thread on
   (bitwise its graphed twin; each round's client_flag events bitwise
   z9's; one capture counted); (z11) gm --var K=50, graphed R=2; then the
   card's memory peak of each of those runs, of the CNN gm2 at K=50, the
   streamed CNN mean at K=200 and ResNet-18 at K=10 with and without remat,
   over the port's memory model, each within [0.5, 2.0]; events and
   stream bytes per round and the round time with the stream on and off
   are printed, and one ``platform: "cuda"`` ledger row per measure goes
   to ``chiprun_out/perf_ledger_cuda.jsonl``;

   live telemetry (``run_telemetry``): (z12) z9's config and z11's, each
   run off, on, on, off, on = the stream and ``--metrics on
   --metrics-port <a free port> --alerts
   byzantine_aircomp_tpu_torch/tools/alert_rules.json``, off = the stream
   alone: records and params bitwise, the
   kernel launched every iteration, ``/metrics`` and ``/healthz`` scraped
   live after two rounds (the round counter advancing), no exporter
   thread or port left after the run, the registry's round count and the
   alert summary in the stream's ``metrics_snapshot``, equal to a replay
   of the stream; host ms a round on against off, the scrape's ms and
   bytes and the registry's series are printed and go to the ledger;

   the implementation knobs (``run_z13``): (z13) gm2 K=1000, gm --var K=50
   and median --var K=50, one round each at ``--agg-impl pallas`` and
   ``xla`` in turns (pallas, xla) after an untimed warm-up:
   records and params within 1e-4 (the median's bitwise), the run's kernel
   launched every iteration under pallas and none of the four under xla
   (the wrappers' counts and, over one more profiled iteration, the
   device's by name), rounds/sec of each run; gm2 K=1000 and gm --var K=50
   at ``--stack-dtype bf16``, graphed R=2 bitwise its eager twin with the
   device count of ``count_replay_launches``, the final params within
   rtol/atol 2e-2 of the f32 run, and both fused steps at [1000, 7850] and
   [50, 7850] timed in f32 and bf16 beside their bounds; median --var K=50
   at ``--fused-epilogue off`` against auto, bitwise; ``--backend ref``
   through the CLI (one round of gm2 classflip at K=10, no JAX imported);
   the native reader built from ``native/dataio.cpp`` and read an IDX file
   and a CIFAR-10 batch equal to the NumPy path; and a sweep of (gm2,
   median, signmv --sign-bits 1) x (none, classflip) at K=20, one round a
   cell, each cell's kernel launched every iteration, with its table;

   the multi-GPU layouts (``run_z14``): (z14) (a) z2's streamed service
   gm2 at ``--pop-shards`` 1 (its record bitwise z2's) and 5 on the
   sequential engine, in turns, the device's ``weiszfeld_step`` count equal
   to steps x chunks, rounds/sec to the perf ledger keyed with pop_shards,
   and one pop_shards-4 iteration card vs CPU; (b) on a one-rank NCCL group,
   ``ShardedFedTrainer`` for run (b)'s gm2 K=1000 and run (a)'s gm --var
   K=50 within 1e-4 of the one-device trainer, its kernel counted on the
   device, NCCL's kernels counted, an all_reduce and a steady iteration
   timed; (c) several ranks where the machine has the cards, else a line
   that says so; (d) a DCP round trip of card params, bitwise; (e)
   ``fault_matrix``, ``bits_matrix`` and ``adaptive_matrix`` on the card,
   each kernel's launches counted, the two smoke gates passing;

   the experiment server (``run_z15``): (z15) an in-process server's lanes
   bitwise their solo runs, a profiled served round, the chaos ``smoke``
   on ``serve`` subprocesses and a tune (its docstring);

   the two-tier aggregation (``run_z16``): (z16) (a) one ``root`` and four
   ``edge`` subprocesses at k=1000, d=7850, 3 rounds, every result bitwise
   the flat aggregate on the card, which holds against the CPU's; the
   edges' ``weiszfeld_step`` launches equal the flat's and their
   ``packed_vote_counts`` launches edges x rounds, a profiled flat round
   counting both on the device; (b) edge 2 SIGKILLed after round 0, the
   survivors finishing degraded; (c) chaos ``edge_ledger`` at ingress at
   most flat/24;

   In runs z4-z8 and z13 the device count over two replays must be exactly
   what the wrappers counted (``LAUNCHES``): a profiler session that counts
   short (a lost record) is profiled again, at most three sessions, and
   one exact session passes; every session short, or any over, fails.  A
   graph with a WHILE node (gm2's) is profiled in a fresh process: in this
   one, after the earlier phases' profiler sessions, torch.profiler drops
   some of the loop bodies' records.  The profiled dispatch leaves the
   params of its eager twin's next two rounds, bit for bit, and a WHILE
   node's launches the twin's.  (z17), last, profiles z4's dispatch in this
   process: it must still be bitwise its twin's, and its device count,
   which may come short, is printed;

5. times the degraded median and trimmed mean (a ``torch.sort`` of the
   [1000, 7850] stack and a gather at a device rank, the path every
   ``--fault`` round of those rules takes) beside the kernel's.

Any failed check raises, so the exit code is not 0 and the result line is
not printed.  The ``kernels`` line holds each kernel at the shape this
slice's run gives it: the Weiszfeld steps at [50, 3,274,634] (runs q, r),
the median with the channel at [50, 11,173,962] (s), the popcount at
[200, 133,103 words] (t).  The script's wall time is printed before it.
The last two lines of standard output are the ``kernels``
JSON line and the ``ok`` JSON line, the card's name and power limit before
them.  Details go to ``chiprun_out/chip_smoke.json``.  Exits with code 2
and prints nothing on standard output when no GPU is visible.
"""

import gc
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
# the widths of this slice's models: the MNIST CNN (fc 1024), the CIFAR-10
# CNN and ResNet-18 at width 64 on CIFAR-10
CNN_D = 3274634
CIFAR_CNN_D = 4259274
RESNET_D = 11173962
# the first width past one pass of the Weiszfeld steps on 132 SMs
# (132 x 8192 + 1: the wide plan), ragged
WIDE_D = 1081345
# the select_columns shapes timed: the main path's, with bulyan's median of
# its theta = 30 rows at K=50 and cclip's median of the K=50 delta norms,
# the EMNIST width's and ResNet-18's, run (v)'s 250 bucket means and run
# (y)'s CNN width
SELECT_TIMED = ((50, 7850), (1000, 7850), (30, 7850), (50, 1), (50, EMNIST_D),
                (1000, EMNIST_D), (50, RESNET_D), (250, 7850), (50, CNN_D))
# (K, d) at which the Weiszfeld steps' fused mode and the popcount are timed
TIMED = ((50, 7850), (1000, 7850), (50, EMNIST_D), (1000, EMNIST_D), (13, WIDE_D),
         (50, CNN_D), (50, RESNET_D), (200, CIFAR_CNN_D))
# run (z16)'s one-bit vote: one edge's 250 rows at the MLP's width (246 words)
Z16_VOTE = (250, 7850)


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


def _on_chip_bytes(torch):
    """What the card can hold on chip at once: L2 plus every SM's shared
    memory and register file (H100 SXM: 50 MB + 132 x (228 + 256) KiB)."""
    p = torch.cuda.get_device_properties(0)
    l2 = getattr(p, "L2_cache_size", 50 * 2**20)
    smem = getattr(p, "shared_memory_per_multiprocessor", 228 * 2**10)
    regs = getattr(p, "regs_per_multiprocessor", 65536) * 4
    return l2 + p.multi_processor_count * (smem + regs)


def _stack_reads(torch, k, d, elem_bytes):
    """How often a Weiszfeld step must read a [K, d] stack from device
    memory at the least: once where the stack fits on chip, twice where it
    does not.  No column's num can be summed before every row's weight is
    known, which needs the whole row, so a stack that cannot stay on chip
    between the two is streamed once for the distances and once for the
    sums, whatever the kernel's plan."""
    return 1 if k * d * elem_bytes <= _on_chip_bytes(torch) else 2


def _bound(k, d, elem_bytes, aircomp, reads=1):
    """Least time for one step: read the stack ``reads`` times (see
    :func:`_stack_reads`), g (and h_sq, s) once, write num and den; flops:
    diff, square-add and weighted add per element (+ the norm's
    square-add for the AirComp step)."""
    nbytes = reads * k * d * elem_bytes + 2 * d * 4 + 4 + (k * 4 + 4 if aircomp else 0)
    flops = k * d * (6 if aircomp else 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# past one pass (the wide plan): both kernels at the first such width and
# the MNIST CNN's, the ideal step also at ResNet-18's
WIDE_SHAPES = {"weiszfeld_step": [(13, WIDE_D), (50, CNN_D), (50, RESNET_D)],
               "aircomp_weiszfeld_step": [(13, WIDE_D), (50, CNN_D)]}


def check_kernels(torch, kernels):
    rows = []
    # (100, 7850): run (z2)'s streamed gm2 chunk
    shapes = [(50, 7850), (60, 7850), (100, 7850), (1000, 7850), (13, 300), (50, EMNIST_D),
              (1000, EMNIST_D)]
    for name, kern, ref in (
        ("weiszfeld_step", kernels.weiszfeld_step, kernels.weiszfeld_step_ref),
        ("aircomp_weiszfeld_step", kernels.aircomp_weiszfeld_step,
         kernels.aircomp_weiszfeld_step_ref),
    ):
        air = name.startswith("aircomp")
        for k, d in shapes + WIDE_SHAPES[name]:
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
                reads = _stack_reads(torch, k, d, w.element_size())
                bound_ms, bound_by = _bound(k, d, w.element_size(), air, reads)
                row = dict(
                    name=name, mode="num_den", k=k, d=d, dtype=str(dtype).replace("torch.", ""),
                    stack_reads_in_bound=reads,
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


def _fused_bound(k, d, elem_bytes, aircomp, reads=1):
    """Least time for one fused step: read the stack ``reads`` times (see
    :func:`_stack_reads`), g_in (and the fades, z and the scaler) once,
    write g_out and the state; flops as :func:`_bound` plus the update's
    few per column."""
    nbytes = reads * k * d * elem_bytes + 2 * d * 4 + 12 + (
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
        for k, d in shapes + WIDE_SHAPES[name]:
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
                    row["stack_reads_in_bound"] = _stack_reads(torch, k, d, w.element_size())
                    row["bound_ms"], row["bound_by"] = _fused_bound(
                        k, d, w.element_size(), air, row["stack_reads_in_bound"])
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


def time_fused_nan_rows_and_idle(torch, kernels, card):
    """The ideal fused step on the service round's stack, [50, 7850] with
    NaN rows (5 of 50, as late clients leave them), against its plain
    version and timed beside its bound; and the step after convergence
    (``active`` = 0: the guess copied, nothing else), which a CUDA graph of
    the round replays ``agg_maxiter`` minus the live steps times per
    aggregation, at [50, 7850], [1000, 7850] and [50, 3,274,634], beside
    the bound of the copy (read and write d floats)."""
    rows = []
    w, guess, _, _ = _inputs(torch, 50, 7850, torch.float32, seed=57850)
    w[[3, 11, 19, 27, 35]] = float("nan")
    state = (torch.ones((), dtype=torch.int32, device="cuda"),
             torch.zeros((), dtype=torch.int64, device="cuda"),
             torch.ones(1, device="cuda"))  # no scaler for gm2: a placeholder
    got = _fused_call(torch, kernels, False, w, guess, torch.empty_like(guess), state, 0.0,
                      None)
    want = _fused_ref_call(kernels, False, w, guess, state, 0.0, None)
    torch.cuda.synchronize()
    err = float((got[0] - want[0]).abs().max())
    if not err <= KERNEL_RTOL * float(want[0].abs().max()) + KERNEL_ATOL:
        _fail(f"weiszfeld_step fused on NaN rows disagrees with its plain version: {err}")
    active, steps = state[0].clone(), state[1].clone()
    g_out = torch.empty_like(guess)
    ms, host_ms = _time_ms(torch, lambda: kernels.weiszfeld_step_fused(
        w, guess, g_out, active, steps, -1.0), **_reps(50, 7850))
    plain_ms, _ = _time_ms(torch, lambda: _fused_ref_call(kernels, False, w, guess, state, -1.0,
                                                          None), **_reps(50, 7850))
    bound_ms, bound_by = _fused_bound(50, 7850, 4, False)
    row = dict(name="weiszfeld_step", mode="fused_nan_rows", k=50, d=7850, dtype="float32",
               nan_rows=5, max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    rows.append(row)
    print(f"kernel weiszfeld_step fused K=50 d=7850 with 5 NaN rows: max_abs_err={err:.3e} "
          f"ms={ms:.5f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} ({bound_by}) [{card}]")
    for k, d in ((50, 7850), (1000, 7850), (50, CNN_D)):
        w, guess, _, _ = _inputs(torch, k, d, torch.float32, seed=k + d)
        idle, steps = torch.zeros((), dtype=torch.int32, device="cuda"), torch.zeros(
            (), dtype=torch.int64, device="cuda")
        g_out = torch.empty_like(guess)
        kernels.weiszfeld_step_fused(w, guess, g_out, idle, steps, 1e-5)
        torch.cuda.synchronize()
        if not _same_bits(torch, g_out, guess) or int(steps) != 0:
            _fail(f"the step after convergence changed the guess at K={k} d={d}")
        ms, host_ms = _time_ms(torch, lambda: kernels.weiszfeld_step_fused(
            w, guess, g_out, idle, steps, 1e-5), **_reps(k, d))
        copy_bound = 2 * d * 4 / HBM_BYTES_PER_S * 1e3
        rows.append(dict(name="weiszfeld_step", mode="fused_after_convergence", k=k, d=d,
                         dtype="float32", max_abs_err=0.0, ms=ms, host_ms=host_ms,
                         bound_ms=copy_bound, bound_by="bytes"))
        print(f"kernel weiszfeld_step fused after convergence K={k} d={d}: ms={ms:.5f} "
              f"host_ms={host_ms:.4f} copy bound_ms={copy_bound:.5f} [{card}]")
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


def _device_kernel_names(torch, fn, tries=3):
    """The device kernels, copies and memsets one call of ``fn`` issues.  A
    profile that caught no device event at all is taken again, up to
    ``tries`` times: the call did run on the card (its result is checked),
    so an empty capture is the tracer's miss, not the call's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [ev.name for ev in _device_events(torch, prof)]
        if names:
            break
    return names


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
             (1000, EMNIST_D, "adversarial"), (1000, EMNIST_D, "plain"),
             (50, RESNET_D, "adversarial"), (50, RESNET_D, "plain"),
             (250, 7850, "adversarial"), (250, 7850, "plain"), (50, CNN_D, "plain")]
    for k, d, stack in cases:
        timed = (k, d) in SELECT_TIMED and stack == "plain"
        adversarial = stack == "adversarial"
        w, terms = _select_inputs(torch, k, d, seed=k + d + adversarial, adversarial=adversarial)
        if stack == "ties":
            w = _tie_stack(torch, k, d, seed=k * d)
        plan = kernels.select_plan(w.device, k, d)
        print(f"select_columns plan K={k} d={d}: {plan}")
        b = int(0.1 * k)
        modes = (("median", None), ("median", terms),
                 ("trimmed_mean", None), ("trimmed_mean", terms))
        if d in (RESNET_D, CNN_D):  # runs (s), (y): the median, with and without the fold
            modes = modes[:2]
        for mode, ch in modes:
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

    for k, d in ((1, 1), (70, 33), (13, 300), (50, 7850), Z16_VOTE, (1000, 7850),
                 (50, EMNIST_D), (1000, EMNIST_D), (200, CIFAR_CNN_D)):
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
        if (k, d) in TIMED + (Z16_VOTE,):
            row["ms"], row["host_ms"] = _time_ms(torch, kern, **_reps(k, d))
            row["plain_ms"], row["plain_host_ms"] = _time_ms(torch, ref, **_reps(k, d))
            row["bound_ms"], row["bound_by"] = _bytes_bound(k * w_cnt * 4 + d * 4)
        rows.append(row)
        print(f"kernel packed_vote_counts K={k} d={d} W={w_cnt}: ok={ok} "
              f"deterministic={deterministic} device ops per call={row['device_ops_per_call']} "
              + " ".join(f"{key}={row[key]:.5f}" for key in
                         ("ms", "host_ms", "plain_ms", "bound_ms") if key in row)
              + (f" [{card}]" if (k, d) in TIMED + (Z16_VOTE,) else ""))
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
        # krum and signmv are discontinuous: a 1e-7 difference in the
        # client stack can flip a ballot or the argmin, so those two are
        # held bitwise on one shared stack below instead
        errs[label] = iteration_card_vs_cpu(torch, cfg, ds, label,
                                            hold=kw["agg"] not in ("krum", "signmv"))

    errs.update(check_shared_stacks(torch))
    return errs


class _DeltaTap:
    """Records the pseudo-gradient ``flat - aggregated`` each trainer hands
    its server optimizer (``fed.server_opt.step``), per device."""

    def __init__(self):
        from byzantine_aircomp_tpu_torch.fed import train

        self.module, self.seen = train.server_opt_lib, {}

    def __enter__(self):
        self.step = self.module.step
        tap = self

        def step(kind, flat, aggregated, state, lr, momentum):
            tap.seen[flat.device.type] = (flat - aggregated, state)
            return tap.step(kind, flat, aggregated, state, lr, momentum)

        self.module.step = step
        return self

    def __exit__(self, *exc):
        self.module.step = self.step


def check_option_iterations(torch, FedConfig):
    """One iteration card vs CPU for the configs of runs (u)-(x), at
    small K: (u) the CNN at full width (K=4), 5 local steps, FedProx,
    server Adam, gm2; (v) median --var under participation 0.5 of 36 + 4
    and buckets of 2; (w) cclip against alie with client momentum and
    FedAvgM; (x) the adaptive defense on mean, its policy set to rung 1, so
    that the trimmed_mean rung aggregates (select_columns on the card)."""
    from byzantine_aircomp_tpu_torch.data import datasets

    ds = datasets.load("mnist", synthetic_train=3000, synthetic_val=500)

    def rung_one(t):
        det, (rung, up, down, budget) = t.defense_state
        t.defense_state = (det, (torch.ones_like(rung), up, down, budget))

    cases = (
        ("u_cnn_fedavg_prox_adam_gm2", dict(
            model="CNN", agg="gm2", attack="classflip", honest_size=3, byz_size=1,
            batch_size=16, agg_maxiter=100, local_steps=5, fedprox_mu=0.01,
            server_opt="adam", server_lr=0.01), None),
        ("v_participation_bucketing_median_var", dict(
            agg="median", attack="signflip", noise_var=1e-2, honest_size=36, byz_size=4,
            participation=0.5, bucket_size=2), None),
        ("w_client_momentum_cclip_alie", dict(
            agg="cclip", attack="alie", honest_size=8, byz_size=2, client_momentum=0.9,
            server_opt="momentum"), None),
        ("x_defense_adaptive_rung1_signflip", dict(
            agg="mean", attack="signflip", defense="adaptive", honest_size=8, byz_size=2),
         rung_one),
    )
    return {label: iteration_card_vs_cpu(torch, FedConfig(**kw), ds, label, prepare=prep)
            for label, kw, prep in cases}


def iteration_card_vs_cpu(torch, cfg, ds, label, hold=True, prepare=None):
    """One iteration of ``cfg`` on the card against the same iteration on
    the CPU (plain versions), from the same params and draws; the new
    params within ``ITER_ATOL`` (where ``hold``), the honest variance
    within 1e-4 relative (under service or streaming, a difference of
    moments: within 1e-6 of the squared norm it cancels), the fault and
    service counts equal.  ``prepare(trainer)``
    sets both trainers' carried state first.

    Under server Adam the pseudo-gradients are held within ``ITER_ATOL``
    instead of the params everywhere: Adam's first step sends each
    coordinate about ``-lr * sign(delta)``, so where the aggregate sits
    within float rounding of the params a last-bit difference flips the
    step.  There the card's optimizer on the CPU's pseudo-gradient must
    give the CPU's params, and the card's own params must match wherever
    |delta| > 1e-5 (there a 1e-7 error in delta moves Adam's first step by
    at most ~1e-7)."""
    from byzantine_aircomp_tpu_torch.fed import server_opt
    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.ops import channel

    cpu = Trainer(cfg, dataset=ds, device="cpu")
    gpu = Trainer(cfg, dataset=ds, device="cuda", params=cpu.flat_params)
    if prepare is not None:
        prepare(cpu)
        prepare(gpu)
    g = torch.Generator().manual_seed(3)
    m_h, m_b = cfg.participant_counts()
    k, d = m_h + m_b, cpu.dim
    gm = cfg.agg == "gm"
    draws = {
        "u": torch.rand(k, cfg.local_steps * cfg.batch_size, generator=g),
        "fades": (torch.randn(cfg.agg_maxiter, k, generator=g) / 2**0.5,
                  torch.randn(cfg.agg_maxiter, k, generator=g) / 2**0.5) if gm else None,
        "noise": torch.randn(cfg.agg_maxiter, d + 1, generator=g) if gm else None,
        "oma": channel.oma_terms(k, d, 1e-2, generator=g),
        "vote_noise": torch.randn(d, generator=g),
        "fault": _fault_draws(torch, cpu.fault, k, g) if cfg.fault is not None else None,
        # the gaussian attack's normals; the other attacks draw none
        "message": (torch.randn(cfg.byz_size, d, generator=g)
                    if cfg.attack == "gaussian" else None),
    }
    if cfg.participation < 1.0:
        draws["part"] = cpu.draw_participants(g)
    if cfg.bucket_size > 1:
        draws["bucket"] = torch.randperm(k, generator=g)
    if cfg.service == "on":
        # the draw's priorities, the churn's masks and the stragglers
        pop_h, pop_b = cfg.population_counts()
        pop = cfg.population
        draws["service_u"] = (torch.rand(pop_h, generator=g), torch.rand(pop_b, generator=g))
        draws["churn"] = (torch.rand(pop, generator=g) < cfg.churn_arrival,
                          torch.rand(pop, generator=g) < cfg.churn_departure)
        draws["late"] = torch.rand(k, generator=g) < cfg.straggler_prob
    with _DeltaTap() as tap:
        new_cpu, var_cpu = cpu.iteration(cpu.flat_params, draws=draws, want_variance=True)
        new_gpu, var_gpu = gpu.iteration(gpu.flat_params, draws=_to(draws, "cuda"),
                                         want_variance=True)
    diff = (new_gpu.cpu() - new_cpu).abs()
    out = {}
    if cfg.server_opt == "adam":
        (delta_cpu, state_cpu), (delta_gpu, _) = tap.seen["cpu"], tap.seen["cuda"]
        delta_err = float((delta_gpu.cpu() - delta_cpu).abs().max())
        upd, _ = server_opt.update("adam", delta_cpu.to("cuda"), _to(state_cpu, "cuda"),
                                   cfg.server_lr, cfg.server_momentum)
        replay_err = float((cpu.flat_params.to("cuda") + upd - new_cpu.to("cuda")).abs().max())
        sure = delta_cpu.abs() > 1e-5
        out.update(pseudo_gradient_max_abs_err=delta_err, replay_max_abs_err=replay_err,
                   share_held=float(sure.float().mean()),
                   max_abs_err_all_coords=float(diff.max()))
        print(f"{label}: pseudo-gradient card vs CPU max_abs_err={delta_err:.3e}, the card's "
              f"Adam on the CPU's pseudo-gradient vs the CPU's params {replay_err:.3e}, "
              f"params held on the {float(sure.float().mean()):.3f} share with |delta| > 1e-5")
        if delta_err > ITER_ATOL or replay_err > ITER_ATOL:
            _fail(f"{label}: the pseudo-gradient or the card's Adam disagrees with the CPU")
        diff = diff[sure.cpu()]
    err = float(diff.max())
    differ = float((diff > 0).float().mean())
    out.update(max_abs_err=err, share_of_coords_differing=differ, d=d,
               variance_card=float(var_gpu), variance_cpu=float(var_cpu))
    if cfg.defense != "off":
        got = gpu.iteration_defense_metrics.cpu()
        want = cpu.iteration_defense_metrics
        out["defense_metrics_card"] = got.tolist()
        if not torch.equal(got[:3], want[:3]):
            _fail(f"{label}: the rung or the flag counts differ card vs CPU: {got} {want}")
    fault_str = ""
    if cfg.service == "on":
        counts_cpu = cpu.iteration_service_metrics.tolist()
        counts_gpu = gpu.iteration_service_metrics.cpu().tolist()
        out["service_counts"] = counts_gpu
        fault_str = f" service counts (avail, absent, late, effK) card {counts_gpu} CPU {counts_cpu}"
        if counts_gpu != counts_cpu or counts_cpu[3] >= k:
            _fail(f"{label}: service counts differ or no row missed the deadline: {fault_str}")
    if cfg.fault is not None:
        counts_cpu = cpu.iteration_fault_metrics.tolist()
        counts_gpu = gpu.iteration_fault_metrics.cpu().tolist()
        out["fault_counts"] = counts_gpu
        fault_str = f" fault counts card {counts_gpu} CPU {counts_cpu}"
        if counts_gpu != counts_cpu or counts_cpu[3] >= k:
            _fail(f"{label}: fault counts differ or nothing was faulted: {fault_str}")
    print(f"one {label} iteration, card vs CPU: max_abs_err={err:.3e} (tolerance "
          f"{ITER_ATOL:.0e}) share of coordinates differing={differ:.3e} "
          f"variance {float(var_gpu):.6e} vs {float(var_cpu):.6e} (rtol 1e-4){fault_str}")
    if new_gpu.shape != (d,) or not bool(torch.isfinite(new_gpu).all()):
        _fail(f"{label} iteration on the card gave non-finite params")
    if hold and err > ITER_ATOL:
        _fail(f"{label} iteration on the card disagrees with the CPU: {err}")
    # an erased or corrupted honest row makes the variance NaN on both
    same_nan = math.isnan(float(var_gpu)) and math.isnan(float(var_cpu))
    var_tol = 1e-4 * abs(float(var_cpu))
    if cfg.service == "on" or cfg.cohort_size:
        # the service and streamed variance is a difference of moments,
        # sum ||w||^2 / n - ||mean||^2 (the JAX package's formula): it keeps
        # the f32 rounding of the squared norm it cancels, ~||params||^2
        var_tol = 1e-6 * float(torch.sum(cpu.flat_params.double() ** 2))
    if not same_nan and not abs(float(var_gpu) - float(var_cpu)) <= var_tol:
        _fail(f"{label} honest variance on the card disagrees with the CPU")
    return out


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


def _ranges():
    """The profiler ranges the port opens: the Weiszfeld loop, the clients'
    local steps and the adaptive defense's host read of the rung."""
    from byzantine_aircomp_tpu_torch.defense.policy import RUNG_READ_RANGE
    from byzantine_aircomp_tpu_torch.fed.train import CLIENT_STEP_RANGE
    from byzantine_aircomp_tpu_torch.ops.aggregators import WEISZFELD_LOOP_RANGE

    return WEISZFELD_LOOP_RANGE, CLIENT_STEP_RANGE, RUNG_READ_RANGE


def _span_names():
    """Every profiler range the port opens: its spans (``obs/span.py``),
    the Weiszfeld loop, the defense's rung read, and ``--profile-dir``'s
    round and phases."""
    from byzantine_aircomp_tpu_torch.obs.profile import PHASES, ROUND_RANGE
    from byzantine_aircomp_tpu_torch.obs.span import SPANS

    weiszfeld, _, rung = _ranges()
    return frozenset(SPANS + (weiszfeld, rung, ROUND_RANGE) + PHASES)


def _device_events(torch, prof):
    """The device work of a profile: kernels, copies and memsets, without
    the device-side shadows of profiler ranges (user annotations; by name
    too, where this torch does not flag them)."""
    names = _span_names()
    return [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.name not in names]


def _device_kernels(torch, prof):
    """The device kernels of a profile (copies and memsets left out)."""
    return [ev for ev in _device_events(torch, prof)
            if not ev.name.startswith(("Memcpy", "Memset"))]


def _range_kernels(torch, prof, name):
    """The ranges ``name`` of a profile: their number, their host ms, and
    the device kernels launched inside them (copies and memsets left out),
    with those kernels' device ms.  A kernel belongs to a range when the
    runtime call that launched it (``cudaLaunchKernel``,
    ``cudaLaunchCooperativeKernel``, ...; the same correlation id) started
    on the host inside the range."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    spans = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.device_type == cpu and ev.name == name]
    launched = {ev.id for ev in events
                if ev.device_type == cpu and ev.name.startswith("cu")
                and any(s <= ev.time_range.start <= e for s, e in spans)}
    inside = [ev for ev in _device_kernels(torch, prof) if ev.id in launched]
    host_ms = sum(e - s for s, e in spans) / 1e3
    device_ms = sum(ev.device_time_total for ev in inside) / 1e3
    return len(spans), host_ms, [ev.name for ev in inside], device_ms


# each wrapper's device kernels, as the profiler names them (the Weiszfeld
# steps' two plans: step_kernel, and wide_kernel past one pass)
_WEISZFELD_NAMES = ("step_kernel", "wide_kernel")
DEVICE_NAMES = {"weiszfeld_step": _WEISZFELD_NAMES, "aircomp_weiszfeld_step": _WEISZFELD_NAMES,
                "select_columns": ("select_kernel",), "packed_vote_counts": ("count_kernel",)}


def _is_kernel_of(name, kernel):
    return any(n in name for n in DEVICE_NAMES[kernel])


# the wrappers counted together on the device: the two Weiszfeld wrappers
# launch the same kernels
DEVICE_GROUPS = (("weiszfeld_step", "aircomp_weiszfeld_step"), ("select_columns",),
                 ("packed_vote_counts",))


def _device_launches(torch, prof):
    """The device kernels of each of :data:`DEVICE_GROUPS` in a profile,
    counted by name: what ran on the card, not what a wrapper counted."""
    names = [ev.name for ev in _device_kernels(torch, prof)]
    return {"+".join(group): sum(_is_kernel_of(n, group[0]) for n in names)
            for group in DEVICE_GROUPS}


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
    before = kernels.LAUNCHES[kernel] if kernel else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.iteration(trainer.flat_params, gens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = (kernels.LAUNCHES[kernel] - before) if kernel else 0
    per_kernel, spans = {}, []
    for ev in _device_events(torch, prof):
        name = _short(ev.name)
        per_kernel[name] = per_kernel.get(name, 0.0) + ev.device_time_total / 1e3
        spans.append((ev.time_range.start, ev.time_range.end))
    # busy: the union of the device spans (cuDNN may run kernels side by
    # side, so their summed times can exceed the wall)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    busy_ms = busy_us / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    # the run's own kernel: its device ms and launches in this iteration
    own = [ev for ev in _device_kernels(torch, prof)
           if kernel and _is_kernel_of(ev.name, kernel)]
    out = dict(
        kernel_device_ms=sum(ev.device_time_total for ev in own) / 1e3,
        kernel_device_launches=len(own),
        wall_ms=wall_ms,
        device_busy_ms=busy_ms if busy_ms > 0 else None,
        device_summed_ms=sum(per_kernel.values()),
        idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0 else None,
        device_kernels=len(_device_kernels(torch, prof)),
        top_kernels_ms=top,
    )
    weiszfeld, client, rung = _ranges()
    for label, name in (("client_step", client), ("rung_read", rung)):
        n, host, kernels_in, device = _range_kernels(torch, prof, name)
        if n:
            # the share of the iteration's device time that the range's
            # kernels take, and its host ms (the rung read: the wait for
            # the device to drain up to the read)
            out[label] = dict(ranges=n, host_ms=host, device_ms=device, kernels=len(kernels_in),
                              share_of_device_ms=device / max(out["device_summed_ms"], 1e-9))
    loops, host_ms, inside, _ = _range_kernels(torch, prof, weiszfeld)
    if loops and kernel:
        # the step kernel's own launches, found in the profile, must be the
        # ones the counter saw: else the profile missed launches
        found = sum(_is_kernel_of(name, kernel) for name in inside)
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
    ("q_cnn_gm2", dict(agg="gm2", model="CNN", honest_size=40, byz_size=10), 1,
     "weiszfeld_step", 1),
    ("r_cnn_gm_var", dict(agg="gm", noise_var=1e-2, model="CNN", honest_size=40,
                          byz_size=10), 1, "aircomp_weiszfeld_step", 1),
    ("s_resnet18_median_var_signflip", dict(
        agg="median", attack="signflip", noise_var=1e-2, model="ResNet18", dataset="cifar10",
        remat=True, eval_train=False, honest_size=45, byz_size=5), 1, "select_columns", 1),
    ("t_cifar_cnn_dirichlet_signmv1_var", dict(
        agg="signmv", sign_bits=1, sign_eta=0.01, noise_var=1e-2, model="CNN",
        dataset="cifar10_hard", partition="dirichlet", dirichlet_alpha=0.3,
        eval_train=False, honest_size=160, byz_size=40), 1, "packed_vote_counts", 1),
    ("u_cnn_fedavg_prox_adam_gm2", dict(
        agg="gm2", model="CNN", honest_size=40, byz_size=10, local_steps=5, fedprox_mu=0.01,
        server_opt="adam", server_lr=0.01), 1, "weiszfeld_step", 1),
    ("v_participation_bucketing_median_var", dict(
        agg="median", attack="signflip", noise_var=1e-2, honest_size=900, byz_size=100,
        participation=0.5, bucket_size=2), 1, "select_columns", 1),
    ("w_client_momentum_cclip_alie", dict(
        agg="cclip", attack="alie", honest_size=40, byz_size=10, client_momentum=0.9,
        server_opt="momentum"), 1, "select_columns", 3),
    # the trimmed_mean rung launches select_columns only from its escalation
    # on: checked by check_escalation, not per iteration
    ("x_defense_adaptive_signflip", dict(
        agg="mean", attack="signflip@1", defense="adaptive", honest_size=40, byz_size=10),
     3, "select_columns", 0),
    ("y_cnn_defense_monitor_under_radar", dict(
        agg="median", attack="under_radar", noise_var=1e-2, model="CNN", defense="monitor",
        honest_size=40, byz_size=10), 1, "select_columns", 1),
)
# each run's flat width where it is not the MNIST MLP's 7,850
RUN_D = {"n_emnist_gm2": EMNIST_D, "o_emnist_median_var_gaussian": EMNIST_D,
         "p_emnist_signmv1_ipm": EMNIST_D, "q_cnn_gm2": CNN_D, "r_cnn_gm_var": CNN_D,
         "s_resnet18_median_var_signflip": RESNET_D,
         "t_cifar_cnn_dirichlet_signmv1_var": CIFAR_CNN_D, "u_cnn_fedavg_prox_adam_gm2": CNN_D,
         "y_cnn_defense_monitor_under_radar": CNN_D}
# runs whose accuracy after 2 rounds must pass 0.3
ACCURACY_BAR = ("a_gm_var", "i_gm2_chaos", "j_resume_gm2")
# runs whose params may end non-finite, a check this slice gives up for
# them: the noisy AirComp Weiszfeld solve (gm, var 1e-2) diverges on the
# CNN's 3.27M coordinates, in the JAX package as in the port
# (tests/test_torch_gm_cnn.py), since the receiver noise's norm grows as
# sqrt(d) past the clients' spread.  Their aggregations after the first
# run on non-finite stacks, so their launch counts are not a live solve's;
# the kernel is held against the plain version on the run's first stack
# instead (check_real_stack)
MAY_DIVERGE = ("r_cnn_gm_var",)
# the run whose message attack runs under torch.cuda.set_sync_debug_mode("error")
SYNC_GUARDED = "l_minsum_median_var"
# run (j)'s second resume config: the carried state of the training options
# and the adaptive defense (server Adam, client momentum, buckets, detector
# and policy), MLP K=50, 2 rounds cut after round 1
RESUME_OPTIONS = dict(agg="trimmed_mean", attack="signflip", honest_size=40, byz_size=10,
                      client_momentum=0.9, server_opt="adam", bucket_size=2,
                      defense="adaptive", defense_ladder="trimmed_mean,multi_krum")


def _same_record(a, b):
    """Two records equal in every entry but ``roundsPerSec`` (host clock);
    floats compared as bits, NaN included (the defense ladder, a list of
    names, by value)."""
    for key in a:
        if key == "roundsPerSec":
            continue
        x, y = a[key], b[key]
        if isinstance(x, list) and all(isinstance(u, float) for u in x + y):
            if len(x) != len(y) or any(
                    struct.pack("<d", u) != struct.pack("<d", v) for u, v in zip(x, y)):
                return False
        elif isinstance(x, list):
            if x != y:
                return False
        elif x != y:
            return False
    return set(a) == set(b)


def run_resume(torch, kernels, harness, cfg, label="j", cut=1):
    """Run (j): ``cfg`` straight through, and again as ``cut`` rounds with a
    checkpoint per round (per dispatch) and then ``inherit`` to the end in a
    fresh Trainer; the final params and the paths (all but ``roundsPerSec``)
    must be bitwise equal.  Returns the resumed run's (trainer, record),
    with the launches of all three runs."""
    import dataclasses
    import shutil

    ck = os.path.join(cfg.cache_dir, f"ckpt_{label}")
    shutil.rmtree(ck, ignore_errors=True)
    straight_t, straight = harness.run_with_trainer(cfg, device="cuda")
    harness.run_with_trainer(dataclasses.replace(cfg, rounds=cut, checkpoint_dir=ck),
                             device="cuda")
    resumed_t, resumed = harness.run_with_trainer(
        dataclasses.replace(cfg, checkpoint_dir=ck, inherit=True), device="cuda")
    torch.cuda.synchronize()
    same_params = torch.equal(straight_t.flat_params, resumed_t.flat_params)
    same_paths = _same_record(straight, resumed)
    print(f"run {label} resume: {cfg.rounds} rounds straight vs {cut} round(s) + --inherit "
          f"to {cfg.rounds} in a fresh Trainer: "
          f"params bitwise equal={same_params}, paths bitwise equal={same_paths} "
          f"(valAccPath {straight['valAccPath']} vs {resumed['valAccPath']})")
    if not (same_params and same_paths):
        diff = float((straight_t.flat_params - resumed_t.flat_params).abs().max())
        _fail(f"run {label}: the resumed run differs from the straight run (params max abs "
              f"diff {diff}; paths equal {same_paths})")
    return resumed_t, resumed


def check_real_stack(torch, kernels, trainer, card, steps=3):
    """gm with ``--var`` on a wide model, whose run may diverge: the first
    aggregation of ``trainer``'s first iteration (its real client stack and
    guess), ``steps`` fused AirComp steps through the kernel and through its
    plain version from the same draws, within the kernel tolerance.
    :func:`check_fused` holds the kernel on synthetic stacks; this is the
    run's own.  ``trainer`` is left as it was."""
    from byzantine_aircomp_tpu_torch.ops import channel

    seen, agg = {}, trainer.agg_fn

    def capture(w, **kw):
        seen["w"], seen["guess"] = w, kw["guess"]
        return agg(w, **kw)

    trainer.agg_fn = capture
    try:
        trainer.iteration(trainer.flat_params, trainer.iteration_generators(0, 0))
    finally:
        trainer.agg_fn = agg
    w, g0 = seen["w"], seen["guess"].clone()
    k, d = w.shape
    g = torch.Generator(device="cuda").manual_seed(7)
    h_r = channel.FADE_STD * torch.randn(steps, k, device="cuda", generator=g)
    h_i = channel.FADE_STD * torch.randn(steps, k, device="cuda", generator=g)
    z = torch.randn(steps, d + 1, device="cuda", generator=g)
    noise_scale = torch.sqrt(torch.tensor(trainer.cfg.noise_var, dtype=torch.float32) / 2.0)
    one = lambda: torch.ones((), dtype=torch.int32, device="cuda")  # noqa: E731
    zero = lambda: torch.zeros((), dtype=torch.int64, device="cuda")  # noqa: E731
    kern = [g0.clone(), one(), zero(), kernels.guess_rms(g0)]
    plain = [g0.clone(), one(), zero(), kernels.guess_rms(g0)]
    errs = []
    for i in range(steps):
        out = kernels.aircomp_weiszfeld_step_fused(
            w, kern[0], torch.empty_like(g0), kern[1], kern[2], -1.0, h_r[i], h_i[i],
            kern[3].clone(), z=z[i], noise_scale=noise_scale)
        kern = [out[0].clone(), out[1], out[2], out[3]]
        plain = list(kernels.aircomp_weiszfeld_step_fused_ref(
            w, plain[0], plain[1], plain[2], -1.0, h_r[i], h_i[i], plain[3], z=z[i],
            noise_scale=noise_scale))
        errs.append(float((kern[0] - plain[0]).abs().max())
                    / max(float(plain[0].abs().max()), 1e-30))
    ok = all(e <= KERNEL_RTOL for e in errs)
    print(f"run {trainer.cfg.model} gm var {trainer.cfg.noise_var}, the run's first stack "
          f"K={k} d={d}: {steps} steps kernel vs plain rel err {['%.2e' % e for e in errs]} "
          f"(tolerance {KERNEL_RTOL:.0e}) [{card}]")
    if not ok:
        _fail(f"gm on the run's own stack: the kernel disagrees with the plain version: {errs}")
    return dict(d=d, k=k, steps=steps, rel_err=errs, ok=ok)


def check_escalation(torch, kernels, harness, cfg, record, launches):
    """Run (x): the rung leaves 0 by round 3 and select_columns (the
    trimmed_mean rung) launched; then duty_cycle and mimic, 1 round each
    under the same defense, must end with finite params."""
    import dataclasses

    rungs = record["defenseRungPath"]
    print(f"run x defense: rung per round {rungs}, flagged "
          f"{record['defenseFlaggedPath']}, suspicious {record['defenseSuspiciousPath']}, "
          f"transitions {record['defenseTransitionsPath']}; select_columns launches "
          f"{launches['select_columns']}")
    if not max(rungs) >= 1:
        _fail(f"run x: the rung never left 0: {rungs}")
    if launches["select_columns"] < 1:
        _fail("run x: the trimmed_mean rung never launched select_columns")
    out = dict(rungs=rungs, select_columns_launches=launches["select_columns"])
    for attack in ("duty_cycle", "mimic"):
        t, rec = harness.run_with_trainer(
            dataclasses.replace(cfg, attack=attack, rounds=1), device="cuda")
        finite = bool(torch.isfinite(t.flat_params).all())
        print(f"run x {attack}: params finite={finite} rung {rec['defenseRungPath']} "
              f"flagged {rec['defenseFlaggedPath']} val_acc {rec['valAccPath'][-1]:.4f}")
        if not finite:
            _fail(f"run x {attack}: non-finite params")
        out[attack] = dict(rungs=rec["defenseRungPath"], val_acc=rec["valAccPath"][-1])
    return out


def check_monitor_is_off(torch, harness, cfg, record):
    """Run (y): under_radar needs a defense to read (both packages refuse it
    under --defense off), so the bitwise twin is the same config against
    the omniscient alie: its --defense monitor run and its --defense off
    run must end with bitwise the same params and record paths."""
    import dataclasses

    twin = dataclasses.replace(cfg, attack="alie")
    mon_t, mon = harness.run_with_trainer(twin, device="cuda")
    off_t, off = harness.run_with_trainer(dataclasses.replace(twin, defense="off"),
                                          device="cuda")
    torch.cuda.synchronize()
    same_params = torch.equal(off_t.flat_params, mon_t.flat_params)
    same_paths = _same_record(off, {key: mon[key] for key in off})
    print(f"run y: under_radar under monitor: rung {record['defenseRungPath']} flagged "
          f"{record['defenseFlaggedPath']} score max {record['defenseScorePath']}; its alie "
          f"twin, --defense monitor vs off on the card: params bitwise equal={same_params}, "
          f"paths bitwise equal={same_paths} (monitor flagged {mon['defenseFlaggedPath']})")
    if not (same_params and same_paths):
        _fail("run y: --defense monitor changed the trajectory")
    return dict(twin_attack="alie", params_bitwise=same_params, paths_bitwise=same_paths,
                twin_flagged=mon["defenseFlaggedPath"])


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
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        guard, extra = None, {}
        if label == "j_resume_gm2":
            # three runs: straight, one round checkpointed, the resume; and
            # the same for the training options' and the defense's state
            trainer, record = run_resume(torch, kernels, harness, cfg)
            iterations = 2 * rounds * cfg.display_interval
            extra["resume_options"] = run_resume(
                torch, kernels, harness,
                FedConfig(**RESUME_OPTIONS, rounds=2, display_interval=10, cache_dir=cache_dir),
                label="j2")[1]["defenseRungPath"]
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
        peak_bytes = torch.cuda.max_memory_allocated()
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
        if label.startswith("x_"):
            extra["escalation"] = check_escalation(torch, kernels, harness, cfg, record,
                                                   launches)
        if label.startswith("y_"):
            extra["monitor_vs_off"] = check_monitor_is_off(torch, harness, cfg, record)
        if trainer.dim != RUN_D.get(label, 7850):
            _fail(f"run {label}: d = {trainer.dim}, not {RUN_D.get(label, 7850)}")
        finite = bool(torch.isfinite(trainer.flat_params).all())
        if not finite and label not in MAY_DIVERGE:
            _fail(f"run {label} ended with non-finite params")
        extra["params_finite"] = finite
        if label in MAY_DIVERGE:
            # profile an iteration from the seeded params, as the run's first
            # one started, and hold that iteration's stack kernel vs plain
            from byzantine_aircomp_tpu_torch.fed.train import Trainer

            trainer = Trainer(cfg, dataset=trainer.dataset, device="cuda")
            extra["real_stack"] = check_real_stack(torch, kernels, trainer, card)
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
              f"{prof['kernel_device_launches']} launch(es); client step "
              f"{prof.get('client_step')}; rung read {prof.get('rung_read')}; "
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
        if cfg.defense != "off":
            extra["defense_paths"] = {key: record[key] for key in record
                                      if key.startswith("defense")}
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
            rounds_per_sec=rps, wall_seconds=wall, peak_memory_bytes=peak_bytes, card=card,
        )
        print(f"run {label}: launches={launches} val_acc={val_acc:.4f} "
              f"rounds/sec per round={['%.4f' % r for r in rps]} wall={wall:.1f}s "
              f"max_memory_allocated={peak_bytes / 2**30:.3f} GiB "
              f"variance={record['variencePath']} [{card}]")
    return runs


def check_conv_models(torch, kernels, harness, FedConfig, card, cache_dir):
    """This slice's models beyond runs (q)-(t): ResNet-18 at full width with
    and without ``remat`` (one iteration each, K=10, from the same params
    and draws: params within 1e-6, both peak memories; the iteration without
    remat run twice for identical bits); one iteration on the card against
    the CPU for the CNN (gm2) and ResNet-18 (median with the channel), K=4,
    within ``ITER_ATOL``; and a CNN run resumed from its checkpoint, K=10,
    bitwise the straight run."""
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    out = {}
    cifar = datasets.load("cifar10", synthetic_train=2000, synthetic_val=500)
    base = dict(model="ResNet18", dataset="cifar10", agg="median", honest_size=8, byz_size=2,
                attack="classflip")
    ref = Trainer(FedConfig(**base), dataset=cifar, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    u = torch.rand(10, ref.cfg.batch_size, device="cuda", generator=g)
    params, peaks, remat_rows = {}, {}, {}
    for remat in (False, True, False):
        t = Trainer(FedConfig(remat=remat, **base), dataset=cifar, device="cuda",
                    params=ref.flat_params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        new, _ = t.iteration(t.flat_params, draws={"u": u})
        torch.cuda.synchronize()
        if remat in params:
            remat_rows["rerun_bitwise"] = _same_bits(torch, new, params[remat])
        else:
            params[remat] = new
            peaks[remat] = torch.cuda.max_memory_allocated()
        del t
    err = float((params[True] - params[False]).abs().max())
    remat_rows.update(max_abs_err=err, peak_bytes_remat_off=peaks[False],
                      peak_bytes_remat_on=peaks[True], d=ref.dim)
    print(f"ResNet-18 width 64, K=10, one iteration remat on vs off: max_abs_err={err:.3e} "
          f"(tolerance 1e-6) max_memory_allocated off={peaks[False] / 2**30:.3f} GiB "
          f"on={peaks[True] / 2**30:.3f} GiB; rerun without remat bitwise="
          f"{remat_rows['rerun_bitwise']} [{card}]")
    if not (err <= 1e-6 and bool(torch.isfinite(params[True]).all())):
        _fail(f"ResNet-18 with remat disagrees with remat off: {err}")
    if not remat_rows["rerun_bitwise"]:
        _fail("ResNet-18: one iteration rerun on the card gave other bits")
    if not peaks[True] < peaks[False]:
        _fail(f"ResNet-18: remat did not lower the iteration's peak memory "
              f"({peaks[True]} against {peaks[False]} bytes)")
    out["resnet_remat"] = remat_rows
    del ref

    mnist = datasets.load("mnist", synthetic_train=3000, synthetic_val=500)
    small = dict(honest_size=3, byz_size=1, attack="classflip", batch_size=16,
                 agg_maxiter=100)
    out["iteration_vs_cpu"] = {
        "cnn_gm2": iteration_card_vs_cpu(
            torch, FedConfig(model="CNN", agg="gm2", **small), mnist, "cnn_gm2"),
        "resnet18_median_var": iteration_card_vs_cpu(
            torch, FedConfig(model="ResNet18", dataset="cifar10", agg="median",
                             noise_var=1e-2, **small), cifar, "resnet18_median_var"),
    }
    cfg = FedConfig(model="CNN", agg="gm2", attack="classflip", honest_size=8, byz_size=2,
                    rounds=2, display_interval=10, cache_dir=cache_dir)
    kernels.reset_launches()
    run_resume(torch, kernels, harness, cfg, label="cnn")
    out["cnn_resume"] = dict(bitwise=True, d=CNN_D, launches=dict(kernels.LAUNCHES))
    return out


def check_service_iterations(torch, kernels, FedConfig):
    """One iteration card vs CPU for this slice, at small K, with the
    service draws shared (the per-id link's key is a seed, the same on both
    devices): (a) service gm --var: ``aircomp_weiszfeld_step`` on a stack
    with NaN rows; (b) service trimmed_mean --var under --defense adaptive,
    ladder trimmed_mean,median,gm2, the rung forced to 1 (the degraded
    median); (c) streamed gm2 at cohort 4 (the num/den kernel per chunk)."""
    from byzantine_aircomp_tpu_torch.data import datasets

    ds = datasets.load("mnist", synthetic_train=3000, synthetic_val=500)

    def rung_one(t):
        det, (rung, up, down, budget) = t.defense_state
        t.defense_state = (det, (torch.ones_like(rung), up, down, budget))

    service = dict(service="on", population=40, straggler_prob=0.2)
    # gm at 5 steps, as in check_solver_and_iteration: a noisy solve at a
    # small K random-walks, and the two devices' last bits part within tens
    # of steps
    cases = (
        ("z_service_gm_var", dict(agg="gm", noise_var=1e-2, attack="classflip",
                                  honest_size=8, byz_size=2, agg_maxiter=5, **service),
         None, "aircomp_weiszfeld_step"),
        ("z_service_trimmed_mean_var_adaptive_rung1", dict(
            agg="trimmed_mean", noise_var=1e-2, attack="signflip", honest_size=8, byz_size=2,
            defense="adaptive", defense_ladder="trimmed_mean,median,gm2", **service),
         rung_one, None),
        ("z_streamed_gm2_cohort4", dict(agg="gm2", attack="signflip", honest_size=8,
                                        byz_size=4, cohort_size=4), None, "weiszfeld_step"),
    )
    out = {}
    for label, kw, prep, kernel in cases:
        before = dict(kernels.LAUNCHES)
        out[label] = iteration_card_vs_cpu(torch, FedConfig(**kw), ds, label, prepare=prep)
        if kernel is not None and kernels.LAUNCHES[kernel] <= before[kernel]:
            _fail(f"{label}: {kernel} was not launched on the card")
        out[label]["launches"] = {n: kernels.LAUNCHES[n] - before[n] for n in before}
    return out


class _StackTap:
    """Wraps a kernel wrapper of ``kernels`` for one run and records, per
    call, the stack's shape and (on the device, no host read) its count of
    non-finite rows.  The wrapper itself, which counts launches, still
    runs."""

    def __init__(self, torch, kernels, name):
        self.torch, self.kernels, self.name = torch, kernels, name
        self.shapes, self.bad_rows = [], []

    def __enter__(self):
        self.real = getattr(self.kernels, self.name)
        torch = self.torch

        def tap(w, *args, **kw):
            self.shapes.append(tuple(w.shape))
            self.bad_rows.append(torch.sum(~torch.isfinite(w).all(dim=1)))
            return self.real(w, *args, **kw)

        setattr(self.kernels, self.name, tap)
        return self

    def __exit__(self, *exc):
        setattr(self.kernels, self.name, self.real)
        return False


def _run_stats(torch, kernels, record, t0, iterations, display_interval):
    launches = dict(kernels.LAUNCHES)
    return dict(
        launches=launches,
        launches_per_round={n: c * display_interval / iterations for n, c in launches.items()},
        wall_seconds=time.perf_counter() - t0, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        val_acc_path=record["valAccPath"], rounds_per_sec=record["roundsPerSec"],
        effective_k_path=record.get("effectiveKPath"),
        service_avail_path=record.get("serviceAvailPath"))


def _print_profile(label, prof, kernel, card):
    print(f"run {label} profiled iteration: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']} ms, idle share {prof['idle_share']}, "
          f"{prof['device_kernels']} device kernels; {kernel} "
          f"{prof['kernel_device_ms']:.4f} device ms in {prof['kernel_device_launches']} "
          f"launch(es); client step {prof.get('client_step')}; top kernels "
          f"{prof['top_kernels_ms'][:4]} [{card}]")


def run_z1(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z1) resident service gm2, K=50 (B=10), population 500, stragglers
    0.1, 3 rounds; the params are poisoned after round 1, so exactly one
    warm rollback must follow.  The Weiszfeld kernel must run every
    iteration, every launch on a stack with NaN rows (late clients: with
    this seed every iteration has some, though one with none of the 50 late
    has p = 0.9^50), the effective K stay below 50 in every round, the
    paths be full and finite, and the val accuracy pass 0.3."""
    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=40, byz_size=10,
                    service="on", population=500, straggler_prob=0.1, rounds=3,
                    display_interval=10, cache_dir=cache_dir)
    poisoned = []

    def poison(r, t):
        if r == 1 and not poisoned:
            poisoned.append(r)
            t.flat_params.mul_(float("nan"))

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _StackTap(torch, kernels, "weiszfeld_step_fused") as tap:
        trainer, record = harness.run_with_trainer(cfg, device="cuda", on_round=poison)
    torch.cuda.synchronize()
    # 3 rounds and the rolled-back round again
    iterations = (cfg.rounds + 1) * cfg.display_interval
    stats = _run_stats(torch, kernels, record, t0, iterations, cfg.display_interval)
    bad = torch.stack(tap.bad_rows).cpu()
    calls_with_nan_rows = int((bad > 0).sum())
    paths_ok = all(len(record[key]) == cfg.rounds + (key == "valLossPath")
                   and all(math.isfinite(v) for v in record[key])
                   for key in ("valLossPath", "variencePath", "effectiveKPath",
                               "serviceAvailPath"))
    print(f"run z1_service_gm2: {trainer._rollbacks_done} rollback(s) (epoch "
          f"{trainer._rollback_epoch}, widen {float(trainer.service_state[1])}); "
          f"weiszfeld_step launches {stats['launches']['weiszfeld_step']} over {iterations} "
          f"iterations, {calls_with_nan_rows} of {len(bad)} on stacks with NaN rows; "
          f"effectiveK {record['effectiveKPath']} available {record['serviceAvailPath']} "
          f"late {record['serviceLatePath']} absent {record['serviceAbsentPath']}; val_acc "
          f"{record['valAccPath']} wall {stats['wall_seconds']:.1f}s max_memory_allocated "
          f"{stats['peak_memory_bytes'] / 2**30:.3f} GiB [{card}]")
    if trainer._rollbacks_done != 1:
        _fail(f"run z1: {trainer._rollbacks_done} rollbacks, not 1")
    if stats["launches"]["weiszfeld_step"] < iterations or calls_with_nan_rows != len(bad):
        _fail("run z1: the Weiszfeld kernel did not run every iteration on stacks with NaN "
              "rows")
    if not paths_ok:
        _fail("run z1: the paths are not full length and finite")
    if not max(record["effectiveKPath"]) < cfg.node_size:
        _fail(f"run z1: the effective K reached {cfg.node_size}")
    if not record["valAccPath"][-1] > 0.3:
        _fail(f"run z1: val accuracy {record['valAccPath'][-1]} not above 0.3")
    if not bool(torch.isfinite(trainer.flat_params).all()):
        _fail("run z1 ended with non-finite params")
    prof = profile_iteration(torch, kernels, trainer, "weiszfeld_step")
    _print_profile("z1_service_gm2", prof, "weiszfeld_step", card)
    return dict(stats, profiled_iteration=prof, rollbacks=trainer._rollbacks_done,
                launches_on_nan_stacks=calls_with_nan_rows, card=card)


def run_z2(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z2) streamed service gm2, K=1000 (B=100), cohort 100, population
    5000, stragglers 0.05, --var 1e-2, 1 round: ``weiszfeld_step`` at
    [100, 7850] once per chunk per Weiszfeld step (at least 10 an
    iteration); its resident twin from the same seed must end within 1e-4
    with the same effective K and availability paths."""
    import dataclasses

    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=900, byz_size=100,
                    service="on", population=5000, straggler_prob=0.05, noise_var=1e-2,
                    cohort_size=100, rounds=1, display_interval=10, cache_dir=cache_dir)
    n_chunks = cfg.node_size // cfg.cohort_size
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _StackTap(torch, kernels, "weiszfeld_step") as tap:
        streamed, record = harness.run_with_trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    iterations = cfg.rounds * cfg.display_interval
    stats = _run_stats(torch, kernels, record, t0, iterations, cfg.display_interval)
    launches = stats["launches"]["weiszfeld_step"]
    steps_per_solve = launches / (n_chunks * iterations)
    shapes = sorted(set(tap.shapes))
    prof = profile_iteration(torch, kernels, streamed, "weiszfeld_step")
    loop = prof.pop("weiszfeld_per_step", None) or {}
    # host ms per Weiszfeld step: the loop's host time over its steps (each
    # step one launch per chunk)
    host_ms_per_step = (loop.get("loop_host_ms", float("nan"))
                        / max(loop.get("steps_launched", 0) / n_chunks, 1))
    _print_profile("z2_streamed_service_gm2", prof, "weiszfeld_step", card)
    kernels.reset_launches()
    t1 = time.perf_counter()
    resident, rec_res = harness.run_with_trainer(dataclasses.replace(cfg, cohort_size=0),
                                                 device="cuda")
    torch.cuda.synchronize()
    twin = dict(wall_seconds=time.perf_counter() - t1, launches=dict(kernels.LAUNCHES))
    err = float((streamed.flat_params - resident.flat_params).abs().max())
    same_paths = (record["effectiveKPath"] == rec_res["effectiveKPath"]
                  and record["serviceAvailPath"] == rec_res["serviceAvailPath"])
    print(f"run z2_streamed_service_gm2: weiszfeld_step launches {launches} over {iterations} "
          f"iterations at {shapes}, {steps_per_solve:.2f} Weiszfeld steps per solve, host "
          f"{host_ms_per_step:.3f} ms per step (profiler on; every chunk rebuilt); vs the "
          f"resident twin max_abs_err={err:.3e} (tolerance 1e-4), effectiveK "
          f"{record['effectiveKPath']} vs {rec_res['effectiveKPath']}, available "
          f"{record['serviceAvailPath']} vs {rec_res['serviceAvailPath']}; val_acc "
          f"{record['valAccPath'][-1]:.4f}; wall {stats['wall_seconds']:.1f}s (twin "
          f"{twin['wall_seconds']:.1f}s); max_memory_allocated "
          f"{stats['peak_memory_bytes'] / 2**30:.3f} GiB [{card}]")
    if shapes != [(cfg.cohort_size, 7850)]:
        _fail(f"run z2: weiszfeld_step ran at {shapes}, not [(100, 7850)]")
    if launches < n_chunks * iterations or launches % n_chunks:
        _fail(f"run z2: {launches} weiszfeld_step launches, not once per chunk per step")
    if not err <= ITER_ATOL or not same_paths:
        _fail("run z2: the streamed run disagrees with its resident twin")
    if not bool(torch.isfinite(streamed.flat_params).all()):
        _fail("run z2 ended with non-finite params")
    return dict(stats, profiled_iteration=prof, weiszfeld_loop=loop, shapes=shapes,
                steps_per_solve=steps_per_solve, host_ms_per_step=host_ms_per_step,
                resident_twin=dict(twin, max_abs_err=err, same_paths=same_paths), card=card,
                record=record)


def run_z3(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z3) streamed rounds on the reference's CNN (d = 3,274,634), one
    iteration each from the seeded params and the resident batch stream:
    the streamed mean at K=200 and K=1000, cohort 50 (the peak memory
    follows the cohort, not K: within 10%), beside the resident mean at
    K=1000 (its peak, or that it ran out of memory); the streamed exact
    median at K=200 against the resident median (``select_columns``):
    bitwise on the same rows (one iteration's chunks: the streamed median
    over them and ``select_columns`` over their stack), and the two runs
    bitwise where their rows are (a batched GEMM or convolution may round
    a 50-client batch otherwise than a 200-client one); and the streamed
    gm2 at K=200 (``weiszfeld_step`` at [50, 3,274,634] per chunk per
    step)."""
    import dataclasses

    from byzantine_aircomp_tpu_torch.fed.train import Trainer
    from byzantine_aircomp_tpu_torch.ops import aggregators

    def cfg(**kw):
        return FedConfig(**dict(dict(model="CNN", agg="mean", attack="classflip", rounds=1,
                                     display_interval=1, eval_train=False,
                                     cache_dir=cache_dir), **kw))

    def one(label, c, kernel):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer, record = harness.run_with_trainer(c, device="cuda")
        torch.cuda.synchronize()
        stats = _run_stats(torch, kernels, record, t0, 1, 1)
        if trainer.dim != CNN_D or not bool(torch.isfinite(trainer.flat_params).all()):
            _fail(f"run {label}: d = {trainer.dim} or non-finite params")
        print(f"run {label}: launches={stats['launches']} max_memory_allocated "
              f"{stats['peak_memory_bytes'] / 2**30:.3f} GiB wall {stats['wall_seconds']:.1f}s "
              f"[{card}]")
        return trainer, dict(stats, kernel=kernel)

    sizes = {200: dict(honest_size=150, byz_size=50), 1000: dict(honest_size=900, byz_size=100)}
    out = {}
    for k in (200, 1000):
        _, out[f"z3_streamed_mean_k{k}"] = one(
            f"z3_streamed_mean_k{k}", cfg(cohort_size=50, **sizes[k]), None)
    try:
        _, out["z3_resident_mean_k1000"] = one("z3_resident_mean_k1000",
                                               cfg(**sizes[1000]), None)
    except torch.cuda.OutOfMemoryError as exc:
        out["z3_resident_mean_k1000"] = dict(out_of_memory=str(exc).splitlines()[0])
        print(f"run z3_resident_mean_k1000: out of memory ({str(exc).splitlines()[0]}) "
              f"[{card}]")
    peaks = [out[f"z3_streamed_mean_k{k}"]["peak_memory_bytes"] for k in (200, 1000)]
    ratio = peaks[1] / peaks[0]
    print(f"run z3: streamed mean peak K=1000 / K=200 = {ratio:.4f} (must be within 10%) "
          f"[{card}]")
    if not abs(ratio - 1.0) <= 0.10:
        _fail(f"run z3: the streamed peak grows with K ({peaks})")

    median = dict(agg="median", **sizes[200])
    t_res, out["z3_resident_median_k200"] = one("z3_resident_median_k200", cfg(**median),
                                                "select_columns")
    t_str, out["z3_streamed_median_k200"] = one(
        "z3_streamed_median_k200", cfg(cohort_size=50, **median), None)
    if out["z3_resident_median_k200"]["launches"]["select_columns"] < 1:
        _fail("run z3: the resident median did not launch select_columns")
    same = torch.equal(t_str.flat_params, t_res.flat_params)
    params_err = float((t_str.flat_params - t_res.flat_params).abs().max())
    # the same chunks, held three ways: the streamed median over them
    # (32 counting passes), select_columns over their stack, and the rows
    # of one resident client step
    probe = Trainer(dataclasses.replace(t_str.cfg), dataset=t_str.dataset, device="cuda")
    gens = probe.iteration_generators(0, 0)
    from byzantine_aircomp_tpu_torch.data import datasets as data_lib

    idx = data_lib.sample_client_batch_indices(probe.offsets, probe.sizes, probe.cfg.batch_size,
                                               generator=gens.batch)
    rebuild = probe.make_rebuild(probe.flat_params, gens, idx)
    n_chunks = probe.cfg.node_size // probe.cfg.cohort_size
    chunks = [rebuild(c)[0] for c in range(n_chunks)]
    stack = torch.cat(chunks)
    streamed_med = aggregators.stream_median(lambda c: chunks[c], k=probe.cfg.node_size,
                                             d=probe.dim, n_chunks=n_chunks,
                                             device=stack.device)
    select_med = kernels.fused_median(stack)
    med_same = torch.equal(streamed_med.view(torch.int32), select_med.view(torch.int32))
    del chunks, stack, streamed_med, select_med
    x, y = probe._batches(idx)
    rows = probe.client_stack(probe.flat_params, x, y, probe._part_mask)
    rows_err = float((rows - torch.cat([rebuild(c)[0] for c in range(n_chunks)])).abs().max())
    rows_same = rows_err == 0.0
    del rows
    print(f"run z3 median K=200: streamed params bitwise the resident run's={same} (max abs "
          f"diff {params_err:.3e}); on one iteration's chunks the streamed median is bitwise "
          f"select_columns={med_same}; the chunked client steps (50 clients a batch) against "
          f"the resident one (200): max abs diff {rows_err:.3e} [{card}]")
    if not med_same:
        _fail("run z3: the streamed median differs from select_columns on the same stack")
    if not same and rows_same:
        _fail("run z3: the streamed median run differs from the resident one on equal rows")
    out["z3_median_bitwise"] = dict(params=same, params_max_abs_diff=params_err,
                                    median_vs_select_columns=med_same,
                                    chunked_rows_max_abs_diff=rows_err)
    del probe, rebuild

    t_gm2, out["z3_streamed_gm2_k200"] = one(
        "z3_streamed_gm2_k200", cfg(agg="gm2", cohort_size=50, **sizes[200]),
        "weiszfeld_step")
    launches = out["z3_streamed_gm2_k200"]["launches"]["weiszfeld_step"]
    if launches < n_chunks or launches % n_chunks:
        _fail(f"run z3: {launches} weiszfeld_step launches at [50, {CNN_D}], not per chunk")
    for label, t, kernel in (("z3_streamed_median_k200", t_str, None),
                             ("z3_streamed_gm2_k200", t_gm2, "weiszfeld_step")):
        prof = profile_iteration(torch, kernels, t, kernel)
        prof.pop("weiszfeld_per_step", None)
        _print_profile(label, prof, kernel, card)
        out[label]["profiled_iteration"] = prof
    out["peak_ratio_k1000_over_k200"] = ratio
    out["card"] = card
    return out


def run_service_and_streams(torch, kernels, harness, FedConfig, card, cache_dir):
    """This slice's runs (z1)-(z3), with the wall time they add."""
    t0 = time.perf_counter()
    out = dict(z1=run_z1(torch, kernels, harness, FedConfig, card, cache_dir),
               z2=run_z2(torch, kernels, harness, FedConfig, card, cache_dir),
               z3=run_z3(torch, kernels, harness, FedConfig, card, cache_dir))
    out["wall_seconds"] = time.perf_counter() - t0
    print(f"runs z1-z3 added {out['wall_seconds']:.1f}s [{card}]")
    return out


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


# the graphed dispatches (z4)-(z8): label, config (classflip, the MNIST MLP
# unless stated), the run's kernel; each 2 rounds x interval 10 as one R=2
# dispatch, beside its eager R=1 twin
GRAPH_RUNS = (
    ("z4_gm2_K1000", dict(agg="gm2", honest_size=900, byz_size=100), "weiszfeld_step"),
    ("z5_gm_var_K50", dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10),
     "aircomp_weiszfeld_step"),
    ("z6_median_var_K50", dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10),
     "select_columns"),
    ("z6_trimmed_mean_var_K1000", dict(agg="trimmed_mean", noise_var=1e-2, honest_size=900,
                                       byz_size=100), "select_columns"),
    ("z7_cnn_gm2_K50", dict(agg="gm2", model="CNN", honest_size=40, byz_size=10),
     "weiszfeld_step"),
    # the carried state beyond the params: the server's Adam moments and
    # the monitor's detector and policy, under two local steps and FedProx
    ("z8_gm2_fedavg_adam_monitor_K50", dict(
        agg="gm2", attack="signflip", defense="monitor", local_steps=2, fedprox_mu=0.01,
        server_opt="adam", server_lr=0.01, honest_size=40, byz_size=10), "weiszfeld_step"),
)


def _replicated(record, rounds, r):
    """An R=1 record as the R-round dispatch reports it: each round's eval
    entries repeat its dispatch's boundary eval."""
    from byzantine_aircomp_tpu_torch.fed.harness import _EVAL_PATH_KEYS

    out = dict(record)
    for key in _EVAL_PATH_KEYS:
        path = record[key]
        out[key] = [path[0]] + [path[min(-(-i // r) * r, rounds)] for i in range(1, rounds + 1)]
    return out


def profile_dispatch(torch, trainer, r0, n):
    """One more dispatch of ``n`` rounds of a finished graphed run under
    torch.profiler: wall ms, the union of the device spans and the idle
    share, the device kernels, the kernels of each wrapper group seen
    on the device (:func:`_device_launches`), the launches the wrappers
    counted (``LAUNCHES``, read after a sync) and the digest of the params
    it left (:func:`_params_sha`); and the same dispatch's device ms from
    CUDA events around it, without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from byzantine_aircomp_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run_rounds_stacked(r0, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    # the profiled dispatch's result, before the timed one below moves on
    params_sha = _params_sha(trainer.flat_params)
    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in _device_events(torch, prof))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start_ev.record()
    trainer.run_rounds_stacked(r0, n)
    end_ev.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = busy_us / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms if spans else None,
                idle_share=(1.0 - busy_ms / wall_ms) if spans else None,
                device_kernels=len(_device_kernels(torch, prof)),
                device_launches=_device_launches(torch, prof), launched=launched,
                params_sha=params_sha, unprofiled_wall_ms=host_ms,
                unprofiled_event_ms=start_ev.elapsed_time(end_ev))


def _params_sha(t):
    """The SHA-256 of a tensor's bytes: equal digests, equal bits."""
    import hashlib

    import torch

    raw = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()


# profiler sessions per device count, at most: a session loses kernel
# records now and then, which can only lower a count
PROFILE_SESSIONS = 3


def count_replay_launches(torch, trainer, r0, label):
    """The device kernels of each wrapper group over one more dispatch of two
    replays, counted by name, against what the wrappers counted over it
    (``LAUNCHES``: twice the capture's launches, and the steps a graphed
    gm2 loop's bodies ran, counted on the device): exact.  torch.profiler loses a kernel record now and then (none
    is ever added), so a session that counts short of the capture is
    profiled again, at most :data:`PROFILE_SESSIONS` sessions in all.  Passes
    when one session counts every group exactly and no session counts over;
    fails when any session counts over, or when every session is short (as a
    launch missing from the graph would be, every time).  Returns the exact
    session's profile, every session's counts and the first session's
    profile (the one dispatch of rounds ``r0 ..`` from the run's state)."""
    profs = []

    def measure():
        profs.append(profile_dispatch(torch, trainer, r0, 2))
        return profs[-1]["device_launches"], _wanted(profs[-1]), profs[-1]

    prof, sessions = _exact_sessions(label, "over two replays", "the wrappers' count", measure)
    return prof, sessions, profs[0]


def _wanted(prof):
    """What :func:`profile_dispatch`'s device count of each wrapper group
    has to be: what the group's wrappers counted."""
    return {g: sum(prof["launched"][k] for k in g.split("+")) for g in prof["device_launches"]}


def _graphed_cfgs(FedConfig, kw, cache_dir):
    """A graphed pair's eager R=1 twin config (2 rounds) and its R=2 one."""
    import dataclasses

    twin_cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=2,
                         display_interval=10, cache_dir=cache_dir)
    return twin_cfg, dataclasses.replace(twin_cfg, rounds_per_dispatch=2)


def _same_as_twin(label, prof, twin_next, kernel):
    """Fail unless ``prof``'s dispatch left the params that the eager twin's
    rounds 2-3 left, bit for bit, and, where ``kernel`` is given, launched
    it as often."""
    if prof["params_sha"] != twin_next["params_sha"] or (
            kernel is not None and prof["launched"][kernel] != twin_next["launched"][kernel]):
        _fail(f"run {label}: the profiled dispatch is not its eager twin's rounds 2-3: "
              f"params digest {prof['params_sha']} against {twin_next['params_sha']}, "
              f"launches {prof['launched']} against {twin_next['launched']}")


def fresh_replay_count(label, kw, cache_dir):
    """:func:`count_replay_launches` of the graphed run of ``kw`` in a new
    process (``chip_smoke.py --count-replays``), whose profiler sessions are
    its first.  Returns what :func:`count_in_fresh_process` wrote."""
    out = os.path.join(cache_dir, f"count_{label}.json")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--count-replays", label,
                           json.dumps(kw), out], capture_output=True, text=True, timeout=900)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        _fail(f"run {label}: the fresh process's count failed (exit {proc.returncode}): "
              f"{proc.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


def count_in_fresh_process(label, kw_json, out):
    """The child of :func:`fresh_replay_count`: the graphed run of
    ``kw_json`` (2 rounds, R=2), then :func:`count_replay_launches`; writes
    its profile, sessions and first profile to ``out`` as JSON."""
    import torch

    from byzantine_aircomp_tpu_torch.device import resolve_device
    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.ops import kernels

    resolve_device("cuda")
    kernels.build()
    cfg = _graphed_cfgs(FedConfig, json.loads(kw_json), os.path.dirname(out))[1]
    trainer, _ = harness.run_with_trainer(cfg, device="cuda")
    prof, sessions, first = count_replay_launches(torch, trainer, cfg.rounds,
                                                  f"{label} (fresh process)")
    with open(out, "w") as f:
        json.dump(dict(prof=prof, sessions=sessions, first=first), f)
    return 0


def _exact_sessions(label, over_what, against, measure):
    """Up to :data:`PROFILE_SESSIONS` profiler sessions of ``measure()``,
    which returns (device counts by wrapper group, the counts they must
    equal, its profile): passes when one session counts every group
    exactly and no session counts over, since a session can lose kernel
    records but never adds one.  Returns the exact session's profile and
    every session's counts."""
    sessions = []
    for _ in range(PROFILE_SESSIONS):
        seen, want, prof = measure()
        over = sorted(g for g in seen if seen[g] > want[g])
        short = sorted(g for g in seen if seen[g] < want[g])
        sessions.append(dict(device=seen, want=want, short=short, over=over))
        if over:
            _fail(f"run {label}: {over} kernels ran on the device more often {over_what} "
                  f"({seen}) than {against} ({want})")
        if not short:
            break
    n_short = sum(bool(x["short"]) for x in sessions)
    print(f"run {label}: device launches {over_what} in {len(sessions)} profiler "
          f"session(s), {n_short} short: {[x['device'] for x in sessions]} against "
          f"{[x['want'] for x in sessions]}")
    if sessions[-1]["short"]:
        _fail(f"run {label}: every one of {len(sessions)} profiler sessions counted fewer "
              f"kernels than {against}: {sessions}")
    return prof, sessions


def graphed_pair(torch, kernels, harness, FedConfig, card, cache_dir, label, kw, kernel,
                 profile_here=False):
    """One R=2 graphed run of ``kw`` (2 rounds) through
    ``harness.run_with_trainer`` and its eager R=1 twin from the same seed:
    the graphed record must be the twin's with the evals repeated within the
    dispatch, and the final params the twin's, bit for bit; one capture; the
    run's kernel launched from the graph every iteration, counted on the
    device (:func:`count_replay_launches`) over one more dispatch, whose
    params must be the twin's after two more eager rounds, bit for bit.

    Where the capture counted none of the kernel's launches, the graph runs
    it in loop bodies (gm2's WHILE node), which count their steps on the
    device: that dispatch must also launch it as often as the twin's rounds,
    and it is profiled in a fresh process (:func:`fresh_replay_count`), since
    in a process that profiled much before torch.profiler drops some of a
    loop body's kernel records.  ``profile_here`` profiles it in this
    process instead, once, and fails on the params, the launches or a count
    over the wrappers', but only prints a short one.  Returns (entry, the
    graphed trainer)."""
    from byzantine_aircomp_tpu_torch.fed import graphs

    twin_cfg, cfg = _graphed_cfgs(FedConfig, kw, cache_dir)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    twin_t, twin = harness.run_with_trainer(twin_cfg, device="cuda")
    torch.cuda.synchronize()
    twin_launches = dict(kernels.LAUNCHES)
    # the Weiszfeld steps the twin's solves ran while active
    twin_live = kernels.live_steps()
    twin_peak = torch.cuda.max_memory_allocated()
    # only the twin's params stay on the card: the graphed run's peak
    # is its own
    twin_params = twin_t.flat_params.clone()
    # the twin's next two rounds, eagerly: what one more graphed dispatch
    # must leave, bit for bit, and launch
    before = dict(kernels.LAUNCHES)
    twin_t.run_rounds_stacked(cfg.rounds, 2)
    torch.cuda.synchronize()
    twin_next = dict(params_sha=_params_sha(twin_t.flat_params),
                     launched={k: kernels.LAUNCHES[k] - before[k] for k in before})
    del twin_t
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer, record = harness.run_with_trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rg = trainer.round_graph
    if not trainer.dispatch_graph[0] or rg is None or rg.captures != 1:
        _fail(f"run {label}: not one capture ({trainer.dispatch_graph})")
    at_capture = rg.replay_launches
    want = _replicated(twin, cfg.rounds, cfg.rounds_per_dispatch)
    same = _same_record(record, want)
    params_equal = torch.equal(trainer.flat_params, twin_params)
    if not (same and params_equal):
        diff = {key: [abs(a - b) for a, b in zip(record[key], want[key])]
                for key in ("variencePath", "valLossPath")}
        _fail(f"run {label}: the graphed run differs from its eager twin: record "
              f"{diff}, params max abs diff "
              f"{float((trainer.flat_params - twin_params).abs().max())}")
    del twin_params
    # the capture's kernel, copy and set nodes (every node of these rounds)
    nodes = graphs.LAST_CAPTURE.nodes
    loop_node = at_capture.get(kernel, 0) == 0
    if not loop_node:
        prof, sessions, first = count_replay_launches(torch, trainer, cfg.rounds, label)
    elif profile_here:
        prof = first = profile_dispatch(torch, trainer, cfg.rounds, 2)
        sessions = [dict(device=prof["device_launches"], want=_wanted(prof))]
        print(f"run {label}: device launches over two replays in this process "
              f"{sessions[0]['device']} against the wrappers' {sessions[0]['want']}")
        over = sorted(g for g, n in sessions[0]["device"].items() if n > sessions[0]["want"][g])
        if over:
            _fail(f"run {label}: {over} kernels ran on the device more often than the "
                  f"wrappers counted")
    else:
        fresh = fresh_replay_count(label, kw, cache_dir)
        prof, sessions, first = fresh["prof"], fresh["sessions"], fresh["first"]
    _same_as_twin(label, first, twin_next, kernel if loop_node else None)
    per_round = {group: seen / 2 for group, seen in prof["device_launches"].items()}
    group = next(g for g in per_round if kernel in g.split("+"))
    if per_round[group] < cfg.display_interval:
        _fail(f"run {label}: {kernel} ran {per_round[group]} times per replayed round "
              f"on the device, not every iteration")
    live_per_round = twin_live / twin_cfg.rounds if twin_live else None
    after = (per_round[group] - live_per_round
             if live_per_round is not None else None)
    entry = dict(
        config=dict(dict(attack="classflip"), **kw, rounds=2, display_interval=10,
                    rounds_per_dispatch=2),
        records_equal=same, params_bitwise_equal=params_equal, captures=rg.captures,
        replays=rg.replays, warmup_seconds=rg.warmup_seconds,
        capture_seconds=rg.capture_seconds, graph_nodes=nodes,
        rounds_per_sec=record["roundsPerSec"], twin_rounds_per_sec=twin["roundsPerSec"],
        launches_per_round=per_round, capture_launches_per_round=at_capture,
        twin_launches_per_round={n: c / twin_cfg.rounds for n, c in twin_launches.items()},
        weiszfeld_live_steps_per_round=live_per_round,
        weiszfeld_steps_after_convergence_per_round=after,
        peak_memory_bytes=peak, twin_peak_memory_bytes=twin_peak, wall_seconds=wall,
        dispatch_profile=prof, profile_sessions=sessions, loop_node=loop_node,
        profiled_in="this process" if profile_here or not loop_node else "a fresh process",
        twin_next_launches=twin_next["launched"], card=card)
    print(f"run {label}: graphed R=2 record == eager R=1 twin (evals repeated in the "
          f"dispatch)={same}, params bitwise={params_equal}; captures {rg.captures}, "
          f"warm-up {rg.warmup_seconds:.2f}s, capture+instantiate "
          f"{rg.capture_seconds:.2f}s, {nodes} graph nodes; rounds/sec graphed "
          f"{record['roundsPerSec']} eager twin {twin['roundsPerSec']}; launches per "
          f"replayed round, seen on the device {per_round} (eager twin "
          f"{entry['twin_launches_per_round']}); Weiszfeld live steps per round "
          f"{live_per_round}, after convergence {after}; one more dispatch: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['device_busy_ms']} ms, idle share "
          f"{prof['idle_share']}, {prof['device_kernels']} device kernels, unprofiled "
          f"{prof['unprofiled_wall_ms']:.1f} ms wall / {prof['unprofiled_event_ms']:.1f} "
          f"ms between events; max_memory_allocated graphed {peak / 2**30:.3f} GiB, "
          f"eager twin {twin_peak / 2**30:.3f} GiB [{card}]")
    return entry, trainer


def run_graphed(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z4)-(z8): each run of :data:`GRAPH_RUNS` as one R=2 dispatch beside
    its eager R=1 twin (:func:`graphed_pair`).  Printed: captures, warm-up
    and capture seconds, the graph's nodes, rounds/sec of both, the idle
    share over one more dispatch, the launches per round (the Weiszfeld
    steps run after convergence apart, from the twin's live steps) and both
    peaks of ``torch.cuda.max_memory_allocated``."""
    out = {}
    t_all = time.perf_counter()
    for label, kw, kernel in GRAPH_RUNS:
        out[label], trainer = graphed_pair(torch, kernels, harness, FedConfig, card,
                                           cache_dir, label, kw, kernel)
        del trainer
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"runs z4-z8 added {out['wall_seconds']:.1f}s [{card}]")
    return out


def check_profiler_loss(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z17) z4's graphed pair once more, last of all, with its profiled
    dispatch in this process (:func:`graphed_pair`'s ``profile_here``):
    after this process's profiler sessions torch.profiler may drop some of
    the loop bodies' kernel records, and the dispatch must still leave its
    eager twin's params, bit for bit, having launched the twin's steps.
    Returns the device's count against the wrappers'."""
    label, kw, kernel = GRAPH_RUNS[0]
    entry, trainer = graphed_pair(torch, kernels, harness, FedConfig, card, cache_dir,
                                  "z17_" + label, kw, kernel, profile_here=True)
    del trainer
    (session,) = entry["profile_sessions"]
    return dict(session, params_bitwise_twin=True, card=card)


def run_j3(torch, kernels, harness, FedConfig, card, cache_dir):
    """(j3) run (j)'s config under R=2 with the writer thread on: 4 rounds
    straight against 2 rounds checkpointed and ``inherit`` to 4 in a fresh
    Trainer, bitwise (each trainer captures its own graph)."""
    cfg = FedConfig(agg="gm2", attack="classflip", honest_size=45, byz_size=5,
                    dataset="mnist_hard", rounds=4, display_interval=10, rounds_per_dispatch=2,
                    async_writer="on", cache_dir=cache_dir)
    kernels.reset_launches()
    trainer, record = run_resume(torch, kernels, harness, cfg, label="j3", cut=2)
    if trainer.round_graph is None or trainer.round_graph.captures != 1:
        _fail("run j3: the resumed trainer did not replay one graph")
    return dict(launches=dict(kernels.LAUNCHES), val_acc_path=record["valAccPath"],
                replays=trainer.round_graph.replays, card=card)


# (z9)-(z11): the main path with the event stream, forensics and the
# profiler on (gm2 K=1000 and gm --var K=50, classflip, the MNIST MLP)
OBS_Z9 = dict(agg="gm2", attack="classflip", honest_size=900, byz_size=100,
              display_interval=10, defense="monitor")
OBS_Z11 = dict(agg="gm", noise_var=1e-2, attack="classflip", honest_size=40, byz_size=10,
               display_interval=10, rounds=8, rounds_per_dispatch=2)
# the memory model's other cells: z7's CNN gm2 K=50 (one R=2 dispatch),
# z3's streamed CNN mean at K=200 (cohort 50), and ResNet-18 at K=10 with
# and without remat (median --var, CIFAR-10)
OBS_MEMORY_RUNS = (
    ("mem_cnn_gm2_K50", dict(agg="gm2", attack="classflip", model="CNN", honest_size=40,
                             byz_size=10, rounds=2, rounds_per_dispatch=2,
                             display_interval=10), "mnist", "weiszfeld_step"),
    ("mem_z3_streamed_cnn_mean_K200", dict(agg="mean", attack="classflip", model="CNN",
                                           honest_size=150, byz_size=50, cohort_size=50,
                                           rounds=1, display_interval=1, eval_train=False),
     "mnist", None),
    ("mem_resnet18_remat_K10", dict(agg="median", noise_var=1e-2, attack="signflip",
                                    model="ResNet18", dataset="cifar10", remat=True,
                                    honest_size=9, byz_size=1, rounds=1, display_interval=1,
                                    eval_train=False), "cifar10", "select_columns"),
    ("mem_resnet18_K10", dict(agg="median", noise_var=1e-2, attack="signflip",
                              model="ResNet18", dataset="cifar10", honest_size=9, byz_size=1,
                              rounds=1, display_interval=1, eval_train=False), "cifar10",
     "select_columns"),
)


def _obs_stream(obs_dir):
    """The events of the one stream under ``obs_dir``, and its bytes."""
    (name,) = [n for n in os.listdir(obs_dir) if n.endswith(".events.jsonl")]
    path = os.path.join(obs_dir, name)
    with open(path) as f:
        return [json.loads(line) for line in f], os.path.getsize(path)


def _obs_tokens(events):
    """The stream as (kind, span name) tokens, a run of client_flag events
    as one token."""
    out = []
    for e in events:
        tok = (e["kind"], e.get("name"))
        if not (tok == ("client_flag", None) and out and out[-1] == tok):
            out.append(tok)
    return out


def _flags_by_round(events):
    return {r: [{k: v for k, v in e.items() if k not in ("ts", "seq")} for e in events
                if e["kind"] == "client_flag" and e["round"] == r]
            for r in sorted({e["round"] for e in events if e["kind"] == "client_flag"})}


def _drive(torch, kernels, harness, label, cfg, kernel, ds, on_round=None):
    """One run on the card, the launch counts set to 0 just before it and
    read just after: fails unless ``kernel`` launched every iteration and
    the params are finite.  ``on_round(r, trainer)`` runs after each
    round's (dispatch's) fold, events and flight record.  Returns
    (trainer, record, launches, wall seconds)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    trainer, record = harness.run_with_trainer(cfg, device="cuda", dataset=ds,
                                               on_round=on_round)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if kernel is not None and launches[kernel] < cfg.rounds * cfg.display_interval:
        _fail(f"run {label}: {kernel} launched {launches[kernel]} times in "
              f"{cfg.rounds * cfg.display_interval} iterations")
    if not bool(torch.isfinite(trainer.flat_params).all()):
        _fail(f"run {label}: non-finite params")
    return trainer, record, launches, wall


def _stamper(stamps):
    """An ``on_round`` that appends (rounds done, host clock) to ``stamps``
    (None: no callback)."""
    return None if stamps is None else (
        lambda r, _t: stamps.append((r, time.perf_counter())))


def _round_seconds(stamps, window, r):
    """Host seconds per round between successive ``on_round`` stamps (the
    round or dispatch of ``r`` rounds, its eval, fold, events and flight
    record), past the first dispatch (its set-up or capture) and away from
    the rounds in ``window`` (the profiler's, or those a scrape follows)."""
    # a stamp comes before the profiler's round_end of its dispatch,
    # which exports the window's trace: the next interval holds it
    return [(t1 - t0) / (r1 - r0) for (r0, t0), (r1, t1) in zip(stamps, stamps[1:])
            if not any(i in window for i in range(r0 - r, r1))]


def run_obs(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z9)-(z11) and the memory model on the card.

    (z9) gm2 K=1000, eager R=1, 7 rounds, with the stream, ``--defense
    monitor --forensics full --forensics-top 8`` and the profiler over
    ``--profile-rounds 1:2``, beside its twin with every obs and forensics
    knob off: records (but the rate) and params bitwise, every event valid,
    the stream run_start, then per round a round span, an eval span,
    defense, client_flag, round and the checkpoint span of the round-time
    stamps, then profile, retrace, the run-end
    forensic_dump and run_end; ``flight_run_end.json`` written; the trace
    holds the ``round`` range once and the Weiszfeld kernels in it
    (``_device_kernels``); the memory block's source ``device:cuda`` and
    ``exceeds_model`` false.  (z10) the same under ``--rounds-per-dispatch
    2 --async-writer on`` (8 rounds, graphed) beside its graphed twin with
    the stream off: records and params bitwise; each round's client_flag
    events, the forensic top-M computed inside the graph, bitwise (z9)'s
    but for ``ts`` and ``seq``; one capture counted, steady state ok;
    ``seq`` rising.  (z11) gm --var K=50, R=2 graphed (8 rounds), ``--obs-dir`` only,
    beside its twin: the stream valid, the record bitwise.  Then the memory
    model: measured (the run's own ``max_memory_allocated``) over modeled
    for (z9)-(z11) and :data:`OBS_MEMORY_RUNS`, each within [0.5,
    ``hbm_warn_factor``]; and the model of the resident CNN at K=1000,
    beside the card's memory.  Each run launches its kernel every
    iteration (counts set to 0 before it and read after).  Printed: events
    and stream bytes per round, and the host time of each round with its
    eval, fold, events and flight record (between ``on_round`` stamps, past
    the first dispatch and the profiled window's rounds and trace export)
    with the stream on
    against off.  One ``platform: "cuda"`` row per run goes to
    ``chiprun_out/perf_ledger_cuda.jsonl``."""
    from byzantine_aircomp_tpu_torch import obs as obs_lib
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.fed.train import Trainer

    root = os.path.join(cache_dir, "obs")
    if os.path.isdir(root):
        import shutil

        shutil.rmtree(root)
    data = {"mnist": datasets.load("mnist")}
    out, memory = {}, {}
    t_all = time.perf_counter()

    def drive(label, cfg, kernel, ds, stamps=None):
        return _drive(torch, kernels, harness, label, cfg, kernel, ds, _stamper(stamps))

    round_seconds = _round_seconds

    def pair(label, kw, obs_kw, kernel, ds="mnist"):
        """The run with ``obs_kw`` beside its twin without: records (but
        the rate) and params bitwise.  Returns (trainer, record, events,
        entry)."""
        twin_stamps, stamps = [], []
        twin_t, twin, _, twin_wall = drive(
            f"{label}_twin", FedConfig(cache_dir=os.path.join(root, label + "_twin"), **kw),
            kernel, data[ds], twin_stamps)
        twin_params = twin_t.flat_params.clone()
        del twin_t
        cfg = FedConfig(cache_dir=os.path.join(root, label), **kw, **obs_kw)
        trainer, record, launches, wall = drive(label, cfg, kernel, data[ds], stamps)
        same = _same_record(record, twin)
        params_equal = torch.equal(trainer.flat_params, twin_params)
        if not (same and params_equal):
            _fail(f"run {label}: the observed run differs from its twin (record {same}, "
                  f"params {params_equal})")
        events, nbytes = _obs_stream(cfg.obs_dir)
        for e in events:
            obs_lib.validate_event(e)
        if [e["seq"] for e in events] != list(range(len(events))):
            _fail(f"run {label}: seq does not rise through the stream")
        mem = [e for e in events if e["kind"] == "run_end"][0]["memory"]
        if mem["source"] != "device:cuda" or mem["exceeds_model"]:
            _fail(f"run {label}: memory block {mem}")
        window = (range(*map(int, cfg.profile_rounds.split(":"))) if cfg.profile_rounds
                  else range(0))
        on = round_seconds(stamps, window, cfg.rounds_per_dispatch)
        off = round_seconds(twin_stamps, window, cfg.rounds_per_dispatch)
        entry = dict(
            config=dict(kw, **obs_kw), records_equal=same, params_bitwise_equal=params_equal,
            events=len(events), events_per_round=len(events) / cfg.rounds,
            stream_bytes=nbytes, stream_bytes_per_round=nbytes / cfg.rounds,
            round_seconds_obs_on=on, round_seconds_obs_off=off,
            round_seconds_obs_on_mean=sum(on) / len(on),
            round_seconds_obs_off_mean=sum(off) / len(off),
            wall_seconds=wall, twin_wall_seconds=twin_wall, launches=launches,
            memory=mem, card=card)
        memory[label] = mem
        print(f"run {label}: record and params bitwise its twin's (obs off): {same} "
              f"{params_equal}; {len(events)} events ({entry['events_per_round']:.1f} per "
              f"round), {nbytes} stream bytes ({entry['stream_bytes_per_round']:.0f} per "
              f"round); host ms per round with its eval and fold, obs on: mean "
              f"{entry['round_seconds_obs_on_mean'] * 1e3:.2f} of "
              f"{[round(x * 1e3, 2) for x in on]}, off: mean "
              f"{entry['round_seconds_obs_off_mean'] * 1e3:.2f} of "
              f"{[round(x * 1e3, 2) for x in off]}; launches {launches} [{card}]")
        return trainer, record, events, entry

    # (z9)
    d9 = os.path.join(root, "z9_stream")
    z9_obs = dict(obs_dir=d9, forensics="full", forensics_top=8,
                  profile_dir=os.path.join(root, "z9_profile"), profile_rounds="1:2")
    t9, r9, ev9, out["z9_gm2_K1000_eager"] = pair(
        "z9_gm2_K1000_eager", dict(OBS_Z9, rounds=7), z9_obs, "weiszfeld_step")
    want = [("span", "setup"), ("run_start", None), ("span", "eval")]
    for _ in range(7):
        # the checkpoint span is on_round's (the round-time stamps)
        want += [("span", "round"), ("span", "eval"), ("defense", None),
                 ("client_flag", None), ("round", None), ("span", "checkpoint")]
    want += [("profile", None), ("retrace", None), ("forensic_dump", None), ("run_end", None)]
    if _obs_tokens(ev9) != want:
        _fail(f"run z9: stream {_obs_tokens(ev9)}")
    if not os.path.exists(os.path.join(d9, "flight_run_end.json")):
        _fail("run z9: no flight_run_end.json")
    prof = t9.profiler.last_profile
    cpu = torch.autograd.DeviceType.CPU
    rounds_traced = sum(1 for ev in prof.events()
                        if ev.device_type == cpu and ev.name == "round")
    weiszfeld = [ev.name for ev in _device_kernels(torch, prof)
                 if _is_kernel_of(ev.name, "weiszfeld_step")]
    if rounds_traced != 1 or len(weiszfeld) < OBS_Z9["display_interval"]:
        _fail(f"run z9: the trace holds {rounds_traced} round ranges and {len(weiszfeld)} "
              "Weiszfeld kernels")
    out["z9_gm2_K1000_eager"].update(trace_round_ranges=rounds_traced,
                                     trace_weiszfeld_kernels=len(weiszfeld),
                                     trace_device_kernels=len(_device_kernels(torch, prof)),
                                     trace_paths=t9.profiler.trace_paths)
    print(f"run z9: the trace of round 1 holds {len(weiszfeld)} Weiszfeld kernels of "
          f"{out['z9_gm2_K1000_eager']['trace_device_kernels']} device kernels [{card}]")
    del t9, prof
    # the stream alone (no forensics, no profiler) over the same rounds, to
    # tell the stream's host time per round from the forensics'
    stamps = []
    cfg = FedConfig(cache_dir=os.path.join(root, "z9_stream_only"),
                    obs_dir=os.path.join(root, "z9_stream_only_stream"),
                    **dict(OBS_Z9, rounds=7))
    t, record, _, _ = drive("z9_stream_only", cfg, "weiszfeld_step", data["mnist"], stamps)
    if not _same_record(record, r9):
        _fail("run z9: the stream-only run's record differs")
    del t
    alone = round_seconds(stamps, range(*map(int, z9_obs["profile_rounds"].split(":"))), 1)
    out["z9_gm2_K1000_eager"].update(round_seconds_stream_only=alone,
                                     round_seconds_stream_only_mean=sum(alone) / len(alone))
    print(f"run z9: host ms per round with the stream alone: mean "
          f"{sum(alone) / len(alone) * 1e3:.2f} of {[round(x * 1e3, 2) for x in alone]} "
          f"[{card}]")

    # (z10)
    z10_kw = dict(OBS_Z9, rounds=8, rounds_per_dispatch=2, async_writer="on")
    t10, _, ev10, out["z10_gm2_K1000_graphed"] = pair(
        "z10_gm2_K1000_graphed", z10_kw,
        dict(obs_dir=os.path.join(root, "z10_stream"), forensics="full", forensics_top=8),
        "weiszfeld_step")
    if t10.round_graph is None or t10.round_graph.captures != 1:
        _fail("run z10: not one capture")
    (retrace,) = [e for e in ev10 if e["kind"] == "retrace"]
    if retrace["counts"]["multi_round_fn"] != 1 or not retrace["steady_state_ok"]:
        _fail(f"run z10: retrace {retrace}")
    f9, f10 = _flags_by_round(ev9), _flags_by_round(ev10)
    same_flags = all(f10.get(r) == f9[r] for r in f9)
    if not same_flags or sorted(f10) != list(range(8)):
        _fail(f"run z10: the graphed rounds' client_flag events differ from z9's: "
              f"{ {r: (f9.get(r), f10.get(r)) for r in f10} }")
    out["z10_gm2_K1000_graphed"].update(client_flags_bitwise_z9=same_flags,
                                        retrace=retrace["counts"])
    print(f"run z10: each round's client_flag events bitwise z9's: {same_flags}; "
          f"retrace {retrace['counts']} steady {retrace['steady_state_ok']} [{card}]")
    del t10

    # (z11)
    t11, _, _, out["z11_gm_var_K50_graphed"] = pair(
        "z11_gm_var_K50_graphed", OBS_Z11, dict(obs_dir=os.path.join(root, "z11_stream")),
        "aircomp_weiszfeld_step")
    if t11.round_graph is None or t11.round_graph.captures != 1:
        _fail("run z11: not one capture")
    del t11

    # the memory model's other cells
    for label, kw, ds, kernel in OBS_MEMORY_RUNS:
        if ds not in data:
            data[ds] = datasets.load(ds)
        cfg = FedConfig(cache_dir=os.path.join(root, label),
                        obs_dir=os.path.join(root, label + "_stream"), **kw)
        t, record, launches, wall = drive(label, cfg, kernel, data[ds])
        events, _ = _obs_stream(cfg.obs_dir)
        mem = [e for e in events if e["kind"] == "run_end"][0]["memory"]
        memory[label] = mem
        out[label] = dict(config=kw, memory=mem, wall_seconds=wall, launches=launches,
                          card=card)
        del t
    del data["cifar10"]
    # the resident CNN at K=1000: the model's peak beside the card's memory
    # (run z3 runs out of memory there)
    cfg = FedConfig(agg="mean", attack="classflip", model="CNN", honest_size=900,
                    byz_size=100, rounds=1, display_interval=1, eval_train=False)
    t = Trainer(cfg, dataset=data["mnist"], device="cuda")
    resident, terms = harness.modeled_peak(cfg, t)
    del t
    total = torch.cuda.get_device_properties(0).total_memory
    out["resident_cnn_K1000_model"] = dict(modeled_peak_bytes=resident, terms=terms,
                                           device_total_bytes=total, card=card)
    print(f"the resident CNN mean at K=1000: modeled peak {resident / 2**30:.2f} GiB (client "
          f"step {terms['client_step_bytes'] / 2**30:.2f} GiB, stack "
          f"{terms['stack_bytes'] / 2**30:.2f} GiB) against the card's "
          f"{total / 2**30:.2f} GiB [{card}]")

    ledger = obs_lib.PerfLedger(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             obs_lib.ledger.DEFAULT_LEDGER_PATH))
    name, power = [x.strip() for x in card.split(",")][:2]
    bad = []
    for label, mem in memory.items():
        ratio = mem["run_peak_bytes"] / mem["modeled_peak_bytes"]
        print(f"memory {label}: measured {mem['run_peak_bytes'] / 2**30:.3f} GiB / modeled "
              f"{mem['modeled_peak_bytes'] / 2**30:.3f} GiB = {ratio:.3f} (JAX model "
              f"{mem['jax_modeled_peak_bytes'] / 2**30:.3f} GiB) [{card}]")
        if not 0.5 <= ratio <= mem["warn_factor"]:
            bad.append((label, ratio))
        entry, c = out[label], out[label]["config"]
        key = obs_lib.config_key(dict(k=c["honest_size"] + c["byz_size"], b=c["byz_size"],
                                      agg=c["agg"], attack=c["attack"],
                                      model=c.get("model", "MLP"),
                                      dataset=c.get("dataset", "mnist")))
        ledger.append(f"peak_over_model_{label}", ratio, unit="ratio", platform="cuda",
                      key=key, card=name, power_limit=power,
                      peak_measured_bytes=mem["run_peak_bytes"], peak_source=mem["source"],
                      peak_resident_modeled_bytes=mem["modeled_peak_bytes"])
        if "round_seconds_obs_on" in entry:
            for side in ("on", "off"):
                ledger.append(f"round_seconds_obs_{side}_{label}",
                              entry[f"round_seconds_obs_{side}_mean"], unit="s",
                              platform="cuda", key=key, card=name, power_limit=power,
                              samples=entry[f"round_seconds_obs_{side}"])
            for metric, unit in (("events_per_round", "events"),
                                 ("stream_bytes_per_round", "bytes")):
                ledger.append(f"{metric}_{label}", entry[metric], unit=unit, platform="cuda",
                              key=key, card=name, power_limit=power)
    if bad:
        _fail(f"the memory model misses: measured/modeled {bad} outside [0.5, warn factor]")
    out["ledger"] = ledger.path
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"runs z9-z11 and the memory cells added {out['wall_seconds']:.1f}s [{card}]")
    return out

# the telemetry phase: z9's and z11's configs with --metrics on, a scrape
# port and the repo's rules file, each beside a twin with them off; the
# rounds after whose stamp the run is scraped
TELEMETRY_RUNS = (
    ("z9_gm2_K1000_eager", dict(OBS_Z9, rounds=7), "weiszfeld_step", (3, 7)),
    ("z11_gm_var_K50_graphed", OBS_Z11, "aircomp_weiszfeld_step", (4, 8)),
)
ALERT_RULES = "byzantine_aircomp_tpu_torch/tools/alert_rules.json"


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scrape(port, path):
    """(status, body, ms) of one GET on the local exporter."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            status, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body.decode(), (time.perf_counter() - t0) * 1e3


def _replay_registry(obs_lib, events, rules):
    """A finished stream folded into a fresh registry as the harness folds
    it live: each event into the metrics sink, the alert engine after each
    round event and once more after run_end, up to the run's
    metrics_snapshot.  Returns (snapshot, finalize summary)."""
    registry = obs_lib.MetricsRegistry()
    sink = obs_lib.MetricsSink(registry)
    engine = obs_lib.AlertEngine(obs_lib.load_rules(rules), registry)
    last_round = max(next(e for e in events if e["kind"] == "run_start")["rounds"] - 1, 0)
    summary = None
    for e in events:
        if e["kind"] == "metrics_snapshot":
            break
        if e["kind"] == "alert":
            continue
        sink.emit(e)
        if e["kind"] == "round":
            engine.evaluate(e["round"], sink)
        elif e["kind"] == "run_end":
            summary = engine.finalize(last_round, sink)
    return registry.snapshot(), summary


def run_telemetry(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z12) live telemetry on the main path, eager and graphed.

    z9's config (gm2 K=1000, eager, 7 rounds) and z11's (gm --var K=50,
    graphed R=2, 8 rounds), each run four times in turns: off, on, on, off.
    On is the stream and ``--metrics on --metrics-port <a free port>
    --alerts`` the repo's rules file; off is the stream alone.  Each on run
    against the first off run: records (but the rate) and params bitwise;
    every run launches the kernel every iteration (counts set to 0 before
    each run and read after); ``/metrics`` and ``/healthz`` scraped live
    after two rounds' stamps (the round counter at those rounds, healthy,
    the last round one less); after the run no exporter thread is left and
    the port refuses; the stream's ``metrics_snapshot`` counts the rounds
    run, carries the alert summary (the progress rule fired, the memory
    watermark rule did not), and equals a replay of the stream through a
    fresh registry and engine.  Printed: host ms per round between
    ``on_round`` stamps, on against off (the intervals a scrape follows
    left out on both sides), the scrapes' ms and bytes and the registry's
    series; each goes to the ledger as a ``platform: "cuda"`` row."""
    import threading

    from byzantine_aircomp_tpu_torch import obs as obs_lib
    from byzantine_aircomp_tpu_torch.data import datasets

    root = os.path.join(cache_dir, "telemetry")
    if os.path.isdir(root):
        import shutil

        shutil.rmtree(root)
    rules = os.path.join(os.path.dirname(os.path.abspath(__file__)), ALERT_RULES)
    ds = datasets.load("mnist")
    ledger = obs_lib.PerfLedger(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             obs_lib.ledger.DEFAULT_LEDGER_PATH))
    name, power = [x.strip() for x in card.split(",")][:2]
    out = {}
    t_all = time.perf_counter()

    def one(label, kw, kernel, scrape_at, telemetry):
        """One run; returns its params, record, launches, the host seconds
        of each round away from a scrape, its scrapes and its stream."""
        stamps, scrapes = [], []
        port = _free_port()

        def on_round(r, _t):
            stamps.append((r, time.perf_counter()))
            if telemetry and r in scrape_at:
                status, body, ms = _scrape(port, "/metrics")
                h_status, health, h_ms = _scrape(port, "/healthz")
                total = [float(line.split()[-1]) for line in body.splitlines()
                         if line.startswith("aircomp_rounds_total ")]
                scrapes.append(dict(round=r, status=status, rounds_total=total, ms=ms,
                                    bytes=len(body.encode()), healthz_status=h_status,
                                    healthz=json.loads(health), healthz_ms=h_ms))

        extra = dict(metrics="on", metrics_port=port, alerts=rules) if telemetry else {}
        cfg = FedConfig(cache_dir=os.path.join(root, label),
                        obs_dir=os.path.join(root, label + "_stream"), **kw, **extra)
        trainer, record, launches, _ = _drive(torch, kernels, harness, label, cfg, kernel,
                                              ds, on_round)
        params = trainer.flat_params.clone()
        graphed = trainer.round_graph is not None and trainer.round_graph.captures == 1
        del trainer
        if graphed != (cfg.rounds_per_dispatch > 1):
            _fail(f"run {label}: graphed {graphed}")
        secs = _round_seconds(stamps, range(0), cfg.rounds_per_dispatch)
        secs = [x for ((r0, _), _), x in zip(zip(stamps, stamps[1:]), secs)
                if r0 not in scrape_at]
        events, _ = _obs_stream(cfg.obs_dir)
        if telemetry:
            want = [dict(round=r, status=200, rounds_total=[float(r)], healthz_status=200,
                         last_round=r - 1, ok=True) for r in scrape_at]
            seen = [dict(round=x["round"], status=x["status"],
                         rounds_total=x["rounds_total"], healthz_status=x["healthz_status"],
                         last_round=x["healthz"]["last_round"], ok=x["healthz"]["ok"])
                    for x in scrapes]
            if seen != want:
                _fail(f"run {label}: live scrapes {seen}, want {want}")
            if any(t.name == "aircomp-metrics-exporter" for t in threading.enumerate()):
                _fail(f"run {label}: the exporter thread outlived the run")
            try:
                _scrape(port, "/metrics")
                _fail(f"run {label}: the port still answers after the run")
            except OSError:
                pass
        return params, record, launches, secs, scrapes, events, cfg

    for label, kw, kernel, scrape_at in TELEMETRY_RUNS:
        runs = [one(f"{label}_{i}_{'on' if on else 'off'}", kw, kernel, scrape_at, on)
                for i, on in enumerate((False, True, True, False))]
        params0, record0 = runs[0][:2]
        for params, record, *_ in runs[1:]:
            same, params_equal = _same_record(record, record0), torch.equal(params, params0)
            if not (same and params_equal):
                _fail(f"run {label}: a run differs from the first off run (record {same}, "
                      f"params {params_equal})")
        scrapes = runs[1][4] + runs[2][4]
        summaries, series = [], None
        for *_, events, cfg in runs[1:3]:
            for e in events:
                obs_lib.validate_event(e)
            snaps = [e for e in events if e["kind"] == "metrics_snapshot"]
            if len(snaps) != 1:
                _fail(f"run {label}: {len(snaps)} metrics_snapshot events")
            snap = snaps[0]
            rounds_total = snap["metrics"]["aircomp_rounds_total"]["series"][0]["value"]
            summary = snap["alerts"]
            if rounds_total != cfg.rounds or summary is None:
                _fail(f"run {label}: registry counted {rounds_total} rounds of {cfg.rounds}, "
                      f"alert summary {summary}")
            if (not summary["rules"]["round_progress"]["fired"]
                    or summary["rules"]["hbm_watermark"]["fired"]):
                # the watermark rule reads the run's own peak, which run_obs
                # holds within [0.5, 2.0] of the model
                _fail(f"run {label}: the progress rule never fired or the watermark "
                      f"rule fired: {summary}")
            replay, replay_summary = _replay_registry(obs_lib, events, rules)
            if replay != snap["metrics"] or replay_summary != summary:
                _fail(f"run {label}: the live registry differs from the stream's replay")
            summaries.append(summary)
            series = (sum(len(f["series"]) for f in snap["metrics"].values()),
                      len(snap["metrics"]))
        alerts = [(e["rule"], e["round"], e["firing"]) for e in runs[1][5]
                  if e["kind"] == "alert"]
        on, off = runs[1][3] + runs[2][3], runs[0][3] + runs[3][3]
        entry = dict(
            config=dict(kw, metrics="on", alerts=ALERT_RULES), order="off, on, on, off",
            records_and_params_bitwise=True, launches=[r[2] for r in runs],
            scrapes=scrapes, alerts=alerts, alert_summaries=summaries,
            registry_series=series[0], registry_families=series[1],
            round_seconds_telemetry_on=on, round_seconds_telemetry_off=off,
            round_seconds_telemetry_on_mean=sum(on) / len(on),
            round_seconds_telemetry_off_mean=sum(off) / len(off), card=card)
        out[label] = entry
        print(f"run z12 {label} (off, on, on, off): records and params bitwise; scrapes "
              f"at rounds {[x['round'] for x in scrapes]} read aircomp_rounds_total "
              f"{[x['rounds_total'] for x in scrapes]} in "
              f"{[round(x['ms'], 3) for x in scrapes]} ms, "
              f"{[x['bytes'] for x in scrapes]} bytes, /healthz in "
              f"{[round(x['healthz_ms'], 3) for x in scrapes]} ms; registry {series[0]} "
              f"series in {series[1]} families; alerts {alerts}; host ms per round on: "
              f"mean {entry['round_seconds_telemetry_on_mean'] * 1e3:.2f} of "
              f"{[round(x * 1e3, 2) for x in on]}, off: mean "
              f"{entry['round_seconds_telemetry_off_mean'] * 1e3:.2f} of "
              f"{[round(x * 1e3, 2) for x in off]}; launches "
              f"{[r[2].get(kernel) for r in runs]} [{card}]")
        key = obs_lib.config_key(dict(k=kw["honest_size"] + kw["byz_size"], b=kw["byz_size"],
                                      agg=kw["agg"], attack=kw["attack"], model="MLP",
                                      dataset="mnist"))
        for side in ("on", "off"):
            ledger.append(f"round_seconds_telemetry_{side}_{label}",
                          entry[f"round_seconds_telemetry_{side}_mean"], unit="s",
                          platform="cuda", key=key, card=name, power_limit=power,
                          samples=entry[f"round_seconds_telemetry_{side}"])
        for x in scrapes:
            ledger.append(f"scrape_ms_{label}", x["ms"], unit="ms", platform="cuda", key=key,
                          card=name, power_limit=power, bytes=x["bytes"], round=x["round"])
        ledger.append(f"registry_series_{label}", series[0], unit="series", platform="cuda",
                      key=key, card=name, power_limit=power)
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"run z12 added {out['wall_seconds']:.1f}s [{card}]")
    return out

# (z13): the main path's A/B of the kernels against their plain versions,
# each config at --agg-impl pallas and xla, in turns; ITER_ATOL for the
# Weiszfeld rules' records and params, the same bits for the median
AB_RUNS = (
    ("b_gm2_K1000", dict(agg="gm2", honest_size=900, byz_size=100), "weiszfeld_step",
     ITER_ATOL),
    ("a_gm_var_K50", dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10),
     "aircomp_weiszfeld_step", ITER_ATOL),
    ("c_median_var_K50", dict(agg="median", noise_var=1e-2, honest_size=40, byz_size=10),
     "select_columns", 0.0),
)
BF16_RUNS = (
    ("z13_gm2_bf16_K1000", dict(agg="gm2", honest_size=900, byz_size=100, stack_dtype="bf16"),
     "weiszfeld_step"),
    ("z13_gm_var_bf16_K50", dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10,
                                 stack_dtype="bf16"), "aircomp_weiszfeld_step"),
)
# JAX's bf16 tolerance (tests/test_aggregators.py:472)
BF16_TOL = 2e-2
_RECORD_PATHS = ("trainLossPath", "trainAccPath", "valLossPath", "valAccPath", "variencePath")


def _profiled_groups(torch, trainer):
    """The device kernels of each wrapper group in one more iteration of a
    finished run, counted by name (:func:`_device_launches`)."""
    from torch.profiler import ProfilerActivity, profile

    gens = trainer.iteration_generators(10**6, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.iteration(trainer.flat_params, gens)
        torch.cuda.synchronize()
    return _device_launches(torch, prof)


def _record_diff(a, b):
    """The largest absolute difference over the records' float paths."""
    return max(abs(u - v) for key in _RECORD_PATHS for u, v in zip(a[key], b[key]))


def _time_bf16_fused(torch, kernels, card):
    """Each Weiszfeld kernel's fused step at the main path's shapes, f32 and
    bf16 from the same values in one call: device ms per call (CUDA-graph
    replay), the plain version's, and the bound at 4- and 2-byte elements."""
    from byzantine_aircomp_tpu_torch.ops import channel

    rows = []
    noise_scale = torch.sqrt(torch.tensor(1e-2, dtype=torch.float32) / 2.0)
    for name, air, (k, d) in (("weiszfeld_step", False, (1000, 7850)),
                              ("aircomp_weiszfeld_step", True, (50, 7850))):
        for dtype in (torch.float32, torch.bfloat16):
            w, guess, _, _ = _inputs(torch, k, d, dtype, seed=k + d)
            g = torch.Generator(device="cuda").manual_seed(k * d)
            draws = dict(h_r=torch.randn(k, device="cuda", generator=g),
                         h_i=torch.randn(k, device="cuda", generator=g),
                         fade_scale=channel.FADE_STD,
                         z=torch.randn(d + 1, device="cuda", generator=g),
                         noise_scale=noise_scale)
            state = (torch.ones((), dtype=torch.int32, device="cuda"),
                     torch.zeros((), dtype=torch.int64, device="cuda"),
                     kernels.guess_rms(guess))
            got = _fused_call(torch, kernels, air, w, guess, torch.empty_like(guess), state,
                              0.0, draws)
            want = _fused_ref_call(kernels, air, w, guess, state, 0.0, draws)
            err = float((got[0] - want[0]).abs().max())
            if not err <= KERNEL_RTOL * float(want[0].abs().max()) + KERNEL_ATOL:
                _fail(f"{name} fused {dtype} at [{k}, {d}] disagrees with its plain "
                      f"version: {err}")
            active, steps, scaler = (t.clone() for t in state)
            g_out = torch.empty_like(guess)

            def step():
                if not air:
                    return kernels.weiszfeld_step_fused(w, guess, g_out, active, steps, -1.0)
                return kernels.aircomp_weiszfeld_step_fused(
                    w, guess, g_out, active, steps, -1.0, draws["h_r"], draws["h_i"], scaler,
                    fade_scale=draws["fade_scale"], z=draws["z"],
                    noise_scale=draws["noise_scale"])

            ms, host_ms = _time_ms(torch, step, **_reps(k, d))
            plain_ms, _ = _time_ms(torch, lambda: _fused_ref_call(
                kernels, air, w, guess, state, -1.0, draws), **_reps(k, d))
            reads = _stack_reads(torch, k, d, w.element_size())
            bound_ms, bound_by = _fused_bound(k, d, w.element_size(), air, reads)
            row = dict(name=name, mode="fused", k=k, d=d, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by, stack_reads_in_bound=reads,
                       card=card)
            rows.append(row)
            print(f"kernel {name} fused [{k}, {d}] {row['dtype']}: {ms:.5f} ms (host "
                  f"{host_ms:.5f}), plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by}, {reads} read(s) of {w.element_size()}-byte elements), "
                  f"max_abs_err {err:.3e} [{card}]")
    return rows


def _write_native_inputs(root):
    """An IDX file (gzipped) and a CIFAR-10 binary batch, from a seed."""
    import gzip

    import numpy as np

    rng = np.random.default_rng(13)
    arr = rng.integers(0, 256, size=(64, 28, 28), dtype=np.uint8)
    idx = os.path.join(root, "train-images-idx3-ubyte.gz")
    with gzip.open(idx, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())
    labels = rng.integers(0, 10, size=32, dtype=np.uint8)
    images = rng.integers(0, 256, size=(32, 3, 32, 32), dtype=np.uint8)
    cifar = os.path.join(root, "data_batch_1.bin")
    with open(cifar, "wb") as f:
        for i in range(len(labels)):
            f.write(bytes([labels[i]]))
            f.write(images[i].tobytes())
    return idx, cifar


def check_native_reader(card, cache_dir):
    """The native reader: the library built from ``native/dataio.cpp`` into
    ``build/native/``, an IDX file and a CIFAR-10 batch read and normalized
    through it, equal to the NumPy path (the normalization within the
    library's FMA rounding)."""
    import numpy as np

    from byzantine_aircomp_tpu_torch.data import datasets, native_io

    t0 = time.perf_counter()
    lib = native_io.library()
    build_s = time.perf_counter() - t0
    if lib is None:
        _fail(f"the native reader did not build: {native_io.describe()}")
    os.makedirs(cache_dir, exist_ok=True)
    idx, cifar = _write_native_inputs(cache_dir)
    native = (datasets._read_idx(idx), datasets._read_cifar_bin(cifar))
    norm = datasets._normalize(native[0], *datasets.MNIST_STATS)
    saved = native_io._lib
    native_io._lib = None
    os.environ["AIRCOMP_NO_NATIVE"] = "1"
    native_io._lib_attempted = False
    try:
        plain = (datasets._read_idx(idx), datasets._read_cifar_bin(cifar))
        plain_norm = datasets._normalize(plain[0], *datasets.MNIST_STATS)
        reader_off = native_io.describe()
    finally:
        del os.environ["AIRCOMP_NO_NATIVE"]
        native_io._lib, native_io._lib_attempted = saved, True
    same = (np.array_equal(native[0], plain[0]) and np.array_equal(native[1][0], plain[1][0])
            and np.array_equal(native[1][1], plain[1][1]))
    norm_err = float(np.abs(norm - plain_norm).max())
    print(f"native reader: {native_io.describe()} (built or found in {build_s:.2f}s); "
          f"idx {native[0].shape} and cifar {native[1][0].shape} equal to the numpy path="
          f"{same}; normalize max abs diff {norm_err:.2e}; without it: {reader_off} [{card}]")
    if not same or not np.allclose(norm, plain_norm, rtol=1e-6, atol=0):
        _fail("the native reader disagrees with the numpy path")
    return dict(reader=native_io.describe(), build_seconds=build_s, equal=same,
                normalize_max_abs_err=norm_err)


def run_z13(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z13): the implementation knobs, the referee, the native reader and
    the sweep on the card.

    * The main path's A/B: (b) gm2 K=1000, (a) gm --var K=50 and (c) median
      --var K=50, one round each from one seed, at --agg-impl pallas and
      xla in turns (pallas, xla): records and params within
      ITER_ATOL (the median's the same bits); under pallas the run's
      kernel launched every iteration (the wrappers' counts) and seen on
      the device in one more profiled iteration; under xla none of the
      four launched (the wrappers' counts and the device, by name); the
      rounds/sec of each run.
    * bf16: gm2 K=1000 and gm --var K=50 at --stack-dtype bf16, graphed R=2
      against the eager twin (:func:`graphed_pair`), and the final params
      within rtol/atol 2e-2 of the f32 eager run; each kernel's fused step
      at [1000, 7850] and [50, 7850], f32 and bf16, timed with its bound.
    * The fold: median --var K=50 at --fused-epilogue off against auto,
      records and params bitwise.
    * The referee: ``--backend ref`` through the CLI, one round of gm2
      classflip at K=10, with no JAX imported.
    * The native reader (:func:`check_native_reader`).
    * The sweep: (gm2, median, signmv-1) x (none, classflip) at K=20, one
      round a cell, each cell's kernel launched every iteration."""
    import dataclasses

    from byzantine_aircomp_tpu_torch import cli
    from byzantine_aircomp_tpu_torch.analysis import sweep
    from byzantine_aircomp_tpu_torch.data import datasets

    out = dict(ab={}, bf16={}, card=card)
    t_all = time.perf_counter()
    ds = datasets.load("mnist")
    # a warm-up run, not timed: the turns start from a warm process
    _drive(torch, kernels, harness, "z13 warm-up", FedConfig(
        **dict(dict(attack="classflip"), **AB_RUNS[0][1]), rounds=1, display_interval=10,
        eval_train=False, cache_dir=cache_dir), AB_RUNS[0][2], ds)
    for label, kw, kernel, atol in AB_RUNS:
        cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=1, display_interval=10,
                        eval_train=False, cache_dir=cache_dir)
        runs = []
        for turn, impl in enumerate(("pallas", "xla")):
            c = dataclasses.replace(cfg, agg_impl=impl)
            trainer, record, launches, wall = _drive(
                torch, kernels, harness, f"z13 {label} {impl}", c,
                kernel if impl == "pallas" else None, ds)
            if trainer._agg_impl != impl:
                _fail(f"run z13 {label}: the trainer resolved {trainer._agg_impl}, not {impl}")
            device = _profiled_groups(torch, trainer)
            group = next(g for g in device if kernel in g.split("+"))
            if impl == "pallas" and device[group] < 1:
                _fail(f"run z13 {label} pallas: no {kernel} kernel seen on the device in a "
                      f"profiled iteration: {device}")
            if impl == "xla" and (any(launches.values()) or any(device.values())):
                _fail(f"run z13 {label} xla launched kernels: wrappers {launches}, "
                      f"device {device}")
            runs.append(dict(impl=impl, turn=turn, record=record, wall_seconds=wall,
                             launches=launches, device_launches_profiled_iteration=device,
                             rounds_per_sec=record["roundsPerSec"][0],
                             params=trainer.flat_params.clone()))
            del trainer
        pallas, xla = runs[0], runs[1]
        p_err = float((pallas["params"] - xla["params"]).abs().max())
        r_err = _record_diff(pallas["record"], xla["record"])
        if not (p_err <= atol and r_err <= atol):
            _fail(f"run z13 {label}: pallas and xla differ by {p_err} (params), {r_err} "
                  f"(records), more than {atol}")
        rates = [(r["impl"], r["rounds_per_sec"]) for r in runs]
        print(f"run z13 {label}: pallas vs xla params max abs diff {p_err:.3e}, records "
              f"{r_err:.3e}; rounds/sec in turns {rates}; launches "
              f"pallas {runs[0]['launches']}, xla {runs[1]['launches']}; device, one more "
              f"iteration: pallas {runs[0]['device_launches_profiled_iteration']}, xla "
              f"{runs[1]['device_launches_profiled_iteration']} [{card}]")
        for r in runs:
            del r["params"], r["record"]
        out["ab"][label] = dict(params_max_abs_diff=p_err, records_max_abs_diff=r_err,
                                runs=runs, tolerance=atol)
    for label, kw, kernel in BF16_RUNS:
        entry, trainer = graphed_pair(torch, kernels, harness, FedConfig, card, cache_dir,
                                      label, kw, kernel)
        f32_kw = dict(kw, stack_dtype="f32")
        f32_cfg = FedConfig(**dict(dict(attack="classflip"), **f32_kw), rounds=2,
                            display_interval=10, cache_dir=cache_dir)
        f32_t, _ = harness.run_with_trainer(f32_cfg, device="cuda")
        close = torch.allclose(trainer.flat_params, f32_t.flat_params, rtol=BF16_TOL,
                               atol=BF16_TOL)
        diff = float((trainer.flat_params - f32_t.flat_params).abs().max())
        print(f"run {label}: final params vs the f32 run max abs diff {diff:.3e}, within "
              f"rtol/atol {BF16_TOL}: {close} [{card}]")
        if not close:
            _fail(f"run {label}: the bf16 run's params are not within {BF16_TOL} of the f32 run")
        entry["params_vs_f32_max_abs_diff"] = diff
        out["bf16"][label] = entry
        del trainer, f32_t
    out["bf16"]["fused_rows"] = _time_bf16_fused(torch, kernels, card)
    # the fold: median --var with the channel in select_columns' read (auto on
    # the card) against the channel applied first (off)
    fold = {}
    for mode in ("auto", "off"):
        cfg = FedConfig(agg="median", noise_var=1e-2, attack="classflip", honest_size=40,
                        byz_size=10, rounds=1, display_interval=10, cache_dir=cache_dir,
                        fused_epilogue=mode)
        trainer, record, launches, _ = _drive(torch, kernels, harness, f"z13 fold {mode}",
                                              cfg, "select_columns", ds)
        fold[mode] = (trainer.channel_fused, record, trainer.flat_params.clone(), launches)
        del trainer
    same = (torch.equal(fold["auto"][2], fold["off"][2])
            and _same_record(fold["auto"][1], fold["off"][1]))
    print(f"run z13 fold: median --var K=50 channel folded (auto: {fold['auto'][0]}) vs "
          f"applied first (off: {fold['off'][0]}): records and params bitwise={same}; "
          f"launches {fold['auto'][3]} / {fold['off'][3]} [{card}]")
    if not (same and fold["auto"][0] and not fold["off"][0]):
        _fail("run z13 fold: the folded median differs from the channel applied first")
    out["fold"] = dict(bitwise=same, launches={m: fold[m][3] for m in fold})
    # the referee
    t0 = time.perf_counter()
    paths = cli.main(["--backend", "ref", "--agg", "gm2", "--attack", "classflip", "--K",
                      "10", "--B", "2", "--rounds", "1", "--interval", "10",
                      "--no-eval-train"])
    ref_s = time.perf_counter() - t0
    jax_loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
                        and sys.modules[m] is not None)
    print(f"run z13 referee: --backend ref gm2 classflip K=10, one round in {ref_s:.1f}s: "
          f"val acc {paths['valAccPath']}, variance {paths['variencePath']}; JAX modules "
          f"loaded: {jax_loaded}")
    if jax_loaded or len(paths["valAccPath"]) != 2 or not all(
            math.isfinite(v) for v in paths["valAccPath"] + paths["variencePath"]):
        _fail("run z13 referee: the NumPy referee's run failed or imported JAX")
    out["referee"] = dict(val_acc_path=paths["valAccPath"], seconds=ref_s)
    out["native_reader"] = check_native_reader(card, os.path.join(cache_dir, "native"))
    # the sweep: signmv-1's sign_bits reach no other rule, so it runs apart
    cells, order = {}, []
    kernel_of = {"gm2": "weiszfeld_step", "median": "select_columns",
                 "signmv": "packed_vote_counts"}

    def on_cell(agg, attack, cell):
        torch.cuda.synchronize()
        cells[(agg, attack)] = dict(cell, launches=dict(kernels.LAUNCHES))
        order.append((agg, attack))
        kernels.reset_launches()

    base = dict(dataset="mnist", honest_size=16, byz_size=4, rounds=1, display_interval=10,
                batch_size=50, eval_train=False, seed=2021)
    grid = {}
    t0 = time.perf_counter()
    for aggs, extra in ((["gm2", "median"], {}), (["signmv"], dict(sign_bits=1, sign_eta=0.01))):
        kernels.reset_launches()
        grid.update(sweep.run_sweep(aggs, [None, "classflip"], dict(base, **extra), dataset=ds,
                                    on_cell=on_cell))
    sweep_s = time.perf_counter() - t0
    table = sweep.markdown_table(grid)
    print(table)
    for (agg, attack), cell in cells.items():
        k = kernel_of[agg]
        if cell["launches"][k] < base["rounds"] * base["display_interval"]:
            _fail(f"sweep cell {agg}/{attack}: {k} launched {cell['launches'][k]} times")
        print(f"sweep cell {agg}/{attack or 'none'}: val_acc {cell['val_acc']} rounds/sec "
              f"{cell.get('rounds_per_sec')} launches {cell['launches']} [{card}]")
    out["sweep"] = dict(cells={f"{a}|{t or 'none'}": c for (a, t), c in cells.items()},
                        table=table, seconds=sweep_s)
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"run z13 added {out['wall_seconds']:.1f}s [{card}]")
    return out


# (z14): population shards, the sharded trainer on a process group, the
# multi-rank runs, the distributed checkpoint and the offline matrices.
# z2's 10 chunks split over 5 sequential shards (4 would not divide them:
# the config refuses it, as JAX's does)
Z14_SHARDS = 5
Z14_SHARDED_RUNS = (
    ("b_gm2_K1000", dict(agg="gm2", honest_size=900, byz_size=100), "weiszfeld_step"),
    ("a_gm_var_K50", dict(agg="gm", noise_var=1e-2, honest_size=40, byz_size=10),
     "aircomp_weiszfeld_step"),
)


def _nccl_kernels(torch, trainer):
    """The device kernels of one more iteration of ``trainer`` whose names
    are NCCL's, and the four wrappers' groups (:func:`_device_launches`)."""
    from torch.profiler import ProfilerActivity, profile

    gens = trainer.iteration_generators(10**6, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.iteration(trainer.flat_params, gens)
        torch.cuda.synchronize()
    names = [ev.name for ev in _device_kernels(torch, prof)]
    nccl = sorted({_short(n) for n in names if "nccl" in n.lower()})
    return sum("nccl" in n.lower() for n in names), nccl, _device_launches(torch, prof)


def _z14_rank(rank, world, port, out_dir):
    """(z14 c) one rank of an NCCL group of ``world`` cards: z2's streamed
    service gm2 at pop_shards ``world`` on the process-group engine, and
    run (b)'s gm2 K=1000 on the sharded trainer, one round each; rank 0
    writes the params."""
    import torch

    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.parallel import multihost

    multihost.initialize(coordinator=f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, device="cuda", timeout_s=300)
    try:
        out = {}
        for label, cfg in (
                ("pop", FedConfig(agg="gm2", attack="classflip", honest_size=900,
                                  byz_size=100, service="on", population=5000,
                                  straggler_prob=0.05, noise_var=1e-2, cohort_size=100,
                                  pop_shards=world, rounds=1, display_interval=10,
                                  eval_train=False)),
                ("sharded", FedConfig(agg="gm2", attack="classflip", honest_size=900,
                                      byz_size=100, rounds=1, display_interval=10,
                                      eval_train=False, sharded=True))):
            trainer, record = harness.run_with_trainer(cfg, device="cuda",
                                                       record_in_file=False)
            out[label] = dict(params=trainer.flat_params.cpu(), layout=trainer.layout_desc,
                              val_acc=record["valAccPath"][-1])
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "z14_ranks.pt"))
    finally:
        multihost.shutdown()


def run_z14(torch, kernels, harness, FedConfig, card, cache_dir, z2_record):
    """(z14): population shards and the multi-GPU layouts on the card.

    * (a) z2's streamed service gm2 (K=1000, cohort 100) at pop_shards 1
      (its record bitwise z2's in this call) and 5 (the sequential engine;
      4 does not divide the 10 chunks), one round each in turns (1, 5, 5,
      1): rounds/sec of each, and over
      one more profiled iteration of each the ``weiszfeld_step`` kernels on
      the device equal to the wrapper's count, a whole number of steps x
      chunks; each turn's rounds/sec goes to the perf ledger, keyed with
      its pop_shards; one iteration at pop_shards 4 (K=400, B=100, four chunks, no
      ``--var``: the per-id link needs the iteration's generators, which
      the shared-draw check does not pass) on the card against the CPU,
      within 1e-4.
    * (b) a one-rank NCCL group (a TCPStore on 127.0.0.1 at a free port):
      run (b)'s gm2 K=1000 and run (a)'s gm --var K=50, one round each on
      ``ShardedFedTrainer`` (the stack kept split, the rule's collective
      form) against the one-device trainer: records and params within
      1e-4, the kernel launched every iteration, and over one more
      profiled iteration the kernel's and NCCL's device kernels counted;
      the host ms of one all_reduce, and of an iteration of each trainer
      in the steady state.
    * (c) with two cards or more, one rank per card (``torch.
      multiprocessing``): (a) at pop_shards 2 on the process-group engine
      and (b) sharded, each within 1e-4 of this process's sequential
      engine and one-device trainer; with one card, one line says so.
    * (d) ``utils/checkpoint.py``: a DCP save and load of CUDA params
      ([1000, 7850] f32 and [7850] bf16), bitwise.
    * (e) the matrices: ``fault_matrix`` at K=20, (gm2, trimmed_mean) x
      (none, dropout) x (none, classflip), one round of 10 iterations a
      cell; ``bits_matrix --bits 1,32`` over every attack for 12
      iterations (``--assert-smoke``); ``adaptive_matrix`` over signflip,
      mimic, under_radar and duty_cycle x (off, monitor, adaptive)
      (``--assert-smoke``); each prints its cells and its kernels' launches.
    """
    import dataclasses
    import socket

    import torch.multiprocessing as tmp

    from byzantine_aircomp_tpu_torch.analysis import adaptive_matrix, bits_matrix, fault_matrix
    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.parallel import multihost
    from byzantine_aircomp_tpu_torch.registry import ATTACKS
    from byzantine_aircomp_tpu_torch.utils import checkpoint as dcp_ckpt

    out = dict(card=card)
    t_all = time.perf_counter()
    # (a) population shards
    base = FedConfig(agg="gm2", attack="classflip", honest_size=900, byz_size=100,
                     service="on", population=5000, straggler_prob=0.05, noise_var=1e-2,
                     cohort_size=100, rounds=1, display_interval=10, cache_dir=cache_dir)
    n_chunks = base.node_size // base.cohort_size
    turns = []
    for shards in (1, Z14_SHARDS, Z14_SHARDS, 1):
        cfg = dataclasses.replace(base, pop_shards=shards)
        gc.collect()
        kernels.reset_launches()
        t0 = time.perf_counter()
        trainer, record = harness.run_with_trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.LAUNCHES["weiszfeld_step"]
        before = launches
        device = _profiled_groups(torch, trainer)["weiszfeld_step+aircomp_weiszfeld_step"]
        counted = kernels.LAUNCHES["weiszfeld_step"] - before
        entry = dict(pop_shards=shards, rounds_per_sec=record["roundsPerSec"][0],
                     wall_seconds=wall, launches=launches,
                     profiled_iteration=dict(device=device, wrapper=counted,
                                             steps=counted / n_chunks),
                     bitwise_z2=_same_record(record, z2_record) if shards == 1 else None)
        turns.append(entry)
        print(f"run z14a pop_shards={shards}: rounds/sec {entry['rounds_per_sec']:.4f}, wall "
              f"{wall:.1f}s, weiszfeld_step launches {launches} over 10 iterations; one more "
              f"iteration: {device} on the device, {counted} by the wrapper = "
              f"{counted / n_chunks:g} steps x {n_chunks} chunks; record bitwise z2: "
              f"{entry['bitwise_z2']} [{card}]")
        if device != counted or counted % n_chunks or launches % n_chunks or launches < 10 * n_chunks:
            _fail(f"run z14a pop_shards={shards}: weiszfeld_step counted {device} on the device, "
                  f"{counted} by the wrapper, {launches} in the run ({n_chunks} chunks)")
        if shards == 1 and not entry["bitwise_z2"]:
            _fail("run z14a: the pop_shards=1 record is not bitwise z2's")
        if not bool(torch.isfinite(trainer.flat_params).all()):
            _fail(f"run z14a pop_shards={shards}: non-finite params")
        del trainer
    # the perf ledger's rows: pop_shards is part of their configuration key
    from byzantine_aircomp_tpu_torch import obs as obs_lib

    ledger = obs_lib.PerfLedger(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                             obs_lib.ledger.DEFAULT_LEDGER_PATH))
    name, power = [x.strip() for x in card.split(",")][:2]
    for t in turns:
        key = obs_lib.config_key(dict(k=base.node_size, b=base.byz_size, agg=base.agg,
                                      attack=base.attack, model="MLP", dataset="mnist",
                                      pop_shards=t["pop_shards"]))
        ledger.append("rounds_per_sec_z14a_streamed_service_gm2", t["rounds_per_sec"],
                      unit="rounds/s", platform="cuda", key=key, card=name, power_limit=power,
                      population=base.population, cohort_size=base.cohort_size)
    rate = {s: [t["rounds_per_sec"] for t in turns if t["pop_shards"] == s]
            for s in (1, Z14_SHARDS)}
    ratio = (sum(rate[Z14_SHARDS]) / 2) / (sum(rate[1]) / 2)
    print(f"run z14a: rounds/sec pop_shards {Z14_SHARDS} over 1 (means of two turns each) "
          f"{ratio:.4f} (prediction: within 10%) [{card}]")
    out["a"] = dict(turns=turns, rate_ratio_shards_over_1=ratio, shards=Z14_SHARDS)
    ds_small = datasets.load("mnist", synthetic_train=20000, synthetic_val=1000)
    out["a"]["card_vs_cpu_s4"] = iteration_card_vs_cpu(
        torch, dataclasses.replace(base, honest_size=300, byz_size=100, population=2000,
                                   pop_shards=4, noise_var=None, cache_dir=""), ds_small,
        "z14a_pop_shards4_K400")
    print(f"run z14a pop_shards 4, K=400, one iteration card vs CPU: max_abs_err "
          f"{out['a']['card_vs_cpu_s4']['max_abs_err']:.3e} (tolerance {ITER_ATOL}) [{card}]")

    # (b) a one-rank NCCL group
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    multihost.initialize(coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0,
                         device="cuda", timeout_s=300)
    out["b"] = {}
    try:
        # one rank's all_reduce of a [7851] f32 vector (gm's [num, den]),
        # host clock over 200 calls ending in a synchronize
        import torch.distributed as dist

        vec = torch.zeros(7851, device="cuda")
        for _ in range(20):
            dist.all_reduce(vec)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(vec)
        torch.cuda.synchronize()
        out["b"]["all_reduce_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        print(f"run z14b: one-rank NCCL all_reduce of [7851] f32: "
              f"{out['b']['all_reduce_ms']:.4f} ms a call (host clock, 200 calls) [{card}]")
        ds = datasets.load("mnist")
        for label, kw, kernel in Z14_SHARDED_RUNS:
            cfg = FedConfig(**dict(dict(attack="classflip"), **kw), rounds=1,
                            display_interval=10, eval_train=False, cache_dir=cache_dir)
            single, rec_single, _, _ = _drive(torch, kernels, harness, f"z14b {label} one device",
                                              cfg, kernel, ds)
            sharded, rec_sharded, launches, wall = _drive(
                torch, kernels, harness, f"z14b {label} sharded",
                dataclasses.replace(cfg, sharded=True), kernel, ds)
            if type(sharded).__name__ != "ShardedFedTrainer" or sharded.gathers:
                _fail(f"run z14b {label}: {type(sharded).__name__} "
                      f"{getattr(sharded, 'layout_desc', '')}")
            p_err = float((sharded.flat_params - single.flat_params).abs().max())
            r_err = _record_diff(rec_sharded, rec_single)
            n_nccl, nccl_names, device = _nccl_kernels(torch, sharded)
            # steady state: three more iterations of each trainer, host clock
            # ending in a synchronize (the run's rate holds its first
            # iteration and the group's first collective)
            steady = {}
            for side, tr in (("sharded", sharded), ("one_device", single)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for it in range(3):
                    tr.flat_params, _ = tr.iteration(tr.flat_params,
                                                     tr.iteration_generators(10**6 + 1, it))
                torch.cuda.synchronize()
                steady[side] = (time.perf_counter() - t0) / 3 * 1e3
            print(f"run z14b {label}: {sharded.layout_desc}; vs the one-device trainer params "
                  f"max abs diff {p_err:.3e}, records {r_err:.3e} (tolerance {ITER_ATOL}); "
                  f"launches {launches}; one more iteration on the device: {device}, NCCL "
                  f"kernels {n_nccl} {nccl_names}; rounds/sec {rec_sharded['roundsPerSec'][0]:.3f}"
                  f" vs {rec_single['roundsPerSec'][0]:.3f}; steady ms an iteration "
                  f"{steady['sharded']:.2f} vs {steady['one_device']:.2f} [{card}]")
            group = next(g for g in device if kernel in g.split("+"))
            if not (p_err <= ITER_ATOL and r_err <= ITER_ATOL) or device[group] < 1:
                _fail(f"run z14b {label}: the sharded run disagrees or launched no {kernel}")
            out["b"][label] = dict(params_max_abs_diff=p_err, records_max_abs_diff=r_err,
                                   launches=launches, device=device, nccl_kernels=n_nccl,
                                   nccl_names=nccl_names, wall_seconds=wall,
                                   rounds_per_sec=rec_sharded["roundsPerSec"][0],
                                   steady_ms_per_iteration=steady,
                                   one_device_rounds_per_sec=rec_single["roundsPerSec"][0])
            del single, sharded
    finally:
        multihost.shutdown()

    # (c) several ranks need as many cards
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"run z14c: skipped, {n_cards} card on this machine: NCCL needs one card per "
              "rank (two ranks on one GPU are refused, and gloo cannot all_gather CUDA "
              f"tensors) [{card}]")
        out["c"] = dict(skipped=f"{n_cards} card")
    else:
        world = min(n_cards, 4)
        res_dir = os.path.join(cache_dir, "z14c")
        os.makedirs(res_dir, exist_ok=True)
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        tmp.start_processes(_z14_rank, args=(world, port, res_dir), nprocs=world,
                            start_method="spawn")
        ranks = torch.load(os.path.join(res_dir, "z14_ranks.pt"))
        out["c"] = {}
        for label, cfg in (("pop", dataclasses.replace(base, pop_shards=world, eval_train=False)),
                           ("sharded", FedConfig(agg="gm2", attack="classflip",
                                                 honest_size=900, byz_size=100, rounds=1,
                                                 display_interval=10, eval_train=False))):
            ref, _ = harness.run_with_trainer(cfg, device="cuda", record_in_file=False)
            err = float((ranks[label]["params"] - ref.flat_params.cpu()).abs().max())
            print(f"run z14c {label} on {world} ranks: {ranks[label]['layout']}; vs this "
                  f"process max abs diff {err:.3e} (tolerance {ITER_ATOL}) [{card}]")
            if not err <= ITER_ATOL:
                _fail(f"run z14c {label}: {world} ranks disagree with one process")
            out["c"][label] = dict(max_abs_err=err, world=world)

    # (d) the distributed checkpoint
    g = torch.Generator(device="cuda").manual_seed(14)
    params = {"w": torch.randn(1000, 7850, device="cuda", generator=g),
              "bias": torch.randn(7850, device="cuda", generator=g).to(torch.bfloat16)}
    t0 = time.perf_counter()
    path = dcp_ckpt.save(os.path.join(cache_dir, "dcp"), "z14", 3, params)
    save_s = time.perf_counter() - t0
    r, back = dcp_ckpt.load(os.path.join(cache_dir, "dcp"), "z14",
                            {k: torch.zeros_like(v) for k, v in params.items()})
    same = r == 3 and all(torch.equal(back[k], params[k]) for k in params)
    print(f"run z14d: DCP save of [1000, 7850] f32 + [7850] bf16 card params in {save_s:.2f}s, "
          f"load bitwise={same}, files {sorted(os.listdir(path))} [{card}]")
    if not same:
        _fail("run z14d: the DCP round trip is not bitwise")
    out["d"] = dict(bitwise=same, save_seconds=save_s)

    # (e) the matrices, each kernel's launches counted around it
    quiet = lambda s: None  # noqa: E731
    kernels.reset_launches()
    t0 = time.perf_counter()
    fgrid = fault_matrix.run_matrix(
        ["gm2", "trimmed_mean"], [None, "dropout"], [None, "classflip"],
        dict(dataset="mnist", honest_size=16, byz_size=4, rounds=1, display_interval=10,
             batch_size=50, eval_train=False, seed=2021), dataset=ds, log=quiet)
    torch.cuda.synchronize()
    f_launch = dict(kernels.LAUNCHES)
    print(fault_matrix.markdown_table(fgrid))
    print(f"run z14e fault_matrix: {len(fgrid)} cells in {time.perf_counter() - t0:.1f}s, "
          f"launches {f_launch} [{card}]")
    if f_launch["weiszfeld_step"] < 40 or f_launch["select_columns"] < 20 or not all(
            c["finite_all_rounds"] for c in fgrid.values()):
        _fail(f"run z14e fault_matrix: kernels not launched or a cell diverged: {f_launch}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    bgrid = bits_matrix.run_matrix(sorted(ATTACKS.names()), [1, 32], iters=12, seed=0,
                                   device="cuda", log=quiet)
    torch.cuda.synchronize()
    b_launch = dict(kernels.LAUNCHES)
    bits_matrix.assert_smoke(bgrid)
    print(bits_matrix.markdown_table(bgrid))
    print(f"run z14e bits_matrix: {len(bgrid)} cells in {time.perf_counter() - t0:.1f}s, "
          f"under_radar {bits_matrix.under_radar_verdict(bgrid)}, launches {b_launch} [{card}]")
    if b_launch["packed_vote_counts"] < 12:
        _fail(f"run z14e bits_matrix: packed_vote_counts launched {b_launch}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    agrid = adaptive_matrix.run_matrix(["signflip", "mimic", "under_radar", "duty_cycle"],
                                       ["off", "monitor", "adaptive"], seed=0, device="cuda",
                                       log=quiet)
    torch.cuda.synchronize()
    a_launch = dict(kernels.LAUNCHES)
    adaptive_matrix.assert_smoke(agrid)
    print(adaptive_matrix.markdown_table(agrid))
    print(f"run z14e adaptive_matrix: {len(agrid)} cells in {time.perf_counter() - t0:.1f}s, "
          f"launches {a_launch} [{card}]")
    if a_launch["select_columns"] < 1:
        _fail(f"run z14e adaptive_matrix: the ladder's trimmed_mean never launched {a_launch}")
    out["e"] = dict(
        fault={f"{a}|{f or 'none'}|{t or 'none'}": c for (a, f, t), c in fgrid.items()},
        fault_launches=f_launch, bits={f"{a}|{b}": c for (a, b), c in bgrid.items()},
        bits_launches=b_launch, adaptive={"|".join(k): c for k, c in agrid.items()},
        adaptive_launches=a_launch)
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"run z14 added {out['wall_seconds']:.1f}s [{card}]")
    return out


# (z15): the experiment server, the chaos smoke and the tuner on the card.
# Each tenant runs Z15_ROUNDS rounds of the MNIST MLP (d = 7,850) at full
# width; gm2 classflip K=1000 in one group (three seeds and one poisoned by a
# huge step), gm --var 1e-2 K=50 in another, with a gamma swap posted over
# HTTP during its round 0 (it lands at round 1)
Z15_GM2 = dict(agg="gm2", attack="classflip", honest_size=900, byz_size=100)
Z15_GM_VAR = dict(agg="gm", attack="classflip", noise_var=1e-2, honest_size=40, byz_size=10)
Z15_ROUNDS = 2
Z15_SWAP = ("gamma", 5e-3)


def _post(port, path, body):
    """(status, parsed body, ms) of one POST on the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(), method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw or b"{}"), (time.perf_counter() - t0) * 1e3


def _served_record(info):
    import pickle

    with open(info["record"], "rb") as f:
        return pickle.load(f)


def _profiled_served_round(torch, kernels, srv, bodies):
    """One round of each tenant of ``bodies``, submitted over HTTP and
    served by one drain under torch.profiler: the device kernels of each
    wrapper group against what the wrappers counted in that drain, exact
    (:func:`_exact_sessions`; a session short of the wrappers' count serves
    the tenants again)."""
    from torch.profiler import ProfilerActivity, profile

    def measure():
        ids = []
        for body in bodies:
            status, info, _ms = _post(srv.port, "/runs", body)
            if status != 201:
                _fail(f"run z15 profiled: POST /runs answered {status}: {info}")
            ids.append(info["run_id"])
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            srv.manager.drain()
            torch.cuda.synchronize()
        counted = dict(kernels.LAUNCHES)
        states = [srv.manager.get(rid)["status"] for rid in ids]
        if states != ["completed"] * len(ids) or not (
                counted["weiszfeld_step"] and counted["aircomp_weiszfeld_step"]):
            _fail(f"run z15 profiled: the tenants ended {states}, launches {counted}")
        seen = _device_launches(torch, prof)
        return seen, {g: sum(counted[k] for k in g.split("+")) for g in seen}, None

    t0 = time.perf_counter()
    sessions = _exact_sessions("z15 profiled served round", "in one served round",
                               "the wrappers counted", measure)[1]
    return dict(sessions=sessions, seconds=time.perf_counter() - t0)


def run_z15(torch, kernels, harness, FedConfig, card, cache_dir):
    """(z15): the experiment server on the card.

    * An in-process ``ExperimentServer`` (its HTTP surface on a local port,
      this thread driving the device through ``drain``): three gm2
      classflip K=1000 tenants that differ in their seed, a fourth with
      ``gamma`` 1e30 (poisoned), and one gm --var 1e-2 K=50 tenant whose
      ``gamma`` is swapped over HTTP during its round 0, all submitted over
      HTTP, 2 rounds each.  Every healthy lane's record is bitwise its solo
      harness run on the card (the gm --var run with the same swap after
      its round 0), ``roundsPerSec`` aside; one ``batch_round_fn`` build
      per group; the wrappers' ``weiszfeld_step`` count equals the three
      solo runs' plus the poisoned config's one round, and the
      ``aircomp_weiszfeld_step`` count the gm --var solo run's; the
      poisoned lane is quarantined and its cotenants complete; ``/healthz``
      answers 200 and ``/metrics`` carries the tenants' ``run_id`` labels.
      Then two more gm2 tenants and one gm --var tenant (one iteration a
      round: 1,000 steps, where ten would give the profiler 10,000) are
      served one round under torch.profiler, and the Weiszfeld kernels
      seen on the device equal the wrappers' count
      (:func:`_profiled_served_round`).
      Lane and solo rounds/sec and the admission time (the client's
      largest of the five POSTs, the server's p99 bucket edge) are
      printed.
    * Chaos ``smoke`` against ``python -m byzantine_aircomp_tpu_torch
      serve`` subprocesses on the card.
    * A tune of 2 candidates (4 lanes) x 2 generations on the adaptive
      ladder (mean, trimmed_mean, multi_krum): one build per generation,
      ``select_columns`` launched by the ladder's trimmed_mean rung."""
    import shutil

    from byzantine_aircomp_tpu_torch.data import datasets
    from byzantine_aircomp_tpu_torch.serve.batch import BatchRunner
    from byzantine_aircomp_tpu_torch.serve.server import ExperimentServer
    from byzantine_aircomp_tpu_torch.tune import Tuner

    out = dict(card=card)
    t_all = time.perf_counter()
    ds = datasets.load("mnist")
    root = os.path.join(cache_dir, "z15_serve")
    shutil.rmtree(root, ignore_errors=True)
    base = dict(rounds=Z15_ROUNDS, display_interval=10, eval_train=False)
    healthy = [dict(base, **Z15_GM2, seed=s) for s in (2021, 2022, 2023)]
    poisoned = dict(base, **Z15_GM2, seed=2024, gamma=1e30)
    gm_var = dict(base, **Z15_GM_VAR, seed=2021)
    srv = ExperimentServer(root, port=0, host="127.0.0.1", dataset=ds, device="cuda")
    srv.exporter.start()  # the run API; this thread drives the device
    port = srv.port
    posted = []
    orig_round = BatchRunner.run_round

    def swapping_round(self, round_idx):
        # the gm --var group's round 0 done: the swap goes over HTTP and
        # lands at the lane's next round boundary
        res = orig_round(self, round_idx)
        if not posted and self.cfgs[0].noise_var is not None:
            posted.append(_post(port, f"/runs/{ids[-1]}/knobs", dict([Z15_SWAP])))
        return res

    try:
        admission, ids = [], []
        for body in healthy + [poisoned, gm_var]:
            status, info, ms = _post(port, "/runs", body)
            if status != 201:
                _fail(f"run z15: POST /runs answered {status}: {info}")
            admission.append(ms)
            ids.append(info["run_id"])
        BatchRunner.run_round = swapping_round
        gc.collect()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            srv.manager.drain()
        finally:
            BatchRunner.run_round = orig_round
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        served = dict(kernels.LAUNCHES)
        infos = {rid: json.loads(_scrape(port, f"/runs/{rid}")[1]) for rid in ids}
        h_status, h_body, _ = _scrape(port, "/healthz")
        m_status, metrics, scrape_ms = _scrape(port, "/metrics")
        server_p99 = srv.registry.quantile("aircomp_http_request_seconds", 0.99,
                                           route="POST /runs")
        profiled = _profiled_served_round(
            torch, kernels, srv, [dict(healthy[0], rounds=1, seed=s) for s in (2031, 2032)]
            + [dict(gm_var, rounds=1, seed=2031, display_interval=1)])
    finally:
        srv.exporter.close()
        srv.manager.close()
    backend = "vmap (a group's lanes in turn, one stream)"
    good = ids[:3] + ids[4:]
    bad = infos[ids[3]]
    if not (all(infos[r]["status"] == "completed" and infos[r].get("lowerings") == 1
                for r in good)
            and bad["status"] == "failed" and "quarantined" in bad.get("error", "")):
        _fail(f"run z15: lanes not completed with one build, or the poisoned lane not "
              f"quarantined: {infos}")
    if not (posted and posted[0][0] == 200 and infos[ids[-1]]["swaps"] == [
            dict(round=1, knob=Z15_SWAP[0], value=Z15_SWAP[1])]):
        _fail(f"run z15: the swap did not land at round 1: {posted} {infos[ids[-1]]}")
    if h_status != 200 or m_status != 200 or not all(
            f'run_id="{r}"' in metrics for r in ids):
        _fail(f"run z15: /healthz {h_status} {h_body} or /metrics {m_status} without the "
              "tenants' run_id labels")
    # the solo references, each through the harness on the card
    solo_launch = {k: 0 for k in served}
    lanes = []
    for body, rid in zip(healthy + [gm_var], good):
        swap = rid == ids[-1]
        cfg = FedConfig(**dict(body, cache_dir=os.path.join(cache_dir, "z15_solo")))
        kernel = "aircomp_weiszfeld_step" if swap else "weiszfeld_step"
        _t, record, launches, wall = _drive(
            torch, kernels, harness, f"z15 solo {rid}", cfg, kernel, ds,
            on_round=(lambda r, t: setattr(t.cfg, *Z15_SWAP) if r == 1 else None)
            if swap else None)
        del _t
        for k, v in launches.items():
            solo_launch[k] += v
        got = _served_record(infos[rid])
        lane_rate, solo_rate = got.pop("roundsPerSec"), record.pop("roundsPerSec")
        if not _same_record(got, record):
            _fail(f"run z15: lane {rid} is not bitwise its solo run")
        lanes.append(dict(run_id=rid, lane=infos[rid]["lane"], agg=body["agg"],
                          lane_rounds_per_sec=lane_rate, solo_rounds_per_sec=solo_rate,
                          solo_wall_seconds=wall))
    # the poisoned config's one round, which its lane ran before quarantine
    t = harness.make_trainer(FedConfig(**poisoned), dataset=ds, device="cuda")
    kernels.reset_launches()
    t.run_round(0)
    torch.cuda.synchronize()
    solo_launch["weiszfeld_step"] += kernels.LAUNCHES["weiszfeld_step"]
    del t
    counted = {k: (served[k], solo_launch[k]) for k in ("weiszfeld_step",
                                                        "aircomp_weiszfeld_step")}
    if any(a != b or a == 0 for a, b in counted.values()):
        _fail(f"run z15: served launches differ from the solo runs' (served, solo): {counted}")
    client_max = max(admission)
    for lane in lanes:
        print(f"run z15 lane {lane['run_id']} ({lane['agg']}, lane {lane['lane']}): bitwise "
              f"its solo run; rounds/sec lane {lane['lane_rounds_per_sec']} solo "
              f"{lane['solo_rounds_per_sec']} [{card}]")
    print(f"run z15 served: {len(ids)} tenants in 2 groups ({backend}), drain "
          f"{served_s:.2f}s; launches (served, solo) {counted}; poisoned lane "
          f"{bad['error']}; admission max of {len(admission)} POSTs {client_max:.2f} ms "
          f"(client clock), server p99 {None if server_p99 is None else server_p99 * 1e3} ms "
          f"(bucket edge); /metrics {scrape_ms:.2f} ms; the profiled round "
          f"{profiled['seconds']:.1f}s [{card}]")
    out["serve"] = dict(infos=infos, lanes=lanes, launches_served=served,
                        launches_solo=solo_launch, drain_seconds=served_s,
                        admission_ms=admission, admission_max_client_ms=client_max,
                        admission_p99_server_s=server_p99, backend=backend,
                        profiled_served_round=profiled)

    # the chaos smoke against serve subprocesses on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(cache_dir, "z15_chaos")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch.analysis.chaos", "--scenario",
         "smoke", "--device", "cuda", "--workdir", work],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p)))
    chaos_s = time.perf_counter() - t0
    print(proc.stdout.strip())
    if proc.returncode != 0 or "smoke: OK" not in proc.stdout:
        _fail(f"run z15 chaos smoke failed (rc {proc.returncode}): {proc.stderr[-3000:]}")
    print(f"run z15 chaos smoke: OK in {chaos_s:.1f}s [{card}]")
    out["chaos_smoke_seconds"] = chaos_s

    # the tuner on the adaptive ladder
    base_cfg = FedConfig(honest_size=13, byz_size=3, attack="signflip@1", agg="mean",
                         defense="adaptive", defense_ladder="mean,trimmed_mean,multi_krum",
                         forensics="top", forensics_top=8, display_interval=2,
                         eval_train=False, rounds=1, defense_warmup=1, batch_size=32)
    kernels.reset_launches()
    t0 = time.perf_counter()
    tuner = Tuner(base_cfg, population=2, generations=2, base_rounds=3, seed=0, dataset=ds,
                  device="cuda")
    result = tuner.run()
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tl = dict(kernels.LAUNCHES)
    print(f"run z15 tune: 2 candidates x 2 generations (4 then 2 lanes) in {tune_s:.1f}s, "
          f"builds {tuner.lowerings}, winner {result['tuned']['candidate']} objective "
          f"{result['tuned']['objective']:.4f} (default "
          f"{result['default'].get('objective', float('nan')):.4f}), launches {tl} [{card}]")
    if tuner.lowerings != 2 or tl["select_columns"] < 1:
        _fail(f"run z15 tune: {tuner.lowerings} builds for 2 generations, or the ladder's "
              f"trimmed_mean never launched select_columns: {tl}")
    out["tune"] = dict(builds=tuner.lowerings, launches=tl, seconds=tune_s,
                       tuned=result["tuned"], default=result["default"])
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"run z15 added {out['wall_seconds']:.1f}s [{card}]")
    return out


# (z16): the two-tier aggregation on the card.  One root and four edges
# (``python -m byzantine_aircomp_tpu_torch root|edge --device cuda``) at the
# MNIST MLP's width: each edge owns 5 chunks of 50 rows of a [1000, 7850]
# round stack, runs the streamed median, trimmed mean, mean and gm2 over
# them and packs its 250 rows' signs; gm2 launches weiszfeld_step in num/den
# mode once per chunk per Weiszfeld step, the vote packed_vote_counts once
# per edge per round; median and trimmed_mean bisect ranks in torch ops
Z16_TOPOLOGY = dict(edges=4, k=1000, d=7850, cohort=50, rounds=3,
                    aggs=["median", "trimmed_mean", "mean", "gm2"], sign_bits=1,
                    gm2_maxiter=1000, seed=2021, partial_timeout=10.0)
# the card's flat aggregate against the CPU's plain versions
Z16_TOL = {"median": 0.0, "signvote": 0.0, "mean": 1e-6, "trimmed_mean": 1e-6,
           "gm2": ITER_ATOL}


def _z16_topology(work):
    cfg = dict(Z16_TOPOLOGY, keys={str(e): os.urandom(32).hex()
                                   for e in range(Z16_TOPOLOGY["edges"])})
    path = os.path.join(work, "topo.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _z16_tree(chaos, topo, work, label, kill=None):
    """One root and its edges as subprocesses on the card; with ``kill``,
    that edge is SIGKILLed once round 0 completes.  Returns the root's
    results, the edges' summaries (None for the killed one) and the wall
    seconds from the root's start to its exit."""
    obs = os.path.join(work, f"{label}_obs")
    t0 = time.perf_counter()
    root = chaos.Root(topo, obs, os.path.join(work, f"{label}_root.log"), linger=0.5)
    edges = [chaos.EdgeProc(topo, e, root.url, obs, os.path.join(work, f"{label}_edge{e}.log"))
             for e in range(Z16_TOPOLOGY["edges"])]
    try:
        if kill is not None:
            root.wait_round(0, deadline=300)
            edges[kill].kill9()
        results = root.wait_exit(deadline=600)
        wall = time.perf_counter() - t0
        summaries = [None if e == kill else edges[e].summary(deadline=120)
                     for e in range(len(edges))]
    finally:
        for e in edges:
            e.close()
        root.close()
    return results, summaries, wall


def run_z16(torch, kernels, card, cache_dir):
    """(z16): the two-tier aggregation on the card.

    (a) A root and four edges at ``Z16_TOPOLOGY`` (k=1000, d=7850, 3
    rounds): no edge quarantined, every round's every result bitwise the
    flat single-process aggregate (``analysis/chaos.py::_flat_reference``,
    ``SeqShardCtx`` and the whole-stack vote) computed here on the card,
    whose results hold against the CPU's plain versions (median and the
    vote bitwise, mean and trimmed_mean within 1e-6, gm2 within 1e-4);
    summed over the edges, their ``weiszfeld_step`` launches equal the
    flat's, and their ``packed_vote_counts`` launches equal edges x rounds;
    one profiled flat round shows both kernels on the device, as often as
    the wrappers counted (:func:`_exact_sessions`).  Per round: wall time,
    exchanges, the root's ingress bytes and fold ms, the edges' ms on the
    wire.
    (b) The same topology with edge 2 SIGKILLed once round 0 completes: the
    root quarantines it (``partial_timeout``), the three survivors finish
    rounds 1-2 degraded, round 0 bitwise the flat.  JAX's build count is
    one per program by construction; the set-ups the card makes
    (``ops/kernels.py::SETUPS``: each kernel's load, the [cohort, d]
    Weiszfeld workspace) are each made once, all by the healthy program,
    in (a) and (b).
    (c) chaos ``edge_ledger`` on the card (JAX's k=128, d=7850 one-bit
    topology), run beside (b): root ingress at most flat/24."""
    import dataclasses
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from byzantine_aircomp_tpu_torch.analysis import chaos
    from byzantine_aircomp_tpu_torch.ops import shardctx
    from byzantine_aircomp_tpu_torch.serve.edge import TopologyConfig

    out = dict(card=card, topology=Z16_TOPOLOGY)
    t_all = time.perf_counter()
    work = os.path.join(cache_dir, "z16")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    topo = _z16_topology(work)
    cfg = TopologyConfig.load(topo)
    chaos.DEVICE = "cuda"

    # an edge's one-time set-ups on the card (ops/kernels.py::SETUPS), all
    # made by the program that runs first: the two kernels' loads and one
    # Weiszfeld workspace of the [cohort, d] chunk
    setups = {"load:weiszfeld_step": 1, "load:packed_vote_counts": 1,
              f"workspace:{cfg.cohort}x{cfg.d}": 1}

    # (a) the healthy tree, then the flat aggregate on the card and the CPU
    results, summaries, wall = _z16_tree(chaos, topo, work, "a")
    if results["quarantined"] or any(s["status"] != "completed" or s["rounds"] != cfg.rounds
                                     or s["lowerings"] != {"edge_round_fn": 1}
                                     or s["setups"] != {"edge_round_fn": setups}
                                     or s["device"] != "cuda" for s in summaries):
        _fail(f"run z16a: an edge was quarantined or did not finish with one set-up "
              f"{setups}: {results['quarantined']} {summaries}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    flat = chaos._flat_reference(cfg, device="cuda")
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    flat_launch = dict(kernels.LAUNCHES)
    chaos._assert_matches_flat(cfg, results, flat)
    t0 = time.perf_counter()
    flat_cpu = chaos._flat_reference(cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    errs = {}
    for name, tol in Z16_TOL.items():
        errs[name] = max(float(np.max(np.abs(flat[r][name].astype(np.float64)
                                              - flat_cpu[r][name].astype(np.float64))))
                         for r in range(cfg.rounds))
        same = all(flat[r][name].tobytes() == flat_cpu[r][name].tobytes()
                   for r in range(cfg.rounds))
        if (tol == 0.0 and not same) or errs[name] > tol:
            _fail(f"run z16a: the card's flat {name} is {errs[name]} from the CPU's (tol {tol})")
    edge_launch = {k: sum(s["launches"][k] for s in summaries) for k in flat_launch}
    votes = cfg.edges * cfg.rounds
    if (edge_launch["weiszfeld_step"] != flat_launch["weiszfeld_step"]
            or not flat_launch["weiszfeld_step"]
            or edge_launch["packed_vote_counts"] != votes):
        _fail(f"run z16a: the edges launched {edge_launch}, the flat {flat_launch}; "
              f"packed_vote_counts should be {votes}")
    one = dataclasses.replace(cfg, rounds=1)

    def measure():
        torch.cuda.synchronize()
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            chaos._flat_reference(one, device="cuda")
            torch.cuda.synchronize()
        counted = dict(kernels.LAUNCHES)
        seen = _device_launches(torch, prof)
        return seen, {g: sum(counted[k] for k in g.split("+")) for g in seen}, None

    sessions = _exact_sessions("z16a profiled flat round", "in one flat round",
                               "the wrappers counted", measure)[1]
    if not (sessions[-1]["device"]["weiszfeld_step+aircomp_weiszfeld_step"]
            and sessions[-1]["device"]["packed_vote_counts"]):
        _fail(f"run z16a: a kernel of the path was not seen on the device: {sessions}")
    per_round = []
    for r in range(cfg.rounds):
        rr = results["rounds"][str(r)]
        er = [s["per_round"][r] for s in summaries]
        per_round.append(dict(round=r, wall_ms=max(e["ms"] for e in er),
                              exchanges=er[0]["exchanges"], folds=rr["folds"],
                              ingress_bytes=rr["ingress_bytes"], fold_ms=rr["fold_ms"],
                              edge_exchange_ms=[e["exchange_ms"] for e in er],
                              edge_stack_ms=[e["stack_ms"] for e in er]))
        print(f"run z16a round {r}: wall {per_round[-1]['wall_ms']:.1f} ms, "
              f"{per_round[-1]['exchanges']} exchanges per edge ({rr['folds']} folds), root "
              f"ingress {rr['ingress_bytes']} B, root fold {rr['fold_ms']:.1f} ms, edges' "
              f"exchange ms {[round(x, 1) for x in per_round[-1]['edge_exchange_ms']]}, stack "
              f"draw ms {[round(x, 1) for x in per_round[-1]['edge_stack_ms']]} [{card}]")
    print(f"run z16a: 4 edges x 3 rounds at k=1000 d=7850 in {wall:.1f}s (processes "
          f"included), every result bitwise the card's flat aggregate; card vs CPU flat max "
          f"abs err {errs}; launches edges {edge_launch} flat {flat_launch}; flat on the card "
          f"{flat_s:.2f}s, on the CPU {cpu_s:.2f}s [{card}]")
    out["a"] = dict(wall_seconds=wall, per_round=per_round, card_vs_cpu=errs,
                    launches_edges=edge_launch, launches_flat=flat_launch,
                    profiled_flat_round=sessions, flat_card_seconds=flat_s,
                    flat_cpu_seconds=cpu_s, summaries=summaries,
                    fold_lowerings=results["fold_lowerings"],
                    fold_signatures=results["fold_signatures"])

    # (c) the bandwidth claim on JAX's own topology, started now so that its
    # processes' start-up overlaps (b)'s: its numbers are bytes, which the
    # overlap does not move
    repo = os.path.dirname(os.path.abspath(__file__))
    t_c = time.perf_counter()
    ledger = subprocess.Popen(
        [sys.executable, "-m", "byzantine_aircomp_tpu_torch.analysis.chaos", "--scenario",
         "edge_ledger", "--device", "cuda", "--workdir", os.path.join(work, "ledger")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p)))

    # (b) the kill leg
    try:
        results, summaries, wall = _z16_tree(chaos, topo, work, "b", kill=2)
    except BaseException:
        ledger.kill()
        ledger.wait()
        raise
    survivors = [s for s in summaries if s is not None]
    if results["quarantined"] != {"2": "partial_timeout"} or any(
            s["status"] != "completed" or s["rounds"] != cfg.rounds
            or s["lowerings"] != {"edge_round_fn": 1, "edge_round_fn_degraded": 1}
            or s["setups"] != {"edge_round_fn": setups, "edge_round_fn_degraded": {}}
            for s in survivors):
        _fail(f"run z16b: {results['quarantined']} {survivors}")
    rounds = results["rounds"]
    if rounds["0"]["degraded"] or not all(rounds[str(r)]["completed"] and rounds[str(r)]["degraded"]
                                          for r in range(1, cfg.rounds)):
        _fail(f"run z16b: rounds 1-2 not completed degraded: {rounds}")
    chaos._assert_matches_flat(cfg, results, flat, rounds=[0])
    print(f"run z16b: edge 2 SIGKILLed after round 0, quarantined {results['quarantined']}, "
          f"3 survivors finished rounds 1-2 degraded, builds "
          f"{[s['lowerings'] for s in survivors]} (1 per program by construction), set-ups "
          f"{[s['setups'] for s in survivors]}, round 0 bitwise the flat; {wall:.1f}s "
          f"[{card}]")
    out["b"] = dict(wall_seconds=wall, quarantined=results["quarantined"],
                    builds=[s["lowerings"] for s in survivors],
                    setups=[s["setups"] for s in survivors],
                    per_round=[s["per_round"] for s in survivors])

    # (c), waited for
    try:
        stdout, stderr = ledger.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        ledger.kill()
        stdout, stderr = ledger.communicate()
    ledger_s = time.perf_counter() - t_c
    print(stdout.strip())
    if ledger.returncode != 0 or "edge_ledger: OK" not in stdout:
        _fail(f"run z16c edge_ledger failed (rc {ledger.returncode}): {stderr[-3000:]}")
    with open(os.path.join(work, "ledger", "edge_ledger", "edge_ledger_row.json")) as f:
        row = json.load(f)
    ratio = row["bytes_moved_f32"] / row["bytes_moved"]
    print(f"run z16c edge_ledger: root ingress {row['bytes_moved']} B a round against flat "
          f"f32 {row['bytes_moved_f32']} B (flat/{ratio:.2f}) in {ledger_s:.1f}s, beside (b) "
          f"[{card}]")
    out["c"] = dict(row=row, flat_over_ingress=ratio, seconds=ledger_s)
    out["wall_seconds"] = time.perf_counter() - t_all
    print(f"run z16 added {out['wall_seconds']:.1f}s [{card}]")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--count-replays"]:  # fresh_replay_count's child
        return count_in_fresh_process(*sys.argv[2:5])
    from byzantine_aircomp_tpu_torch.device import resolve_device
    from byzantine_aircomp_tpu_torch.fed import harness
    from byzantine_aircomp_tpu_torch.fed.config import FedConfig
    from byzantine_aircomp_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    resolve_device("cuda")  # TF32 off, deterministic cuDNN
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"built kernels in {time.perf_counter() - t0:.1f}s: {build_s}")

    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return res

    rows = phase("check_kernels", check_kernels, torch, kernels)
    rows += phase("check_fused", check_fused, torch, kernels)
    rows += phase("check_select_and_popcount", check_select_and_popcount, torch, kernels, card)
    rows += phase("time_fused_nan_rows_and_idle", time_fused_nan_rows_and_idle, torch, kernels,
                  card)
    iter_errs = phase("check_solver_and_iteration", check_solver_and_iteration, torch)
    iter_errs.update(phase("check_option_iterations", check_option_iterations, torch, FedConfig))
    iter_errs.update(phase("check_service_iterations", check_service_iterations, torch, kernels,
                           FedConfig))
    root = os.path.dirname(os.path.abspath(__file__))
    cache_dir = os.path.join(root, "build", "chip_smoke")
    ctx = (torch, kernels, harness, FedConfig, card, cache_dir)
    runs = phase("run_main_path", run_main_path, *ctx)
    conv = phase("check_conv_models", check_conv_models, *ctx)
    service_runs = phase("run_service_and_streams", run_service_and_streams, *ctx)
    graphed_runs = phase("run_graphed", run_graphed, *ctx)
    graphed_runs["j3"] = phase("run_j3", run_j3, *ctx)
    obs_runs = phase("run_obs", run_obs, *ctx)
    telemetry_runs = phase("run_telemetry", run_telemetry, *ctx)
    knob_runs = phase("run_z13", run_z13, *ctx)
    layout_runs = phase("run_z14", run_z14, *ctx, service_runs["z2"].pop("record"))
    serve_runs = phase("run_z15", run_z15, *ctx)
    topology_runs = phase("run_z16", run_z16, torch, kernels, card, cache_dir)
    degraded_sort = phase("time_degraded_sort", time_degraded_sort, torch, kernels, card)
    profiler_loss = phase("check_profiler_loss", check_profiler_loss, *ctx)
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")

    # each kernel's row: the shape this slice's run gives it, the CNN's and
    # ResNet-18's widths (the Weiszfeld kernels in their fused mode, which
    # the main path runs)
    picks = {
        "weiszfeld_step": ("q_cnn_gm2", dict(k=50, d=CNN_D, dtype="float32", mode="fused")),
        "aircomp_weiszfeld_step": ("r_cnn_gm_var", dict(k=50, d=CNN_D, dtype="float32",
                                                        mode="fused")),
        "select_columns": ("s_resnet18_median_var_signflip",
                           dict(k=50, d=RESNET_D, mode="median", channel=True,
                                adversarial=False)),
        "packed_vote_counts": ("t_cifar_cnn_dirichlet_signmv1_var",
                               dict(k=200, d=CIFAR_CNN_D)),
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
    if sorted(k["name"] for k in line) != sorted(sources):
        _fail(f"the kernels line lists {[k['name'] for k in line]}")
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                       build_seconds=build_s, kernel_rows=rows,
                       iteration_vs_cpu_max_abs_err=iter_errs, runs=runs, conv_models=conv,
                       service_and_streamed_runs=service_runs, graphed_runs=graphed_runs,
                       obs_runs=obs_runs, telemetry_runs=telemetry_runs,
                       knob_runs=knob_runs, layout_runs=layout_runs, serve_runs=serve_runs,
                       topology_runs=topology_runs, degraded_sort=degraded_sort,
                       profiler_loss=profiler_loss,
                       phase_seconds=phase_s, kernels=line,
                       wall_seconds=time.perf_counter() - t_start), f, indent=1)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": line}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
