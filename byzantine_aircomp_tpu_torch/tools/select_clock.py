"""Where the time of ``select_columns`` goes, from clock64 marks in the kernel.

    python -m byzantine_aircomp_tpu_torch.tools.select_clock

Builds ``ops/csrc/select_columns.cu`` a second time with
``-DSELECT_COLUMNS_CLOCK -Xptxas -v`` (each block then records clock64 at
its start, after staging its keys and at its end, the global timer at its
start and end, and clock64 around the digit passes of one radix column),
runs the four modes
(median, trimmed mean, each with and without the channel fold) at K=50 and
K=1000, d=7850, and prints per case: the median and largest staging and
selection cycles over the blocks, the same in microseconds (cycles times
the blocks' own ns per cycle), and the span from the first block's start to
the last block's end; at K > 64, the median over blocks of each digit
pass of one column (its first pass only where the two ranks of a trimmed
mean part later) and of the whole column.  Beside them, the production build's device ms per
call (CUDA-graph replay, ``chip_smoke._time_ms``).  Needs one NVIDIA GPU;
writes ``chiprun_out/select_clock.json``.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

from ..ops import channel, kernels

ROOT = kernels.BUILD_DIR.parents[1]
SLOTS = 11  # clock words per block, kClockSlots in the source


def _build_clock_lib():
    out = kernels.BUILD_DIR / "clock" / "libselect_columns_clock.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DSELECT_COLUMNS_CLOCK", "-Xptxas", "-v",
           "-o", str(out), str(kernels.CSRC / kernels._SOURCES["select_columns"])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.select_columns_launch.argtypes = kernels._ARGTYPES["select_columns"]
    lib.select_columns_launch.restype = ctypes.c_int
    for qname, (argtypes, restype) in kernels._QUERIES.get("select_columns", {}).items():
        q = getattr(lib, qname)
        q.argtypes, q.restype = argtypes, restype
    lib.select_columns_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.select_columns_clock_read.restype = ctypes.c_int
    return lib, proc.stderr + proc.stdout


def _inputs(k, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = 0.01 * torch.randn(1, d, device="cuda", generator=g) + 1e-3 * torch.randn(
        k, d, device="cuda", generator=g)
    terms = channel.oma_terms(k, d, 1e-2, generator=g, device="cuda")
    return w.contiguous(), channel.OmaTerms(*(t.contiguous() for t in terms))


def _call(mode, w, b, ch):
    if mode == "median":
        return kernels.fused_median(w, ch)
    return kernels.fused_trimmed_mean(w, b, ch)


def _grid_blocks(lib, k, d):
    """Run the library's own plan (it raises that build's shared-memory
    cap) and return its grid."""
    plan = (ctypes.c_longlong * len(kernels._SELECT_PLAN_FIELDS))()
    err = lib.select_columns_plan(k, d, ctypes.addressof(plan))
    if err != 0:
        raise RuntimeError(f"select_columns_plan failed: CUDA error {err}")
    return dict(zip(kernels._SELECT_PLAN_FIELDS, plan))["grid"]


def main():
    if not torch.cuda.is_available():
        print("select_clock: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    card = chip_smoke._card_line()
    print(card)
    kernels.build(["select_columns"])
    prod = kernels._LIBS["select_columns"]
    clock_lib, ptxas = _build_clock_lib()
    print("ptxas (clock build):\n" + "\n".join(
        line for line in ptxas.splitlines() if "registers" in line or "spill" in line))
    rows = []
    d = 7850
    for k in (50, 1000):
        w, terms = _inputs(k, d, seed=k)
        b = int(0.1 * k)
        for mode, ch in (("median", None), ("median", terms),
                         ("trimmed_mean", None), ("trimmed_mean", terms)):
            kernels._LIBS["select_columns"] = prod
            ms, host_ms = chip_smoke._time_ms(torch, lambda: _call(mode, w, b, ch))
            blocks = _grid_blocks(clock_lib, k, d)
            kernels._LIBS["select_columns"] = clock_lib
            _call(mode, w, b, ch)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (SLOTS * blocks))()
            err = clock_lib.select_columns_clock_read(ctypes.addressof(buf), blocks)
            if err != 0:
                raise RuntimeError(f"clock read failed: CUDA error {err}")
            kernels._LIBS["select_columns"] = prod
            marks = [buf[SLOTS * i: SLOTS * (i + 1)] for i in range(blocks)]
            stage = [m[1] - m[0] for m in marks]
            select = [m[2] - m[1] for m in marks]
            ns_per_cycle = statistics.median(
                (m[4] - m[3]) / max(m[2] - m[0], 1) for m in marks)
            span_ns = max(m[4] for m in marks) - min(m[3] for m in marks)
            row = dict(
                mode=mode, channel=ch is not None, k=k, d=d, blocks=blocks,
                stage_cycles_median=statistics.median(stage), stage_cycles_max=max(stage),
                select_cycles_median=statistics.median(select),
                select_cycles_max=max(select), ns_per_cycle=ns_per_cycle,
                stage_us_median=statistics.median(stage) * ns_per_cycle / 1e3,
                select_us_median=statistics.median(select) * ns_per_cycle / 1e3,
                block_us_median=statistics.median(m[4] - m[3] for m in marks) / 1e3,
                span_us=span_ns / 1e3, ms=ms, host_ms=host_ms, card=card,
            )
            row["plan"] = kernels.select_plan(w.device, k, d)
            if k > 64:
                passes = [statistics.median(m[6 + i] - m[5 + i] for m in marks) * ns_per_cycle / 1e3
                          for i in range(4 if mode == "median" else 1)]
                row["column_pass_us_median"] = passes
                row["column_us_median"] = statistics.median(
                    m[10 if mode == "trimmed_mean" else 9] - m[5] for m in marks) * ns_per_cycle / 1e3
            rows.append(row)
            print(f"select_columns {mode}{'+channel' if ch is not None else ''} K={k} "
                  f"d={d}: {blocks} blocks; per block stage {row['stage_us_median']:.2f} us "
                  f"(max {max(stage) * ns_per_cycle / 1e3:.2f}), select "
                  f"{row['select_us_median']:.2f} us (max {max(select) * ns_per_cycle / 1e3:.2f}), "
                  f"block {row['block_us_median']:.2f} us; span {row['span_us']:.2f} us; "
                  f"plan {row['plan']}; "
                  + (f"one column {row['column_us_median']:.2f} us, passes "
                     f"{['%.2f' % x for x in row['column_pass_us_median']]} us; "
                     if k > 64 else "")
                  + f"device {ms:.4f} ms/call, host {host_ms:.4f} ms/call [{card}]")
    out_dir = ROOT / "chiprun_out"
    os.makedirs(out_dir, exist_ok=True)
    with open(out_dir / "select_clock.json", "w") as f:
        json.dump(dict(card=card, ptxas=ptxas, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
