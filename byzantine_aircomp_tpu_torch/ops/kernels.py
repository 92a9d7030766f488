"""Hand-written Hopper kernels of the port, and their plain versions.

Counterpart of ``byzantine_aircomp_tpu/ops/pallas_kernels.py``, one kernel
for each TPU kernel there:

* :func:`weiszfeld_step` (``csrc/weiszfeld_step.cu``) — one ideal step,
  ``num = sum_i w_i/d_i``, ``den = sum_i 1/d_i`` (the ``gm2`` aggregator);
* :func:`aircomp_weiszfeld_step` (``csrc/aircomp_weiszfeld_step.cu``) — one
  over-the-air step with OMA2 power control (the ``gm`` aggregator);
* :func:`weiszfeld_step_fused` / :func:`aircomp_weiszfeld_step_fused` — the
  same kernels in their fused mode: a whole step of the Weiszfeld loop
  (the guess update, the stopping rule and, for ``gm``, the fades' squared
  magnitudes, the receiver noise and the next scaler) in one launch;
* :func:`fused_median` / :func:`fused_trimmed_mean`
  (``csrc/select_columns.cu``) — coordinatewise order statistics over
  IEEE total-order keys, with the OMA channel optionally folded into the
  read (``median``, ``trimmed_mean``);
* :func:`packed_vote_counts` (``csrc/packed_vote_counts.cu``) — per-bit
  ballot counts of the packed one-bit sign words (``signmv``).

The CUDA sources are compiled with ``nvcc`` for ``sm_90a`` into shared
libraries with a plain C interface, loaded with ``ctypes`` (an ``nvcc``
build of such a file takes seconds; one that includes PyTorch's headers,
minutes).  The build runs at first use, or through :func:`build`, into
``build/torch_kernels/`` at the repository root, keyed by a digest of each
source and the headers it includes.

Each wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  Inside
:func:`implementation` (the trainer's resolved ``FedConfig.agg_impl``) the
choice is the caller's instead: ``"pallas"`` launches the kernels and
refuses a CPU tensor (there is no kernel on the CPU), ``"xla"`` runs the
plain versions on any device and launches nothing.  ``LAUNCHES`` counts kernel
launches per source (both modes of a Weiszfeld kernel count under its
source), so a run can show that it went through the kernels; a CUDA-graph
replay of a round adds the launches its capture recorded
(:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

from .channel import OmaTerms, floored_hsq, oma_residual

# shared Weiszfeld constants (the kernels' sources hold the same values)
DIST_CLAMP = 1e-4  # divide-by-zero guard, MNIST_Air_weight.py:151,:178
GM_THRESHOLD_FACTOR = 500.0  # gm power-control threshold = 500*scaler^2, :152

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = {
    "weiszfeld_step": "weiszfeld_step.cu",
    "aircomp_weiszfeld_step": "aircomp_weiszfeld_step.cu",
    "select_columns": "select_columns.cu",
    "packed_vote_counts": "packed_vote_counts.cu",
}
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches per wrapper since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in _SOURCES}
# this process's one-time set-ups, counted where they happen and never
# reset: a kernel's library loaded ("load:NAME") and a Weiszfeld workspace
# allocated ("workspace:KxD"), so a second set-up of one kind shows as a 2
SETUPS: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_LL, _I, _F = ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "weiszfeld_step": [_P, _I, _P, _LL, _LL, _P, _P, _P, _P],
    "aircomp_weiszfeld_step": [
        _P, _I, _P, _P, _P, _F, _LL, _LL, _P, _P, _P, _P,
    ],
    "select_columns": [
        _P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P, _P, _P,
    ],
    "packed_vote_counts": [_P, _LL, _LL, _LL, _P, _P],
}
# further C functions of a library: name -> (argtypes, restype)
_WORKSPACE_QUERY = {"weiszfeld_workspace_bytes": ([_LL, _LL], _LL)}
_QUERIES = {
    "weiszfeld_step": {
        **_WORKSPACE_QUERY,
        "weiszfeld_step_fused": (
            [_P, _I, _P, _P, _LL, _LL, _F, _P, _P, _P, _P], _I,
        ),
    },
    "aircomp_weiszfeld_step": {
        **_WORKSPACE_QUERY,
        "aircomp_weiszfeld_step_fused": (
            [_P, _I, _P, _P, _P, _P, _F, _P, _F, _P, _F, _LL, _LL, _F, _P, _P,
             _P, _P], _I,
        ),
    },
    "select_columns": {
        "select_columns_plan": ([_LL, _LL, _P], _I),
    },
}
# Weiszfeld workspaces (slice partials and the ticket), one per
# (device, K, d), allocated at first use and kept
_WORKSPACES: Dict[Tuple[int, int, int], torch.Tensor] = {}
# select_columns launch plans, one per (device, K, d), found at first use so
# that a call makes no CUDA attribute query
_SELECT_PLANS: Dict[Tuple[int, int, int], Dict[str, int]] = {}
_SELECT_PLAN_FIELDS = (
    "path", "strip", "threads", "smem_bytes", "scratch_bytes", "blocks_per_sm",
    "blocks_per_sm_channel", "grid",
)


# the implementation the wrappers take (FedConfig.agg_impl, resolved by the
# trainer): None lets each tensor's device decide
_IMPL: Optional[str] = None
IMPLS = ("pallas", "xla")


@contextlib.contextmanager
def implementation(impl: Optional[str]):
    """Within the block every wrapper takes ``impl``: ``"pallas"`` (the
    kernels; a CPU tensor raises), ``"xla"`` (the plain versions on any
    device) or None (the tensor's device decides)."""
    global _IMPL
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"implementation must be one of {IMPLS} or None, got {impl!r}")
    prev, _IMPL = _IMPL, impl
    try:
        yield
    finally:
        _IMPL = prev


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launches(counts: Dict[str, int]):
    """Count the launches of one CUDA-graph replay: a capture only records
    the launches its wrappers counted (the graph module takes them back
    out), and every replay launches each of them once (``fed/graphs.py``)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


# ---------------------------------------------------------------------------
# build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels need the CUDA toolkit to build"
        )
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _source_files(name: str):
    """The kernel's source and the repo headers it includes (transitively),
    in a fixed order."""
    files, todo = [], [_SOURCES[name]]
    while todo:
        f = todo.pop(0)
        if f not in files:
            files.append(f)
            todo += [m.decode() for m in _INCLUDE.findall((CSRC / f).read_bytes())]
    return files


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in _source_files(name):
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(_SOURCES)) -> Dict[str, float]:
    """Compile (where not yet built) and load the named kernels, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library already on disk)."""
    names = [n for n in names if n not in _LIBS]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / _SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {_SOURCES[name]}:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    for name in names:
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        for qname, (argtypes, restype) in _QUERIES.get(name, {}).items():
            q = getattr(lib, qname)
            q.argtypes, q.restype = argtypes, restype
        _LIBS[name] = lib
        _count_setup(f"load:{name}")
    return seconds


def _count_setup(key: str) -> None:
    SETUPS[key] = SETUPS.get(key, 0) + 1


def _launch_fn(name: str):
    if name not in _LIBS:
        build([name])
    return getattr(_LIBS[name], f"{name}_launch")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the kernels' referee on the card)


def _finite_masked(w: torch.Tensor):
    wf = w.to(torch.float32)
    finite = torch.isfinite(wf).all(dim=1)
    return torch.where(finite[:, None], wf, 0.0), finite


def weiszfeld_step_ref(w: torch.Tensor, guess: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`weiszfeld_step`: ``(num [d], den [])``."""
    wz, finite = _finite_masked(w)
    dist = torch.clamp(torch.linalg.vector_norm(wz - guess[None, :], dim=1), min=DIST_CLAMP)
    inv = torch.where(finite, 1.0 / dist, 0.0)
    return torch.sum(wz * inv[:, None], dim=0), torch.sum(inv)


def aircomp_weiszfeld_step_ref(
    w: torch.Tensor,
    guess: torch.Tensor,
    h_sq: torch.Tensor,
    scaler: torch.Tensor,
    p_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`aircomp_weiszfeld_step`."""
    wz, finite = _finite_masked(w)
    d = w.shape[1]
    s = scaler.reshape(())
    dist = torch.clamp(torch.linalg.vector_norm(wz - guess[None, :], dim=1), min=DIST_CLAMP)
    inv = 1.0 / dist
    sq_norm = torch.sum(wz * wz, dim=1)
    p_message = inv * inv * (sq_norm + s * s) / (d + 1.0) / h_sq
    gain = torch.sqrt(p_max / torch.maximum(p_message, GM_THRESHOLD_FACTOR * s * s))
    coeff = torch.where(finite, gain * inv, 0.0)
    return torch.sum(wz * coeff[:, None], dim=0), torch.sum(coeff) * s


def weiszfeld_advance(
    g: torch.Tensor,
    g_next: torch.Tensor,
    active: torch.Tensor,
    steps: torch.Tensor,
    tol: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Weiszfeld loop's update and stopping rule (the JAX
    ``lax.while_loop`` cond ``movement > tol``, movement starting at +Inf):
    ``(g_next if active else g, active & movement > tol, steps + active)``.
    ``active`` is int32, ``steps`` int64."""
    on = active != 0
    movement = torch.linalg.vector_norm(g - g_next)
    return (
        torch.where(on, g_next, g),
        (on & (movement > tol)).to(torch.int32),
        steps + on.to(torch.int64),
    )


def weiszfeld_step_fused_ref(w, g, active, steps, tol):
    """Plain torch version of :func:`weiszfeld_step_fused`."""
    num, den = weiszfeld_step_ref(w, g)
    return weiszfeld_advance(g, num / den, active, steps, tol)


def guess_rms(g: torch.Tensor) -> torch.Tensor:
    """The gm scaler: the RMS of the guess, a one-element tensor."""
    return torch.sqrt(torch.mean(g**2)).reshape(1)


def aircomp_weiszfeld_step_fused_ref(
    w, g, active, steps, tol, h_r, h_i, scaler, *, fade_scale=None, z=None,
    noise_scale=None, p_max=1.0,
):
    """Plain torch version of :func:`aircomp_weiszfeld_step_fused`: the
    fades (``fade_scale * draw``, as ``channel.rayleigh_fade``), OMA2 on the
    gm message, the receiver noise, ``g_next = num / den * scaler``, the
    stopping rule and the next scaler (reference ``:145-155``)."""
    if fade_scale is not None:
        h_r, h_i = fade_scale * h_r, fade_scale * h_i
    num, den = aircomp_weiszfeld_step_ref(w, g, floored_hsq(h_r, h_i), scaler, p_max)
    if z is not None:
        n = noise_scale * z
        num = num + n[:-1]
        den = den + n[-1]
    g_out, active, steps = weiszfeld_advance(g, num / den * scaler, active, steps, tol)
    return g_out, active, steps, guess_rms(g_out)


KEY_MIN = -(2**31)
KEY_MAX = 2**31 - 1
SIGN_WORD_BITS = 32  # coordinates per sign word, LSB-first


def total_order_keys(v: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 keys whose integer order is the IEEE-754 total order
    (``pallas_kernels.total_order_keys``, :262).

    A positive float keeps its bit pattern; a negative one is
    bit-complemented into [0, 2^31 - 1] and shifted down by 2^31, which
    reverses its order without overflow.  ``-0.0 < +0.0``, and a positive
    NaN ranks above +Inf as a sort puts it.  A NEGATIVE NaN ranks below
    -Inf where a sort puts it last; no fault or attack of this codebase
    makes one."""
    i = v.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(i < 0, torch.bitwise_not(i) + KEY_MIN, i)


def total_order_vals(keys: torch.Tensor) -> torch.Tensor:
    """Exact inverse of :func:`total_order_keys` (NaN payloads too)."""
    i = torch.where(keys < 0, torch.bitwise_not(keys - KEY_MIN), keys)
    return i.contiguous().view(torch.float32)


def nth_smallest_keys(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Per-column n-th smallest (0-indexed) key of [K, d] int32 keys, by a
    32-step bisection on the key value: each step counts ``keys <= mid``
    (JAX ``_nth_smallest_keys``, ``ops/aggregators.py:112``)."""
    cols = keys.shape[1]
    lo = torch.full((cols,), KEY_MIN, dtype=torch.int32, device=keys.device)
    hi = torch.full((cols,), KEY_MAX, dtype=torch.int32, device=keys.device)
    for _ in range(32):
        # floor((lo + hi) / 2) without overflow; >> on int32 is arithmetic
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        cnt = torch.sum(keys <= mid[None, :], dim=0)
        above = cnt <= n  # fewer than n + 1 keys at or below mid
        lo, hi = torch.where(above, mid + 1, lo), torch.where(above, hi, mid)
    return lo


RADIX_SHIFTS = (24, 16, 8, 0)  # 8-bit digits of the unsigned key, high first


def nth_smallest_keys_radix(keys: torch.Tensor, ranks: Tuple[int, ...]):
    """Plain mirror of ``select_columns``' radix select (the CUDA kernel's
    path for K > 64), for one rank or two (``ranks = (b, K - b - 1)``).

    For each rank n, per column of [K, d] int32 keys: on the unsigned form
    ``key ^ 0x80000000`` (here ``key + 2^31`` in int64), four passes over
    8-bit digits, most significant first; each pass counts the digit of
    every key that matches the prefix found so far into 256 bins, takes the
    bin where the running count first exceeds n, subtracts the keys below
    that bin from n and appends the bin to the prefix.  Returns
    ``(selected, n_lt, n_le, passes)``: the n-th smallest keys [R, d]
    int32, their #(<) and #(<=) as the passes leave them (the keys below the
    bins taken, plus the last bin's size), and the column passes [d] the
    kernel makes: two ranks share a pass while their prefixes agree and
    take one each after they part, so 4 to 7."""
    if len(ranks) not in (1, 2):
        raise ValueError(f"one or two ranks, got {ranks}")
    u = keys.to(torch.int64) + 2**31
    cols = keys.shape[1]
    zeros = torch.zeros(cols, dtype=torch.int64, device=keys.device)
    selected, n_lt, n_le, prefixes = [], [], [], []
    for n in ranks:
        prefix, below, left = zeros, zeros, zeros + n
        per_pass = []
        for shift in RADIX_SHIFTS:
            cand = (u >> (shift + 8)) == (prefix >> (shift + 8))[None, :]
            digit = torch.where(cand, (u >> shift) & 255, 256)
            hist = torch.zeros(257, cols, dtype=torch.int64, device=keys.device)
            hist = hist.scatter_add_(0, digit, torch.ones_like(digit))[:256]
            run = torch.cumsum(hist, dim=0)
            bin_ = torch.sum(run <= left[None, :], dim=0)  # first bin past the rank
            under = run.gather(0, (bin_ - 1).clamp(min=0)[None, :])[0]
            under = torch.where(bin_ > 0, under, 0)
            eq = hist.gather(0, bin_[None, :])[0]
            left, below = left - under, below + under
            prefix = prefix | (bin_ << shift)
            per_pass.append(prefix)
        selected.append((prefix - 2**31).to(torch.int32))
        n_lt.append(below)
        n_le.append(below + eq)
        prefixes.append(per_pass)
    passes = torch.full((cols,), len(RADIX_SHIFTS), dtype=torch.int64, device=keys.device)
    if len(ranks) == 2:
        # the pass at which the two prefixes part (4: never)
        parted = torch.stack([a != b for a, b in zip(*prefixes)])  # [4, d]
        first = torch.where(parted.any(dim=0), parted.to(torch.int64).argmax(dim=0), 3)
        passes = first + 1 + 2 * (3 - first)
    return torch.stack(selected), torch.stack(n_lt), torch.stack(n_le), passes


def select_median(w: torch.Tensor) -> torch.Tensor:
    """Coordinatewise lower-middle median ``sorted[(K - 1) // 2]`` of a
    [K, d] stack, without a sort (JAX ``_select_median``, :137)."""
    k = w.shape[0]
    return total_order_vals(nth_smallest_keys(total_order_keys(w), (k - 1) // 2))


def select_trimmed_mean(w: torch.Tensor, b: int) -> torch.Tensor:
    """b-trimmed column mean without a sort (JAX ``_select_trimmed_mean``,
    :145): find the kept band's boundary keys by bisection, sum the strict
    interior, and add each boundary value times its kept copies (exact
    under ties at the trim boundary)."""
    k = w.shape[0]
    w32 = w.to(torch.float32)
    keys = total_order_keys(w32)
    lo_k = nth_smallest_keys(keys, b)  # rank b, the lowest kept
    hi_k = nth_smallest_keys(keys, k - b - 1)  # rank K-b-1, the highest kept
    interior = (keys > lo_k[None, :]) & (keys < hi_k[None, :])
    total = torch.sum(torch.where(interior, w32, 0.0), dim=0)
    last = k - b - 1

    def kept_copies(boundary):
        # entries equal to a boundary key occupy the rank run
        # [#(< key), #(<= key) - 1]; clip it to the kept band [b, last]
        n_lt = torch.sum(keys < boundary[None, :], dim=0)
        n_le = torch.sum(keys <= boundary[None, :], dim=0)
        run = torch.clamp(n_le - 1, max=last) - torch.clamp(n_lt, min=b) + 1
        return torch.clamp(run, min=0).to(torch.float32)

    def boundary_sum(boundary, copies):
        # only where copies exist: keeps 0 * Inf and 0 * NaN out
        return torch.where(copies > 0, copies * total_order_vals(boundary), 0.0)

    total = total + boundary_sum(lo_k, kept_copies(lo_k))
    total = total + torch.where(
        lo_k == hi_k, 0.0, boundary_sum(hi_k, kept_copies(hi_k))
    )
    return total / float(k - 2 * b)


def _received(w: torch.Tensor, channel: Optional[OmaTerms]) -> torch.Tensor:
    return w if channel is None else w + oma_residual(channel)


def fused_median_ref(w: torch.Tensor, channel: Optional[OmaTerms] = None) -> torch.Tensor:
    """Plain torch version of :func:`fused_median`.  Not ``torch.median``:
    that returns NaN for a column holding a NaN and does not order -0.0
    below +0.0."""
    return select_median(_received(w, channel))


def fused_trimmed_mean_ref(
    w: torch.Tensor, b: int, channel: Optional[OmaTerms] = None
) -> torch.Tensor:
    """Plain torch version of :func:`fused_trimmed_mean`."""
    return select_trimmed_mean(_received(w, channel), b)


def packed_vote_counts_ref(words: torch.Tensor, d: int) -> torch.Tensor:
    """Plain torch version of :func:`packed_vote_counts`: bit planes
    ``(words >> j) & 1`` summed over K, flattened in ``c = w*32 + j``
    order (JAX ``_packed_vote_counts_xla``, ``ops/aggregators.py:660``).
    ``>>`` on int32 is arithmetic, so a word with bit 31 set shifts in
    ones from the top, but ``& 1`` still reads bit j."""
    shifts = torch.arange(SIGN_WORD_BITS, dtype=torch.int32, device=words.device)
    planes = (words[:, :, None] >> shifts[None, None, :]) & 1
    counts = torch.sum(planes, dim=0, dtype=torch.int32)  # [W, 32]
    return counts.reshape(-1)[:d]


# ---------------------------------------------------------------------------
# wrappers


def _check_stack(w: torch.Tensor, guess: torch.Tensor):
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"stack must be [K, d] with K, d >= 1, got {tuple(w.shape)}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stack dtype must be float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("stack must be contiguous")
    _check_vec(guess, w, w.shape[1], "guess")


def _check_vec(t: torch.Tensor, w: torch.Tensor, n: int, what: str):
    if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous float32 tensor of {n} values, "
            f"got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != w.device:
        raise ValueError(f"{what} is on {t.device}, the stack on {w.device}")


def _use_kernel(w: torch.Tensor) -> bool:
    """Whether a wrapper launches its kernel for ``w`` (else it runs the
    plain version), under :func:`implementation`: ``"xla"`` never launches;
    ``"pallas"`` launches for a CUDA tensor and raises for a CPU one; with
    no choice made a CUDA tensor launches and a CPU one runs plain.  Any
    other device raises."""
    if w.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel for device {w.device}")
    if _IMPL == "xla":
        return False
    if w.device.type == "cuda":
        return True
    if _IMPL == "pallas":
        raise RuntimeError(
            "agg_impl 'pallas' runs the CUDA kernels, and a CPU tensor has none: "
            "use --agg-impl xla (the plain versions) or auto on the CPU")
    return False


def _workspace(name: str, w: torch.Tensor) -> torch.Tensor:
    """The Weiszfeld workspace for ``w``'s device and shape, allocated (and
    its ticket zeroed) at first use; never inside a CUDA-graph capture.

    Every step of that shape, of both Weiszfeld kernels, shares it, so those
    steps must run one after another: on one stream, or replayed from one
    CUDA graph.  Two steps of one shape running at the same time on two
    streams would corrupt each other's partial sums and ticket, with no
    error.  The port issues every step on the current stream."""
    k, d = w.shape
    key = (w.device.index, k, d)
    ws = _WORKSPACES.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the Weiszfeld workspace must be allocated before a CUDA-graph "
                "capture: run one step outside the capture first"
            )
        nbytes = _LIBS[name].weiszfeld_workspace_bytes(k, d)
        if nbytes < 0:
            raise RuntimeError(f"{name}: no tiling for K={k}, d={d} (CUDA error {-nbytes})")
        ws = torch.zeros(nbytes, dtype=torch.uint8, device=w.device)
        _WORKSPACES[key] = ws
        _count_setup(f"workspace:{k}x{d}")
    return ws


def weiszfeld_step(w: torch.Tensor, guess: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ideal Weiszfeld step over [K, d]: ``(num [d], den [])``."""
    if not _use_kernel(w):
        return weiszfeld_step_ref(w, guess)
    _check_stack(w, guess)
    k, d = w.shape
    fn = _launch_fn("weiszfeld_step")
    with torch.cuda.device(w.device):
        ws = _workspace("weiszfeld_step", w)
        num = torch.empty(d, dtype=torch.float32, device=w.device)
        den = torch.empty((), dtype=torch.float32, device=w.device)
        err = fn(
            w.data_ptr(), int(w.dtype == torch.bfloat16), guess.data_ptr(),
            k, d, ws.data_ptr(), num.data_ptr(), den.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"weiszfeld_step launch failed: CUDA error {err}")
    LAUNCHES["weiszfeld_step"] += 1
    return num, den


def aircomp_weiszfeld_step(
    w: torch.Tensor,
    guess: torch.Tensor,
    h_sq: torch.Tensor,
    scaler: torch.Tensor,
    p_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One over-the-air Weiszfeld step: ``(num [d], den [])`` with
    ``num = sum_i gain_i * w_i / d_i`` and ``den = sum_i gain_i * s / d_i``,
    the noiseless receiver sums of OMA2 on the gm message (reference
    ``:145-155``).  ``h_sq`` [K] is each client's squared fade magnitude,
    ``scaler`` the RMS of the guess (a one-element tensor, read on the
    device); the caller adds the receiver noise."""
    if not _use_kernel(w):
        return aircomp_weiszfeld_step_ref(w, guess, h_sq, scaler, p_max)
    _check_stack(w, guess)
    k, d = w.shape
    _check_vec(h_sq, w, k, "h_sq")
    _check_vec(scaler, w, 1, "scaler")
    fn = _launch_fn("aircomp_weiszfeld_step")
    with torch.cuda.device(w.device):
        ws = _workspace("aircomp_weiszfeld_step", w)
        num = torch.empty(d, dtype=torch.float32, device=w.device)
        den = torch.empty((), dtype=torch.float32, device=w.device)
        err = fn(
            w.data_ptr(), int(w.dtype == torch.bfloat16), guess.data_ptr(),
            h_sq.data_ptr(), scaler.data_ptr(), float(p_max), k, d,
            ws.data_ptr(), num.data_ptr(), den.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"aircomp_weiszfeld_step launch failed: CUDA error {err}")
    LAUNCHES["aircomp_weiszfeld_step"] += 1
    return num, den


def _check_state(w, g_in, g_out, active, steps):
    _check_stack(w, g_in)
    _check_vec(g_out, w, w.shape[1], "g_out")
    if g_out.data_ptr() == g_in.data_ptr():
        raise ValueError("g_out must be another buffer than g_in")
    for t, dtype, what in ((active, torch.int32, "active"), (steps, torch.int64, "steps")):
        if t.dtype != dtype or t.numel() != 1 or t.device != w.device:
            raise ValueError(
                f"{what} must be one {dtype} on {w.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}"
            )


def weiszfeld_step_fused(
    w: torch.Tensor,
    g_in: torch.Tensor,
    g_out: torch.Tensor,
    active: torch.Tensor,
    steps: torch.Tensor,
    tol: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the gm2 Weiszfeld loop in one launch:
    ``(g_next, active, steps)`` as :func:`weiszfeld_step_fused_ref` gives
    them.  On the card the kernel writes the guess into ``g_out`` and
    updates ``active`` (int32) and ``steps`` (int64) in place, and returns
    those tensors; on the CPU ``g_out`` is unused."""
    if not _use_kernel(w):
        return weiszfeld_step_fused_ref(w, g_in, active, steps, tol)
    _check_state(w, g_in, g_out, active, steps)
    k, d = w.shape
    _launch_fn("weiszfeld_step")
    lib = _LIBS["weiszfeld_step"]
    with torch.cuda.device(w.device):
        ws = _workspace("weiszfeld_step", w)
        err = lib.weiszfeld_step_fused(
            w.data_ptr(), int(w.dtype == torch.bfloat16), g_in.data_ptr(),
            g_out.data_ptr(), k, d, float(tol), active.data_ptr(),
            steps.data_ptr(), ws.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"weiszfeld_step_fused launch failed: CUDA error {err}")
    LAUNCHES["weiszfeld_step"] += 1
    return g_out, active, steps


def aircomp_weiszfeld_step_fused(
    w: torch.Tensor,
    g_in: torch.Tensor,
    g_out: torch.Tensor,
    active: torch.Tensor,
    steps: torch.Tensor,
    tol: float,
    h_r: torch.Tensor,
    h_i: torch.Tensor,
    scaler: torch.Tensor,
    *,
    fade_scale: Optional[float] = None,
    z: Optional[torch.Tensor] = None,
    noise_scale: Optional[torch.Tensor] = None,
    p_max: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step of the gm Weiszfeld loop in one launch:
    ``(g_next, active, steps, next scaler)`` as
    :func:`aircomp_weiszfeld_step_fused_ref` gives them.  ``h_r``, ``h_i``
    [K] are the fades, or with ``fade_scale`` the draws the fades are
    ``fade_scale`` times; ``z`` [d+1] the receiver's standard normals and
    ``noise_scale`` their std (a float32 0-d tensor), or both None for a
    noiseless receiver.  On the card ``g_out``, ``active``, ``steps`` and
    ``scaler`` are written in place and returned."""
    if not _use_kernel(w):
        return aircomp_weiszfeld_step_fused_ref(
            w, g_in, active, steps, tol, h_r, h_i, scaler,
            fade_scale=fade_scale, z=z, noise_scale=noise_scale, p_max=p_max,
        )
    _check_state(w, g_in, g_out, active, steps)
    k, d = w.shape
    _check_vec(h_r, w, k, "h_r")
    _check_vec(h_i, w, k, "h_i")
    _check_vec(scaler, w, 1, "scaler")
    if (z is None) != (noise_scale is None):
        raise ValueError("z and noise_scale come together")
    if z is not None:
        _check_vec(z, w, d + 1, "z")
    _launch_fn("aircomp_weiszfeld_step")
    lib = _LIBS["aircomp_weiszfeld_step"]
    with torch.cuda.device(w.device):
        ws = _workspace("aircomp_weiszfeld_step", w)
        err = lib.aircomp_weiszfeld_step_fused(
            w.data_ptr(), int(w.dtype == torch.bfloat16), g_in.data_ptr(),
            g_out.data_ptr(), h_r.data_ptr(), h_i.data_ptr(),
            1.0 if fade_scale is None else float(fade_scale),
            None if z is None else z.data_ptr(),
            0.0 if noise_scale is None else float(noise_scale),
            scaler.data_ptr(), float(p_max), k, d, float(tol),
            active.data_ptr(), steps.data_ptr(), ws.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"aircomp_weiszfeld_step_fused launch failed: CUDA error {err}")
    LAUNCHES["aircomp_weiszfeld_step"] += 1
    return g_out, active, steps, scaler


def _check_select(w: torch.Tensor, channel: Optional[OmaTerms]):
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"stack must be [K, d] with K, d >= 1, got {tuple(w.shape)}")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"stack must be a contiguous float32 tensor, got {w.dtype}")
    if channel is None:
        return
    k, d = w.shape
    for what, t in zip(channel._fields, channel):
        shape = (k, d) if what in ("n_r", "n_i") else (k,)
        _check_vec(t, w, t.numel(), f"channel.{what}")
        if tuple(t.shape) != shape:
            raise ValueError(f"channel.{what} must be {list(shape)}, got {list(t.shape)}")


def select_plan(device, k: int, d: int) -> Dict[str, int]:
    """The launch configuration of ``select_columns`` for a [K, d] stack on
    the CUDA ``device``: ``path`` (0: K <= 64, keys in registers; 1: keys
    in shared memory; 2: keys in a global scratch), columns and threads per
    block, dynamic shared bytes, ``scratch_bytes``, resident blocks per SM
    (without and with the channel) and the grid.  Found once per (device,
    K, d), which also raises the kernels' shared-memory cap: never inside a
    CUDA-graph capture."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, k, d)
    plan = _SELECT_PLANS.get(key)
    if plan is None:
        _launch_fn("select_columns")
        buf = (ctypes.c_longlong * len(_SELECT_PLAN_FIELDS))()
        with torch.cuda.device(index):
            err = _LIBS["select_columns"].select_columns_plan(k, d, ctypes.addressof(buf))
        if err != 0:
            raise RuntimeError(f"select_columns_plan failed for K={k}, d={d}: CUDA error {err}")
        plan = dict(zip(_SELECT_PLAN_FIELDS, buf))
        _SELECT_PLANS[key] = plan
    return plan


def _select(w: torch.Tensor, b: int, want_mean: bool,
            channel: Optional[OmaTerms]) -> torch.Tensor:
    _check_select(w, channel)
    k, d = w.shape
    plan = select_plan(w.device, k, d)
    fn = _launch_fn("select_columns")
    with torch.cuda.device(w.device):
        scratch = (
            torch.empty(k * d, dtype=torch.int32, device=w.device)
            if plan["scratch_bytes"] else None
        )
        out = torch.empty(d, dtype=torch.float32, device=w.device)
        if channel is None:
            ch = (None,) * 5
        else:
            ch = (channel.n_r.data_ptr(), channel.n_i.data_ptr(),
                  channel.h_r.data_ptr(), channel.h_i.data_ptr(),
                  channel.h_sq.data_ptr())
        err = fn(
            w.data_ptr(), *ch, k, d, b, int(want_mean), plan["path"],
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"select_columns launch failed: CUDA error {err}")
    LAUNCHES["select_columns"] += 1
    return out


def fused_median(w: torch.Tensor, channel: Optional[OmaTerms] = None) -> torch.Tensor:
    """Coordinatewise lower-middle median ``sorted[(K - 1) // 2]`` of a
    [K, d] f32 stack, with ``channel`` (:class:`..channel.OmaTerms`) folded
    into the read as ``w + oma_residual(channel)``."""
    if not _use_kernel(w):
        return fused_median_ref(w, channel)
    return _select(w, 0, False, channel)


def fused_trimmed_mean(
    w: torch.Tensor, b: int, channel: Optional[OmaTerms] = None
) -> torch.Tensor:
    """Coordinatewise mean of ``sorted[b .. K - b - 1]`` (``K - 2b >= 1``),
    with the optional channel fold of :func:`fused_median`."""
    k = w.shape[0]
    if b < 0 or k - 2 * b < 1:
        raise ValueError(f"trimmed mean needs 0 <= b and K - 2b >= 1, got K={k}, b={b}")
    if not _use_kernel(w):
        return fused_trimmed_mean_ref(w, b, channel)
    return _select(w, b, True, channel)


def packed_vote_counts(words: torch.Tensor, d: int) -> torch.Tensor:
    """Per-coordinate set-bit counts [d] int32 of a [K, W = ceil(d/32)]
    stack of sign words (int32 carrying the uint32 bits, LSB-first):
    ``counts[c] = #{k : bit (c % 32) of words[k, c // 32]}``."""
    if not _use_kernel(words):
        return packed_vote_counts_ref(words, d)
    if words.dim() != 2 or words.dtype != torch.int32 or not words.is_contiguous():
        raise ValueError(
            f"words must be a contiguous [K, W] int32 tensor, got {words.dtype} "
            f"{tuple(words.shape)}"
        )
    k, w_cnt = words.shape
    if w_cnt != -(-d // SIGN_WORD_BITS):
        raise ValueError(f"{w_cnt} words per row do not hold d={d} coordinates")
    fn = _launch_fn("packed_vote_counts")
    with torch.cuda.device(words.device):
        counts = torch.empty(d, dtype=torch.int32, device=words.device)
        err = fn(words.data_ptr(), k, w_cnt, d, counts.data_ptr(),
                 torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_vote_counts launch failed: CUDA error {err}")
    LAUNCHES["packed_vote_counts"] += 1
    return counts
