"""Memory models: the aggregation's traffic and the run's peak on the card.

The traffic side (:func:`stack_bytes` .. :func:`aggregator_hbm_model`) and
the JAX package's two peak models (:func:`streamed_peak_bytes`,
:func:`modeled_peak_bytes`) are copied verbatim from
``byzantine_aircomp_tpu/obs/hbm.py``, so that at JAX's arguments they give
JAX's integers.  ``aggregator_hbm_model``'s ``impl`` is the route the
port's trainer takes: ``"pallas"`` (the hand-written CUDA kernel, JAX's
Pallas case) on the card, ``"xla"`` (the plain torch version) on the CPU.

JAX's peak model does not hold on the card: it counts 3 stacks, 4 [d]
vectors and the data, and a torch round holds more.  The port's model,
:func:`cuda_peak_bytes`, is what the harness cross-checks the CUDA
allocator's peak against (``hbm_warn_factor``).  Its terms, counted in
``fed/train.py::Trainer.iteration``:

* ``data_bytes`` — what the trainer keeps on the card for the whole run:
  the train rows (u8 or f32) and labels, and the eval caches (the val
  split, and the train split when ``eval_train``, as f32 rows and int64
  labels), allocated by the initial eval before the first round;
* ``param_copies`` [d] f32 vectors — params, the aggregate, the server
  step, the Weiszfeld guess and its workspaces (6 under streaming: the
  running sums too);
* ``stack_copies`` [rows, d] f32 stacks — at the client step's peak the
  per-leaf [rows, d] gradient buffers of the backward and their sum, then
  ``w - gamma * (g + wd * w)`` holds g, one temporary and the result; at
  the aggregation's peak the stack, the honest rows' centred copy and its
  square (the variance).  3 either way; ``channel_copies`` more for a
  rule that takes the OMA terms [rows, d] x 2 (median, trimmed mean and
  the rest under ``--var``, not gm, which owns its channel);
* the client step's working set (:func:`client_step_bytes`), absent from
  JAX's model: for each of the rows x E x B samples, the input rows in f32
  (``input_copies``: the normalized batch, and the data attack's
  ``torch.where`` copy) and the activations that ``torch.func.grad``
  keeps (``activation_copies`` = 2: the forward's saved tensors and, since
  ``grad`` runs its backward with ``create_graph=True``, every backward
  intermediate to its end).  :func:`per_sample_bytes` takes the
  activation bytes from the model's layer shapes; under ``--remat`` only
  the block inputs stay, plus one block's activations while it is
  recomputed.

``rows`` is K for the resident round and ``cohort_size`` for a streamed
one, which adds the O(K) per-client state and holds 6 [d] vectors.  The resident CNN at K=1000 holds 13.1 GB per stack and
~43 GB of activations for 50,000 samples: it does not fit in 80 GB, which
JAX's 3-stack model (39.3 GB) does not say.
"""

from __future__ import annotations

from typing import Any, Dict

#: aggregators whose epilogue is the sort-family selection the fused paths
#: realize (ops/aggregators.py dispatch)
SORT_FAMILY = ("median", "trimmed_mean")


def stack_bytes(k: int, d: int, dtype_bytes: int = 4) -> int:
    """Bytes of one [K, d] client stack."""
    return k * d * dtype_bytes


def packed_stack_bytes(k: int, d: int, bits: int = 1) -> int:
    """Bytes of the packed sign-channel payload for a [K, d] delta stack.

    ``bits=1`` is the bit-packed uint32 wire (``ops.aggregators
    .pack_signs``): K rows of ``ceil(d/32)`` whole words — ~1/32 of the
    f32 stack, the acceptance-gated ratio.  ``bits=8/16`` model the
    quantize-dequantize emulation's hypothetical wire (``k*d*bits/8``,
    exact since bytes need no word padding); ``bits=32`` degenerates to
    :func:`stack_bytes`."""
    if bits == 1:
        return k * (-(-d // 32)) * 4
    return k * d * bits // 8


def packed_vote_hbm_bytes(k: int, d: int, impl: str = "pallas") -> int:
    """Analytic HBM bytes of one packed majority-vote reduce.

    Both realizations read the [K, W] uint32 words exactly once.  The
    pallas kernel stores a [32, Wp] int32 counts tile per word column and
    the caller's transpose fix-up re-reads/writes it in coordinate order
    (O(d), counted honestly — it is ~K/32 times smaller than the word
    read); the XLA bit-plane fallback materializes the same [W, 32]
    counts.  Compare against ``stack_bytes(k, d) * 34`` (the f32 select
    reduce) or the 3-pass sort lower bound for the bandwidth table."""
    w_cnt = -(-d // 32)
    words = k * w_cnt * 4
    counts = 32 * w_cnt * 4  # [32, W] int32 counts (write + fix-up read)
    out = d * 4
    if impl == "pallas":
        kp, wp = -(-k // 8) * 8, -(-w_cnt // 128) * 128
        words = kp * wp * 4  # padded word tiles, DMA'd into VMEM once
        counts = 32 * wp * 4
    return words + 2 * counts + out


def epilogue_hbm_bytes(
    impl: str, k: int, d: int, b: int, channel: bool
) -> int:
    """Analytic HBM bytes per sort-family aggregation epilogue (f32).

    ``impl`` is one of ``sort`` (full XLA bitonic sort — a LOWER bound of
    3 stack-sized round trips), ``select`` (XLA key bisection: 32 cheap
    counting passes over int32 keys + one value pass), or ``pallas`` (the
    single-HBM-pass peel kernel: each padded tile is DMA'd into VMEM
    exactly once).  ``channel`` adds the OMA terms: the [K, d] noise pair
    folded into the fused reads, or the standalone read-modify-write pass
    the sort path pays first.
    """
    stack = k * d * 4
    out = d * 4
    if impl == "pallas":
        kp, dp = -(-k // 8) * 8, -(-d // 128) * 128
        tiles = (kp * dp * 4) * (3 if channel else 1)  # w (+ n_r, n_i)
        return tiles + out
    if impl == "select":
        # keys materialize once (stack read), 32 bisection count passes
        # re-read them, one final masked-sum pass reads values
        core = stack * 34
        if channel:
            core += 3 * stack  # n_r + n_i reads, post-channel stack write
        return core + out
    if impl == "sort":
        # sort: LOWER bound — read stack, write sorted, re-read kept band
        core = 3 * stack
        if channel:
            core += 4 * stack  # standalone OMA pass: read w, n_r, n_i, write
        return core + out
    raise ValueError(f"unknown epilogue impl {impl!r}")


def aggregator_hbm_model(
    agg: str,
    k: int,
    d: int,
    *,
    impl: str = "xla",
    fused: bool = False,
    channel: bool = False,
    trim: int = 0,
) -> Dict[str, Any]:
    """Per-round aggregation HBM accounting for the harness's run_start
    event.  Sort-family aggregators get the full epilogue model under the
    realization the trainer actually resolved (``fused`` + ``impl``);
    iterative aggregators (gm & co. re-read the stack once per Weiszfeld
    step — iteration count is data-dependent) report the per-iteration
    stack read and a null total."""
    sb = stack_bytes(k, d)
    if agg in SORT_FAMILY:
        impl_name = (
            ("pallas" if impl == "pallas" else "select") if fused else "sort"
        )
        hbm = epilogue_hbm_bytes(impl_name, k, d, trim, channel)
        return {
            "agg": agg,
            "impl": impl_name,
            "stack_bytes": sb,
            "hbm_bytes": hbm,
            "hbm_x": round(hbm / sb, 3),
        }
    return {
        "agg": agg,
        "impl": impl,
        "stack_bytes": sb,
        "hbm_bytes": None,
        "hbm_x": None,
        "bytes_per_weiszfeld_iter": sb,
    }


def streamed_peak_bytes(
    k: int,
    d: int,
    cohort: int,
    *,
    dtype_bytes: int = 4,
    data_bytes: int = 0,
    chunk_copies: int = 3,
    param_copies: int = 6,
    state_bytes_per_client: int = 0,
    pop_shards: int = 1,
) -> int:
    """Peak-allocation model for the COHORT-STREAMED round program
    (``--cohort-size > 0``) — the counterpart of :func:`modeled_peak_bytes`
    whose resident [K, d] stack term is replaced by the streamed carry:

    * ``chunk_copies`` [cohort, d] buffers — the rebuilt chunk, its
      per-chunk transform transient (attack/channel ``where``), and the
      per-client local-step batch working set, all of which XLA reuses
      across scan steps;
    * ``param_copies`` [d] f32 vectors — params plus the scan-carried
      streaming accumulators (sum_all / sum_finite / Weiszfeld num /
      bisection lo+hi rows);
    * ``state_bytes_per_client`` * K — the surviving O(K) per-client state
      (defense detector [K] rows, Gilbert-Elliott bools); 0 when those
      features are off;
    * ``data_bytes`` — the uploaded dataset, unchanged by streaming.

    Peak scales as O(cohort*d + d + K), never O(K*d): the quantity the
    K-sweep acceptance demo and the harness watermark cross-check read.

    ``pop_shards > 1`` turns this into the PER-HOST budget under the
    population mesh (``parallel/popmesh.py``).  The mesh divides the
    wall-clock chunk count, not the buffers: each owner scans its own
    chunk range with the same chunk/param/state working set because the
    carry is replicated rather than partitioned.  What sharding ADDS per
    host is the merge transient — one shard-ordered ``all_gather`` stacks
    the S per-shard partial carries (the [d] float accumulators and the
    per-client state rows) before the canonical fold — so those terms
    exist S-fold for the fold's lifetime.  The int-summed leaves (rank
    counts, sketch histograms, vote planes) merge by ``psum`` and never
    stack.  The result must be compared against the PER-DEVICE watermark
    (``obs/profile.py per_device_memory``), never a mesh-wide total.
    """
    chunk = cohort * d * dtype_bytes
    params = d * dtype_bytes
    peak = (
        chunk_copies * chunk
        + param_copies * params
        + state_bytes_per_client * k
        + data_bytes
    )
    if pop_shards > 1:
        peak += (pop_shards - 1) * (
            param_copies * params + state_bytes_per_client * k
        )
    return peak


def modeled_peak_bytes(
    k: int,
    d: int,
    *,
    dtype_bytes: int = 4,
    data_bytes: int = 0,
    stack_copies: int = 3,
    param_copies: int = 4,
) -> int:
    """Static peak-allocation model for the training program, the
    cross-check target for measured ``peak_bytes_in_use`` watermarks
    (``obs/profile.py``).

    The resident [K, d] stack dominates; ``stack_copies`` covers the
    worst transient (stack + perturbed/sorted copy + channel pair) and
    ``param_copies`` the [d] vectors (params, update, optimizer-ish
    temporaries).  ``data_bytes`` is the uploaded dataset.  Deliberately
    conservative and shape-only — the measured side
    (``benchmarks/hbm_compile.py``) answers the exact question; this
    model exists so a watermark wildly above it (factor
    ``hbm_warn_factor``) raises a flag on device-sourced measurements.
    """
    stack = stack_bytes(k, d, dtype_bytes)
    params = d * dtype_bytes
    return stack_copies * stack + param_copies * params + data_bytes



# -- the port's peak model on the card ---------------------------------

def client_step_bytes(
    samples: int,
    input_bytes: int,
    activation_bytes: int,
    *,
    input_copies: int = 2,
    activation_copies: int = 2,
) -> int:
    """The client step's working set: ``samples`` (= rows x E x B) input
    rows of ``input_bytes`` f32 bytes each, ``input_copies`` times, and
    ``activation_copies`` times the ``activation_bytes`` per sample that
    the per-sample gradient keeps."""
    return samples * (input_copies * input_bytes + activation_copies * activation_bytes)


def cuda_peak_bytes(
    rows: int,
    d: int,
    *,
    client_bytes: int,
    data_bytes: int = 0,
    stack_copies: int = 3,
    channel_copies: int = 0,
    param_copies: int = 4,
    state_bytes: int = 0,
    dtype_bytes: int = 4,
) -> int:
    """The port's peak model of one training run on the card (the module
    docstring lists the terms): ``data_bytes + param_copies * d +
    (stack_copies + channel_copies) * rows * d`` (bytes of ``dtype_bytes``)
    plus the client step's ``client_bytes`` and the per-client
    ``state_bytes``.  A streamed round counts ``rows`` = the cohort and 6
    [d] vectors (the running sums)."""
    stack = rows * d * dtype_bytes
    return (data_bytes + param_copies * d * dtype_bytes
            + (stack_copies + channel_copies) * stack + client_bytes + state_bytes)


def per_sample_bytes(model, sample_shape, remat: bool = False):
    """``(input_bytes, activation_bytes)`` of one sample through ``model``:
    the f32 input row, and the bytes of every tensor the forward makes
    (views left out), from one forward of one sample on the ``meta``
    device (no memory, no arithmetic).  With ``remat`` the activations
    inside a residual block (a module named ``BasicBlock``) are not kept:
    only each block's input, plus the largest block's activations (one
    block is recomputed at a time)."""
    import math

    import torch
    from torch.func import functional_call
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    st = dict(depth=0, outside=0, inside=0, block=0, block_max=0, block_inputs=0)

    def nbytes(out):
        return sum(t.numel() * t.element_size() for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor))

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                n = nbytes(out)
                if st["depth"]:
                    st["inside"] += n
                    st["block"] += n
                else:
                    st["outside"] += n
            return out

    def pre(module, args):
        if st["depth"] == 0:
            st["block_inputs"] += nbytes(args)
            st["block"] = 0
        st["depth"] += 1

    def post(module, args, out):
        st["depth"] -= 1
        if st["depth"] == 0:
            st["block_max"] = max(st["block_max"], st["block"])

    hooks = []
    for m in model.modules():
        if type(m).__name__ == "BasicBlock":
            hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    meta = {n: torch.empty(t.shape, dtype=t.dtype, device="meta")
            for n, t in list(model.named_parameters()) + list(model.named_buffers())}
    x = torch.empty((1,) + tuple(sample_shape), dtype=torch.float32, device="meta")
    try:
        with torch.no_grad(), _Count():
            functional_call(model, meta, (x,))
    finally:
        for h in hooks:
            h.remove()
    input_bytes = 4 * math.prod(sample_shape)
    if remat:
        return input_bytes, st["outside"] + st["block_inputs"] + st["block_max"]
    return input_bytes, st["outside"] + st["inside"]
