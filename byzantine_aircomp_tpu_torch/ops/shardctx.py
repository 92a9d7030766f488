"""Population-shard contexts for the streamed chunk passes (JAX
``ops/shardctx.py``).

``--pop-shards S`` splits a streamed service round's cohort chunks over S
owners: shard ``p`` passes over the global chunk indices ``[p*cpp,
(p+1)*cpp)`` (``cpp = n_chunks // S``), each from the pass's initial carry,
and the per-shard partial carries merge by a fixed algebra.  Three
interchangeable engines run the same pass:

* :data:`LOCAL` (S == 1): one Python loop over all chunks, the op sequence
  of the streamed round before population shards, bit for bit;
* :class:`SeqShardCtx` (S > 1, one process): the S shard loops one after
  another, merged by an explicit left fold in shard order.  It is the
  reference engine: it fixes the association order the process-group
  engine reproduces bit for bit;
* ``parallel.popmesh.MeshShardCtx`` (S > 1, a process group of S ranks):
  each rank passes over its own chunk range, and the partials merge by
  collectives.

Each carry leaf declares its merge with a tag:

* ``"sum"``: integer leaves add (exact in any order, so a collective sum
  is the sequential fold: rank counts, sketch histograms, finite counts,
  flag counts).  Float leaves do not reassociate, so both engines take the
  S partials in shard order and reduce them by the same left fold;
* ``"min"`` / ``"max"``: order statistics, exact in any order;
* ``"stack"``: no merge; the caller receives the [S, ...] partials in shard
  order and owns the combine (the trainer's detector rows merge by
  disjoint-row selection, which is not leafwise).

Empty ``()`` slots pass through untouched, so a feature that is off costs
nothing.  Carries are tuples of tensors and ``()``.

The second half holds the wire helpers of the JAX package's two-tier
edge -> root topology: a canonical, versioned JSON encoding of one shard's
flat partial leaves and their tags (numpy in, numpy out).
"""

from __future__ import annotations

import base64

import numpy as np
import torch


def _op(tag, like):
    """The binary merge of ``tag`` for torch tensors or numpy arrays."""
    lib = torch if isinstance(like, torch.Tensor) else np
    if tag == "sum":
        return lambda a, b: a + b
    if tag == "min":
        return lib.minimum
    if tag == "max":
        return lib.maximum
    raise ValueError(f"unknown shard merge tag {tag!r}")


def fold_leaves(parts, tag, n_shards: int):
    """Merge one leaf's S partials (a [S, ...] tensor or array, or a list of
    S) under its tag with the canonical left fold.  Shared by the
    sequential engine and the process-group engine's float-sum path, so the
    two give the same bits."""
    if tag == "stack":
        return parts
    op = _op(tag, parts[0])
    out = parts[0]
    for p in range(1, n_shards):
        out = op(out, parts[p])
    return out


def _is_empty(x) -> bool:
    return isinstance(x, tuple) and len(x) == 0


def merge_spec_tree(spec, stacked, n_shards: int, merge_leaf):
    """Apply ``merge_leaf(tag, parts)`` across a (spec, partials) tree pair,
    passing empty ``()`` slots through; one tag may cover a whole subtree
    whose leaves all merge the same way."""
    if _is_empty(spec):
        return ()
    if isinstance(spec, str):
        if isinstance(stacked, tuple):
            return tuple(merge_spec_tree(spec, s, n_shards, merge_leaf) for s in stacked)
        return merge_leaf(spec, stacked)
    return tuple(merge_spec_tree(t, s, n_shards, merge_leaf) for t, s in zip(spec, stacked))


def _transpose(carries):
    """S carry trees -> one tree whose leaves are lists of S leaves."""
    first = carries[0]
    if isinstance(first, tuple):
        return tuple(_transpose([c[i] for c in carries]) for i in range(len(first)))
    return list(carries)


def clone_tree(x):
    """A copy of a carry tree whose tensors a shard may update in place."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(clone_tree(v) for v in x)
    return x


def seq_merge_leaf(n_shards: int):
    """The sequential engine's merge of one leaf's list of S partials."""

    def merge(tag, parts):
        if tag == "stack":
            return torch.stack(parts) if isinstance(parts[0], torch.Tensor) else np.stack(parts)
        return fold_leaves(parts, tag, n_shards)

    return merge


def _check_split(n_chunks: int, n_shards: int) -> int:
    if n_chunks % n_shards:
        raise ValueError(f"n_chunks {n_chunks} not divisible by pop_shards {n_shards}")
    return n_chunks // n_shards


class LocalShardCtx:
    """S == 1: one pass over all chunks, the spec ignored; a ``pop_shards=1``
    run is bitwise the streamed round that predates population shards."""

    n_shards = 1

    def scan_idx_merge(self, n_chunks: int, body, init, spec=None):
        carry = init
        for c in range(n_chunks):
            carry = body(carry, c)
        return carry

    def scan_merge(self, rebuild, n_chunks: int, body, init, spec=None):
        return self.scan_idx_merge(
            n_chunks, lambda carry, c: body(carry, rebuild(c), c), init, spec)


class SeqShardCtx:
    """S > 1 in one process: the sequential reference engine.  Shard p
    passes over its chunks from its own copy of ``init``; the S partials
    merge by :func:`fold_leaves`, the association order the process-group
    engine reproduces.  ``"sum"`` integer leaves make the result independent
    of S; float sums fork with S, as ``--cohort-size`` forks from the
    resident round (the config hash carries ``pop_shards`` for that)."""

    def __init__(self, n_shards: int):
        if n_shards < 2:
            raise ValueError("SeqShardCtx wants n_shards >= 2; use LOCAL")
        self.n_shards = n_shards

    def scan_idx_merge(self, n_chunks: int, body, init, spec):
        S = self.n_shards
        cpp = _check_split(n_chunks, S)
        carries = []
        for p in range(S):
            carry = clone_tree(init)
            for c in range(p * cpp, (p + 1) * cpp):
                carry = body(carry, c)
            carries.append(carry)
        return merge_spec_tree(spec, _transpose(carries), S, seq_merge_leaf(S))

    def scan_merge(self, rebuild, n_chunks: int, body, init, spec):
        return self.scan_idx_merge(
            n_chunks, lambda carry, c: body(carry, rebuild(c), c), init, spec)


#: the default context of every streamed rule and of the trainer's
#: observation pass when population shards are off
LOCAL = LocalShardCtx()


def make_ctx(n_shards: int):
    """LOCAL for one shard, else the sequential engine."""
    return LOCAL if n_shards == 1 else SeqShardCtx(n_shards)


# --------------------------------------------------------------------------
# Serializable partials (the JAX package's edge -> root wire)
#
# Every leaf serializes as the raw C-order bytes of a deterministic wire
# dtype, base64'd into JSON, so two processes holding the same arrays give
# the same wire strings.  Integer leaves ship as the smallest integer dtype
# that holds their values and widen back on decode; float leaves ship
# verbatim (the left fold is association-sensitive).  ``WIRE_VERSION``
# bumps on any change to this layout.
# --------------------------------------------------------------------------

#: version stamp carried by every wire partial (checked on decode)
WIRE_VERSION = 1

#: narrowing ladder for integer leaves, smallest first
_NARROW_INTS = (
    np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
    np.uint64, np.int64,
)


def _spec_tags(spec):
    if _is_empty(spec):
        return []
    if isinstance(spec, str):
        return [spec]
    return [t for s in spec for t in _spec_tags(s)]


def flat_tags(spec, flat_leaves):
    """Spec tags aligned with a flattened partial: one string spec covers a
    multi-leaf carry whose leaves all merge the same way."""
    tags = _spec_tags(spec)
    if len(tags) == 1 and len(flat_leaves) > 1:
        tags = tags * len(flat_leaves)
    if len(tags) != len(flat_leaves):
        raise ValueError(f"spec has {len(tags)} tags for {len(flat_leaves)} leaves")
    return tags


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def encode_leaf(x) -> dict:
    """One array -> a canonical JSON-safe dict (dtype, wire dtype, shape,
    base64 C-order bytes).  Integer and bool leaves narrow losslessly."""
    a = _numpy(x)
    logical = a.dtype
    wire = a
    if a.dtype.kind == "b":
        wire = a.astype(np.uint8)
    elif a.dtype.kind in "iu" and a.size:
        lo, hi = int(a.min()), int(a.max())
        for cand in _NARROW_INTS:
            info = np.iinfo(cand)
            if lo >= info.min and hi <= info.max:
                if np.dtype(cand).itemsize < logical.itemsize:
                    wire = a.astype(cand)
                break
    return {
        "dtype": logical.str,
        "wdtype": np.asarray(wire).dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(np.ascontiguousarray(wire).tobytes()).decode("ascii"),
    }


def decode_leaf(obj: dict) -> np.ndarray:
    """Inverse of :func:`encode_leaf`: back to the logical dtype, bit for bit."""
    wire_dt = np.dtype(obj["wdtype"])
    flat = np.frombuffer(base64.b64decode(obj["data"]), dtype=wire_dt)
    arr = flat.reshape(tuple(obj["shape"]))
    logical = np.dtype(obj["dtype"])
    if logical.kind == "b":
        return arr.astype(bool)
    if wire_dt != logical:
        return arr.astype(logical)
    return np.array(arr)  # own the buffer (frombuffer views are read-only)


def partial_to_wire(flat_leaves, tags) -> dict:
    """Flat partial leaves and aligned tags -> one canonical wire dict."""
    return {"wire": WIRE_VERSION, "tags": list(tags),
            "leaves": [encode_leaf(x) for x in flat_leaves]}


def partial_from_wire(obj: dict):
    """Wire dict -> ``(flat numpy leaves, tags)``; raises ``ValueError`` on
    version skew or a malformed payload, so garbage never reaches a fold."""
    if not isinstance(obj, dict) or obj.get("wire") != WIRE_VERSION:
        raise ValueError(
            f"wire version {obj.get('wire') if isinstance(obj, dict) else obj!r}"
            f" != {WIRE_VERSION}")
    tags = list(obj.get("tags") or ())
    raw = obj.get("leaves")
    if not isinstance(raw, list) or len(raw) != len(tags):
        raise ValueError("wire partial: leaves/tags arity mismatch")
    return [decode_leaf(e) for e in raw], tags


def fold_partials(stacked_leaves, tags, n_shards: int):
    """Fold per-leaf stacked [S, ...] partials under their tags with the
    canonical left fold, by construction :class:`SeqShardCtx`'s (the same
    :func:`fold_leaves`, the same shard order); numpy or torch."""
    return tuple(fold_leaves(s, t, n_shards) for s, t in zip(stacked_leaves, tags))
