"""Edge aggregator: one shard of the two-tier edge -> root topology.

The port of ``byzantine_aircomp_tpu/serve/edge.py``.

The paper's fusion center becomes a tree: N edge processes each own a
contiguous range of cohort chunks (exactly a ``pop_shards`` shard), run
the unchanged streamed aggregators of ``ops/aggregators.py`` and merge
through :class:`EdgeShardCtx`: a population-shard context whose merge
points POST the partial to the root (``serve/root.py``) and return the
fold.  The per-shard passes are the code the sequential engine runs, and
the root folds with the same ``ops/shardctx.fold_partials`` in shard
order, so the tree's results are bitwise the flat
:class:`~..ops.shardctx.SeqShardCtx` aggregate.

Mechanics worth knowing:

* the streamed passes are eager Python over the shard context
  (``ops/shardctx.py``), so an exchange is a plain host call at the merge
  point: the partial goes to numpy, over HTTP, and the fold comes back to
  tensors on the edge's device.  On the card, gm2 launches
  ``weiszfeld_step`` in num/den mode once per chunk per Weiszfeld step, and
  the one-bit vote launches ``packed_vote_counts`` on this edge's rows;
  median and trimmed_mean bisect ranks on total-order keys in torch ops;
* phases are anonymous: every edge runs the same exchange sequence (every
  branch depends on merged values, which are the same on every edge), so
  a per-round ``seq`` counter is the whole phase-coordination protocol;
* zero-trust submissions: every POST carries the edge id, a strictly
  increasing nonce and an HMAC-SHA256 over the canonical JSON of the
  envelope under the edge's pre-shared key;
* epoch restarts: when the root quarantines a dead edge mid-round it bumps
  the round's epoch; survivors see ``stale_epoch``, re-read the live set
  and run the round again degraded (the streamed rules' effective-K paths
  take it from there).

``python -m byzantine_aircomp_tpu_torch edge --config topo.json --shard 2
--root-url http://host:port`` runs one edge to completion, on the card
unless ``--device cpu``.  An edge is one process with one driving thread:
the kernels' workspaces are module-global.
"""

from __future__ import annotations

import argparse
import hashlib
import hmac
import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class RoundRestart(RuntimeError):
    """The root bumped the round's epoch (an edge died mid-round)."""

    def __init__(self, epoch: int) -> None:
        super().__init__(f"the root restarted the round at epoch {epoch}")
        self.epoch = epoch


class EdgeQuarantined(RuntimeError):
    """The root quarantined this edge; the process must stand down."""

    def __init__(self, reason: str = "") -> None:
        super().__init__(f"edge quarantined: {reason}")


# --------------------------------------------------------------------------
# topology config and submission signing (shared with serve/root.py and the
# chaos harness, which crafts replayed and forged submissions with them)
# --------------------------------------------------------------------------


def canonical_bytes(obj: Any) -> bytes:
    """Deterministic JSON bytes, the HMAC input: ``sort_keys`` and tight
    separators, so both ends serialize the envelope identically."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def sign_envelope(key_hex: str, body: Dict[str, Any]) -> str:
    """HMAC-SHA256 over the canonical envelope (without ``mac``), hex."""
    payload = {k: v for k, v in body.items() if k != "mac"}
    return hmac.new(bytes.fromhex(key_hex), canonical_bytes(payload), hashlib.sha256).hexdigest()


@dataclass
class TopologyConfig:
    """The two-tier run description both tiers load from one JSON file
    (the JAX package's fields, checks and JSON: one file loads in both)."""

    edges: int
    k: int
    d: int
    cohort: int
    rounds: int
    aggs: List[str] = field(default_factory=list)
    sign_bits: int = 0
    trim_ratio: float = 0.1
    quantile: str = "exact"
    sketch_bins: int = 512
    gm2_maxiter: int = 1000
    seed: int = 2021
    partial_timeout: float = 5.0
    # authenticated protocol violations (validly signed, fresh-nonce
    # envelopes the root still rejects) before the edge is quarantined;
    # forgeries and replays never count: an attacker can produce them
    strike_limit: int = 3
    keys: Dict[int, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.k % self.cohort:
            raise ValueError(f"k {self.k} % cohort {self.cohort} != 0")
        if self.n_chunks % self.edges:
            raise ValueError(f"n_chunks {self.n_chunks} % edges {self.edges} != 0")
        missing = [e for e in range(self.edges) if e not in self.keys]
        if missing:
            raise ValueError(f"no HMAC key for edges {missing}")

    @property
    def n_chunks(self) -> int:
        return self.k // self.cohort

    @property
    def chunks_per_edge(self) -> int:
        return self.n_chunks // self.edges

    @property
    def rows_per_edge(self) -> int:
        return self.chunks_per_edge * self.cohort

    @property
    def result_names(self) -> List[str]:
        names = list(self.aggs)
        if self.sign_bits == 1:
            names.append("signvote")
        return names

    @classmethod
    def load(cls, path: str) -> "TopologyConfig":
        with open(path) as f:
            raw = json.load(f)
        raw["keys"] = {int(e): k for e, k in raw.get("keys", {}).items()}
        return cls(**raw)


def round_stack(seed: int, rnd: int, k: int, d: int, device="cpu") -> torch.Tensor:
    """The round's deterministic [k, d] f32 client stack: standard normals
    from a CPU ``torch.Generator`` seeded from (seed, round), moved to
    ``device``.  Every edge, and the flat reference, rebuilds the same
    stack, so a disagreement can only come from the aggregation path; and
    the card sees the CPU's numbers, so its aggregate is comparable with
    the CPU's plain versions.  JAX draws its stack with threefry, which
    torch cannot reproduce: the two packages' stacks differ."""
    digest = hashlib.sha256(f"round_stack:{seed}:{rnd}".encode()).digest()
    gen = torch.Generator().manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return torch.randn((k, d), generator=gen, dtype=torch.float32).to(device)


# --------------------------------------------------------------------------
# the edge-side shard context
# --------------------------------------------------------------------------


def _flatten(tree) -> List[torch.Tensor]:
    """The tensors of a carry tree (tensors, tuples, empty ``()`` slots),
    depth first; empty slots hold none."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _flatten(t)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its tensors replaced, in order, from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tuple(_unflatten(t, leaves) for t in tree)


class EdgeShardCtx:
    """Shard ``p`` of S whose merges cross the network.

    ``scan_idx_merge`` passes over this shard's chunks, the global range
    ``[p*cpp, (p+1)*cpp)``, from its own copy of the pass's initial carry,
    exactly as ``SeqShardCtx`` runs one shard; then ships the partial
    through ``exchange(tags, arrays, meta) -> merged arrays``, a plain host
    call: tensors go to numpy, and the fold comes back as tensors on the
    partial's device.  0-d leaves stay 0-d (gm2's denominator, the finite
    ballot count)."""

    def __init__(self, shard: int, n_shards: int, exchange) -> None:
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} outside [0, {n_shards})")
        self.shard = shard
        self.n_shards = n_shards
        self.exchange = exchange

    def merge(self, carry, spec, meta: Optional[dict] = None):
        """Merge one partial carry with the fleet through the root."""
        from ..ops import shardctx

        flat = _flatten(carry)
        tags = shardctx.flat_tags(spec, flat)
        out = self.exchange(tags, [x.detach().cpu().numpy() for x in flat], meta)
        merged = [torch.from_numpy(np.array(a, order="C")).to(x.device)
                  for a, x in zip(out, flat)]
        return _unflatten(carry, iter(merged))

    def scan_idx_merge(self, n_chunks: int, body, init, spec):
        from ..ops import shardctx

        if n_chunks % self.n_shards:
            raise ValueError(f"n_chunks {n_chunks} not divisible by edges {self.n_shards}")
        cpp = n_chunks // self.n_shards
        carry = shardctx.clone_tree(init)
        for c in range(self.shard * cpp, (self.shard + 1) * cpp):
            carry = body(carry, c)
        return self.merge(carry, spec)

    def scan_merge(self, rebuild, n_chunks: int, body, init, spec):
        return self.scan_idx_merge(
            n_chunks, lambda carry, c: body(carry, rebuild(c), c), init, spec)


# --------------------------------------------------------------------------
# the round program
# --------------------------------------------------------------------------


class EdgeCompute:
    """The edge's round programs, one per degraded-ness (JAX's names
    ``edge_round_fn`` and ``edge_round_fn_degraded``): the healthy program
    and the surviving-set program differ (the degraded rules switch to the
    finite-row, effective-K formulas).

    The port compiles nothing.  ``detector`` keeps JAX's build count for
    JAX's readers: one per program, counted at the first call of
    :meth:`round_fn` for a degraded-ness, so it is 1 by construction and
    measures nothing.  The real one-time set-up is the card's: the kernels'
    libraries loaded and the Weiszfeld workspace of the [cohort, d] chunk
    allocated, each counted where it happens (``ops/kernels.py::SETUPS``).
    ``setups`` holds, per program, those its rounds made: the program that
    runs first makes them all, a later one reuses them, and a second set-up
    of one kind shows as a count of 2."""

    def __init__(self, cfg: TopologyConfig, shard: int, exchange, device,
                 detector=None) -> None:
        from ..obs import RetraceDetector

        self.cfg = cfg
        self.shard = shard
        self.device = torch.device(device)
        self.ctx = EdgeShardCtx(shard, cfg.edges, exchange)
        self.detector = detector if detector is not None else RetraceDetector(keys=())
        self._fns: Dict[bool, Any] = {}
        self.setups: Dict[str, Dict[str, int]] = {}

    def fn_name(self, degraded: bool) -> str:
        return "edge_round_fn_degraded" if degraded else "edge_round_fn"

    def kernel_names(self) -> List[str]:
        """The kernels this round launches on the card."""
        names = []
        if "gm2" in self.cfg.aggs:
            names.append("weiszfeld_step")
        if self.cfg.sign_bits == 1:
            names.append("packed_vote_counts")
        return names

    def round_fn(self, degraded: bool):
        if degraded not in self._fns:
            self.detector.build(self.fn_name(degraded))
            self._fns[degraded] = lambda stack: self._setup_and_round(degraded, stack)
        return self._fns[degraded]

    def _setup_and_round(self, degraded: bool, stack: torch.Tensor):
        from ..ops import kernels

        before = dict(kernels.SETUPS)
        try:
            if self.device.type == "cuda":
                kernels.build(self.kernel_names())
            return self._round(degraded, stack)
        finally:
            mine = self.setups.setdefault(self.fn_name(degraded), {})
            for key, n in kernels.SETUPS.items():
                if n > before.get(key, 0):
                    mine[key] = mine.get(key, 0) + n - before.get(key, 0)

    def _round(self, degraded: bool, stack: torch.Tensor) -> Dict[str, torch.Tensor]:
        from ..ops import aggregators

        cfg = self.cfg
        d, cohort, n_chunks = cfg.d, cfg.cohort, cfg.n_chunks
        ctx = self.ctx

        def rebuild(c):
            return stack[c * cohort:(c + 1) * cohort]

        outs: Dict[str, torch.Tensor] = {}
        sum_all = sum_fin = n_fin = None
        if cfg.aggs:
            # one shared stats pass: mean's sums, gm2's first guess and the
            # degraded paths' finite-row count, all from one exchange
            sum_all, sum_fin, n_fin = aggregators.stream_stats(
                rebuild, n_chunks, d, self.device, ctx)
        for name in cfg.aggs:
            outs[name] = aggregators.stream_aggregate(
                name, rebuild, k=cfg.k, d=d, n_chunks=n_chunks, device=self.device,
                degraded=degraded, sum_all=sum_all, sum_finite=sum_fin, n_finite=n_fin,
                quantile=cfg.quantile, sketch_bins=cfg.sketch_bins,
                trim_ratio=cfg.trim_ratio, maxiter=cfg.gm2_maxiter, ctx=ctx)
        if cfg.sign_bits == 1:
            # the packed one-bit wire: this edge's rows pack to sign words
            # here; only the per-coordinate counts (bounded by the rows per
            # edge, so uint8/uint16 on the wire) and the finite-row ballot
            # count cross the network
            p = self.shard * cfg.rows_per_edge
            rows = stack[p:p + cfg.rows_per_edge]
            words, k_valid = aggregators.pack_signs(
                rows, torch.zeros(d, dtype=torch.float32, device=self.device))
            counts = aggregators.packed_sign_votes(words, d)
            m_counts, m_valid = ctx.merge((counts, k_valid), ("sum", "sum"),
                                          meta={"label": "signvote"})
            outs["signvote"] = (2 * m_counts - m_valid).to(torch.int32)
        # result consensus: every edge computed the same finals (functions
        # of merged data only); the root checks byte equality across the
        # fleet and quarantines dissenters
        names = cfg.result_names
        merged = ctx.merge(tuple(outs[n] for n in names), ("same",) * len(names),
                           meta={"label": "results", "names": names})
        return dict(zip(names, merged))


# --------------------------------------------------------------------------
# the HTTP client half (stdlib urllib; the root is serve/root.py)
# --------------------------------------------------------------------------


class EdgeClient:
    """Signed, nonce'd submissions and fold polling for one edge."""

    def __init__(self, root_url: str, edge: int, key_hex: str,
                 poll_secs: float = 0.02, timeout: float = 30.0) -> None:
        self.root_url = root_url.rstrip("/")
        self.edge = edge
        self.key_hex = key_hex
        self.poll_secs = poll_secs
        self.timeout = timeout
        self._nonce = 0
        self._round = -1
        self._epoch = 0
        self._seq = 0
        # distributed tracing: an outbound W3C header the edge loop sets per
        # round (never part of the signed body), and the time on the wire,
        # which the loop drains into its edge_exchange span
        self.traceparent: Optional[str] = None
        self._exchange_ms = 0.0
        self.exchanges = 0

    # --------------------------------------------------------- plumbing

    def take_exchange_ms(self) -> float:
        """Drain the time on the wire (ms) accumulated since the last call."""
        ms, self._exchange_ms = self._exchange_ms, 0.0
        return ms

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Tuple[int, dict]:
        data = json.dumps(body).encode() if body is not None else None
        headers: Dict[str, str] = {}
        if data:
            headers["Content-Type"] = "application/json"
        if self.traceparent is not None:
            headers["traceparent"] = self.traceparent
        req = urllib.request.Request(self.root_url + path, data=data, method=method,
                                     headers=headers)
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, json.loads(resp.read().decode() or "{}")
        except urllib.error.HTTPError as exc:
            raw = exc.read().decode(errors="replace")
            try:
                return exc.code, json.loads(raw or "{}")
            except json.JSONDecodeError:
                return exc.code, {"error": raw}
        finally:
            self._exchange_ms += (time.monotonic() - t0) * 1e3

    def _raise_for(self, status: int, resp: dict) -> None:
        if status == 410:
            raise EdgeQuarantined(str(resp.get("error", "")))
        if status == 409 and resp.get("error") == "stale_epoch":
            raise RoundRestart(int(resp.get("epoch", self._epoch + 1)))
        raise RuntimeError(f"edge {self.edge}: root answered {status}: {resp}")

    def _signed(self, body: Dict[str, Any]) -> Dict[str, Any]:
        self._nonce += 1
        body = {**body, "edge": self.edge, "nonce": self._nonce}
        body["mac"] = sign_envelope(self.key_hex, body)
        return body

    # --------------------------------------------------------- protocol

    def begin_round(self, rnd: int, epoch: int) -> None:
        self._round, self._epoch, self._seq = rnd, epoch, 0

    def round_state(self, rnd: int) -> dict:
        status, resp = self._request("GET", f"/rounds/{rnd}")
        if status != 200:
            self._raise_for(status, resp)
        return resp

    def exchange(self, tags, arrays, meta: Optional[dict] = None):
        """The :class:`EdgeShardCtx` exchange: POST this shard's partial for
        the current (round, epoch, seq), then poll the fold."""
        from ..ops import shardctx

        seq = self._seq
        self._seq += 1
        self.exchanges += 1
        body = self._signed({
            "op": "partial", "round": self._round, "epoch": self._epoch, "seq": seq,
            "meta": meta or {}, **shardctx.partial_to_wire(arrays, tags),
        })
        status, resp = self._request("POST", "/partials", body)
        if status != 200:
            self._raise_for(status, resp)
        path = f"/fold/{self._round}/{seq}?epoch={self._epoch}&edge={self.edge}"
        deadline = time.time() + self.timeout
        while True:
            status, resp = self._request("GET", path)
            if status == 200:
                leaves, _ = shardctx.partial_from_wire(resp)
                return leaves
            if status == 202:
                if time.time() > deadline:
                    raise RuntimeError(
                        f"edge {self.edge}: fold of round {self._round} seq {seq} "
                        "never completed")
                time.sleep(self.poll_secs)
                continue
            self._raise_for(status, resp)

    def done(self, rnd: int) -> None:
        body = self._signed({"op": "done", "round": rnd, "epoch": self._epoch})
        status, resp = self._request("POST", "/done", body)
        if status != 200:
            self._raise_for(status, resp)


# --------------------------------------------------------------------------
# the edge main loop
# --------------------------------------------------------------------------


def run_edge(cfg: TopologyConfig, shard: int, root_url: str,
             obs_dir: Optional[str] = None, trace: bool = False,
             device: str = "cuda") -> Dict[str, Any]:
    """Run one edge through every round, on ``device`` (the card unless the
    caller asks for the CPU); returns a summary dict.

    Exit invariants (the chaos harness reads them from the summary): every
    round completed or this edge was quarantined, and JAX's build count is
    at most one per program (1 by construction in the port; the set-ups the
    card makes are under ``setups``).  Besides JAX's keys the summary carries, per
    round run, its wall ms (from the round's first request to its ``done``),
    its exchanges and their ms on the wire (the requests, polls included),
    the ms its stack took to draw and move, and the process's kernel launch
    counts (``ops/kernels.py::LAUNCHES``) and, per program, the one-time
    set-ups its rounds made (:class:`EdgeCompute`)."""
    from .. import obs as obs_lib
    from ..device import resolve_device
    from ..ops import kernels

    dev = resolve_device(device)
    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        sink: Any = obs_lib.JsonlSink(os.path.join(obs_dir, f"edge{shard}.events.jsonl"))
    else:
        sink = obs_lib.MemorySink()
    # the fold-poll deadline must outlive the root's partial_timeout: a
    # survivor waiting on a phase a dead edge never joins has to be still
    # polling when the root quarantines the silent edge and answers 409
    client = EdgeClient(root_url, shard, cfg.keys[shard],
                        timeout=max(30.0, cfg.partial_timeout * 2 + 30.0))
    compute = EdgeCompute(cfg, shard, client.exchange, dev)
    status = "completed"
    rounds_run = 0
    per_round: List[Dict[str, Any]] = []
    # --trace on: the whole topology shares one trace; the root mints the id
    # and publishes it in round_info, every edge adopts it at its first poll
    # (minting its own only where the root gives none), and each round's
    # submissions carry the edge_round span as traceparent
    trace_id: Optional[str] = None
    try:
        for rnd in range(cfg.rounds):
            t0 = time.perf_counter()
            stack = round_stack(cfg.seed, rnd, cfg.k, cfg.d, dev)
            stack_ms = (time.perf_counter() - t0) * 1e3
            round_span = obs_lib.trace.new_span_id() if trace else None
            t0 = time.perf_counter()
            client.take_exchange_ms()
            ex0 = client.exchanges
            while True:
                state = client.round_state(rnd)
                if trace and trace_id is None:
                    trace_id = state.get("trace_id") or obs_lib.trace.new_trace_id()
                if trace:
                    client.traceparent = obs_lib.trace.format_traceparent(trace_id, round_span)
                live = list(state.get("live", []))
                if shard not in live:
                    raise EdgeQuarantined("not in live set")
                client.begin_round(rnd, int(state.get("epoch", 0)))
                degraded = len(live) < cfg.edges
                try:
                    compute.round_fn(degraded)(stack)
                except RoundRestart:
                    continue
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                client.done(rnd)
                rounds_run += 1
                ms = (time.perf_counter() - t0) * 1e3
                ex_ms = client.take_exchange_ms()
                per_round.append({"round": rnd, "degraded": degraded, "ms": ms,
                                  "exchanges": client.exchanges - ex0, "exchange_ms": ex_ms,
                                  "stack_ms": stack_ms})
                if trace:
                    sink.emit(obs_lib.make_event(
                        "span", name="edge_round", ms=round(ms, 3), round=rnd, edge=shard,
                        trace_id=trace_id, span_id=round_span))
                    sink.emit(obs_lib.make_event(
                        "span", name="edge_exchange", ms=round(ex_ms, 3), round=rnd,
                        edge=shard, trace_id=trace_id, span_id=obs_lib.trace.new_span_id(),
                        parent_span_id=round_span))
                break
    except EdgeQuarantined:
        status = "quarantined"
    counts = compute.detector.snapshot()
    steady = all(compute.detector.check(name, max_lowerings=1) for name in counts)
    sink.emit(obs_lib.make_event("retrace", counts=counts, steady_state_ok=steady))
    sink.close()
    return {
        "edge": shard,
        "status": status,
        "rounds": rounds_run,
        "lowerings": counts,
        "steady_state_ok": steady,
        "device": dev.type,
        "per_round": per_round,
        "launches": dict(kernels.LAUNCHES),
        "setups": compute.setups,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "byzantine_aircomp_tpu_torch edge",
        description="one edge aggregator of the two-tier topology",
    )
    p.add_argument("--config", required=True, help="topology JSON (shared with the root)")
    p.add_argument("--shard", type=int, required=True,
                   help="this edge's shard index in [0, edges)")
    p.add_argument("--root-url", required=True,
                   help="root base URL, e.g. http://127.0.0.1:8123")
    p.add_argument("--obs-dir", default=None, help="directory for this edge's event stream")
    p.add_argument("--trace", choices=("off", "on"), default="off",
                   help="emit per-round edge spans and propagate the topology trace id on "
                        "every request (output-only)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the edge's device: cuda (default; start-up fails without a GPU) "
                        "or cpu")
    args = p.parse_args(argv)
    cfg = TopologyConfig.load(args.config)
    summary = run_edge(cfg, args.shard, args.root_url, args.obs_dir,
                       trace=args.trace == "on", device=args.device)
    print(f"edge {args.shard}: {json.dumps(summary)}", flush=True)
    return 0 if summary["steady_state_ok"] else 2


if __name__ == "__main__":
    raise SystemExit(main())
