"""Aggregation root: the trusted fold point of the two-tier topology.

The port of ``byzantine_aircomp_tpu/serve/root.py``: the same routes,
status codes, JSON keys, journal records and events.

Edges (``serve/edge.py``) POST canonical wire partials; the root verifies
them (HMAC, nonce monotonicity, epoch currency, finiteness, shape and tag
consistency), folds each complete phase with ``ops/shardctx.py``'s
``fold_partials``, the left fold in shard order the sequential engine
uses, so the tree's results stay bitwise the flat aggregate, and hands
the fold back to polling edges.  Zero-trust posture:

* a forged MAC never reaches the fold: it is rejected before decode,
  journaled (``forged_rejected``) and counted per claimed identity; it
  can not quarantine or strike the edge whose identity it claims, or any
  attacker could evict the fleet edge by edge;
* a replayed nonce under a valid MAC is rejected (409) and journaled
  (``replay_rejected``), but does not quarantine the edge either: the
  protocol runs over plain HTTP, so any on-path observer can capture and
  re-POST a legitimate submission, and containment would turn passive
  capture into permanent eviction.  The nonce high-water mark already
  makes the replay inert;
* an authenticated protocol violation (a fresh, validly signed envelope
  carrying a malformed seq or an out-of-range round, which only the
  keyholder could produce: every verified envelope burns its nonce even
  when later rejected, so a capture cannot be replayed to inflate the
  count) costs a strike; at ``strike_limit`` strikes the edge is
  quarantined (``strike_limit``);
* a partial that fails decode or the finite check quarantines its edge
  (``bad_payload`` / ``nonfinite_partial``).  The phase schema (tags,
  shapes, meta) is decided by no single submitter: submissions buffer
  until every live edge has reported, the majority schema wins (a tie
  goes to the first edge in shard order), and the dissenting minority is
  quarantined (``bad_payload``);
* a missing partial past ``partial_timeout`` quarantines the silent edges
  and bumps the round's epoch: survivors see ``stale_epoch`` on their next
  request, re-read the live set and run the round again degraded.
  Deadlines are checked at the top of every route dispatch (the fleet
  polls continuously) and by :func:`main`'s loop.

The final exchange of every round carries each edge's result arrays under
the ``"same"`` consensus tag: results are functions of merged data only,
so honest edges agree byte for byte.  The root takes the byte majority,
stores the winners as the round's results and quarantines dissenters
(``result_mismatch``) without an epoch bump.

The numeric fold runs as eager elementwise torch ops (add, min, max) on
the root's device, the card unless ``--device cpu``; they give the same
bits on the card and on the CPU.  The JAX root jits its fold and reports
``fold_lowerings`` (lowerings of the jitted fold) beside
``fold_signatures`` (distinct phase signatures: tags, shard count, leaf
shapes and dtypes).  The port compiles nothing, so its ``fold_lowerings``
counts one set-up per distinct signature and equals ``fold_signatures``
by construction; the key stays for JAX's readers, and it measures
nothing.  Nonce high-water marks and quarantines persist to a root
journal (``serve/journal.py``) and are restored before serving, so replay
protection survives a root restart.
"""

from __future__ import annotations

import argparse
import hmac as hmac_lib
import json
import os
import threading
import time
import urllib.parse
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as obs_lib
from ..ops import shardctx
from . import journal as journal_lib
from .edge import TopologyConfig, sign_envelope

_JSON = "application/json"


class Reject(Exception):
    """A verified-bad submission: carries the HTTP status and payload."""

    def __init__(self, status: int, **payload: Any) -> None:
        super().__init__(payload.get("error", "rejected"))
        self.status = status
        self.payload = payload


class RootState:
    """All root bookkeeping behind one lock (HTTP handler threads)."""

    def __init__(
        self,
        cfg: TopologyConfig,
        obs_dir: Optional[str] = None,
        registry=None,
        now_fn=time.time,
        trace: bool = False,
        device: str = "cuda",
    ) -> None:
        from ..device import resolve_device

        self.cfg = cfg
        self.now = now_fn
        self.device = resolve_device(device)
        # --trace on: the root mints the topology-wide trace id (edges adopt
        # it from round_info) and emits per-round root_round / root_fold
        # spans on its own stream
        self.trace = trace
        self.trace_id: Optional[str] = obs_lib.trace.new_trace_id() if trace else None
        self._lock = threading.RLock()
        self.registry = registry if registry is not None else obs_lib.MetricsRegistry()
        if obs_dir:
            os.makedirs(obs_dir, exist_ok=True)
            self.sink: Any = obs_lib.MultiSink([
                obs_lib.JsonlSink(os.path.join(obs_dir, "root.events.jsonl")),
                obs_lib.MetricsSink(self.registry),
            ])
            self.journal = journal_lib.RunJournal(
                os.path.join(obs_dir, journal_lib.ROOT_JOURNAL_NAME))
        else:
            self.sink = obs_lib.MetricsSink(self.registry)
            self.journal = None
        self.live = set(range(cfg.edges))
        self.quarantined: Dict[int, str] = {}
        self.nonces: Dict[int, int] = {e: 0 for e in range(cfg.edges)}
        # strikes: authenticated protocol violations (strike_limit enforced);
        # forged / replays: attacker-producible rejections, counted per
        # claimed identity for observation only
        self.strikes: Dict[int, int] = {}
        self.forged: Dict[int, int] = {}
        self.replays: Dict[int, int] = {}
        self.epoch = 0
        # (round, epoch, seq) -> phase dict
        self.phases: Dict[Tuple[int, int, int], Dict[str, Any]] = {}
        # round -> {"ingress", "done", "completed", "results",
        #           "done_first_ts", "epoch", "folds", "fold_ms"}
        self.rounds: Dict[int, Dict[str, Any]] = {}
        self._fold_sigs: set = set()
        self._restore()

    # ----------------------------------------------------------- restore

    def _restore(self) -> None:
        """Replay the root journal: nonce high-water marks and standing
        quarantines survive a root restart, so captured submissions stay
        dead."""
        if self.journal is None:
            return
        states = journal_lib.replay_edges(
            self.journal.path, warn=lambda m: print(f"[root] {m}", flush=True))
        for edge, st in states.items():
            if edge in self.nonces:
                self.nonces[edge] = max(self.nonces[edge], st["nonce"])
            if st["quarantined"] and edge in self.live:
                self.live.discard(edge)
                self.quarantined[edge] = st["quarantined"]

    # ------------------------------------------------------- observation

    def _emit(self, kind: str, **fields: Any) -> None:
        self.sink.emit(obs_lib.make_event(kind, **fields))

    def _journal(self, op: str, edge: int, **fields: Any) -> None:
        if self.journal is not None:
            self.journal.append(op, f"edge-{edge}", **fields)

    # ------------------------------------------------------- containment

    def _quarantine(self, edge: int, reason: str, bump: bool = True) -> None:
        """Evict ``edge``; optionally bump the epoch so in-flight phases
        restart over the surviving set (consensus dissent does not bump:
        the fold already completed over the majority)."""
        if edge in self.quarantined:
            return
        self.live.discard(edge)
        self.quarantined[edge] = reason
        self._journal("edge_quarantined", edge, reason=reason)
        self._emit("edge_quarantine", edge=edge, reason=reason)
        if bump:
            self.epoch += 1
            # stale-epoch phases can never fold; drop them
            self.phases = {key: ph for key, ph in self.phases.items() if key[1] >= self.epoch}

    def _reject(self, edge: int, reason: str, status: int,
                journal_op: Optional[str] = None, **extra: Any) -> Reject:
        """An attacker-producible rejection (forgery, replay): journaled
        and counted, never a strike."""
        if journal_op:
            self._journal(journal_op, edge, reason=reason, **extra)
        self._emit("edge_reject", edge=edge, reason=reason)
        return Reject(status, error=reason, **extra)

    def _strike(self, edge: int, reason: str, status: int,
                nonce: Optional[int] = None, **extra: Any) -> Reject:
        """An authenticated violation (a fresh, valid MAC and nonce: only
        the keyholder produced it) accrues toward ``cfg.strike_limit``.  The
        burned nonce rides the journal entry, so the high-water mark
        survives a restart and a captured violation cannot strike twice."""
        self.strikes[edge] = self.strikes.get(edge, 0) + 1
        self._journal("strike", edge, reason=reason, nonce=nonce, strikes=self.strikes[edge])
        self._emit("edge_reject", edge=edge, reason=reason)
        exc = Reject(status, error=reason, **extra)
        if self.strikes[edge] >= self.cfg.strike_limit:
            self._quarantine(edge, "strike_limit")
        return exc

    # ------------------------------------------------------ verification

    def _verify(self, body: Any, op: str) -> int:
        """The zero-trust chain; returns the verified edge id or raises
        :class:`Reject`.  Identity, then authenticity, then the nonce (a
        verified nonce is burned at once, before the epoch and round
        checks, so a later-rejected envelope cannot be replayed), then the
        epoch, then the round: an unauthenticated byte never changes fold
        state."""
        if not isinstance(body, dict) or body.get("op") != op:
            raise Reject(400, error=f"body must be a signed {op!r} envelope")
        edge = body.get("edge")
        if not isinstance(edge, int) or edge not in self.nonces:
            raise Reject(401, error="unknown edge")
        mac = body.get("mac")
        want = sign_envelope(self.cfg.keys[edge], body)
        if not (isinstance(mac, str) and hmac_lib.compare_digest(mac, want)):
            self.forged[edge] = self.forged.get(edge, 0) + 1
            raise self._reject(edge, "bad_mac", 401, journal_op="forged_rejected",
                               nonce=body.get("nonce"))
        # authenticated from here on
        if edge in self.quarantined:
            raise Reject(410, error=self.quarantined[edge])
        nonce = body.get("nonce")
        if not isinstance(nonce, int) or nonce <= self.nonces[edge]:
            # a valid MAC with a reused nonce: an on-path replay or a
            # duplicated edge, which the root cannot tell apart; rejected
            # and journaled, never a quarantine
            self.replays[edge] = self.replays.get(edge, 0) + 1
            raise self._reject(edge, "replay", 409, journal_op="replay_rejected", nonce=nonce)
        self.nonces[edge] = nonce
        if body.get("epoch") != self.epoch:
            raise Reject(409, error="stale_epoch", epoch=self.epoch)
        rnd = body.get("round")
        if not isinstance(rnd, int) or not 0 <= rnd < self.cfg.rounds:
            raise self._strike(edge, "bad_round", 400, nonce=nonce, round=rnd)
        return edge

    # ------------------------------------------------------------- folds

    def _fold(self, key: Tuple[int, int, int], phase: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        try:
            self._fold_inner(key, phase)
        finally:
            rst = self._round(key[0])
            rst["folds"] += 1
            rst["fold_ms"] += (time.perf_counter() - t0) * 1e3

    def _fold_inner(self, key: Tuple[int, int, int], phase: Dict[str, Any]) -> None:
        order = sorted(phase["subs"])
        tags = phase["tags"]
        subs = phase["subs"]
        if all(t == "same" for t in tags):
            # result consensus: the majority bytes win, dissenters are
            # contained without an epoch bump (the fold stands)
            winners: List[np.ndarray] = []
            dissent: set = set()
            for i in range(len(subs[order[0]])):
                blobs = {e: subs[e][i].tobytes() for e in order}
                votes = Counter(blobs.values())
                best = max(votes.values())
                # a tie goes to the first edge in shard order
                win_edge = next(e for e in order if votes[blobs[e]] == best)
                winners.append(subs[win_edge][i])
                dissent |= {e for e in order if blobs[e] != blobs[win_edge]}
            phase["folded"] = winners
            names = (phase.get("meta") or {}).get("names")
            if names and len(names) == len(winners):
                self._round(key[0])["results"] = dict(zip(names, winners))
            for e in sorted(dissent):
                self._quarantine(e, "result_mismatch", bump=False)
            return
        stacked = tuple(np.stack([subs[e][i] for e in order])
                        for i in range(len(subs[order[0]])))
        n = len(order)
        self._fold_sigs.add((tuple(tags), n, tuple((s.shape, str(s.dtype)) for s in stacked)))
        out = shardctx.fold_partials(
            tuple(torch.from_numpy(s).to(self.device) for s in stacked), tags, n)
        # np.array, not ascontiguousarray: that one makes a 0-d leaf 1-d
        phase["folded"] = [np.array(x.cpu().numpy(), order="C") for x in out]

    # ---------------------------------------------------------- deadline

    def _round(self, rnd: int) -> Dict[str, Any]:
        rst = self.rounds.setdefault(rnd, {
            "ingress": 0, "done": set(), "completed": False, "results": {},
            "done_first_ts": None, "epoch": self.epoch, "folds": 0, "fold_ms": 0.0,
        })
        if self.trace and "span_id" not in rst:
            # the round's root_round span opens at first ingress and is
            # emitted when the round completes
            rst["span_id"] = obs_lib.trace.new_span_id()
            rst["t0"] = self.now()
        return rst

    def deadline_check(self, now: Optional[float] = None) -> None:
        """Quarantine edges that keep a phase (or a round's close) waiting
        past ``partial_timeout``."""
        now = self.now() if now is None else now
        with self._lock:
            timeout = self.cfg.partial_timeout
            for key, phase in list(self.phases.items()):
                if phase.get("folded") is not None or key[1] != self.epoch:
                    continue
                if now - phase["first_ts"] <= timeout:
                    continue
                for e in sorted(self.live - set(phase["subs"])):
                    self._quarantine(e, "partial_timeout")
            for rnd, rst in self.rounds.items():
                ts = rst.get("done_first_ts")
                if rst["completed"] or ts is None or now - ts <= timeout:
                    continue
                for e in sorted(self.live - rst["done"]):
                    self._quarantine(e, "partial_timeout")
                self._maybe_complete(rnd)

    # ------------------------------------------------------------ routes

    def submit_partial(self, raw: bytes, traceparent=None) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            try:
                body = json.loads(raw.decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                return 400, {"error": f"bad json: {exc}"}
            try:
                edge = self._verify(body, "partial")
                seq = body.get("seq")
                if not isinstance(seq, int) or seq < 0:
                    raise self._strike(edge, "bad_seq", 400, nonce=body["nonce"],
                                       seq=repr(seq))
                try:
                    # a malformed leaf dict raises KeyError or TypeError, not
                    # only ValueError: the same authenticated-hostile payload;
                    # so does a leaf of a dtype torch cannot fold
                    leaves, tags = shardctx.partial_from_wire(body)
                    for x in leaves:
                        torch.from_numpy(x)
                except (ValueError, KeyError, TypeError) as exc:
                    self._quarantine(edge, "bad_payload")
                    raise Reject(422, error=f"bad payload: {exc!r}")
                for x in leaves:
                    if x.dtype.kind == "f" and not np.isfinite(x).all():
                        self._quarantine(edge, "nonfinite_partial")
                        raise Reject(422, error="nonfinite partial")
                rnd = body["round"]
                key = (rnd, self.epoch, seq)
                phase = self.phases.setdefault(key, {
                    "subs": {}, "tags": None, "meta": None,
                    "first_ts": self.now(), "folded": None,
                })
                if phase["folded"] is not None:
                    # the fold stands: a fresh-nonce resubmission can neither
                    # re-open the vote nor fold the phase again
                    return 200, {"ok": True, "seq": seq, "folded": True}
                phase["subs"][edge] = {
                    "leaves": leaves,
                    "tags": list(tags),
                    "shapes": [(list(x.shape), x.dtype.str) for x in leaves],
                    "meta": body.get("meta"),
                }
                rst = self._round(rnd)
                rst["ingress"] += len(raw)
                extra: Dict[str, Any] = {}
                if self.trace and traceparent is not None:
                    # the ingress happened within the edge's round span:
                    # correlate through the W3C header, never the signed body
                    extra["trace_id"] = traceparent[0]
                    extra["span_id"] = traceparent[1]
                self._emit("edge_partial", round=rnd, edge=edge, seq=seq, bytes=len(raw),
                           **extra)
                if self.live <= set(phase["subs"]):
                    self._resolve(key, phase, submitter=edge)
                return 200, {"ok": True, "seq": seq}
            except Reject as exc:
                return exc.status, exc.payload

    def _resolve(self, key: Tuple[int, int, int], phase: Dict[str, Any],
                 submitter: int) -> None:
        """Every live edge has reported: decide the phase schema by majority
        (a tie goes to the first edge in shard order), then fold.  The
        minority is quarantined (``bad_payload``), which bumps the epoch."""
        subs = phase["subs"]
        order = sorted(subs)
        schemas = {
            e: json.dumps([subs[e]["tags"], subs[e]["shapes"], subs[e]["meta"]],
                          sort_keys=True)
            for e in order
        }
        votes = Counter(schemas.values())
        best = max(votes.values())
        win_edge = next(e for e in order if votes[schemas[e]] == best)
        losers = [e for e in order if schemas[e] != schemas[win_edge]]
        if losers:
            for e in losers:
                self._quarantine(e, "bad_payload")
            if submitter in losers:
                raise Reject(422, error="partial disagrees with phase schema quorum")
            return
        winner = subs[win_edge]
        phase["tags"] = winner["tags"]
        phase["meta"] = winner["meta"]
        phase["subs"] = {e: subs[e]["leaves"] for e in order}
        self._fold(key, phase)

    def get_fold(self, rnd: int, seq: int, epoch: int,
                 edge: Optional[int]) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            if edge is not None and edge in self.quarantined:
                return 410, {"error": self.quarantined[edge]}
            if epoch != self.epoch:
                return 409, {"error": "stale_epoch", "epoch": self.epoch}
            phase = self.phases.get((rnd, epoch, seq))
            if phase is None or phase.get("folded") is None:
                return 202, {"pending": True}
            return 200, shardctx.partial_to_wire(phase["folded"], phase["tags"])

    def submit_done(self, raw: bytes) -> Tuple[int, Dict[str, Any]]:
        with self._lock:
            try:
                body = json.loads(raw.decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as exc:
                return 400, {"error": f"bad json: {exc}"}
            try:
                edge = self._verify(body, "done")
            except Reject as exc:
                return exc.status, exc.payload
            rnd = body["round"]
            rst = self._round(rnd)
            rst["done"].add(edge)
            if rst["done_first_ts"] is None:
                rst["done_first_ts"] = self.now()
            self._maybe_complete(rnd)
            return 200, {"ok": True, "completed": rst["completed"]}

    def _maybe_complete(self, rnd: int) -> None:
        rst = self.rounds.get(rnd)
        if rst is None or rst["completed"]:
            return
        if not self.live or not self.live <= rst["done"]:
            return
        rst["completed"] = True
        rst["epoch"] = self.epoch
        degraded = len(self.live) < self.cfg.edges
        rst["degraded"] = degraded
        self._emit("edge_round", round=rnd, epoch=self.epoch, edges=len(self.live),
                   degraded=degraded, ingress_bytes=rst["ingress"])
        if self.trace:
            span_id = rst.get("span_id") or obs_lib.trace.new_span_id()
            ms = max(self.now() - rst.get("t0", self.now()), 0.0) * 1e3
            self._emit("span", name="root_round", ms=round(ms, 3), round=rnd,
                       epoch=self.epoch, trace_id=self.trace_id, span_id=span_id)
            self._emit("span", name="root_fold", ms=round(rst["fold_ms"], 3), round=rnd,
                       trace_id=self.trace_id, span_id=obs_lib.trace.new_span_id(),
                       parent_span_id=span_id)
        for e in sorted(self.live):
            self._journal("partial", e, round=rnd, nonce=self.nonces[e])
            self._journal("round_done", e, round=rnd, epoch=self.epoch)
        # a closed round's phase payloads are dead weight; drop them
        self.phases = {key: ph for key, ph in self.phases.items() if key[0] != rnd}

    def round_info(self, rnd: int) -> Dict[str, Any]:
        with self._lock:
            rst = self.rounds.get(rnd)
            info = {
                "round": rnd,
                "epoch": self.epoch,
                "live": sorted(self.live),
                "completed": bool(rst and rst["completed"]),
            }
            if self.trace_id is not None:
                # edges adopt this at their first poll: one topology-wide trace
                info["trace_id"] = self.trace_id
            return info

    def results(self) -> Dict[str, Any]:
        """JAX's ``/results`` document; each round also carries ``folds``
        (the phases folded, result consensus included) and ``fold_ms`` (the
        root's host ms in them), which JAX's readers ignore."""
        with self._lock:
            rounds = {}
            for rnd, rst in sorted(self.rounds.items()):
                rounds[str(rnd)] = {
                    "completed": rst["completed"],
                    "epoch": rst["epoch"],
                    "ingress_bytes": rst["ingress"],
                    "degraded": rst.get("degraded", len(self.live) < self.cfg.edges),
                    "results": {n: shardctx.encode_leaf(v) for n, v in rst["results"].items()},
                    "folds": rst["folds"],
                    "fold_ms": rst["fold_ms"],
                }
            return {
                "epoch": self.epoch,
                "live": sorted(self.live),
                "quarantined": dict(self.quarantined),
                "strikes": dict(self.strikes),
                "forged": dict(self.forged),
                "replays": dict(self.replays),
                "rounds": rounds,
                # equal by construction: the port compiles no fold (module
                # docstring)
                "fold_lowerings": len(self._fold_sigs),
                "fold_signatures": len(self._fold_sigs),
            }

    def all_done(self) -> bool:
        with self._lock:
            return all(self.rounds.get(r, {}).get("completed") for r in range(self.cfg.rounds))

    def close(self) -> None:
        self.sink.close()
        if self.journal is not None:
            self.journal.close()


class RootServer:
    """One socket: the edge protocol, ``/metrics`` and ``/healthz``."""

    def __init__(
        self,
        cfg: TopologyConfig,
        obs_dir: Optional[str] = None,
        port: int = 0,
        host: str = "0.0.0.0",
        trace: bool = False,
        device: str = "cuda",
    ) -> None:
        self.state = RootState(cfg, obs_dir=obs_dir, trace=trace, device=device)
        self.exporter = obs_lib.MetricsExporter(
            self.state.registry, port=port, host=host, health_fn=self._health,
            routes=self._routes)

    @property
    def port(self) -> Optional[int]:
        return self.exporter.port

    def start(self) -> "RootServer":
        self.exporter.start()
        return self

    def close(self) -> None:
        self.exporter.close()
        self.state.close()

    def __enter__(self) -> "RootServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _health(self) -> Dict[str, Any]:
        st = self.state
        return {"ok": bool(st.live), "live": sorted(st.live),
                "quarantined": dict(st.quarantined), "epoch": st.epoch}

    @staticmethod
    def _json(status: int, payload: Any) -> Tuple[int, str, bytes]:
        return status, _JSON, (json.dumps(payload) + "\n").encode()

    def _routes(self, method: str, path: str, body: bytes,
                headers: Optional[Dict[str, str]] = None) -> Optional[Tuple[int, str, bytes]]:
        url = urllib.parse.urlsplit(path)
        parts = [p for p in url.path.split("/") if p]
        if not parts:
            return None
        # wall-clock progress rides every request (deadline_check)
        self.state.deadline_check()
        try:
            if parts[0] == "partials" and method == "POST":
                from ..obs.trace import parse_traceparent

                return self._json(*self.state.submit_partial(
                    body, traceparent=parse_traceparent((headers or {}).get("traceparent"))))
            if parts[0] == "done" and method == "POST":
                return self._json(*self.state.submit_done(body))
            if parts[0] == "fold" and len(parts) == 3 and method == "GET":
                q = urllib.parse.parse_qs(url.query)
                edge = q.get("edge", [None])[0]
                return self._json(*self.state.get_fold(
                    int(parts[1]), int(parts[2]), int(q.get("epoch", ["0"])[0]),
                    int(edge) if edge is not None else None))
            if parts[0] == "rounds" and len(parts) == 2 and method == "GET":
                return self._json(200, self.state.round_info(int(parts[1])))
            if parts[0] == "results" and method == "GET":
                return self._json(200, self.state.results())
        except ValueError as exc:
            return self._json(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 -- surface it, keep the thread
            return self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "byzantine_aircomp_tpu_torch root",
        description="aggregation root of the two-tier topology",
    )
    p.add_argument("--config", required=True, help="topology JSON (shared with the edges)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--obs-dir", default=None, help="events and root journal directory")
    p.add_argument("--linger", type=float, default=5.0,
                   help="seconds to keep serving after all rounds close (lets a harness "
                        "scrape /results)")
    p.add_argument("--trace", choices=("off", "on"), default="off",
                   help="mint a topology trace id and emit per-round root_round/root_fold "
                        "spans (output-only)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the fold's device: cuda (default; start-up fails without a GPU) "
                        "or cpu")
    args = p.parse_args(argv)
    cfg = TopologyConfig.load(args.config)
    server = RootServer(cfg, obs_dir=args.obs_dir, port=args.port, host=args.host,
                        trace=args.trace == "on", device=args.device).start()
    # parsed by the chaos harness; keep the trailing space (port parse)
    print(f"edge root on {args.host}:{server.port} ", flush=True)
    try:
        while not server.state.all_done():
            time.sleep(0.1)
            server.state.deadline_check()
            if not server.state.live:
                print("edge root: all edges quarantined", flush=True)
                break
        time.sleep(args.linger)
    except KeyboardInterrupt:
        pass
    finally:
        results = server.state.results()
        server.close()
        print(f"edge root results: {json.dumps(results)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
