"""Client-level forensics: top-M flag provenance in the round, and the
flight recorder.

The port of ``byzantine_aircomp_tpu/obs/forensics.py``.  The defense's
round vector says how many clients were flagged; this module says which,
why, and by what margin:

* **Top-M in the round** — :func:`candidate_rows` gathers, per client, the
  score and its (norm, cosine, distance) terms, the z-score against the
  detector's baseline from before the update, the CUSUM after it, and the
  margins to both alarm thresholds into one [rows, NUM_COLS] f32 matrix;
  :func:`top_m` keeps the M highest scores.  ``lax.top_k`` puts the lowest
  index first on ties, so the port takes its top M with a stable
  descending ``torch.sort`` (as ``ops.aggregators.lowest`` does), never
  with ``torch.topk``.  The client column holds the population id under
  service rounds (f32, exact below 2^24) and the stack row otherwise.
  Everything here runs on the device with no host read, so a graphed round
  computes it inside its CUDA graph; the streamed round keeps a running
  top-M across its chunks (:func:`stream_init`, :func:`merge_top_m`).
* **Host-side emission** — :func:`emit_round_flags` turns a round's
  matrix (its iterations merged by :func:`merge_interval`) into
  ``client_flag`` events, deduped by client id keeping the max-score row.
* **Flight recorder** — :class:`FlightRecorder`, a host-side ring of the
  last W rounds of detector state and round summary, dumped atomically to
  ``flight_<round>.json`` once per rollback and once at run end
  (``flight_run_end.json``).

Everything here is output-only: no draws, no carried state, no record
keys, so ``--forensics off`` and ``top``/``full`` runs train bitwise alike.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import io as io_lib
from .events import SCHEMA_VERSION

#: column layout of the forensic matrix ([M, NUM_COLS] f32); ``rung`` is
#: stamped after the policy update by :func:`with_rung`
COLUMNS = (
    "client",
    "score",
    "z",
    "cusum",
    "margin_z",
    "margin_cusum",
    "norm_term",
    "cos_term",
    "dist_term",
    "flagged",
    "rung",
)
NUM_COLS = len(COLUMNS)
_SCORE_COL = COLUMNS.index("score")
_RUNG_COL = COLUMNS.index("rung")


def candidate_rows(ids, score, components, ema_pre, dev_pre, cusum_post, flags, p):
    """Per-client candidate rows [rows, NUM_COLS] (on the device).

    ``ids`` are the rows' client identities (population ids under service
    rounds, stack rows otherwise); ``ema_pre`` / ``dev_pre`` the detector's
    baselines before this iteration's update (the z it thresholded),
    ``cusum_post`` the statistic after it.  The rung column is 0 until
    :func:`with_rung`."""
    f32 = torch.float32
    z = (score.to(f32) - ema_pre.to(f32)) / (dev_pre.to(f32) + p.eps)
    cusum = cusum_post.to(f32)
    return torch.stack(
        [
            ids.to(f32),
            score.to(f32),
            z,
            cusum,
            z - p.z_thresh,
            cusum - p.cusum_thresh,
            components[:, 0].to(f32),
            components[:, 1].to(f32),
            components[:, 2].to(f32),
            flags.to(f32),
            torch.zeros_like(z),
        ],
        dim=1,
    )


def top_m(rows, m: int):
    """The ``m`` rows with the highest scores, in descending score order,
    ties lowest index first (``lax.top_k``'s order): a stable descending
    sort."""
    idx = torch.sort(rows[:, _SCORE_COL], descending=True, stable=True).indices[:m]
    return rows[idx]


def merge_top_m(carry, rows, m: int):
    """A carried [m, NUM_COLS] top-M merged with new candidate rows (the
    streamed round: one call per chunk)."""
    return top_m(torch.cat([carry, rows], dim=0), m)


def stream_init(m: int, device=None):
    """The streamed round's initial top-M: [m, NUM_COLS] zeros with a
    ``-inf`` score column, so every real row displaces a sentinel."""
    init = torch.zeros((m, NUM_COLS), dtype=torch.float32, device=device)
    init[:, _SCORE_COL] = -torch.inf
    return init


def with_rung(mat, rung):
    """``mat`` with the active rung (a scalar, after the policy update)
    in its rung column."""
    out = mat.clone()
    out[:, _RUNG_COL] = torch.as_tensor(rung, device=mat.device).to(torch.float32)
    return out


def merge_interval(mats, m: int):
    """The round's [interval, m, NUM_COLS] iteration matrices reduced to
    one [m, NUM_COLS] top-M; a client flagged in several iterations appears
    once per iteration (host-side emission keeps its peak row)."""
    return top_m(mats.reshape(-1, NUM_COLS), m)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rows_to_records(mat) -> List[Dict[str, Any]]:
    """Host side: [M, NUM_COLS] -> per-client dicts, deduped by client id
    (max score wins), sorted by descending score."""
    mat = np.asarray(_host(mat), np.float64)
    best: Dict[int, np.ndarray] = {}
    for row in mat:
        if not np.isfinite(row[_SCORE_COL]):
            continue  # unfilled streamed sentinel
        cid = int(row[0])
        if cid not in best or row[_SCORE_COL] > best[cid][_SCORE_COL]:
            best[cid] = row
    records = []
    for row in sorted(best.values(), key=lambda r: -r[_SCORE_COL]):
        rec: Dict[str, Any] = {name: float(v) for name, v in zip(COLUMNS, row)}
        rec["client"] = int(row[0])
        rec["flagged"] = bool(row[COLUMNS.index("flagged")] > 0.5)
        rec["rung"] = int(row[_RUNG_COL])
        records.append(rec)
    return records


def emit_round_flags(obs, round_idx: int, mat, *, mode: str) -> int:
    """``client_flag`` events for a round's forensic matrix: ``"top"``
    emits the flagged rows only, ``"full"`` the whole top-M.  Returns the
    number of events emitted."""
    n = 0
    for rec in rows_to_records(mat):
        if mode == "top" and not rec["flagged"]:
            continue
        obs.emit("client_flag", round=round_idx, **rec)
        n += 1
    return n


class FlightRecorder:
    """Ring of the last W rounds of detector state and summary stats.

    ``record`` is called once per completed round from the host loop
    (``--forensics full`` only: it copies the detector state to the host,
    after the round's own barrier); ``dump`` writes the ring to a JSON
    file and emits one ``forensic_dump`` event: once per rollback and once
    at run end."""

    def __init__(self, window: int, out_dir: str) -> None:
        self.window = int(window)
        self.out_dir = out_dir
        self._ring: collections.deque = collections.deque(maxlen=self.window)
        self.dumps: List[str] = []

    def record(
        self,
        round_idx: int,
        *,
        detector_state=None,
        policy_state=None,
        defense_metrics=None,
        forensic_rows=None,
        summary: Optional[Dict[str, Any]] = None,
    ) -> None:
        def _tolist(x):
            if x is None:
                return None
            if isinstance(x, (tuple, list)):
                return [_tolist(v) for v in x]
            return _host(x).tolist()

        snap: Dict[str, Any] = {"round": int(round_idx)}
        if detector_state is not None:
            step, ema, dev, cusum = detector_state
            snap["detector"] = {
                "step": int(_host(step)),
                "ema": _tolist(ema),
                "dev": _tolist(dev),
                "cusum": _tolist(cusum),
            }
        if policy_state is not None:
            snap["policy"] = _tolist(policy_state)
        if defense_metrics is not None:
            snap["defense_metrics"] = _tolist(defense_metrics)
        if forensic_rows is not None:
            snap["top_m"] = rows_to_records(forensic_rows)
        if summary:
            snap["summary"] = dict(summary)
        self._ring.append(snap)

    def dump(self, round_idx: int, reason: str, obs=None) -> Optional[str]:
        """Write ``flight_<round>.json`` (``flight_run_end.json`` for the
        run-end dump) and emit a ``forensic_dump`` event; returns the path
        (None while nothing is recorded)."""
        if not self._ring:
            return None
        name = ("flight_run_end.json" if reason == "run_end"
                else f"flight_{int(round_idx)}.json")
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, name)
        payload = {
            "v": SCHEMA_VERSION,
            "reason": reason,
            "round": int(round_idx),
            "window": self.window,
            "rounds": list(self._ring),
        }
        io_lib.atomic_write(path, lambda f: json.dump(payload, f, default=str), mode="w")
        self.dumps.append(path)
        if obs is not None:
            obs.emit(
                "forensic_dump",
                round=int(round_idx),
                path=path,
                reason=reason,
                window=self.window,
                rounds_recorded=len(payload["rounds"]),
            )
        return path
