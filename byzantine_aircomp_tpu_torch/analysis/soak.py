"""Traffic soak for the serving surface: SLO-gated load generation.

The port of ``byzantine_aircomp_tpu/analysis/soak.py``.

Stands up a REAL in-process :class:`~..serve.server.ExperimentServer`
(ephemeral port, synthetic dataset) and drives its HTTP surface with a
seeded open-loop arrival process — thousands of submits / cancels /
knob-swaps / ``/metrics`` scrapes at exponential inter-arrival times —
while the elastic scheduler (``serve/elastic.py``) batches the tenants,
refills drained lanes from the admission queue, and the shared registry
accumulates the lane-group occupancy telemetry.

The gate is :mod:`..obs.alerts` itself, not ad-hoc assertions: the soak
folds its client-side latency percentiles and 429-correctness counters
into registry gauges (``aircomp_soak_*``) and runs an
:class:`~..obs.alerts.AlertEngine` over the DEFAULT_RULES pack (which
includes ``lane_occupancy_floor``) plus the soak-specific SLO rules in
:data:`SOAK_RULES`.  Any rule firing fails the soak — the same
edge-triggered machinery a production deployment would page on.

SLOs gated:

* p99 admission latency (``POST /runs``) under ``--slo-admission-ms``
* p99 ``/metrics`` scrape latency under ``--slo-scrape-ms``
* 429 correctness: every 429 is a genuine queue-cap rejection (body
  says queue full, a cap is actually configured) and every accepted
  tenant eventually lands — zero misfires
* mean lane-group occupancy >= ``--slo-occupancy`` (the refill path
  keeps lanes fed under churny arrivals)
* one build per batched tenant (``lowerings`` 1: the signature contract
  holds under refill), zero failed runs, every run terminal

Where the queue can take every tenant (``--queue-cap`` 0 or at least
``--tenants``), the scheduler is held until the arrival phase ends
(``RunManager.hold``), so the seeded op sequence alone decides the group's
make-up: unheld, how many tenants land inside the first batch window
depends on the machine's load, and with few tenants a small first group's
drain tail can trip the occupancy floor.  A smaller cap leaves it unheld:
its 429'd tenants land only as the scheduler drains the queue.

The server runs its tenants on the card unless ``--device cpu``.  The JSON
report goes to ``--out`` (a path the caller gives) or stdout.

Usage::

    python -m byzantine_aircomp_tpu_torch.analysis.soak \\
        --tenants 64 --seed 7 --out soak_report.json
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

TERMINAL = ("completed", "failed", "cancelled")

#: soak-specific SLO rules, layered on obs/alerts.py DEFAULT_RULES.  The
#: metrics are gauges the soak itself maintains from client-side
#: measurements, so the gate runs through the exact alert machinery a
#: deployment would page on.  Thresholds are filled in from the CLI.
SOAK_RULES: List[Dict[str, Any]] = [
    {"name": "soak_admission_p99", "metric": "aircomp_soak_admission_p99_ms",
     "reduce": "last", "op": "gt", "value": None, "severity": "page"},
    # the server's own aircomp_http_request_seconds histogram, folded to
    # a gauge each tick — a slow server fires this even when the client
    # clock would excuse it (and vice versa); bucket-resolution p99
    {"name": "soak_server_admission_p99",
     "metric": "aircomp_soak_server_admission_p99_ms",
     "reduce": "last", "op": "gt", "value": None, "severity": "page"},
    {"name": "soak_scrape_p99", "metric": "aircomp_soak_scrape_p99_ms",
     "reduce": "last", "op": "gt", "value": None, "severity": "page"},
    {"name": "soak_429_misfires", "metric": "aircomp_soak_429_misfires_total",
     "reduce": "last", "op": "ge", "value": 1, "severity": "page",
     "absent": 0.0},
]


def _bucket_ceiling_ms(threshold_ms: float) -> float:
    """The smallest HTTP-histogram bucket edge (ms) at or above the
    client-side threshold — the fair server-side equivalent of a
    client SLO, given the histogram only resolves to bucket edges."""
    from ..obs.metrics import HTTP_SECONDS_BUCKETS

    for edge in HTTP_SECONDS_BUCKETS:
        if edge * 1e3 >= threshold_ms:
            return edge * 1e3
    return threshold_ms


def _percentile(samples: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (q in [0, 100]) — no numpy dependency so
    the report math is trivially auditable."""
    if not samples:
        return None
    s = sorted(samples)
    idx = max(0, min(len(s) - 1, int(round(q / 100.0 * len(s) + 0.5)) - 1))
    return s[idx]


def _latency_summary(samples: List[float]) -> Dict[str, Any]:
    return {
        "count": len(samples),
        "p50_ms": _percentile(samples, 50),
        "p95_ms": _percentile(samples, 95),
        "p99_ms": _percentile(samples, 99),
        "max_ms": max(samples) if samples else None,
    }


class _ListSink:
    """Event sink collecting alert events for the report."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def close(self) -> None:  # AlertEngine never closes its sink; parity
        pass


class _Client:
    """Thin timed HTTP client against the soak server."""

    def __init__(self, base: str) -> None:
        self.base = base

    def request(self, method: str, path: str, body=None, timeout=60.0):
        """Returns (status, parsed_json_or_text, latency_ms)."""
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method
        )
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                raw = resp.read()
                status = resp.status
        except urllib.error.HTTPError as exc:
            raw = exc.read()
            status = exc.code
        ms = (time.perf_counter() - t0) * 1000.0
        try:
            payload = json.loads(raw or b"{}")
        except ValueError:
            payload = raw.decode(errors="replace")
        return status, payload, ms


def build_rules(args) -> list:
    from ..obs.alerts import DEFAULT_RULES, Rule

    soak = []
    for spec in SOAK_RULES:
        spec = dict(spec)
        if spec["name"] == "soak_admission_p99":
            spec["value"] = float(args.slo_admission_ms)
        elif spec["name"] == "soak_server_admission_p99":
            # bucket-resolution quantile rounds UP to a bucket edge, so
            # the server-side gate gets the next edge above the client
            # SLO as headroom rather than a copy of the raw threshold
            spec["value"] = _bucket_ceiling_ms(float(args.slo_admission_ms))
        elif spec["name"] == "soak_scrape_p99":
            spec["value"] = float(args.slo_scrape_ms)
        soak.append(spec)
    return [Rule.from_dict(dict(d)) for d in DEFAULT_RULES + soak]


def run_soak(args, log=print) -> Dict[str, Any]:
    """Run one soak; returns the report dict (``report["ok"]`` is the
    gate).  The server lives in-process but ALL traffic goes over real
    HTTP on an ephemeral localhost port."""
    import random

    from ..data import datasets as data_lib
    from ..obs.alerts import AlertEngine
    from ..obs.sinks import EventSink
    from ..serve.server import ExperimentServer

    rng = random.Random(args.seed)
    dataset = data_lib.load(
        "mnist",
        synthetic_train=args.synthetic_train,
        synthetic_val=args.synthetic_val,
    )
    workdir = args.workdir or tempfile.mkdtemp(prefix="soak-")
    srv = ExperimentServer(
        workdir, port=0, host="127.0.0.1", dataset=dataset,
        batch_window=args.batch_window, queue_cap=args.queue_cap,
        device=args.device,
    ).start()
    client = _Client(f"http://127.0.0.1:{srv.port}")
    engine = AlertEngine(build_rules(args), srv.registry)
    alert_sink = _ListSink()

    base_overrides = dict(
        dataset="mnist", honest_size=6, byz_size=0,
        display_interval=args.interval, batch_size=16, agg="mean",
        eval_train=False,
    )

    lat: Dict[str, List[float]] = {
        "admission": [], "scrape": [], "swap": [], "cancel": [],
    }
    counts = {
        "submit_2xx": 0, "submit_429": 0, "cancels": 0, "swaps": 0,
        "swap_rejected_done": 0, "scrapes": 0, "ops": 0,
    }
    misfires: List[str] = []
    run_ids: List[str] = []
    occupancy_samples: List[float] = []
    ticks = [0]
    engine_lock = threading.Lock()

    class _RoundTap(EventSink):
        """Evaluates the alert pack once per group boundary at which a
        round runs (the per-round cadence the occupancy rule's window is
        written for), on the scheduler thread, right after the registry
        folded that boundary's ``lane_group`` event: every boundary is
        sampled once, in order, however loaded the machine.  (A client
        that polled the registry, as the JAX tool does, saw a boundary or
        not depending on its timing, and a group's closing boundary, where
        no lane is live and no round runs, now and then: with the final
        evaluation that stretched a short drain tail into the occupancy
        floor's 4-sample breach.)"""

        def emit(self, event: Dict[str, Any]) -> None:
            if event.get("kind") != "lane_group" or not event.get("live"):
                return
            with engine_lock:
                occupancy_samples.append(float(event["occupancy"]))
                _publish_gauges()
                engine.evaluate(ticks[0], alert_sink)
                ticks[0] += 1

    srv.manager.tap_scheduler(_RoundTap())

    def _tick_engine() -> None:
        """Refresh the soak's own gauges between boundaries (the client's
        latency percentiles, the 429 misfires)."""
        with engine_lock:
            _publish_gauges()

    def _publish_gauges() -> None:
        reg = srv.registry
        p99a = _percentile(lat["admission"], 99)
        if p99a is not None:
            reg.set("aircomp_soak_admission_p99_ms", p99a,
                    help_text="client-measured POST /runs p99 latency")
        p99s = _percentile(lat["scrape"], 99)
        if p99s is not None:
            reg.set("aircomp_soak_scrape_p99_ms", p99s,
                    help_text="client-measured /metrics p99 latency")
        sp99 = reg.quantile(
            "aircomp_http_request_seconds", 0.99, route="POST /runs"
        )
        if sp99 is not None:
            # +Inf bucket -> clamp to a loud finite sentinel (keeps the
            # gauge text and the JSON report strictly parseable)
            reg.set("aircomp_soak_server_admission_p99_ms",
                    min(sp99 * 1e3, 1e9),
                    help_text="server-measured POST /runs p99 latency "
                              "(bucket resolution)")
        reg.set("aircomp_soak_429_misfires_total", float(len(misfires)),
                help_text="429 responses that were not genuine "
                          "queue-cap rejections")

    def _submit() -> None:
        tenant = counts["submit_2xx"]
        overrides = dict(
            base_overrides,
            seed=1000 + tenant,
            # spread horizons so lanes drain at different rounds and the
            # refill path actually runs (rounds is per-lane, outside the
            # signature)
            rounds=args.rounds + rng.choice((0, 1, 2)),
            idempotency_key=f"soak-{args.seed}-{tenant}",
        )
        status, payload, ms = client.request("POST", "/runs", overrides)
        lat["admission"].append(ms)
        if status in (200, 201):
            counts["submit_2xx"] += 1
            run_ids.append(payload["run_id"])
        elif status == 429:
            counts["submit_429"] += 1
            err = payload.get("error", "") if isinstance(payload, dict) else ""
            if args.queue_cap <= 0:
                misfires.append(
                    f"429 with no queue cap configured: {err!r}"
                )
            elif "queue full" not in err:
                misfires.append(f"429 without queue-full body: {err!r}")
        else:
            misfires.append(f"submit returned {status}: {payload!r}")

    def _cancel() -> None:
        if not run_ids:
            return
        rid = rng.choice(run_ids)
        status, _, ms = client.request("POST", f"/runs/{rid}/cancel")
        lat["cancel"].append(ms)
        if status == 200:
            counts["cancels"] += 1
        else:
            misfires.append(f"cancel {rid} returned {status}")

    def _swap() -> None:
        if not run_ids:
            return
        rid = rng.choice(run_ids)
        gamma = round(rng.uniform(0.005, 0.02), 6)
        status, payload, ms = client.request(
            "POST", f"/runs/{rid}/knobs", {"gamma": gamma}
        )
        lat["swap"].append(ms)
        if status == 200:
            counts["swaps"] += 1
        elif status == 400:
            # swapping a finished run is a client race, not a server bug
            counts["swap_rejected_done"] += 1
        else:
            misfires.append(f"swap {rid} returned {status}")

    def _scrape() -> None:
        status, _, ms = client.request("GET", "/metrics")
        lat["scrape"].append(ms)
        if status == 200:
            counts["scrapes"] += 1
        else:
            misfires.append(f"/metrics returned {status}")

    t_start = time.perf_counter()
    deadline = t_start + args.max_secs
    hold = args.queue_cap == 0 or args.queue_cap >= args.tenants
    if hold:
        srv.manager.hold()
    try:
        # ---- phase 1: churny arrivals until the tenant budget lands
        while counts["submit_2xx"] < args.tenants:
            if time.perf_counter() > deadline:
                misfires.append(
                    f"arrival phase exceeded --max-secs {args.max_secs}"
                )
                break
            r = rng.random()
            if r < args.cancel_frac:
                _cancel()
            elif r < args.cancel_frac + args.swap_frac:
                _swap()
            elif r < args.cancel_frac + args.swap_frac + args.scrape_frac:
                _scrape()
            else:
                _submit()
            counts["ops"] += 1
            _tick_engine()
            time.sleep(rng.expovariate(1000.0 / args.arrival_ms))
        if hold:
            # every arrival has landed (or been cancelled while queued):
            # the scheduler groups them all in its first drain
            srv.manager.release()

        # ---- phase 2: keep scraping/swapping until every run is done
        while time.perf_counter() < deadline:
            status, payload, _ = client.request("GET", "/runs")
            runs = payload.get("runs", []) if isinstance(payload, dict) else []
            if runs and all(r["status"] in TERMINAL for r in runs):
                break
            if rng.random() < 0.5:
                _scrape()
            else:
                _swap()
            counts["ops"] += 1
            _tick_engine()
            time.sleep(args.arrival_ms / 1000.0)
        else:
            misfires.append(f"drain exceeded --max-secs {args.max_secs}")

        wall = time.perf_counter() - t_start
        _, listing, _ = client.request("GET", "/runs")
        infos = listing.get("runs", [])

        # ---- final evaluation: gauges current, one last engine pass (the
        # JAX tool runs two here, the second over the same gauges: a sample
        # of a lane group that has ended, twice, which stretches a 2-round
        # drain tail into the occupancy floor's 4-sample breach that the
        # per-sample cadence of _tick_engine is written to avoid)
        with engine_lock:
            _publish_gauges()
            summary = engine.finalize(ticks[0], alert_sink)
    finally:
        srv.close()
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)

    by_status: Dict[str, int] = {}
    for info in infos:
        by_status[info["status"]] = by_status.get(info["status"], 0) + 1
    bad_lowerings = [
        info["run_id"] for info in infos
        if info["status"] == "completed" and info.get("lowerings") != 1
    ]
    refills = srv.registry.value("aircomp_lane_refills_total") or 0
    occ_mean = (
        sum(occupancy_samples) / len(occupancy_samples)
        if occupancy_samples else None
    )

    sp99 = srv.registry.quantile(
        "aircomp_http_request_seconds", 0.99, route="POST /runs"
    )
    server_p99_ms = None if sp99 is None else min(sp99 * 1e3, 1e9)
    server_slo_ms = _bucket_ceiling_ms(float(args.slo_admission_ms))

    slos = [
        {"name": "admission_p99_ms",
         "value": _percentile(lat["admission"], 99),
         "threshold": args.slo_admission_ms,
         "ok": (_percentile(lat["admission"], 99) or 0.0)
         <= args.slo_admission_ms},
        # the same SLO measured from the other side of the socket: the
        # server's own route histogram must agree with the client clock
        {"name": "server_admission_p99_ms",
         "value": server_p99_ms,
         "threshold": server_slo_ms,
         "ok": server_p99_ms is not None
         and server_p99_ms <= server_slo_ms},
        {"name": "scrape_p99_ms",
         "value": _percentile(lat["scrape"], 99),
         "threshold": args.slo_scrape_ms,
         "ok": (_percentile(lat["scrape"], 99) or 0.0)
         <= args.slo_scrape_ms},
        {"name": "429_misfires", "value": len(misfires), "threshold": 0,
         "ok": not misfires},
        {"name": "all_terminal",
         "value": by_status,
         "threshold": f"{args.tenants} accepted, none failed",
         "ok": (
             counts["submit_2xx"] == args.tenants
             and by_status.get("failed", 0) == 0
             and sum(by_status.values()) == len(run_ids)
             and all(i["status"] in TERMINAL for i in infos)
         )},
        {"name": "one_lowering_per_tenant", "value": bad_lowerings,
         "threshold": [], "ok": not bad_lowerings},
        {"name": "occupancy_mean", "value": occ_mean,
         "threshold": args.slo_occupancy,
         "ok": occ_mean is not None and occ_mean >= args.slo_occupancy},
        {"name": "alerts_fired", "value": summary["total_fired"],
         "threshold": 0, "ok": summary["total_fired"] == 0},
    ]
    report = {
        "soak": {
            "seed": args.seed, "tenants": args.tenants,
            "rounds": args.rounds, "arrival_ms": args.arrival_ms,
            "cancel_frac": args.cancel_frac, "swap_frac": args.swap_frac,
            "scrape_frac": args.scrape_frac, "queue_cap": args.queue_cap,
            "synthetic_train": args.synthetic_train,
            "synthetic_val": args.synthetic_val,
            "interval": args.interval, "device": args.device,
            "wall_secs": round(wall, 3),
        },
        "traffic": dict(counts),
        "latency_ms": {k: _latency_summary(v) for k, v in lat.items()},
        "scheduler": {
            "occupancy_mean": occ_mean,
            "occupancy_min": (
                min(occupancy_samples) if occupancy_samples else None
            ),
            "lane_group_samples": len(occupancy_samples),
            "lane_refills": refills,
        },
        "outcomes": by_status,
        "misfires": misfires,
        "alerts": summary,
        "alert_events": [
            {k: e[k] for k in ("rule", "round", "value", "firing")}
            for e in alert_sink.events
        ],
        "slos": slos,
        "ok": all(s["ok"] for s in slos),
    }
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "byzantine_aircomp_tpu_torch.analysis.soak",
        description="SLO-gated traffic soak of the serving HTTP surface",
    )
    p.add_argument("--seed", type=int, default=7,
                   help="arrival-process seed (the soak is replayable)")
    p.add_argument("--tenants", type=int, default=64,
                   help="tenant submissions to land")
    p.add_argument("--rounds", type=int, default=2,
                   help="base per-tenant rounds (each tenant draws "
                        "base + {0,1,2} so lanes drain and refill)")
    p.add_argument("--interval", type=int, default=10,
                   help="iterations per round of every tenant (the JAX tool "
                        "runs 10000, one scan a round; here every iteration is "
                        "host-dispatched, so the default is 10)")
    p.add_argument("--arrival-ms", type=float, default=25.0,
                   help="mean exponential inter-arrival time")
    p.add_argument("--batch-window", type=float, default=0.05,
                   help="seconds the scheduler waits after a submission before "
                        "it groups the queue (the JAX tool's fixed 0.05)")
    p.add_argument("--cancel-frac", type=float, default=0.05,
                   help="fraction of ops that cancel a random run")
    p.add_argument("--swap-frac", type=float, default=0.15,
                   help="fraction of ops that hot-swap a gamma knob")
    p.add_argument("--scrape-frac", type=float, default=0.2,
                   help="fraction of ops that scrape /metrics")
    p.add_argument("--queue-cap", type=int, default=0,
                   help="admission queue cap (0 = unlimited; >0 "
                        "exercises 429 backpressure)")
    p.add_argument("--synthetic-train", type=int, default=600)
    p.add_argument("--synthetic-val", type=int, default=200)
    p.add_argument("--slo-admission-ms", type=float, default=250.0)
    p.add_argument("--slo-scrape-ms", type=float, default=500.0)
    p.add_argument("--slo-occupancy", type=float, default=0.9)
    p.add_argument("--max-secs", type=float, default=600.0,
                   help="hard wall-clock budget; exceeding it is an "
                        "SLO failure, not a hang")
    p.add_argument("--workdir", default=None,
                   help="server root (default: fresh temp dir, removed)")
    p.add_argument("--out", default=None,
                   help="write the JSON report here (default: stdout)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the server's device: cuda (default) or cpu")
    args = p.parse_args(argv)

    report = run_soak(args)
    text = json.dumps(report, indent=1, sort_keys=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"soak report -> {args.out}")
    else:
        print(text)
    for slo in report["slos"]:
        state = "ok  " if slo["ok"] else "FAIL"
        print(f"  [{state}] {slo['name']}: {slo['value']} "
              f"(threshold {slo['threshold']})", file=sys.stderr)
    print(
        f"soak: {'PASS' if report['ok'] else 'FAIL'} "
        f"({report['traffic']['ops']} ops, "
        f"{report['soak']['wall_secs']}s)",
        file=sys.stderr,
    )
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
