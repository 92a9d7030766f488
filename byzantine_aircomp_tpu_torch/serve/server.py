"""The experiment server: a stdlib HTTP control plane over one port.

The port of ``byzantine_aircomp_tpu/serve/server.py``: the same routes,
status codes and JSON keys.

Rides the :class:`~..obs.exporter.MetricsExporter` routes hook, so a
single socket serves both surfaces — the Prometheus scrape endpoints the
repo already had (``/metrics``, ``/healthz``) and the multi-tenant run
API this module adds:

* ``POST /runs``              — submit a run (body: FedConfig overrides
  as JSON; same coercion rules as the CLI's ``--set``); returns 201 with
  the run's info including its server-assigned ``run_id``
* ``GET  /runs``              — list every run with status/progress
* ``GET  /runs/<id>``         — one run's info
* ``POST /runs/<id>/cancel``  — cancel (queued: immediate; running: the
  lane goes dark at the next round boundary)
* ``POST /runs/<id>/knobs``   — hot-swap batchable knobs between rounds
  (body: ``{"gamma": 0.05, ...}``); a swap writes the lane's knob and
  never rebuilds the group

Tenancy: every run writes only under ``<obs_root>/<run_id>/`` (events,
checkpoints, caches), and its metrics carry a ``run_id`` label in the
shared registry, so one ``/metrics`` scrape shows
``aircomp_events_total{kind="round",run_id="run-0001"}`` per tenant.
Errors map conventionally: unknown run -> 404, contract/knob/body
violations -> 400 with ``{"error": ...}``, a full admission queue -> 429,
a mutating request without the ``--auth-token`` bearer -> 401.

The server runs its tenants on ``device`` (``cuda`` unless the caller
asks for the CPU); a body may not name ``use_gpu``, the server's.  The
lanes of a group run in turn on one stream (``serve/batch.py``).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Optional, Tuple

from .. import obs as obs_lib
from ..fed.config import config_from_mapping
from ..obs.metrics import HTTP_SECONDS_BUCKETS
from ..obs.trace import parse_traceparent
from .runs import QueueFull, RunManager

_JSON = "application/json"


class ExperimentServer:
    """RunManager + shared metrics registry + one HTTP surface."""

    def __init__(
        self,
        obs_root: str,
        port: int = 0,
        host: str = "0.0.0.0",
        dataset=None,
        backend: str = "vmap",
        batch_window: float = 0.25,
        queue_cap: int = 0,
        run_retries: int = 1,
        run_backoff: float = 2.0,
        wedge_secs: float = 0.0,
        recover: bool = True,
        auth_token: Optional[str] = None,
        device: str = "cuda",
    ) -> None:
        # optional bearer auth on the MUTATING surface only: submissions,
        # cancels and knob swaps change tenant state, so they 401 without
        # the token; /metrics, /healthz and the read-only GETs stay open
        # for scrapers and dashboards
        self.auth_token = auth_token
        self.registry = obs_lib.MetricsRegistry()
        self.manager = RunManager(
            obs_root,
            registry=self.registry,
            dataset=dataset,
            backend=backend,
            batch_window=batch_window,
            queue_cap=queue_cap,
            run_retries=run_retries,
            run_backoff=run_backoff,
            wedge_secs=wedge_secs,
            device=device,
        )
        if recover:
            # replay the durable journal BEFORE serving: terminal runs
            # are re-adopted as facts, in-flight runs requeue and resume
            # from their last checkpoint
            self.manager.recover()
        self.exporter = obs_lib.MetricsExporter(
            self.registry,
            port=port,
            host=host,
            health_fn=self._health,
            routes=self._routes,
        )

    @property
    def port(self) -> Optional[int]:
        return self.exporter.port

    def start(self) -> "ExperimentServer":
        self.manager.start()
        self.exporter.start()
        return self

    def close(self) -> None:
        self.exporter.close()
        self.manager.close()

    def __enter__(self) -> "ExperimentServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ routes

    def _health(self) -> Dict[str, Any]:
        counts: Dict[str, int] = {}
        for info in self.manager.list_runs():
            counts[info["status"]] = counts.get(info["status"], 0) + 1
        reason = self.manager.degraded()
        body: Dict[str, Any] = {"ok": reason is None, "runs": counts}
        if reason is not None:
            # the exporter maps ok=False to HTTP 503 — a wedged run
            # degrades the whole service until requeued or failed
            body["reason"] = reason
        return body

    @staticmethod
    def _json(status: int, payload: Any) -> Tuple[int, str, bytes]:
        return status, _JSON, (json.dumps(payload) + "\n").encode()

    def _authorized(self, headers: Dict[str, str]) -> bool:
        if self.auth_token is None:
            return True
        auth = headers.get("authorization", "")
        supplied = auth[7:] if auth.startswith("Bearer ") else ""
        # constant-time compare — a token check that leaks prefix length
        # through timing is not a token check
        import hmac as _hmac

        return _hmac.compare_digest(supplied, self.auth_token)

    def _routes(
        self, method: str, path: str, body: bytes,
        headers: Optional[Dict[str, str]] = None,
    ) -> Optional[Tuple[int, str, bytes]]:
        """The exporter's extra-route hook; ``None`` falls through to the
        built-in ``/metrics``/``/healthz`` handling."""
        path = path.split("?", 1)[0]
        # normalize ONCE, before the auth gate: the dispatcher drops
        # empty segments, so gating on the raw path would let
        # ``POST //runs`` skip auth yet still dispatch
        parts = [p for p in path.split("/") if p]
        if (
            method == "POST"
            and parts[:1] == ["runs"]
            and not self._authorized(headers or {})
        ):
            return self._json(401, {"error": "unauthorized"})
        # W3C-style trace continuity: a client that stamps its submit /
        # cancel / knob-swap with ``traceparent`` sees its trace id on
        # every event the request produces (only for --trace on tenants;
        # untraced streams stay byte-identical)
        traceparent = parse_traceparent((headers or {}).get("traceparent"))
        t0 = time.perf_counter()
        try:
            out = self._dispatch(method, parts, body, traceparent)
        except KeyError as exc:
            out = self._json(404, {"error": str(exc).strip("'\"")})
        except QueueFull as exc:  # backpressure, not a client error
            out = self._json(429, {"error": str(exc)})
        except ValueError as exc:  # includes json.JSONDecodeError
            out = self._json(400, {"error": str(exc)})
        except Exception as exc:  # noqa: BLE001 — surface, don't kill the thread
            out = self._json(
                500, {"error": f"{type(exc).__name__}: {exc}"}
            )
        if out is not None:
            # server-measured request latency, by route template (never
            # the raw path — run ids would explode the label space).
            # This is what the soak harness cross-checks its client-side
            # p99 against: a slow server is visible between soaks too.
            self.registry.observe(
                "aircomp_http_request_seconds",
                time.perf_counter() - t0,
                buckets=HTTP_SECONDS_BUCKETS,
                help_text="server-side run-API request latency by route",
                route=self._route_label(method, parts),
            )
        return out

    @staticmethod
    def _route_label(method: str, parts: list) -> str:
        if parts[:1] != ["runs"]:
            return "other"
        if len(parts) == 1:
            return f"{method} /runs"
        if len(parts) == 2:
            return f"{method} /runs/<id>"
        if len(parts) == 3 and parts[2] in ("cancel", "knobs"):
            return f"{method} /runs/<id>/{parts[2]}"
        return "other"

    def _dispatch(
        self, method: str, parts: list, body: bytes,
        traceparent: Optional[Tuple[str, str]] = None,
    ) -> Optional[Tuple[int, str, bytes]]:
        if not parts or parts[0] != "runs":
            return None
        mgr = self.manager
        if len(parts) == 1:
            if method == "POST":
                overrides = json.loads(body.decode() or "{}")
                if not isinstance(overrides, dict):
                    raise ValueError(
                        "POST /runs body must be a JSON object of "
                        "FedConfig overrides"
                    )
                # a client-supplied idempotency key makes submit retries
                # safe: the same key returns the original run (200), a
                # fresh key creates one (201)
                key = overrides.pop("idempotency_key", None)
                if key is not None and not isinstance(key, str):
                    raise ValueError("idempotency_key must be a string")
                run_id, created = mgr.submit_idempotent(
                    config_from_mapping(overrides, use_gpu=mgr.device == "cuda"),
                    key=key,
                    traceparent=traceparent,
                )
                return self._json(201 if created else 200, mgr.get(run_id))
            if method == "GET":
                return self._json(200, {"runs": mgr.list_runs()})
        elif len(parts) == 2 and method == "GET":
            return self._json(200, mgr.get(parts[1]))
        elif len(parts) == 3 and parts[2] == "cancel" and method == "POST":
            return self._json(
                200, mgr.cancel(parts[1], traceparent=traceparent)
            )
        elif len(parts) == 3 and parts[2] == "knobs" and method == "POST":
            swaps = json.loads(body.decode() or "{}")
            if not isinstance(swaps, dict) or not swaps:
                raise ValueError(
                    "POST /runs/<id>/knobs body must be a non-empty JSON "
                    "object {knob: value}"
                )
            info = None
            for knob, value in swaps.items():
                info = mgr.swap(
                    parts[1], knob, value, traceparent=traceparent
                )
            return self._json(200, info)
        return None
