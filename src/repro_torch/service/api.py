"""HTTP front end for the campaign service (stdlib-only).

Endpoints (JSON in/out):

    POST /campaigns              {spec fields}        -> {"id": ...}
                                 {"strategy": "bo"} picks the explorer
                                 (any core.strategies registry name);
                                 with {"hierarchical": true, "accel":
                                 <staged pipeline>, "stages": [...]} the
                                 job runs the hierarchical search (one
                                 concurrent campaign per stage, composed
                                 + end-to-end verified front)
    POST /campaigns/<id>/cancel  -> stop at the next tick boundary
                                    (snapshot kept)
    POST /campaigns/<id>/resume  -> continue a cancelled/failed/killed
                                    campaign from its latest snapshot
    GET  /campaigns              -> [{id, state, accel, strategy}, ...]
    GET  /campaigns/<id>         -> status record; running campaigns
                                    carry live "progress" (stage,
                                    strategy, generation, labels spent)
    GET  /campaigns/<id>/result  -> summary (val_pcc, timings, front size)
    GET  /campaigns/<id>/front   -> the campaign's true Pareto front
    GET  /campaigns/<id>/timeline-> per-tick search telemetry (live
                                    hypervolume vs a frozen reference,
                                    front size, labels requested/served,
                                    store reuse rate, stage)
    GET  /front?accel=<name>     -> merged non-dominated front over every
                                    completed campaign for that accelerator
    GET  /strategies             -> registered explorer names
    GET  /stats                  -> the labeling economy in one blob:
                                    label-store hits, in-flight dedup
                                    hits, coalesced batches, per-backend
                                    labeler counters (incl. process-pool
                                    worker synthesis counters), synth-
                                    cache hit rate + verification state,
                                    surrogate registry counters, and —
                                    under the fleet backend — the fleet:
                                    registered workers, last-heartbeat
                                    ages, leases in flight, requeues,
                                    per-worker labels/sec
    GET  /metrics                -> Prometheus text exposition of the
                                    same counters /stats renders as JSON
                                    (scheduler, labeler, store, synth,
                                    fleet, worker instruments)
    POST /serve                  {"accel": <name>, "inputs": [...],
                                  "tier": "exact|balanced|budget" |
                                  "budget": {"energy": <=x, "qor": >=y} |
                                  "pin_version": <n>, "gen": <lm tokens>}
                                 -> one inference through the serving
                                    tier: the accelerator's engine picks
                                    the operating point off the merged
                                    front (409 until some campaign has
                                    produced one), batches concurrent
                                    requests per point, and returns the
                                    result + genome/labels/catalog
                                    version it served at
    GET  /serving/stats          -> per-engine serving counters
                                    (requests, tier selections, hot
                                    swaps, queue depth, catalog tiers)
    GET  /healthz                -> {"ok": true}

With ``--eval-backend fleet`` the embedded orchestrator's worker
protocol is mounted too (``repro_torch.fleet``; 404 otherwise):

    POST /fleet/register         -> join/rejoin the labeling fleet
    POST /fleet/heartbeat        -> keep-alive (+ verified fingerprints)
    POST /fleet/lease            -> pull one leased genome chunk
    POST /fleet/result           -> stream a chunk's labels back

Run it with ``python -m repro_torch.service`` (see __main__.py).  ``Client``
is a matching urllib convenience wrapper used by the examples/tests.
"""

from __future__ import annotations

import json
import re
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

from .. import obs
from .campaigns import CampaignManager, CampaignSpec, HierarchicalSpec

__all__ = ["make_server", "serve", "Client"]

_log = obs.get_logger("service")


def _campaign_summary(mgr: CampaignManager, cid: str) -> Dict:
    status = mgr.status(cid)
    if status["state"] != "done":
        return status
    res = mgr.result(cid)
    status["front"] = res.front_objectives.tolist()
    # compacted results keep only the front but remember the true count
    status["n_designs"] = int(getattr(res, "n_designs",
                                      len(res.true_objectives)))
    return status


class _Handler(BaseHTTPRequestHandler):
    # set by make_server:
    manager: CampaignManager = None
    quiet: bool = True

    def log_message(self, fmt, *args):  # noqa: A003 - BaseHTTPRequestHandler API
        if not self.quiet:
            super().log_message(fmt, *args)

    # ------------------------------------------------------------------
    def _send(self, obj, code: int = 200) -> None:
        body = json.dumps(obj, default=float).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, msg: str) -> None:
        self._send({"error": msg}, code)

    def _route(self) -> Tuple[str, Dict[str, str]]:
        path, _, query = self.path.partition("?")
        params = {k: v[0] for k, v in urllib.parse.parse_qs(query).items()}
        return path.rstrip("/") or "/", params

    # ------------------------------------------------------------------
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        mgr = self.manager
        path, params = self._route()
        try:
            if path == "/healthz":
                return self._send({"ok": True})
            if path == "/health":
                h = mgr.health()
                return self._send(h, 200 if h.get("ok") else 503)
            if path == "/metrics":
                body = obs.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return None
            if path == "/strategies":
                from ..core.strategies import available_strategies

                return self._send({"strategies": available_strategies()})
            if path == "/stats":
                return self._send(mgr.stats())
            if path == "/serving/stats":
                return self._send(mgr.serving_stats())
            if path == "/fleet/stats":
                fleet = getattr(mgr.scheduler, "fleet", None)
                if fleet is None:
                    return self._error(404, "fleet backend not enabled "
                                            "(start with --eval-backend fleet)")
                return self._send(fleet.stats())
            if path == "/campaigns":
                return self._send(mgr.list_campaigns())
            if path == "/front":
                accel = params.get("accel")
                if not accel:
                    return self._error(400, "missing ?accel=<name>")
                objectives = tuple(
                    params["objectives"].split(",")
                ) if params.get("objectives") else ("qor", "energy")
                return self._send(mgr.global_front(accel, objectives))
            m = re.fullmatch(r"/campaigns/([\w-]+)"
                             r"(/result|/front|/timeline)?", path)
            if m:
                cid, sub = m.group(1), m.group(2)
                if sub == "/front":
                    return self._send(mgr.front(cid))
                if sub == "/result":
                    return self._send(_campaign_summary(mgr, cid))
                if sub == "/timeline":
                    return self._send(mgr.campaign_timeline(cid))
                return self._send(mgr.status(cid))
            return self._error(404, f"no route {path}")
        except KeyError:
            return self._error(404, "unknown campaign")
        except RuntimeError as exc:
            return self._error(409, str(exc))
        except Exception as exc:  # noqa: BLE001 - JSON 500 over a torn socket
            return self._error(500, f"{type(exc).__name__}: {exc}")

    def do_POST(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path, _ = self._route()
        m = re.fullmatch(r"/fleet/(register|heartbeat|lease|result)", path)
        if m:
            from ..fleet.orchestrator import handle_fleet_request

            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("fleet payload must be a JSON object")
                fleet = getattr(self.manager.scheduler, "fleet", None)
                code, obj = handle_fleet_request(fleet, m.group(1), payload)
                return self._send(obj, code)
            except (json.JSONDecodeError, TypeError, ValueError) as exc:
                return self._error(400, f"bad fleet payload: {exc}")
            except Exception as exc:  # noqa: BLE001 - JSON 500
                return self._error(500, f"{type(exc).__name__}: {exc}")
        if path == "/serve":
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("serve payload must be a JSON object")
                accel = payload.get("accel")
                if not accel:
                    raise ValueError('missing "accel"')
                if "inputs" not in payload:
                    raise ValueError('missing "inputs"')
                import numpy as np

                from ..serving import EmptyFrontError, NoFrontError
                from ..serving.engine import (DeadlineExceeded,
                                              OverloadedError)

                objectives = (tuple(payload["objectives"])
                              if payload.get("objectives") else None)
                try:
                    with obs.span("serving.http", accel=accel):
                        eng = self.manager.serving.engine_for(
                            accel, objectives,
                            rank_genes=bool(payload.get("rank_genes")),
                        )
                        result = eng.serve(
                            np.asarray(payload["inputs"]),
                            tier=payload.get("tier"),
                            budget=payload.get("budget"),
                            pin_version=payload.get("pin_version"),
                            gen=payload.get("gen"),
                            return_outputs=bool(
                                payload.get("return_outputs")),
                            deadline_s=payload.get("deadline_s"),
                        )
                except (NoFrontError, EmptyFrontError) as exc:
                    # no completed campaign has produced a front yet:
                    # a state conflict, not a malformed request
                    return self._error(409, str(exc))
                except OverloadedError as exc:
                    # bounded-queue backpressure: retriable — the
                    # fleet http client retries 429 with backoff
                    return self._error(429, str(exc))
                except DeadlineExceeded as exc:
                    return self._error(504, str(exc))
                return self._send(result)
            except (json.JSONDecodeError, TypeError, ValueError) as exc:
                return self._error(400, f"bad serve request: {exc}")
            except Exception as exc:  # noqa: BLE001 - JSON 500
                return self._error(500, f"{type(exc).__name__}: {exc}")
        m = re.fullmatch(r"/campaigns/([\w-]+)/(cancel|resume)", path)
        if m:
            cid, action = m.group(1), m.group(2)
            try:
                if action == "cancel":
                    self.manager.cancel(cid)
                    return self._send({"id": cid, "state": "cancelling"})
                self.manager.resume(cid)
                return self._send({"id": cid, "state": "queued"}, 202)
            except KeyError:
                return self._error(404, "unknown campaign")
            except RuntimeError as exc:
                return self._error(409, str(exc))
            except Exception as exc:  # noqa: BLE001 - JSON 500
                return self._error(500, f"{type(exc).__name__}: {exc}")
        if path != "/campaigns":
            return self._error(404, f"no route {path}")
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(payload, dict):
                raise ValueError("campaign spec must be a JSON object")
            # submit() validates the spec (unknown accelerator, malformed
            # sizes) and raises ValueError -> 400 here, instead of the
            # campaign failing asynchronously in a worker thread
            if payload.get("hierarchical"):
                spec = HierarchicalSpec.from_dict(payload)
                cid = self.manager.submit_hierarchical(spec)
            else:
                spec = CampaignSpec.from_dict(payload)
                cid = self.manager.submit(spec)
        except (json.JSONDecodeError, TypeError, ValueError) as exc:
            return self._error(400, f"bad campaign spec: {exc}")
        except Exception as exc:  # noqa: BLE001 - JSON 500 over a torn socket
            return self._error(500, f"{type(exc).__name__}: {exc}")
        self._send({"id": cid, "state": "queued"}, 202)


def make_server(
    manager: CampaignManager,
    host: str = "127.0.0.1",
    port: int = 8177,
    *,
    quiet: bool = True,
) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"manager": manager, "quiet": quiet})
    return ThreadingHTTPServer((host, port), handler)


def serve(manager, host="127.0.0.1", port=8177, *, quiet=False) -> None:
    if not obs.get_logger().handlers:  # CLI sets its own level first
        obs.setup_logging("info")
    srv = make_server(manager, host, port, quiet=quiet)
    _log.info("listening on http://%s:%s", host, srv.server_address[1])
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        _log.info("shutting down")
    finally:
        srv.server_close()
        manager.shutdown()


class Client:
    """Minimal stdlib client for the service API.

    Rides ``repro_torch.fleet.http.request_json``: GETs retry transient
    transport errors and 429/5xx with exponential backoff + jitter;
    POSTs are NOT retried (``retries=0``) because campaign submission
    is not idempotent — a retried submit after a torn response would
    start a second campaign."""

    def __init__(self, base: str, *, timeout: float = 600.0, retries: int = 4):
        self.base = base.rstrip("/")
        self.timeout = float(timeout)
        self.retries = int(retries)

    def _req(self, path: str, payload: Optional[Dict] = None):
        from ..fleet.http import request_json

        return request_json(
            self.base + path, payload, timeout=self.timeout,
            retries=self.retries if payload is None else 0,
        )

    def submit(self, **spec) -> str:
        return self._req("/campaigns", spec)["id"]

    def submit_hierarchical(self, **spec) -> str:
        return self._req("/campaigns", {**spec, "hierarchical": True})["id"]

    def status(self, cid: str) -> Dict:
        return self._req(f"/campaigns/{cid}")

    def cancel(self, cid: str) -> Dict:
        return self._req(f"/campaigns/{cid}/cancel", {})

    def resume(self, cid: str) -> Dict:
        return self._req(f"/campaigns/{cid}/resume", {})

    def strategies(self) -> list:
        return self._req("/strategies")["strategies"]

    def result(self, cid: str) -> Dict:
        return self._req(f"/campaigns/{cid}/result")

    def front(self, cid: str) -> Dict:
        return self._req(f"/campaigns/{cid}/front")

    def timeline(self, cid: str) -> Dict:
        return self._req(f"/campaigns/{cid}/timeline")

    def metrics(self) -> str:
        """Raw Prometheus text from GET /metrics."""
        import urllib.request

        with urllib.request.urlopen(self.base + "/metrics",
                                    timeout=self.timeout) as resp:
            return resp.read().decode()

    def global_front(self, accel: str,
                     objectives: Optional[Tuple[str, ...]] = None) -> Dict:
        q = f"/front?accel={accel}"
        if objectives:
            q += "&objectives=" + ",".join(objectives)
        return self._req(q)

    def stats(self) -> Dict:
        return self._req("/stats")

    def health(self) -> Dict:
        """GET /health: readiness blob with ``ok``.  A degraded service
        answers 503 with the same body — returned, not raised, so a
        probe loop can inspect WHAT is unhealthy."""
        from ..fleet.http import HttpError, request_json

        try:
            # no retries: a liveness probe wants the answer NOW
            return request_json(self.base + "/health",
                                timeout=self.timeout, retries=0)
        except HttpError as exc:
            if exc.code == 503 and "ok" in (exc.detail or ""):
                import json as _json

                try:
                    return _json.loads(exc.detail)
                except ValueError:
                    pass
            raise

    def serve(self, accel: str, inputs, **kw) -> Dict:
        """One inference through the serving tier.  ``inputs`` is a
        batch of accelerator inputs (or an LM prompt token list);
        keywords pass through: tier=, budget=, pin_version=, gen=,
        return_outputs=, objectives=, rank_genes=."""
        import numpy as np

        if isinstance(inputs, np.ndarray):
            inputs = inputs.tolist()
        return self._req("/serve", {"accel": accel, "inputs": inputs, **kw})

    def serving_stats(self) -> Dict:
        return self._req("/serving/stats")

    def wait(self, cid: str, timeout: float = 600.0, poll: float = 0.25) -> Dict:
        import time

        t0 = time.time()
        while True:
            st = self.status(cid)
            if st["state"] in ("done", "failed") or time.time() - t0 > timeout:
                return st
            time.sleep(poll)
