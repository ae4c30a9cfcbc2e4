"""Stdlib HTTP client with bounded retry, backoff, breaker + deadline.

Every HTTP edge in the fleet (worker registration, lease polling, result
streaming, heartbeats) and the service ``Client`` rides this one helper
instead of growing its own ad-hoc ``urllib`` code.  Retries cover the
transient failures a fleet actually sees — connection refused while the
orchestrator restarts, a dropped socket, a 502/503/504 from a proxy —
with exponential backoff and full jitter so a rejoining fleet does not
synchronize into a thundering herd.

Two graceful-degradation guards bound the worst case:

  * ``total_deadline_s`` caps the WHOLE call — attempts plus backoff
    sleeps — so a caller with its own SLA (a heartbeat loop, a serving
    request) can never be wedged by a slow storm of retries.
  * a :class:`CircuitBreaker` (optional, shared by a caller across its
    calls) fails fast while a peer is melting down: after ``threshold``
    consecutive failures the circuit opens and calls raise immediately
    (``HttpError`` with ``circuit_open`` detail) until ``reset_s`` has
    passed, then one probe call half-opens it.

Retrying a POST is safe here because every fleet POST is idempotent by
construction: registration and heartbeats are upserts, a duplicated
lease request just creates an extra lease that expires and requeues,
and a duplicated result commits content-addressed labels that dedupe to
zero bytes.  Callers with genuinely non-idempotent POSTs (e.g. campaign
submission) pass ``retries=0``.

The ``http.request`` fault point fires once per *attempt*, so an
injected 503 burst exercises exactly the retry/backoff/breaker path a
real storm would.
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Optional

from .. import faults, obs

__all__ = ["CircuitBreaker", "HttpError", "request_json"]

# HTTP statuses worth retrying: the server (or a proxy in front of it)
# says "not right now", not "you are wrong"
RETRY_STATUSES = (429, 502, 503, 504)


class HttpError(urllib.error.HTTPError):
    """A non-retryable (or retries-exhausted) HTTP failure.

    Subclasses ``urllib.error.HTTPError`` so callers written against the
    raw urllib wrapper (``except urllib.error.HTTPError as e: e.code``)
    keep working unchanged.  ``code``/``status`` is ``None`` for pure
    transport failures (connection refused, timeout) where no HTTP
    response ever arrived; ``detail`` carries the server's decoded JSON
    ``error`` field when it sent one."""

    def __init__(self, url: str, status: Optional[int], detail: str):
        super().__init__(url, status, detail, None, None)
        self.url = url
        self.detail = detail

    def __str__(self):
        if self.code is None:
            return f"{self.url}: {self.detail}"
        return f"{self.url}: HTTP {self.code}: {self.detail}"


class CircuitBreaker:
    """Consecutive-failure circuit: closed → open → half-open.

    Thread-safe and deliberately simple: ``threshold`` consecutive
    failures open the circuit for ``reset_s`` seconds, during which
    :meth:`allow` is False (callers fail fast instead of queueing up
    behind timeouts).  After ``reset_s`` ONE caller is admitted as the
    half-open probe; its success closes the circuit, its failure
    re-opens the clock."""

    def __init__(self, *, threshold: int = 5, reset_s: float = 10.0,
                 name: str = ""):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self.name = name
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self.opens = obs.REGISTRY.counter(
            "repro_http_breaker_opens_total",
            "circuit breaker transitions to open")
        self.fast_fails = obs.REGISTRY.counter(
            "repro_http_breaker_fast_fails_total",
            "calls refused while the circuit was open")

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if time.monotonic() - self._opened_at >= self.reset_s:
                return "half_open"
            return "open"

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if time.monotonic() - self._opened_at < self.reset_s:
                self.fast_fails.inc()
                return False
            if self._probing:  # one probe at a time in half-open
                self.fast_fails.inc()
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._opened_at is not None:
                # failed half-open probe: restart the open window
                self._opened_at = time.monotonic()
            elif self._failures >= self.threshold:
                self._opened_at = time.monotonic()
                self.opens.inc()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": ("closed" if self._opened_at is None else
                          ("half_open" if time.monotonic() - self._opened_at
                           >= self.reset_s else "open")),
                "failures": self._failures,
                "opens": int(self.opens.value),
                "fast_fails": int(self.fast_fails.value),
            }


def request_json(
    url: str,
    payload: Optional[Dict] = None,
    *,
    method: Optional[str] = None,
    timeout: float = 30.0,
    retries: int = 4,
    backoff_s: float = 0.25,
    backoff_max_s: float = 4.0,
    jitter: float = 1.0,
    rng: Optional[random.Random] = None,
    total_deadline_s: Optional[float] = None,
    breaker: Optional[CircuitBreaker] = None,
) -> Dict:
    """GET (``payload is None``) or POST ``payload`` as JSON and return
    the decoded JSON response.

    Transient failures (connection errors, timeouts, ``RETRY_STATUSES``)
    are retried up to ``retries`` times with exponential backoff capped
    at ``backoff_max_s``; each sleep is scaled by a uniform random
    factor in ``[1 - jitter/2, 1 + jitter/2]`` (full-jitter style).  Any
    other HTTP error raises ``HttpError`` immediately with the decoded
    error body when the server sent one.

    ``total_deadline_s`` bounds attempts + backoff wall-clock; when the
    budget would be exceeded the call raises instead of sleeping.
    ``breaker`` (optional) fail-fasts while its circuit is open and is
    fed success/failure per call."""
    if method is None:
        method = "GET" if payload is None else "POST"
    rng = rng or random
    t0 = time.monotonic()
    if breaker is not None and not breaker.allow():
        raise HttpError(
            url, None, f"circuit_open: breaker {breaker.name or 'http'} "
            f"open after {breaker.threshold} consecutive failures")
    last: Optional[Exception] = None
    for attempt in range(retries + 1):
        if attempt:
            delay = min(backoff_s * (2.0 ** (attempt - 1)),
                        backoff_max_s)
            if jitter > 0:
                delay *= 1.0 + jitter * (rng.random() - 0.5)
            delay = max(delay, 0.0)
            if total_deadline_s is not None and (
                    time.monotonic() - t0 + delay > total_deadline_s):
                break  # sleeping would blow the budget: give up now
            time.sleep(delay)
        try:
            f = faults.check("http.request", url=url, method=method,
                             attempt=attempt)
            if f is not None:
                if f.delay_s > 0:
                    time.sleep(f.delay_s)
                if f.kind == "error":
                    if f.status is not None:
                        # styled as a server response so the retry/
                        # breaker path sees a real status code
                        raise urllib.error.HTTPError(
                            url, f.status, "injected", None, None)
                    raise urllib.error.URLError("injected fault")
            data = (None if payload is None
                    else json.dumps(payload).encode())
            req = urllib.request.Request(
                url, data=data, method=method,
                headers={"Content-Type": "application/json"},
            )
            att_timeout = timeout
            if total_deadline_s is not None:
                remaining = total_deadline_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                att_timeout = min(timeout, remaining)
            with urllib.request.urlopen(
                    req, timeout=att_timeout) as resp:
                out = json.loads(resp.read() or b"{}")
            if breaker is not None:
                breaker.record_success()
            return out
        except urllib.error.HTTPError as exc:
            body = exc.read() if exc.fp is not None else b""
            try:
                detail = json.loads(body).get("error", body.decode())
            except Exception:  # noqa: BLE001 - non-JSON error body
                detail = body.decode(errors="replace")
            if exc.code not in RETRY_STATUSES:
                raise HttpError(url, exc.code, detail) from exc
            last = HttpError(url, exc.code, detail)
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError) as exc:
            last = exc
    # exhausted retries / blown deadline: that is peer-health signal.
    # (Non-retryable 4xx raised above is the CALLER's bug and must not
    # open the circuit for healthy traffic.)
    if breaker is not None:
        breaker.record_failure()
    if (total_deadline_s is not None
            and time.monotonic() - t0 >= total_deadline_s
            and last is None):
        raise HttpError(url, None,
                        f"total deadline {total_deadline_s}s exceeded")
    if isinstance(last, HttpError):
        raise last
    raise HttpError(url, None, f"retries exhausted: {last}") from last
