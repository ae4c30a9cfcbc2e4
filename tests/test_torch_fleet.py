"""The port's labeling fleet (``repro_torch.fleet``) on the CPU: the
retrying HTTP helper, the coordinator's lease/requeue state machine (the
JAX package's ``tests/test_fleet.py`` cases as one parametrised test),
empty-fleet and unportable-context degradation, and a ``kill -9`` of a
``python -m repro_torch.fleet.worker --device cpu`` subprocess mid
campaign over real HTTP that changes no byte of the front.  Lease and
heartbeat TTLs are short; one worker subprocess at a time."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from repro.service import EvalContext as RefEvalContext
from repro.accel import MCMAccelerator as RefMCM
from repro.core.acl.library import default_library as ref_library
from repro_torch.accel import MCMAccelerator
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import V5E
from repro_torch.faults import FaultPlan
from repro_torch.fleet import (
    PROTOCOL_VERSION,
    FleetCoordinator,
    HttpError,
    context_is_portable,
    encode_labels,
    request_json,
    serve_fleet,
)
from repro_torch.service import (
    CampaignManager,
    CampaignSpec,
    EvalContext,
    EvalScheduler,
    InMemoryLabelStore,
    JsonlLabelStore,
)
from repro_torch.service.api import make_server
from repro_torch.service.store import LABEL_KEYS

from _torch_threads import bounded_torch_threads  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LIB = default_library()

# label keys that are a pure function of (context, genome)
DET_KEYS = ("qor", "latency", "energy", "flops", "hbm_bytes")
SMALL = dict(n_train=10, n_qor_samples=2, pop_size=8, n_parents=4,
             n_generations=3)


def _wait_for(pred, timeout=60.0, every=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(every)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------------
# http helper
# ---------------------------------------------------------------------------

def _flaky_server(script):
    """A one-route HTTP server that pops (status, body) pairs per hit."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    hits = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _serve(self):
            status, body = script[min(len(hits), len(script) - 1)]
            hits.append(self.path)
            payload = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = lambda self: self._serve()  # noqa: E731

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", hits


@pytest.mark.parametrize("script,retries,ok,n_hits", [
    ([(503, {}), (429, {}), (200, {"ok": True})], 4, True, 3),
    ([(400, {"error": "bad"}), (200, {"ok": True})], 4, False, 1),
    ([(503, {}), (200, {"ok": True})], 0, False, 1),
], ids=["retries-transient", "client-error-once", "zero-retries"])
def test_request_json_retry_policy(script, retries, ok, n_hits):
    srv, base, hits = _flaky_server(script)
    try:
        if ok:
            assert request_json(base + "/x", {"a": 1}, retries=retries,
                                backoff_s=0.001) == {"ok": True}
        else:
            with pytest.raises(HttpError):
                request_json(base + "/x", {"a": 1}, retries=retries,
                             backoff_s=0.001)
        assert len(hits) == n_hits
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# coordinator state machine (fake contexts: no synthesis, no sockets)
# ---------------------------------------------------------------------------

def _fake_ctx(fp="fp-test"):
    ctx = types.SimpleNamespace(
        accel=types.SimpleNamespace(name="mcm1"),
        rank_genes=False, n_qor_samples=2, qor_seed=0, hw=V5E,
        fingerprint=fp,
    )

    def ground_truth(genomes):
        g = np.atleast_2d(genomes)
        v = g.sum(axis=1).astype(np.float64)
        return {k: v * (i + 1) for i, k in enumerate(LABEL_KEYS)}

    ctx.ground_truth = ground_truth
    return ctx


def _serve_leases(coord, wid, *, n=None, delay=0.0, drop_result=False):
    """Fake remote worker: poll leases and answer with ground truth.
    ``n=None`` serves until the coordinator shuts down."""
    served = 0
    while n is None or served < n:
        if coord._stopped:
            return served
        resp = coord.lease({"worker": wid})
        lease = resp.get("lease")
        if lease is None:
            time.sleep(0.005)
            continue
        served += 1
        if delay:
            time.sleep(delay)
        if drop_result:
            continue                          # simulates a kill -9
        labels = _fake_ctx().ground_truth(np.asarray(lease["genomes"]))
        coord.result({"worker": wid, "lease": lease["id"],
                      "labels": encode_labels(labels),
                      "device": "cpu", "launches": {"rank_k": 0}})
    return served


def _bg(fn, *a, **kw):
    t = threading.Thread(target=fn, args=a, kwargs=kw, daemon=True)
    t.start()
    return t


def _case_roundtrip(coord, ctx, genomes):
    coord.register({"worker": "w0", "host": "h", "pid": 1, "accels": ["*"]})
    _bg(_serve_leases, coord, "w0")
    out = coord.label(ctx, genomes)
    s = coord.stats()
    assert s["live"] == 1 and s["batches"] == 1 and s["requeues"] == 0
    assert s["remote_labels"] == len(genomes) and s["local_labels"] == 0
    w = s["workers"]["w0"]
    assert w["labels"] == len(genomes) and w["alive"]
    assert w["device"] == "cpu" and w["launches"] == {"rank_k": 0}
    return out


def _case_lease_expiry(coord, ctx, genomes):
    """A worker that leases chunks and dies silently: the leases expire,
    the chunks requeue, a survivor completes them."""
    coord.register({"worker": "dead", "accels": ["*"]})
    coord.register({"worker": "live", "accels": ["*"]})
    _bg(_serve_leases, coord, "dead", n=2, drop_result=True)

    def survivor():
        time.sleep(0.1)
        _serve_leases(coord, "live")

    _bg(survivor)
    out = coord.label(ctx, genomes)
    s = coord.stats()
    assert s["requeues"] >= 1 and s["expired_leases"] >= 1
    assert s["workers"]["live"]["labels"] >= 1
    return out


def _case_heartbeat_expiry(coord, ctx, genomes):
    """Heartbeat silence declares the worker dead; with no live worker
    left the blocked label() reclaims every chunk in-process."""
    coord.register({"worker": "w0", "accels": ["*"]})
    _bg(_serve_leases, coord, "w0", n=1, drop_result=True)
    out = coord.label(ctx, genomes)
    s = coord.stats()
    assert s["live"] == 0 and s["dead_workers"] == 1
    assert s["local_labels"] == len(genomes) and s["remote_labels"] == 0
    assert coord.heartbeat({"worker": "w0"}) == {"ok": False,
                                                 "reregister": True}
    return out


def _case_late_duplicate(coord, ctx, genomes):
    """At-most-once commit: a late result from a presumed-dead worker
    lands after the requeued copy completed and changes nothing."""
    coord.register({"worker": "slow", "accels": ["*"]})
    coord.register({"worker": "fast", "accels": ["*"]})
    box = {}
    t = _bg(lambda: box.update(out=coord.label(ctx, genomes)))
    _wait_for(lambda: coord.lease({"worker": "slow"}).get("lease")
              is not None or box.get("out"),
              what="the slow worker to lease the chunk")
    _serve_leases(coord, "fast", n=1)
    t.join(timeout=30)
    before = coord.stats()["duplicate_results"]
    labels = encode_labels(ctx.ground_truth(genomes))
    for lid in list(coord._retired):
        coord.result({"worker": "slow", "lease": lid, "labels": labels})
    assert coord.stats()["duplicate_results"] >= before
    return box["out"]


def _case_drift(coord, ctx, genomes):
    """A worker that rejects every lease pins the fingerprint away from
    itself, then away from the fleet; the batch completes locally."""
    coord.register({"worker": "w0", "accels": ["*"]})

    def reject_all():
        while True:
            lease = coord.lease({"worker": "w0"}).get("lease")
            if lease is None:
                if coord.stats()["drifted_fingerprints"]:
                    return
                time.sleep(0.005)
                continue
            coord.result({"worker": "w0", "lease": lease["id"],
                          "reject": True, "error": "fingerprint drift"})

    _bg(reject_all)
    out = coord.label(ctx, genomes)
    assert coord.stats()["drifted_fingerprints"] == 1
    assert not coord._workers["w0"].can_serve(
        {"fingerprint": ctx.fingerprint, "accel": "mcm1"})
    return out


def _case_bye(coord, ctx, genomes):
    """A polite leave requeues the worker's lease at once."""
    coord.register({"worker": "w0", "accels": ["*"]})
    box = {}
    t = _bg(lambda: box.update(out=coord.label(ctx, genomes)))
    _wait_for(lambda: coord.lease({"worker": "w0"}).get("lease")
              is not None, what="w0 to hold a lease")
    assert coord.heartbeat({"worker": "w0", "bye": True})["bye"]
    t.join(timeout=30)
    assert coord.stats()["live"] == 0
    return box["out"]


def _case_old_protocol_refused(coord, ctx, genomes):
    """A worker that announces the JAX package's protocol (1: its labels'
    flops and bytes are XLA's count) is refused at join and never
    leases; a current worker then serves the batch."""
    from repro.fleet.protocol import PROTOCOL_VERSION as REF_PROTOCOL

    assert REF_PROTOCOL == 1 != PROTOCOL_VERSION
    r = coord.register({"worker": "old", "protocol": REF_PROTOCOL,
                        "accels": ["*"]})
    assert not r["ok"] and f"protocol {REF_PROTOCOL}" in r["error"]
    assert "old" not in coord.stats()["workers"]
    return _case_roundtrip(coord, ctx, genomes)


CASES = {
    # (case, lease TTL, heartbeat TTL, chunk size, genomes)
    "roundtrip": (_case_roundtrip, 5.0, 5.0, None, 12),
    "old_protocol_refused_at_join": (_case_old_protocol_refused, 5.0, 5.0,
                                     None, 4),
    "lease_expiry_requeues": (_case_lease_expiry, 0.3, 60.0, None, 8),
    "heartbeat_expiry_reclaims": (_case_heartbeat_expiry, 60.0, 0.3,
                                  None, 4),
    "late_duplicate_dropped": (_case_late_duplicate, 0.2, 60.0, 100, 4),
    "drift_pins_worker_then_fleet": (_case_drift, 5.0, 60.0, None, 2),
    "bye_requeues_at_once": (_case_bye, 60.0, 60.0, None, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_coordinator_state_machine(case):
    """Every path of the lease/requeue state machine ends in labels equal
    to plain ground truth."""
    fn, lease_ttl, hb_ttl, chunk, n = CASES[case]
    coord = FleetCoordinator(lease_ttl_s=lease_ttl, heartbeat_ttl_s=hb_ttl,
                             chunk_size=chunk)
    ctx = _fake_ctx("fp-drifty" if case.startswith("drift") else "fp-test")
    genomes = np.arange(2 * n).reshape(n, 2)
    t0 = time.monotonic()
    try:
        out = fn(coord, ctx, genomes)
    finally:
        coord.shutdown()
    ref = ctx.ground_truth(genomes)
    for k in LABEL_KEYS:
        assert np.array_equal(out[k], ref[k]), k
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------------------
# scheduler integration: empty fleet, unportable context
# ---------------------------------------------------------------------------

def test_empty_fleet_falls_back_to_process_backend():
    ctx = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2, device="cpu")
    sched = EvalScheduler(InMemoryLabelStore(), n_workers=2,
                          backend="fleet", fleet_fallback="process",
                          process_workers=1, max_wait_s=0.005, device="cpu")
    try:
        genomes = np.tile(ctx.accel.exact_genome(LIB), (3, 1))
        genomes[:, 0] = [0, 1, 2]
        out = sched.label(ctx, genomes)
        ref = ctx.ground_truth(genomes)
        for k in DET_KEYS:
            assert out[k].tobytes() == ref[k].tobytes()
        s = sched.stats()
        assert s["fleet_fallbacks"] >= 1 and s["fleet_batches"] == 0
        assert s["fleet"]["registered"] == 0
        assert s["labeler"]["labeled"] == 3     # the process pool ran it
    finally:
        sched.shutdown()


def test_unportable_context_stays_off_the_fleet():
    drop = [c for c in LIB.kind("mul8s") if not c.is_exact][-1].name
    sub = LIB.subset([c.name for c in LIB.circuits if c.name != drop])
    ctx = EvalContext(MCMAccelerator(1), sub, n_qor_samples=2, device="cpu")
    assert not context_is_portable(ctx)
    coord = FleetCoordinator()
    coord.register({"worker": "w0", "accels": ["*"]})
    assert not coord.eligible(ctx)
    # a portable context with a live capable worker is eligible
    ok = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2, device="cpu")
    assert coord.eligible(ok)
    coord.shutdown()


# ---------------------------------------------------------------------------
# end to end over real HTTP
# ---------------------------------------------------------------------------

def _spawn_worker(base, wid, store=None, fault_plan=None):
    cmd = [sys.executable, "-m", "repro_torch.fleet.worker",
           "--orchestrator", base, "--id", wid, "--device", "cpu",
           "--no-warm", "--max-idle-s", "120"]
    if store:
        cmd += ["--store", store]
    env = {**os.environ, "PYTHONPATH": SRC, "OPENBLAS_NUM_THREADS": "1",
           "OMP_NUM_THREADS": "1"}
    if fault_plan is not None:
        env["REPRO_FAULTS"] = fault_plan.to_json()
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL, env=env)


def test_kill9_mid_campaign_front_is_byte_identical():
    """A worker ``kill -9``'d while it holds a lease, a second one that
    joins after the campaign started: the front is byte-identical to
    the thread backend's, and the killed lease requeued.

    Worker A stalls in its first synthesis run (an injected latency), so
    it still holds that lease once B has registered; A is killed only
    then.  Killed before B's registration, A would be declared dead
    ``heartbeat_ttl_s`` later with no live worker in the fleet whenever
    B's start-up (a torch import, slow under a loaded host) took longer,
    and the next batch would fall back off the fleet."""
    spec = CampaignSpec(accel="mcm1", **SMALL)
    ref_mgr = CampaignManager(eval_workers=2, campaign_workers=1,
                              device="cpu")
    try:
        ref_cid = ref_mgr.submit(spec)
        assert ref_mgr.wait(ref_cid, timeout=300) == "done"
        ref = ref_mgr.result(ref_cid)
    finally:
        ref_mgr.shutdown()

    mgr = CampaignManager(eval_workers=2, campaign_workers=1,
                          eval_backend="fleet", device="cpu",
                          lease_ttl_s=60.0, heartbeat_ttl_s=8.0)
    srv = make_server(mgr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    fleet = mgr.scheduler.fleet
    procs = []
    try:
        stall = FaultPlan().add("synth.compile", "latency", delay_s=300.0,
                                times=1)
        procs.append(_spawn_worker(base, "wA", fault_plan=stall))
        _wait_for(lambda: fleet.stats()["live"] >= 1, timeout=120,
                  what="worker A to register")
        cid = mgr.submit(spec)
        _wait_for(lambda: fleet.stats()["batches"] >= 1, timeout=120,
                  what="the first fleet batch")
        procs.append(_spawn_worker(base, "wB"))
        _wait_for(lambda: fleet.stats()["live"] >= 2, timeout=120,
                  what="worker B to register")

        def a_holds_lease():
            with fleet._cv:
                return any(l.worker == "wA" for l in fleet._leases.values())

        _wait_for(a_holds_lease, timeout=120, every=0.002,
                  what="worker A to hold a lease")
        procs[0].send_signal(signal.SIGKILL)

        assert mgr.wait(cid, timeout=300) == "done", mgr.status(cid)
        res = mgr.result(cid)
        assert np.array_equal(ref.front_genomes, res.front_genomes)
        assert res.front_objectives.tobytes() == ref.front_objectives.tobytes()
        s = fleet.stats()
        assert s["remote_labels"] > 0
        assert s["expired_leases"] >= 1 and s["requeues"] >= 1
        sched = mgr.stats()["scheduler"]
        assert sched["fleet_batches"] > 0 and sched["fleet_fallbacks"] == 0
        # every live worker reported its device and its launch counts
        for w in s["workers"].values():
            if w["labels"]:
                assert w["device"] == "cpu"
                assert set(w["launches"]) >= {"population_lut", "rank_k"}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        srv.shutdown()
        mgr.shutdown()


def test_fleet_worker_warm_starts_and_labels_v5e_as_the_reference(tmp_path):
    """A ``--device cpu`` worker pointed at the shared store answers
    already-known genomes from its replica; a V5E context it labels
    afresh gives the JAX package's qor and energy."""
    path = str(tmp_path / "labels.jsonl")
    ctx = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2, device="cpu",
                      hw=V5E)
    genomes = np.tile(ctx.accel.exact_genome(LIB), (6, 1))
    genomes[:, 0] = [0, 1, 2, 3, 4, 5]
    labels = ctx.ground_truth(genomes[:4])
    store = JsonlLabelStore(path)
    store.put_many((ctx.key(genomes[i]), {k: labels[k][i] for k in LABEL_KEYS})
                   for i in range(4))
    store.close()

    coord = FleetCoordinator(lease_ttl_s=30.0, heartbeat_ttl_s=30.0,
                             chunk_size=6)
    srv = serve_fleet(coord, port=0)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    proc = _spawn_worker(base, "warm", store=path)
    try:
        _wait_for(lambda: coord.stats()["live"] >= 1, timeout=120,
                  what="the warm worker to register")
        out = coord.label(ctx, genomes)
        want = ctx.ground_truth(genomes)
        for k in DET_KEYS:
            assert out[k].tobytes() == want[k].tobytes()
        s = coord.stats()
        assert s["workers"]["warm"]["store_hits"] == 4
        assert s["remote_labels"] == 6 and s["local_labels"] == 0
        # the JAX package's context keys XLA-counted labels: another
        # fingerprint, but the same qor and energy
        ref = RefEvalContext(RefMCM(1), ref_library(), n_qor_samples=2)
        assert ref.fingerprint != ctx.fingerprint
        rl = ref.ground_truth(genomes[4:])
        for k in ("qor", "energy"):
            assert out[k][4:].tobytes() == np.asarray(rl[k]).tobytes()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        srv.shutdown()
        coord.shutdown()
