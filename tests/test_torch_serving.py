"""The port's serving tier (``repro_torch.serving``) on the CPU, against
the JAX package's:

* ``SimBackend``'s outputs and measured QoR equal the JAX package's
  ``SimBackend`` on the same genome and inputs, for every image family;
* tier selection and SLA budgets as in ``tests/test_serving.py``, the
  catalog's choices equal to the JAX package's;
* the engine: tiers with measured QoR, one group per operating point,
  wire-float coercion, error isolation, bounded admission, deadlines;
* a hot-swap drill: version pinning byte-identical, and swaps under
  concurrent traffic that drop no request;
* the manager's hub and ``POST /serve`` over HTTP;
* ``LMBackend`` on reduced granite-8b and falcon-mamba-7b serving two
  genomes from the accelerator's one model, its tokens equal to
  ``launch/serve.py --front``'s for the same tier.

Every genome and input is drawn from a numpy seed."""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.core.acl.library import default_library as ref_library
from repro.serving import FrontCatalog as RefFrontCatalog
from repro.serving.backends import SimBackend as RefSimBackend
from repro.service.campaigns import make_accelerator as ref_make_accelerator
from repro_torch.accel import LMAccelerator
from repro_torch.configs import get_config
from repro_torch.core.acl.library import default_library
from repro_torch.launch.serve import policy_from_front, serve_batch
from repro_torch.models import reduced
from repro_torch.serving import (
    FrontCatalog,
    LMBackend,
    NoFrontError,
    ServingEngine,
    SimBackend,
    make_backend,
)
from repro_torch.serving.engine import DeadlineExceeded, OverloadedError
from repro_torch.service import CampaignManager, CampaignSpec, make_accelerator

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()
SMALL = dict(n_train=10, n_qor_samples=2, pop_size=8, n_parents=4,
             n_generations=2)


def _cat(rows, accel="toy", objectives=("qor", "energy"), module=None):
    """rows: [(genome tuple, qor, energy)] with raw qor (higher better)."""
    cls = module or FrontCatalog
    genomes = [list(g) for g, _, _ in rows]
    front = [[-q, e] for _, q, e in rows]
    return cls.from_front(accel, genomes, front, objectives)


def _req(inputs, return_outputs=True):
    return types.SimpleNamespace(inputs=inputs, return_outputs=return_outputs)


# ---------------------------------------------------------------------------
# SimBackend against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gaussian3x3", "mcm2", "hevc_dct4x4",
                                  "smoothed_dct", "smoothed_dct/stage1"])
def test_sim_backend_equals_reference(name):
    acc, ref = make_accelerator(name), ref_make_accelerator(name)
    sizes = acc.gene_sizes(LIB)
    g = np.random.default_rng(5).integers(0, sizes)
    point = _cat([(tuple(int(v) for v in g), 50.0, 1.0)],
                 accel=name).points[0]
    rpoint = _cat([(tuple(int(v) for v in g), 50.0, 1.0)], accel=name,
                  module=RefFrontCatalog).points[0]
    reqs = [_req(acc.sample_inputs(2, seed=s)) for s in (1, 2, 3)]
    got = SimBackend(acc, LIB, device="cpu").run(point, reqs)
    want = RefSimBackend(ref, RLIB).run(rpoint, reqs)
    for a, b in zip(got, want):
        assert a["qor"] == b["qor"]
        assert a["outputs"] == b["outputs"]


# ---------------------------------------------------------------------------
# tier selection, as the JAX package's catalog chooses
# ---------------------------------------------------------------------------

ROWS = [((0, 1), 100.0, 10.0), ((2, 3), 80.0, 6.0), ((4, 5), 60.0, 4.0),
        ((6, 7), 40.0, 3.0), ((8, 9), 40.0, 3.0)]


@pytest.mark.parametrize("select", [
    {"tier": "exact"}, {"tier": "balanced"}, {"tier": "budget"},
    {"budget": {"energy": 5.0}}, {"budget": {"qor": 70.0}},
    {"budget": {"qor": 70.0, "energy": 5.0}}, {"budget": {"qor": 1e6}},
], ids=["exact", "balanced", "budget", "energy-cap", "qor-floor",
        "both-infeasible", "impossible"])
def test_tier_selection_equals_reference(select):
    got = _cat(ROWS).select(**select)
    want = _cat(ROWS, module=RefFrontCatalog).select(**select)
    assert got.point.genome == want.point.genome
    assert got.feasible == want.feasible and got.tier == want.tier


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gauss():
    accel = make_accelerator("gaussian3x3")
    g_exact = accel.exact_genome(LIB)
    g_cheap = g_exact.copy()
    for i in range(9):
        g_cheap[i] = (g_cheap[i] + 1) % len(LIB.kind("mul8u"))
    return accel, g_exact, g_cheap


def _gauss_cat(accel, g_exact, g_cheap, qor_cheap=40.0):
    return _cat([(tuple(int(v) for v in g_exact), 100.0, 10.0),
                 (tuple(int(v) for v in g_cheap), qor_cheap, 3.0)],
                accel=accel.name)


def _engine(gauss, **kw):
    accel, g_exact, g_cheap = gauss
    return ServingEngine(accel, LIB, device="cpu",
                         catalog=_gauss_cat(accel, g_exact, g_cheap), **kw)


def test_engine_serves_tiers_with_measured_qor(gauss):
    accel, g_exact, g_cheap = gauss
    eng = _engine(gauss)
    try:
        X = accel.sample_inputs(2, seed=0)
        r_exact = eng.serve(X, tier="exact")
        r_budget = eng.serve(X, tier="budget", return_outputs=True)
        assert r_exact["qor"] == 100.0
        assert r_exact["genome"] == [int(v) for v in g_exact]
        assert r_budget["qor"] < r_exact["qor"]
        assert r_budget["genome"] == [int(v) for v in g_cheap]
        want = accel.simulate_batch(g_cheap[None], LIB, X[None],
                                    per_genome_inputs=True, device="cpu")
        assert np.array_equal(np.asarray(r_budget["outputs"]), want[0])
        st = eng.stats()
        assert st["responses"] == 2 and st["errors"] == 0
        assert st["device"] == "cpu" and st["backend"] == "sim"
    finally:
        eng.close()


def test_engine_batches_same_point_into_one_group(gauss):
    accel = gauss[0]
    eng = _engine(gauss, max_batch=8, max_wait_s=0.2)
    try:
        X = accel.sample_inputs(2, seed=1)
        results = [f.result(timeout=120)
                   for f in [eng.submit(X, tier="budget") for _ in range(4)]]
        assert {r["batch"] for r in results} == {results[0]["batch"]}
        assert all(r["group_size"] == 4 for r in results)
        assert eng.stats()["groups"] == 1
    finally:
        eng.close()


def test_engine_coerces_wire_float_inputs(gauss):
    accel = gauss[0]
    eng = _engine(gauss)
    try:
        X = accel.sample_inputs(2, seed=7)
        as_int = eng.serve(X, tier="budget", return_outputs=True)
        as_float = eng.serve(X.astype(np.float64), tier="budget",
                             return_outputs=True)
        assert as_float["qor"] == as_int["qor"]
        assert as_float["outputs"] == as_int["outputs"]
        with pytest.raises(ValueError, match="integer operands"):
            eng.serve(X + 0.5, tier="budget")
    finally:
        eng.close()


def test_engine_error_isolation(gauss):
    accel = gauss[0]
    eng = _engine(gauss)
    try:
        X = accel.sample_inputs(1, seed=2)
        bad = eng.submit(X, tier="turbo")
        pinned = eng.submit(X, tier="exact", pin_version=999)
        good = eng.submit(X, tier="exact")
        with pytest.raises(ValueError, match="unknown tier"):
            bad.result(timeout=120)
        with pytest.raises(ValueError, match="unknown catalog version"):
            pinned.result(timeout=120)
        assert good.result(timeout=120)["qor"] == 100.0
    finally:
        eng.close()


def test_engine_bounded_queue_and_deadline(gauss):
    accel = gauss[0]
    eng = _engine(gauss, max_queue=1, max_wait_s=0.0)
    X = accel.sample_inputs(1, seed=3)
    try:
        # hold the batcher inside a group so the queue fills
        gate = threading.Event()
        run = eng.backend.run

        def slow(point, reqs):
            gate.wait(30)
            return run(point, reqs)

        eng.backend.run = slow
        first = eng.submit(X, tier="exact")
        _wait = time.monotonic() + 30
        while eng.stats()["queue_depth"] and time.monotonic() < _wait:
            time.sleep(0.005)
        queued = eng.submit(X, tier="exact", deadline_s=0.01)
        with pytest.raises(OverloadedError):
            eng.submit(X, tier="exact")
        time.sleep(0.05)
        gate.set()
        assert first.result(timeout=60)["qor"] == 100.0
        with pytest.raises(DeadlineExceeded):
            queued.result(timeout=60)
        st = eng.stats()
        assert st["rejects"] == 1 and st["expired"] == 1
    finally:
        eng.backend.run = run
        eng.close()


def test_hot_swap_and_version_pinning_byte_identical(gauss):
    accel, g_exact, _ = gauss
    eng = _engine(gauss)
    try:
        X = accel.sample_inputs(2, seed=3)
        before = eng.serve(X, tier="budget", return_outputs=True)
        assert before["catalog_version"] == 1
        only_exact = _cat([(tuple(int(v) for v in g_exact), 100.0, 10.0)],
                          accel=accel.name)
        assert eng.install(only_exact) == 2
        assert eng.install(_cat([(tuple(int(v) for v in g_exact), 100.0,
                                  10.0)], accel=accel.name)) is None
        after = eng.serve(X, tier="budget", return_outputs=True)
        assert after["catalog_version"] == 2
        assert after["genome"] == [int(v) for v in g_exact]
        pinned = eng.serve(X, tier="budget", pin_version=1,
                           return_outputs=True)
        assert pinned["genome"] == before["genome"]
        assert pinned["outputs"] == before["outputs"]
        assert pinned["qor"] == before["qor"]
        assert eng.stats()["hot_swaps"] == 1
    finally:
        eng.close()


def test_hot_swap_under_concurrent_traffic_drops_no_request(gauss):
    accel, g_exact, g_cheap = gauss
    eng = _engine(gauss, max_batch=4, max_wait_s=0.002)
    version_genome = {1: [int(v) for v in g_cheap]}
    try:
        X = accel.sample_inputs(1, seed=4)
        stop = threading.Event()

        def swapper():
            flip = 0
            while not stop.is_set():
                flip += 1
                cat = _cat([
                    (tuple(int(v) for v in g_exact), 100.0,
                     10.0 if flip % 2 else 3.0),
                    (tuple(int(v) for v in g_cheap),
                     40.0 if flip % 2 else 100.0,
                     3.0 if flip % 2 else 10.0)], accel=accel.name)
                v = eng.install(cat)
                if v is not None:
                    version_genome[v] = list(
                        cat.points[cat.tiers["budget"]].genome)
                time.sleep(0.001)

        sw = threading.Thread(target=swapper)
        sw.start()
        futs = [eng.submit(X, tier="budget") for _ in range(40)]
        results = [f.result(timeout=180) for f in futs]
        stop.set()
        sw.join(timeout=10)
        for r in results:
            assert r["genome"] == version_genome[r["catalog_version"]], r
        st = eng.stats()
        assert st["errors"] == 0 and st["responses"] == 40
        assert st["hot_swaps"] >= 1
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the manager's hub and POST /serve
# ---------------------------------------------------------------------------

def test_manager_hub_and_http_serve():
    from repro_torch.service.api import Client, make_server

    mgr = CampaignManager(eval_workers=2, campaign_workers=1, device="cpu")
    fired = []
    mgr.subscribe_front(fired.append)
    srv = make_server(mgr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    cli = Client(f"http://127.0.0.1:{srv.server_address[1]}", retries=0)
    try:
        with pytest.raises(Exception, match="409"):
            cli.serve("mcm2", [[1, 2, 3, 4]], tier="exact")
        cid = cli.submit(accel="mcm2", **SMALL)
        assert cli.wait(cid, timeout=300)["state"] == "done"
        assert "mcm2" in fired
        with pytest.raises(NoFrontError):
            mgr.serving.engine_for("mcm1")
        accel = make_accelerator("mcm2")
        X = accel.sample_inputs(4, seed=2)
        r = cli.serve("mcm2", X, tier="budget", return_outputs=True)
        assert r["tier"] == "budget" and r["catalog_version"] == 1
        g = np.asarray(r["genome"])
        want = accel.simulate_batch(g[None], LIB, X[None],
                                    per_genome_inputs=True, device="cpu")
        assert np.array_equal(np.asarray(r["outputs"]), want[0])
        r2 = cli.serve("mcm2", X,
                       budget={"energy": r["labels"]["energy"] + 1.0})
        assert r2["feasible"]
        for bad in ({"accel": "mcm2"}, {"inputs": [[1]]}):
            with pytest.raises(Exception, match="400"):
                cli._req("/serve", bad)
        with pytest.raises(Exception, match="400"):
            cli.serve("mcm2", X, tier="turbo")
        assert cli.serve("mcm2", X)["tier"] == "balanced"
        eng = mgr.serving.engine_for("mcm2")
        assert eng.device.type == "cpu"
        gf = mgr.global_front("mcm2", ("qor", "energy"))
        assert len(eng.catalog) == len(gf["genomes"])
        ss = cli.serving_stats()
        assert ss["engines"]["mcm2"]["responses"] >= 3
        assert "repro_serving_requests_total" in cli.metrics()
        assert cli.health()["serving"]["engines"]["mcm2"]["alive"]
        # a second campaign refreshes the engine (same front: no new
        # version, or a swap)
        v0 = eng.catalog.version
        cid2 = cli.submit(accel="mcm2", **{**SMALL, "seed": 1})
        assert cli.wait(cid2, timeout=300)["state"] == "done"
        assert fired.count("mcm2") >= 2 and eng.catalog.version >= v0
    finally:
        srv.shutdown()
        mgr.shutdown()


# ---------------------------------------------------------------------------
# LMBackend: one model, a policy per genome
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-8b", "falcon-mamba-7b"])
def test_lm_backend_serves_two_genomes_from_one_model(tmp_path, arch):
    cfg = get_config(arch)
    acc = LMAccelerator(cfg, device="cpu")
    exact = acc.exact_genome(LIB)
    cheap = exact.copy()
    cheap[0] = 5      # the first and third slots on other circuits
    cheap[2] = 3
    cat = FrontCatalog.from_front(acc.name, [exact.tolist(), cheap.tolist()],
                                  [[-100.0, 2e-6], [-30.0, 1e-6]])
    path = tmp_path / "front.json"
    path.write_text(json.dumps(cat.to_json()))
    prompts = np.random.default_rng(4).integers(
        0, acc.cfg.vocab_size, (2, 6)).astype(np.int32)

    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu")
    try:
        eng = mgr.serving.register(acc, cat, max_batch=2, max_wait_s=5.0)
        assert isinstance(eng.backend, LMBackend)
        assert isinstance(make_backend(acc, LIB), LMBackend)
        got = {}
        for tier in ("exact", "budget"):
            futs = [eng.submit(p, tier=tier, gen=3) for p in prompts]
            res = [f.result(timeout=300) for f in futs]
            assert all(r["group_size"] == 2 for r in res)
            got[tier] = np.stack([r["tokens"] for r in res])
        model_id = id(acc._model)
        assert acc._model is not None
        with pytest.raises(ValueError, match="already served"):
            mgr.serving.register(acc, cat)
    finally:
        mgr.shutdown()
    assert id(acc._model) == model_id
    small = reduced(cfg)
    for tier in ("exact", "budget"):
        policy, sel = policy_from_front(small, str(path), tier)
        tokens, _ = serve_batch(small, prompts=torch.from_numpy(prompts),
                                gen=3, policy=policy, seed=0, device="cpu")
        assert np.array_equal(got[tier], tokens[:, -3:].numpy()), tier
