"""The port's hierarchical search (``repro_torch.hierarchy.compose`` and
``search``) on the CPU, against the JAX package's:

* ``compose_fronts`` equals the brute-force cross-product and the JAX
  package's fold, over stages, front sizes and the QoR column;
* ``run_hierarchical`` on ``smoothed_dct`` at a tiny size under
  ``hw=V5E`` gives the JAX package's stage fronts, candidates, verified
  objectives (``qor`` and ``energy`` bit for bit) and front mask;
* the service job (``submit_hierarchical``), the global front,
  retention compaction, spec validation and the final tag's accounting;
* the launch counter and the population engine cache under 8 threads;
* the CLI on the CPU, warm on its own store.

Every front and genome is drawn from a numpy seed."""

import sys
import threading

import numpy as np
import pytest

from repro.accel.smoothed_dct import SmoothedDct as RefSmoothedDct
from repro.core.acl.library import default_library as ref_library
from repro.hierarchy import HierarchicalConfig as RefHierarchicalConfig
from repro.hierarchy import compose_fronts as ref_compose_fronts
from repro.hierarchy import run_hierarchical as ref_run_hierarchical
from repro_torch import _build
from repro_torch.accel import fused
from repro_torch.accel.smoothed_dct import SmoothedDct
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import V5E
from repro_torch.core.pareto import non_dominated_mask
from repro_torch.hierarchy import (
    HierarchicalConfig,
    StageFront,
    compose_fronts,
    run_hierarchical,
    truncate_front,
)
from repro_torch.hierarchy.compose import _combine, compose_qor
from repro_torch.service import CampaignManager, HierarchicalSpec

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()

TINY = dict(n_train=8, n_qor_samples=2, pop_size=8, n_parents=4,
            n_generations=1)


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------

def _random_fronts(rng, n_stages, m, qor_index, sizes):
    fronts = []
    for _ in range(n_stages):
        n = int(rng.integers(*sizes))
        obj = rng.normal(size=(n, m))
        if qor_index is not None:
            obj[:, qor_index] = -rng.uniform(5, 100, size=n)
        fronts.append(StageFront(genomes=np.arange(n)[:, None],
                                 objectives=obj))
    return fronts


def _brute_force(fronts, qor_index):
    """The full cross-product (same combine, left fold, no pruning)."""
    objs = fronts[0].objectives.astype(np.float64)
    for f in fronts[1:]:
        objs = _combine(objs, f.objectives.astype(np.float64), qor_index)
    return objs[non_dominated_mask(objs)]


def _sorted(obj):
    return obj[np.lexsort(obj.T)]


@pytest.mark.parametrize("sizes", [(1, 3), (3, 7), (6, 10)])
@pytest.mark.parametrize("n_stages,m,qor_index", [
    (2, 2, 0), (3, 2, 0), (2, 3, 1), (3, 3, None), (4, 2, 1),
])
def test_compose_equals_bruteforce(n_stages, m, qor_index, sizes):
    for seed in range(4):
        rng = np.random.default_rng(100 * seed + n_stages)
        fronts = _random_fronts(rng, n_stages, m, qor_index, sizes)
        res = compose_fronts(fronts, qor_index=qor_index)
        brute = _brute_force(fronts, qor_index)
        assert _sorted(res.objectives).tobytes() == _sorted(brute).tobytes()
        assert res.stats.survivors == len(res.indices)
        assert res.stats.cross_product_size == float(np.prod(
            [len(f.objectives) for f in fronts]))
        # the indices, through the stage genomes (each a front row's
        # index here), reconstruct the composed objectives
        for t, row in enumerate(res.indices):
            rows = [int(res.stage_genomes[s][i, 0]) for s, i in enumerate(row)]
            obj = fronts[0].objectives[rows[0]][None].astype(np.float64)
            for s in range(1, n_stages):
                obj = _combine(obj, fronts[s].objectives[rows[s]][None]
                               .astype(np.float64), qor_index)
            assert obj[0].tobytes() == res.objectives[t].tobytes()
        # and the JAX package's fold, capped too, gives the same
        for caps in ({}, {"k_per_stage": 3, "max_survivors": 4}):
            got = compose_fronts(fronts, qor_index=qor_index, **caps)
            want = ref_compose_fronts(fronts, qor_index=qor_index, **caps)
            assert np.array_equal(got.indices, want.indices)
            assert got.objectives.tobytes() == want.objectives.tobytes()


def test_compose_qor_is_monotone_noise_addition():
    assert compose_qor(np.array(-40.0), np.array(-100.0)) < -39.9
    assert np.isclose(compose_qor(np.array(-40.0), np.array(-40.0)),
                      -40 + 10 * np.log10(2))
    assert compose_qor(np.array(-20.0), np.array(-50.0)) > compose_qor(
        np.array(-30.0), np.array(-50.0))


def test_truncate_front_keeps_extremes():
    obj = np.stack([np.arange(10.0), -np.arange(10.0)], axis=1)
    sel = truncate_front(obj, 4)
    assert len(sel) == 4
    assert 0 in obj[sel][:, 0] and 9 in obj[sel][:, 0]
    assert len(truncate_front(obj, None)) == 10
    assert len(truncate_front(obj, 20)) == 10


def test_compose_respects_caps():
    fronts = _random_fronts(np.random.default_rng(7), 3, 2, 0, (3, 7))
    res = compose_fronts(fronts, qor_index=0, k_per_stage=3,
                         max_survivors=4)
    assert all(t <= 3 for t in res.stats.truncated_sizes)
    assert len(res.objectives) <= 4
    for row in res.indices:
        for s, gidx in enumerate(row):
            assert 0 <= gidx < len(res.stage_genomes[s])


# ---------------------------------------------------------------------------
# run_hierarchical against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_runs():
    cfg = dict(k_per_stage=3, max_candidates=4, **TINY)
    got = run_hierarchical(SmoothedDct(), LIB, HierarchicalConfig(**cfg),
                           device="cpu", hw=V5E)
    want = ref_run_hierarchical(RefSmoothedDct(), ref_library(),
                                RefHierarchicalConfig(**cfg))
    return got, want


def test_stage_fronts_equal_the_reference(both_runs):
    got, want = both_runs
    assert len(got.stage_fronts) == len(want.stage_fronts) == 2
    for a, b in zip(got.stage_fronts, want.stage_fronts):
        assert np.array_equal(a.genomes, b.genomes)
        assert a.objectives.tobytes() == b.objectives.tobytes()


def test_verified_front_equals_the_reference_bit_for_bit(both_runs):
    got, want = both_runs
    assert np.array_equal(got.candidate_genomes, want.candidate_genomes)
    for k in ("qor", "energy"):
        assert got.final_labels[k].tobytes() == want.final_labels[k].tobytes()
    assert got.true_objectives.tobytes() == want.true_objectives.tobytes()
    assert np.array_equal(got.front_mask, want.front_mask)
    assert np.array_equal(got.compose_stats.truncated_sizes,
                          want.compose_stats.truncated_sizes)
    assert got.ground_truth_calls == want.ground_truth_calls
    assert got.flat_space_size == want.flat_space_size


def test_run_hierarchical_end_to_end(both_runs):
    res, _ = both_runs
    assert len(res.stage_campaign_ids) == 2
    assert np.isclose(res.true_objectives[:, 0].min(), -100.0)
    assert len(np.unique(res.candidate_genomes, axis=0)) == len(
        res.candidate_genomes)
    assert res.candidate_genomes.shape[1] == len(SmoothedDct().slots)
    gt = res.ground_truth_calls
    assert gt["total"] == gt["stage_campaigns"] + gt["final"]
    assert 0 < gt["final"] <= len(res.candidate_genomes)
    assert res.max_concurrent_stages >= 1
    assert set(res.timings) >= {"stage_campaigns", "compose",
                                "final_eval", "total", "stage0", "stage1"}


def test_given_manager_refuses_device_and_hw():
    mgr = CampaignManager(eval_workers=1, campaign_workers=2, device="cpu")
    try:
        cfg = HierarchicalConfig(k_per_stage=3, max_candidates=4, **TINY)
        with pytest.raises(ValueError, match="owned manager"):
            run_hierarchical(SmoothedDct(), LIB, cfg, manager=mgr,
                             device="cpu")
        with pytest.raises(ValueError, match="owned manager"):
            run_hierarchical(SmoothedDct(), LIB, cfg, manager=mgr, hw=V5E)
    finally:
        mgr.shutdown()


# ---------------------------------------------------------------------------
# the service job
# ---------------------------------------------------------------------------

def test_hierarchical_service_job_and_global_front():
    from repro_torch.service.campaigns import _CompactResult

    mgr = CampaignManager(eval_workers=2, campaign_workers=2, device="cpu")
    try:
        cid = mgr.submit_hierarchical(HierarchicalSpec(
            accel="smoothed_dct", k_per_stage=4, max_candidates=8, **TINY))
        assert mgr.wait(cid, timeout=600) == "done"
        st = mgr.status(cid)
        assert st["kind"] == "hierarchical" and st["front_size"] > 0
        assert len(st["stage_campaigns"]) == 2
        assert st["max_concurrent_stages"] >= 1
        assert st["ground_truth_calls"]["total"] > 0
        assert len(mgr.front(cid)["front"]) == st["front_size"]
        assert mgr.global_front("smoothed_dct")["campaigns"] == [cid]
        kinds = {c["id"]: c["kind"] for c in mgr.list_campaigns()}
        assert kinds[cid] == "hierarchical"
        assert all(kinds[sc] == "dse" for sc in st["stage_campaigns"])
        mgr.keep_results = 0
        mgr._evict()
        assert isinstance(mgr.result(cid), _CompactResult)
        st2 = mgr.status(cid)
        assert st2["front_size"] == st["front_size"]
        assert st2["ground_truth_calls"] == st["ground_truth_calls"]
        assert len(mgr.front(cid)["front"]) == st["front_size"]
    finally:
        mgr.shutdown()


def test_hierarchical_spec_validation():
    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu")
    try:
        with pytest.raises(ValueError, match="not a staged pipeline"):
            mgr.submit_hierarchical(HierarchicalSpec(accel="mcm2", **TINY))
        with pytest.raises(ValueError, match="stages"):
            mgr.submit_hierarchical(HierarchicalSpec(
                accel="smoothed_dct", stages=({"n_train": 4},), **TINY))
        with pytest.raises(ValueError, match="max_candidates"):
            mgr.submit_hierarchical(HierarchicalSpec(
                accel="smoothed_dct", max_candidates=0, **TINY))
        with pytest.raises(ValueError, match="k_per_stage"):
            mgr.submit_hierarchical(HierarchicalSpec(
                accel="smoothed_dct", k_per_stage=0, **TINY))
        with pytest.raises(ValueError, match="bad stage 0 spec"):
            mgr.submit_hierarchical(HierarchicalSpec(
                accel="smoothed_dct", stages=({"n_train": 0}, {}), **TINY))
        with pytest.raises(ValueError, match="bad stage 1 override"):
            mgr.submit_hierarchical(HierarchicalSpec(
                accel="smoothed_dct", stages=({}, {"n_trian": 8}), **TINY))
        assert mgr.list_campaigns() == []
    finally:
        mgr.shutdown()


def test_hierarchical_final_tag_accounting_is_reclaimed():
    mgr = CampaignManager(eval_workers=2, campaign_workers=2, device="cpu")
    try:
        cfg = HierarchicalConfig(k_per_stage=3, max_candidates=4, **TINY)
        res = run_hierarchical(SmoothedDct(), LIB, cfg, manager=mgr)
        per = mgr.scheduler.stats()["per_campaign"]
        assert set(res.stage_campaign_ids) <= set(per)
        assert not any("/final-" in k for k in per)
        assert res.ground_truth_calls["final"] > 0
    finally:
        mgr.shutdown()


# ---------------------------------------------------------------------------
# host state shared by the eval threads
# ---------------------------------------------------------------------------

def _hammer(fn, n_threads=8, timeout=120):
    """Run ``fn`` on ``n_threads`` threads released together, with a short
    switch interval so a read-modify-write race shows."""
    start = threading.Barrier(n_threads)
    errors = []

    def run():
        try:
            start.wait()
            fn()
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors


def test_launch_counter_counts_every_launch_from_8_threads(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", {"rank_k": 0})
    per_thread = 20000

    def launch():
        for _ in range(per_thread):
            _build.count_launch("rank_k")

    _hammer(launch)
    assert _build.LAUNCHES["rank_k"] == 8 * per_thread
    _build.reset_launches()
    assert _build.LAUNCHES["rank_k"] == 0
    # the increment waits for the lock (the interpreter may happen to
    # run an unlocked += without a switch, so the count alone can pass)
    with _build._LOCK:
        t = threading.Thread(target=_build.count_launch, args=("rank_k",))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive() and _build.LAUNCHES["rank_k"] == 0
    t.join(timeout=60)
    assert not t.is_alive() and _build.LAUNCHES["rank_k"] == 1


def test_engine_is_built_once_under_8_threads(monkeypatch):
    monkeypatch.setattr(fused, "_ENGINES", {})
    built = []
    real = fused._Engine

    class Counted(real):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(fused, "_Engine", Counted)
    engines = []
    _hammer(lambda: engines.append(fused.build_engine(LIB, device="cpu")))
    assert len(built) == 1
    assert len(engines) == 8 and all(e is engines[0] for e in engines)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_on_the_cpu_reruns_warm_from_its_store(tmp_path, monkeypatch,
                                                   capsys):
    import json

    from repro_torch.launch import dse_hier

    outs = []
    for run in range(2):
        out = tmp_path / f"h{run}.json"
        monkeypatch.setattr(sys, "argv", [
            "dse_hier", "--device", "cpu", "--hw", "v5e",
            "--n-train", "8", "--generations", "1", "--pop", "8",
            "--parents", "4", "--k-per-stage", "3", "--max-candidates", "4",
            "--store", str(tmp_path / "h.jsonl"), "--out", str(out)])
        dse_hier.main()
        outs.append(json.loads(out.read_text()))
    assert outs[0]["ground_truth_calls"]["total"] > 0
    assert outs[1]["ground_truth_calls"]["total"] == 0
    assert outs[0]["front"] == outs[1]["front"]
    assert "verified front" in capsys.readouterr().out
    # the process pool gives the thread backend's front
    out = tmp_path / "p.json"
    monkeypatch.setattr(sys, "argv", [
        "dse_hier", "--device", "cpu", "--hw", "v5e", "--eval-backend",
        "process", "--eval-workers", "1",
        "--n-train", "8", "--generations", "1", "--pop", "8",
        "--parents", "4", "--k-per-stage", "3", "--max-candidates", "4",
        "--out", str(out)])
    dse_hier.main()
    proc = json.loads(out.read_text())
    assert proc["front"] == outs[0]["front"]
    assert proc["eval_backend"]["process_batches"] > 0
    assert proc["eval_backend"]["process_fallbacks"] == 0
    with pytest.raises(SystemExit):
        monkeypatch.setattr(sys, "argv", ["dse_hier", "--eval-backend",
                                          "processes"])
        dse_hier.main()
