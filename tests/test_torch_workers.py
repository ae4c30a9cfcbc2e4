"""The port's process-pool labeler (``repro_torch.service.workers``) on
the CPU, against the thread backend and the JAX package:

* labels from two spawned children byte-equal to the thread backend's,
  and ``qor``/``energy`` to the JAX package's under ``hw=V5E``;
* the wire descriptor carries the cost model, so V5E and H100 contexts
  both pass the child's fingerprint gate, and a descriptor whose cost
  model drifted fails it;
* ``can_label`` is False for an ad-hoc registered pipeline and a subset
  library, and the scheduler then labels in process and counts the
  fallback;
* the children's synthesis, engine and launch counters are summed;
* what the portability rule decides for ``lm:granite-8b``;
* ``CampaignManager(eval_backend="process")`` gives the thread
  backend's front.

Two spawned workers at most, one pool for the file.  Every genome is
drawn from a numpy seed."""

import os

import numpy as np
import pytest

from repro.accel import GaussianFilter as RefGaussian
from repro.accel import MCMAccelerator as RefMCM
from repro.core.acl.library import default_library as ref_library
from repro.service import EvalContext as RefEvalContext
from repro_torch.accel import GaussianFilter, LMAccelerator, MCMAccelerator
from repro_torch.configs import get_config
from repro_torch.core.acl.library import default_library
from repro_torch.core.hw import H100_SXM, V5E
from repro_torch.fleet.protocol import (
    build_context,
    context_is_portable,
    ctx_descriptor,
)
from repro_torch.service import (
    CampaignManager,
    CampaignSpec,
    EvalContext,
    EvalScheduler,
    InMemoryLabelStore,
    ProcessPoolLabeler,
    make_accelerator,
    register_accelerator,
    unregister_accelerator,
)

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

# label keys that are a pure function of (context, genome)
DET_KEYS = ("qor", "latency", "energy", "flops", "hbm_bytes")
SMALL = dict(n_train=10, n_qor_samples=2, pop_size=8, n_parents=4,
             n_generations=2)

ACCELS = {"mcm2": (lambda: MCMAccelerator(1), lambda: RefMCM(1)),
          "gaussian3x3": (GaussianFilter, RefGaussian)}


def _genomes(acc, n, seed):
    sizes = acc.gene_sizes(LIB)
    g = np.random.default_rng(seed).integers(0, sizes, size=(n, len(sizes)))
    g[0] = acc.exact_genome(LIB)
    return g


@pytest.fixture(scope="module")
def pool():
    p = ProcessPoolLabeler(2, device="cpu")
    yield p
    p.shutdown()


@pytest.mark.parametrize("hw", [V5E, H100_SXM], ids=["v5e", "h100"])
@pytest.mark.parametrize("name", list(ACCELS))
def test_process_labels_byte_equal_thread_and_reference(pool, name, hw):
    mine, ref = ACCELS[name]
    ctx = EvalContext(mine(), LIB, n_qor_samples=2, device="cpu", hw=hw)
    assert pool.can_label(ctx)
    g = _genomes(ctx.accel, 7, seed=3)
    got = pool.label(ctx, g)
    want = ctx.ground_truth(g)
    for k in DET_KEYS:
        assert got[k].tobytes() == want[k].tobytes(), k
    if hw is V5E:
        # the JAX package's context keys XLA-counted labels: another
        # fingerprint, but the same qor and energy
        rctx = RefEvalContext(ref(), RLIB, n_qor_samples=2)
        assert rctx.fingerprint != ctx.fingerprint
        rlab = rctx.ground_truth(g[:4])
        for k in ("qor", "energy"):
            assert got[k][:4].tobytes() == np.asarray(rlab[k]).tobytes(), k


@pytest.mark.parametrize("hw", [V5E, H100_SXM], ids=["v5e", "h100"])
def test_descriptor_carries_the_cost_model_not_the_device(hw):
    ctx = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2,
                      device="cpu", hw=hw)
    desc = ctx_descriptor(ctx)
    assert desc["hw"] == {V5E: "v5e", H100_SXM: "h100"}[hw]
    assert "device" not in desc
    rebuilt = build_context(desc, LIB, device="cpu")
    assert rebuilt.fingerprint == ctx.fingerprint and rebuilt.hw is hw
    # the other cost model is another fingerprint: the gate refuses it
    drifted = dict(desc, hw="h100" if hw is V5E else "v5e")
    with pytest.raises(RuntimeError, match="fingerprint"):
        build_context(drifted, LIB, device="cpu")


def test_can_label_refuses_what_a_child_cannot_rebuild(pool):
    register_accelerator("adhoc-mcm", lambda: MCMAccelerator(2))
    try:
        adhoc = make_accelerator("adhoc-mcm")
        adhoc.name = "adhoc-mcm"
        assert not pool.can_label(EvalContext(adhoc, LIB, device="cpu"))
    finally:
        unregister_accelerator("adhoc-mcm")
    sub = _subset()
    assert not pool.can_label(EvalContext(MCMAccelerator(1), sub,
                                          device="cpu"))
    assert pool.can_label(EvalContext(MCMAccelerator(1), LIB, device="cpu"))


def _subset():
    """The library less one approximate mul8s circuit: another library
    fingerprint, which no fresh process rebuilds."""
    drop = [c for c in LIB.kind("mul8s") if not c.is_exact][-1].name
    return LIB.subset([c.name for c in LIB.circuits if c.name != drop])


def test_unportable_context_falls_back_in_process_and_is_counted():
    sub = _subset()
    ctx = EvalContext(MCMAccelerator(1), sub, n_qor_samples=2, device="cpu")
    sched = EvalScheduler(InMemoryLabelStore(), backend="process",
                          process_workers=1, device="cpu", max_wait_s=0.0)
    try:
        g = np.stack([MCMAccelerator(1).exact_genome(sub)] * 2)
        g[1, 0] = 1
        out = sched.label(ctx, g)
        want = ctx.ground_truth(g)
        for k in DET_KEYS:
            assert out[k].tobytes() == want[k].tobytes()
        s = sched.stats()
        assert s["process_fallbacks"] == 1 and s["process_batches"] == 0
        assert s["labeler"]["labeled"] == 0
    finally:
        sched.shutdown()


def test_children_counters_are_summed(pool, tmp_path):
    before = pool.stats()
    ctx = EvalContext(GaussianFilter(), LIB, n_qor_samples=2, device="cpu")
    g = _genomes(ctx.accel, 6, seed=9)
    labels = pool.label(ctx, g)
    s = pool.stats()
    assert s["synth"]["workers_reporting"] == 2
    assert s["sim"]["workers_reporting"] == 2
    assert s["chunks"] - before["chunks"] == 4
    # every genome's run is paid in the child that labeled it (fresh
    # contexts, no shared cache): the children's summed runs grew by the
    # genomes whose label carries synthesis seconds
    paid = int(np.count_nonzero(labels["synth_time"] > 0))
    assert s["synth"]["compiles"] - before["synth"]["compiles"] == paid
    # launch counts live per child: summed latest-per-pid, and the
    # chunks in which each kernel ran (none on the CPU)
    assert set(s["launches"]) >= {"population_lut", "rank_k"}
    assert sum(s["launches"].values()) == 0 and s["chunks_launching"] == {}
    assert s["device"] == "cpu" and s["workers"] == 2


def test_merge_sums_launches_per_child_and_counts_chunks():
    """The parent's view of counts that live in its children: the latest
    cumulative counts per pid are summed; a chunk counts for each kernel
    it launched."""
    lab = ProcessPoolLabeler.__new__(ProcessPoolLabeler)
    lab._lock = __import__("threading").Lock()
    lab._worker_synth, lab._worker_sim = {}, {}
    lab._worker_launches, lab._chunks_launching = {}, {}

    def chunk(pid, total, delta):
        return {"_launches": {"pid": pid, "device": "cuda:0",
                              "total": total, "chunk": delta}}

    lab.merge([chunk(1, {"population_lut": 2, "rank_k": 3},
                     {"population_lut": 2, "rank_k": 3}),
               chunk(2, {"population_lut": 1, "rank_k": 0},
                     {"population_lut": 1, "rank_k": 0})])
    lab.merge([chunk(1, {"population_lut": 4, "rank_k": 3},
                     {"population_lut": 2, "rank_k": 0})])
    assert lab._worker_launches == {1: {"population_lut": 4, "rank_k": 3},
                                    2: {"population_lut": 1, "rank_k": 0}}
    assert lab._chunks_launching == {"population_lut": 3, "rank_k": 1}


def test_shared_synth_cache_path_surfaces_in_stats(tmp_path):
    """The counterpart of the JAX package's
    ``test_process_pool_stats_surface_synth_counters``: a pool riding
    one persistent synthesis cache file reports the children's runs."""
    path = str(tmp_path / "synth.jsonl")
    p = ProcessPoolLabeler(1, device="cpu", synth_cache_path=path)
    try:
        ctx = EvalContext(MCMAccelerator(0), LIB, n_qor_samples=2,
                          device="cpu")
        assert p.can_label(ctx)
        p.label(ctx, _genomes(ctx.accel, 3, seed=7))
        s = p.stats()
        assert s["synth"]["workers_reporting"] == 1
        assert s["synth"]["compiles"] > 0
        assert s["synth_cache_path"] == path and os.path.exists(path)
    finally:
        p.shutdown()


def test_lm_context_portability_rule():
    """``make_accelerator("lm:granite-8b")`` builds the reduced config
    from seed 0 on the given device: exactly such a context crosses a
    process.  The full-size accelerator (another config in the
    fingerprint), another seed and another device kind do not."""
    reduced = make_accelerator("lm:granite-8b", device="cpu")
    assert context_is_portable(EvalContext(reduced, LIB, device="cpu"))
    full = LMAccelerator(get_config("granite-8b"), use_reduced=False,
                         device="cpu")
    assert not context_is_portable(EvalContext(full, LIB, device="cpu"))
    seeded = LMAccelerator(get_config("granite-8b"), seed=1, device="cpu")
    assert not context_is_portable(EvalContext(seeded, LIB, device="cpu"))
    # a worker on another device kind derives another fingerprint
    assert not context_is_portable(EvalContext(reduced, LIB, device="cpu"),
                                   device="cuda")
    assert reduced._model is None and full._model is None


def test_manager_process_backend_front_equals_thread_backend():
    spec = CampaignSpec(accel="mcm2", **SMALL)
    fronts = {}
    for backend in ("thread", "process"):
        mgr = CampaignManager(eval_workers=2, campaign_workers=1,
                              eval_backend=backend, process_workers=2,
                              device="cpu")
        try:
            cid = mgr.submit(spec)
            assert mgr.wait(cid, timeout=600) == "done", mgr.status(cid)
            res = mgr.result(cid)
            fronts[backend] = (res.front_genomes, res.front_objectives)
            s = mgr.stats()["scheduler"]
            if backend == "process":
                assert s["process_batches"] > 0
                assert s["process_fallbacks"] == 0
                assert s["labeler"]["labeled"] == s["labeled"]
        finally:
            mgr.shutdown()
    assert np.array_equal(fronts["thread"][0], fronts["process"][0])
    assert fronts["thread"][1].tobytes() == fronts["process"][1].tobytes()
