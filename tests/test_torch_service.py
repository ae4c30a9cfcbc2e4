"""The port's in-process campaign service (``repro_torch.service``) on the
CPU, against the JAX package's:

* the evaluation context's fingerprint is the JAX package's signature
  plus the label count it names (``synth.LABEL_COUNT``), so under
  ``hw=V5E`` no key is shared; it differs between the H100 and v5e
  cost models; the device stays out of it;
* a ``.jsonl`` label store that the JAX package wrote answers no port
  context: every genome is labeled anew, its ``qor``/``energy`` equal
  to the stored bytes and its ``flops``/``hbm_bytes`` the port's own;
* the scheduler's store hits, in-flight dedup and duplicate rows in one
  call (the counterparts of ``tests/test_service.py``'s scheduler
  cases);
* two concurrent campaigns share labels and give ``run_dse``'s front; a
  warm store pays no ground truth;
* ``lm:<arch>`` campaigns run on the manager's device;
* the process and fleet backends and the serving hub run on the CPU
  (their own tests: ``tests/test_torch_workers.py``,
  ``test_torch_fleet.py``, ``test_torch_serving.py``); an unknown
  backend raises.

Every genome is drawn from a numpy seed."""

import hashlib
import threading
import time

import numpy as np
import pytest

from repro.accel import GaussianFilter as RefGaussian
from repro.accel import HEVCDct as RefHEVCDct
from repro.accel import MCMAccelerator as RefMCM
from repro.accel.smoothed_dct import SmoothedDct as RefSmoothedDct
from repro.core.acl.library import default_library as ref_library
from repro.service import EvalContext as RefEvalContext
from repro.service import EvalScheduler as RefEvalScheduler
from repro.service import JsonlLabelStore as RefJsonlLabelStore
from repro_torch.accel import (
    GaussianFilter, HEVCDct, LMAccelerator, MCMAccelerator,
)
from repro_torch.configs import get_config
from repro_torch.accel.smoothed_dct import SmoothedDct
from repro_torch.core.acl.library import default_library
from repro_torch.core.dse import run_dse
from repro_torch.core.hw import H100_SXM, V5E
from repro_torch.service import (
    CampaignManager,
    CampaignSpec,
    EvalContext,
    EvalScheduler,
    InMemoryLabelStore,
    JsonlLabelStore,
    make_accelerator,
)
from repro_torch.service import store as store_mod
from repro_torch.service.store import LABEL_KEYS, STORE_SCHEMA_VERSION

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()

SMALL = dict(n_train=10, n_qor_samples=2, pop_size=8, n_parents=4,
             n_generations=2)

# (port accelerator, the JAX package's) of every builtin image family
ACCELS = {
    "mcm2": (lambda: MCMAccelerator(1), lambda: RefMCM(1)),
    "gaussian3x3": (GaussianFilter, RefGaussian),
    "hevc_dct4x4": (HEVCDct, RefHEVCDct),
    "smoothed_dct": (SmoothedDct, RefSmoothedDct),
    "smoothed_dct/stage1": (lambda: SmoothedDct().stage_views()[1],
                            lambda: RefSmoothedDct().stage_views()[1]),
}


def _genomes(acc, n, seed):
    sizes = acc.gene_sizes(LIB)
    return np.random.default_rng(seed).integers(0, sizes, size=(n, len(sizes)))


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(ACCELS))
def test_fingerprint_equals_the_reference_under_v5e(name):
    """Under ``V5E`` the port's fingerprint differs from the JAX
    package's only by the label count it names: the two packages count
    flops and bytes differently, so no key is shared."""
    port, ref = ACCELS[name]
    want = RefEvalContext(ref(), RLIB, n_qor_samples=2).fingerprint
    got = EvalContext(port(), LIB, n_qor_samples=2, hw=V5E)
    assert got.fingerprint != want
    # the rest of the signature is the JAX package's: with the count's
    # term dropped, the digests are equal
    sig = "|".join([
        f"v{STORE_SCHEMA_VERSION}", store_mod._accel_fingerprint(got.accel),
        store_mod._library_fingerprint(LIB), "rank_genes=0",
        f"qor=2@{got.qor_seed}"])
    assert hashlib.sha256(sig.encode()).hexdigest()[:24] == want
    g = _genomes(got.accel, 3, 0)
    ref_ctx = RefEvalContext(ref(), RLIB, n_qor_samples=2)
    assert not {got.key(r) for r in g} & {ref_ctx.key(r) for r in g}


@pytest.mark.parametrize("name", list(ACCELS))
def test_fingerprint_keys_the_cost_model_not_the_device(name):
    port, _ = ACCELS[name]
    h100 = EvalContext(port(), LIB, n_qor_samples=2)
    assert h100.hw is H100_SXM
    v5e = EvalContext(port(), LIB, n_qor_samples=2, hw=V5E)
    assert h100.fingerprint != v5e.fingerprint
    for dev in ("cpu", "cuda"):
        assert EvalContext(port(), LIB, n_qor_samples=2,
                           device=dev).fingerprint == h100.fingerprint


def test_context_fingerprint_sensitivity():
    base = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2).fingerprint
    assert EvalContext(MCMAccelerator(1), LIB,
                       n_qor_samples=2).fingerprint == base
    for ctx in (EvalContext(MCMAccelerator(0), LIB, n_qor_samples=2),
                EvalContext(MCMAccelerator(1), LIB, rank_genes=True,
                            n_qor_samples=2),
                EvalContext(MCMAccelerator(1), LIB, n_qor_samples=3),
                EvalContext(MCMAccelerator(1),
                            LIB.subset([c.name for c in LIB.circuits[:40]]),
                            n_qor_samples=2)):
        assert ctx.fingerprint != base


# ---------------------------------------------------------------------------
# a store the JAX package wrote
# ---------------------------------------------------------------------------

def test_reference_written_store_is_read_without_ground_truth(tmp_path):
    """A store the JAX package wrote answers no port context: its flops
    and bytes are XLA's count, so the port labels every genome anew, with
    the stored qor and energy and its own flops and bytes."""
    path = str(tmp_path / "labels.jsonl")
    genomes = _genomes(MCMAccelerator(1), 12, 7)
    ref_store = RefJsonlLabelStore(path)
    ref_sched = RefEvalScheduler(ref_store, n_workers=1)
    ref_ctx = RefEvalContext(RefMCM(1), RLIB, n_qor_samples=2)
    want = ref_sched.label(ref_ctx, genomes)
    ref_sched.shutdown()
    ref_store.close()

    store = JsonlLabelStore(path)
    sched = EvalScheduler(store, n_workers=2)
    ctx = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2,
                      device="cpu", hw=V5E)
    got = sched.label(ctx, genomes)
    s = sched.stats()
    sched.shutdown()
    store.close()
    n = len(np.unique(genomes, axis=0))
    assert s["labeled"] == s["requests"] == n and s["store_hits"] == 0
    for k in ("qor", "energy"):
        assert got[k].tobytes() == want[k].tobytes(), k
    # flops and bytes are the port's own count, not the stored XLA ones
    fresh = ctx.ground_truth(genomes)
    for k in ("flops", "hbm_bytes", "latency"):
        assert got[k].tobytes() == fresh[k].tobytes(), k
    assert not np.array_equal(got["flops"], want["flops"])


def test_h100_labels_never_answer_a_v5e_context():
    store = InMemoryLabelStore()
    sched = EvalScheduler(store, n_workers=1)
    genomes = _genomes(MCMAccelerator(1), 6, 3)
    h100 = sched.label(EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2,
                                   device="cpu"), genomes)
    v5e = sched.label(EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2,
                                  device="cpu", hw=V5E), genomes)
    s = sched.stats()
    sched.shutdown()
    assert s["store_hits"] == 0 and s["labeled"] == 2 * len(genomes)
    assert h100["qor"].tobytes() == v5e["qor"].tobytes()
    assert not np.array_equal(h100["energy"], v5e["energy"])


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

class _CountingCtx:
    """EvalContext stand-in with an observable, slowable ground truth."""

    def __init__(self, delay: float = 0.0):
        self.calls = []
        self.delay = delay
        self.fingerprint = "counting"
        self._lock = threading.Lock()

    def key(self, genome):
        return "g" + "-".join(str(int(v)) for v in np.atleast_1d(genome))

    def ground_truth(self, genomes):
        genomes = np.atleast_2d(genomes)
        with self._lock:
            self.calls.append(len(genomes))
        if self.delay:
            time.sleep(self.delay)
        val = genomes.sum(axis=1).astype(float)
        return {k: val.copy() for k in LABEL_KEYS}


def test_scheduler_store_hits_and_batching():
    sched = EvalScheduler(InMemoryLabelStore(), n_workers=2, max_batch=8,
                          max_wait_s=0.01)
    ctx = _CountingCtx()
    genomes = np.arange(12).reshape(6, 2)
    out = sched.label(ctx, genomes, campaign="a")
    assert np.array_equal(out["qor"], genomes.sum(axis=1).astype(float))
    assert sum(ctx.calls) == 6
    out2 = sched.label(ctx, genomes, campaign="b")
    assert np.array_equal(out2["qor"], out["qor"])
    assert sum(ctx.calls) == 6
    s = sched.stats()
    assert s["store_hits"] == 6 and s["labeled"] == 6
    assert s["per_campaign"]["b"]["store_hits"] == 6
    assert s["per_campaign"]["b"]["labeled"] == 0
    sched.shutdown()


def test_scheduler_inflight_dedup():
    """Two concurrent requests for one genome -> one ground-truth call."""
    sched = EvalScheduler(InMemoryLabelStore(), n_workers=2, max_batch=8,
                          max_wait_s=0.05)
    ctx = _CountingCtx(delay=0.2)
    genomes = np.array([[7, 7], [8, 8]])
    results = {}

    def ask(tag):
        results[tag] = sched.label(ctx, genomes, campaign=tag)

    threads = [threading.Thread(target=ask, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert np.array_equal(results["a"]["qor"], results["b"]["qor"])
    assert sum(ctx.calls) == 2
    s = sched.stats()
    assert s["labeled"] == 2
    assert s["inflight_dedup_hits"] + s["store_hits"] == 2
    sched.shutdown()


def test_scheduler_duplicate_rows_one_call():
    """Duplicates within one submit dedupe in flight too."""
    sched = EvalScheduler(InMemoryLabelStore(), n_workers=1, max_batch=8,
                          max_wait_s=0.01)
    ctx = _CountingCtx()
    out = sched.label(ctx, np.array([[1, 2], [1, 2], [1, 2], [3, 4]]))
    assert sum(ctx.calls) == 2
    assert out["qor"].tolist() == [3.0, 3.0, 3.0, 7.0]
    assert sched.stats()["inflight_dedup_hits"] == 2
    sched.shutdown()


def test_scheduler_max_batch_sets_the_ground_truth_batches():
    sched = EvalScheduler(InMemoryLabelStore(), n_workers=1, max_batch=1000)
    ctx = _CountingCtx()
    sched.label(ctx, np.arange(2000).reshape(1000, 2))
    s = sched.stats()
    sched.shutdown()
    assert ctx.calls == [1000]
    assert s["batches"] == 1 and s["mean_batch_size"] == 1000.0


# ---------------------------------------------------------------------------
# campaigns
# ---------------------------------------------------------------------------

def test_two_concurrent_campaigns_share_labels():
    spec = CampaignSpec(accel="mcm2", **SMALL)
    ref = run_dse(MCMAccelerator(1), LIB, spec.dse_config(), device="cpu")
    mgr = CampaignManager(eval_workers=2, campaign_workers=2,
                          max_wait_s=0.02, device="cpu")
    try:
        c1, c2 = mgr.submit(spec), mgr.submit(spec)
        assert mgr.wait(c1, timeout=600) == "done"
        assert mgr.wait(c2, timeout=600) == "done"
        r1, r2 = mgr.result(c1), mgr.result(c2)
        assert np.array_equal(r1.front_genomes, r2.front_genomes)
        assert np.array_equal(r1.front_genomes, ref.front_genomes)
        assert r1.front_objectives.tobytes() == ref.front_objectives.tobytes()
        s = mgr.scheduler.stats()
        assert s["labeled"] < s["requests"]
        per = s["per_campaign"]
        saved = sum(v["store_hits"] + v["inflight_hits"]
                    for v in per.values())
        assert saved >= s["labeled"]
    finally:
        mgr.shutdown()


def test_warm_store_rerun_pays_no_ground_truth(tmp_path):
    path = str(tmp_path / "labels.jsonl")
    spec = CampaignSpec(accel="mcm2", **SMALL)
    fronts, stats = [], []
    for _ in range(2):
        store = JsonlLabelStore(path)
        mgr = CampaignManager(store, eval_workers=2, campaign_workers=1,
                              device="cpu")
        cid = mgr.submit(spec)
        assert mgr.wait(cid, timeout=600) == "done"
        fronts.append(mgr.result(cid).front_objectives)
        stats.append(mgr.scheduler.stats())
        mgr.shutdown()
        store.close()
    assert stats[0]["labeled"] > 0
    assert stats[1]["labeled"] == 0
    assert stats[1]["store_hits"] == stats[1]["requests"]
    assert fronts[0].tobytes() == fronts[1].tobytes()


def test_manager_passes_device_and_hw_to_its_contexts():
    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu",
                          hw=V5E)
    try:
        cid = mgr.submit(CampaignSpec(accel="mcm2", **SMALL))
        assert mgr.wait(cid, timeout=600) == "done"
        ctx = mgr._get(cid).ctx
        assert ctx.device == "cpu" and ctx.hw is V5E
        assert ctx.fingerprint == EvalContext(
            MCMAccelerator(1), LIB, n_qor_samples=2, hw=V5E).fingerprint
        assert ctx.fingerprint != RefEvalContext(
            RefMCM(1), RLIB, n_qor_samples=2).fingerprint
        assert mgr.status(cid)["front_size"] > 0
        assert mgr.health()["ok"]
        assert mgr.stats()["scheduler"]["backend"] == "thread"
    finally:
        mgr.shutdown()


def test_submit_validates_spec_upfront():
    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu")
    try:
        with pytest.raises(ValueError, match="unknown accelerator"):
            mgr.submit(CampaignSpec(accel="nope-such-accel", **SMALL))
        with pytest.raises(ValueError, match="n_train"):
            mgr.submit(CampaignSpec(accel="mcm2", **{**SMALL, "n_train": 0}))
        with pytest.raises(ValueError, match="n_parents"):
            mgr.submit(CampaignSpec(
                accel="mcm2", **{**SMALL, "pop_size": 4, "n_parents": 8}))
        with pytest.raises(ValueError, match="objectives"):
            mgr.submit(CampaignSpec(accel="mcm2",
                                    objectives=("qor", "nope"), **SMALL))
        assert mgr.list_campaigns() == []
    finally:
        mgr.shutdown()


# ---------------------------------------------------------------------------
# the backends and the serving tier (once unported, now run on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["process", "fleet"])
def test_unported_backends_raise(backend):
    """Both backends now run: the process pool labels in its children,
    an empty fleet falls back to the thread backend and counts it; the
    labels equal ground truth on the manager's device."""
    sched = EvalScheduler(InMemoryLabelStore(), backend=backend,
                          process_workers=1, device="cpu", max_wait_s=0.0)
    try:
        ctx = EvalContext(MCMAccelerator(1), LIB, n_qor_samples=2,
                          device="cpu")
        g = _genomes(ctx.accel, 4, seed=8)
        out = sched.label(ctx, g)
        want = ctx.ground_truth(g)
        for k in ("qor", "energy", "latency", "flops", "hbm_bytes"):
            assert out[k].tobytes() == want[k].tobytes()
        s = sched.stats()
        assert s["backend"] == backend
        if backend == "process":
            assert s["process_batches"] == 1 and s["labeler"]["labeled"] == 4
        else:
            assert s["fleet_fallbacks"] == 1 and s["fleet"]["live"] == 0
    finally:
        sched.shutdown()
    mgr = CampaignManager(eval_backend=backend, process_workers=1,
                          device="cpu")
    try:
        assert mgr.stats()["scheduler"]["backend"] == backend
    finally:
        mgr.shutdown()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="'thread'"):
        EvalScheduler(InMemoryLabelStore(), backend="threads")


def test_lm_accelerator_raises():
    """``lm:<arch>`` resolves to the port's LMAccelerator (reduced, its
    model on the factory's device), the encoder-decoder arch's too; an
    unknown arch raises ``ValueError``, the factory's contract."""
    acc = make_accelerator("lm:granite-8b", device="cpu")
    assert isinstance(acc, LMAccelerator)
    assert acc.name == "lm:granite-8b" and acc.cfg.n_layers == 2
    assert acc.device.type == "cpu"
    CampaignSpec(accel="lm:granite-8b", **SMALL).validate()
    # the encoder-decoder arch builds on its reduced config (2 + 2
    # layers), its model on the factory's device
    encdec = make_accelerator("lm:seamless-m4t-medium", device="cpu")
    assert isinstance(encdec, LMAccelerator)
    assert encdec.cfg.is_encoder_decoder and encdec.cfg.n_enc_layers == 2
    assert encdec.cfg.n_layers == 2 and encdec.device.type == "cpu"
    moe = make_accelerator("lm:granite-moe-3b-a800m", device="cpu")
    assert {"expert_in", "expert_out"} <= {s.name for s in moe.slots}
    with pytest.raises(ValueError, match="unknown accelerator"):
        CampaignSpec(accel="lm:no-such-arch", **SMALL).validate()


def test_lm_campaign_on_the_manager():
    """An ``lm:`` campaign on the thread backend labels on the manager's
    device with its cost model, and its front is ``run_dse``'s."""
    spec = CampaignSpec(accel="lm:granite-8b", **SMALL)
    ref = run_dse(LMAccelerator(get_config("granite-8b"), device="cpu"),
                  LIB, spec.dse_config(), device="cpu")
    mgr = CampaignManager(eval_workers=2, campaign_workers=1, device="cpu")
    try:
        cid = mgr.submit(spec)
        assert mgr.wait(cid, timeout=600) == "done", mgr.status(cid)
        ctx = mgr._get(cid).ctx
        assert ctx.accel.device.type == "cpu" and ctx.hw is H100_SXM
        assert "'device': 'cpu'" in ctx.accel.label_fingerprint()
        res = mgr.result(cid)
        assert np.array_equal(res.front_genomes, ref.front_genomes)
        assert res.front_objectives.tobytes() == ref.front_objectives.tobytes()
        assert (-res.front_objectives[:, 0]).max() == 100.0
    finally:
        mgr.shutdown()


def test_serving_tier_raises():
    """The serving hub exists now; before any campaign produced a front,
    serving an accelerator raises ``NoFrontError`` (HTTP 409)."""
    from repro_torch.serving import NoFrontError, ServingHub

    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu")
    try:
        assert isinstance(mgr.serving, ServingHub)
        assert mgr.serving is mgr.serving
        with pytest.raises(NoFrontError):
            mgr.serving.engine_for("mcm2")
        assert mgr.serving_stats() == {"engines": {}}
        assert mgr.stats()["serving"] == {"engines": {}}
    finally:
        mgr.shutdown()
