"""The port's synthesis cache (``core/features/synth.py``): the identity
and structural tiers, first-K verification per graph family, the kill
switch, the persistent JSONL and segmented tiers, and the stage view
sharing its standalone accelerator's runs.  A "compile" here is one run
of a variant's deployment (on the CPU in these tests).

The first eleven cases are the in-process cases of the JAX package's
``tests/test_synth_structural.py``, carried over.  Its twelfth,
``test_process_pool_stats_surface_synth_counters``, needs the process
pool of ``service/workers.py``, which the port does not have yet, and is
left out.  The persistent cold/warm case also runs on a ``.segd``
root.  Then: a torn tail quarantined and a ``.jsonl`` cache migrated warm into
a ``.segd`` root; labels equal with structural keys on, off and warm
from a file, on four accelerators; runs paid equal the distinct structures
(counted with the JAX package's own ``deploy_signature``) plus the
verification runs; and the port's digests differ from the JAX
package's, so neither serves the other's cache file."""

import numpy as np
import pytest

from repro.accel import GaussianFilter as RefGaussian
from repro.accel import HEVCDct as RefHEVCDct
from repro.accel import MCMAccelerator as RefMCM
from repro.accel.smoothed_dct import SmoothedDct as RefSmoothedDct
from repro.core.acl.library import default_library as ref_library
from repro.core.features import synth as ref_synth
from repro.kernels.approx_matmul import from_circuit as ref_from_circuit
from repro_torch.accel import GaussianFilter, HEVCDct, MCMAccelerator
from repro_torch.accel.smoothed_dct import SmoothedDct
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.kernels.approx_matmul import from_circuit

from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
RLIB = ref_library()
CPU = dict(device="cpu")

# graph-derived label keys (deterministic); latency/energy are
# recomputed per variant from circuits/ranks on top of these
HW_KEYS = ("flops", "hbm_bytes", "latency", "energy")


def _variant(kind, names, n_adds=4):
    by = {c.name: c for c in LIB.kind(kind)}
    adds = list(LIB.kind("add16"))[:n_adds]
    circuits = [by[n] for n in names] + adds
    return circuits, [None] * len(names)


def _random_variants(accel, n, seed, rank_genes=False):
    rng = np.random.default_rng(seed)
    sizes = accel.gene_sizes(LIB, rank_genes=rank_genes)
    genomes = rng.integers(0, sizes[None, :], size=(n, len(sizes)))
    genomes[-1] = genomes[0]     # an exact duplicate rides the batch
    return genomes


def _serial_reference(accel, genomes, rank_genes=False):
    """Per-genome synthesize_variant, identity-keyed per-context dict
    cache, structural tier off."""
    synth.reset_fast_codegen()
    keep = synth.STRUCTURAL_KEYS
    synth.STRUCTURAL_KEYS = False
    try:
        cache = {}
        out = []
        for g in genomes:
            circuits, ranks = accel.decode(g, LIB, rank_genes=rank_genes)
            out.append(synth.synthesize_variant(
                accel, circuits, ranks, cache=cache, **CPU,
            ))
        return out
    finally:
        synth.STRUCTURAL_KEYS = keep
        synth.reset_fast_codegen()


# ---------------------------------------------------------------------------
# (a) structural equality property
# ---------------------------------------------------------------------------

def test_structurally_equal_specs_compile_to_identical_cost_numbers():
    """Different named circuits of one deployment class (same rank /
    trunc bits / signedness), and slot PERMUTATIONS of them, produce
    identical graph counts — the invariant the structural cache is keyed
    on.  Run with the structural tier OFF so every variant really runs."""
    accel = GaussianFilter()
    variants = [
        _variant("mul8u", ["mul8u_perf1"] * 3 + ["mul8u_drum3"] * 3
                 + ["mul8u_trunc2"] * 3),
        # same classes, different circuits
        _variant("mul8u", ["mul8u_perf4"] * 3 + ["mul8u_drum6"] * 3
                 + ["mul8u_trunc2"] * 3),
        # same classes, permuted slots
        _variant("mul8u", ["mul8u_trunc2"] * 3 + ["mul8u_perf2"] * 3
                 + ["mul8u_drum5"] * 3),
    ]
    keep = synth.STRUCTURAL_KEYS
    synth.STRUCTURAL_KEYS = False
    try:
        recs = [synth.synthesize_variant(accel, c, r, **CPU)
                for c, r in variants]
    finally:
        synth.STRUCTURAL_KEYS = keep
    assert len({r["flops"] for r in recs}) == 1
    assert len({r["hbm_bytes"] for r in recs}) == 1
    sigs = {
        accel.deploy_signature(
            [from_circuit(c, r) for c, r in zip(cs[:9], rs)]
        )
        for cs, rs in variants
    }
    assert len(sigs) == 1


def test_deploy_signature_distinguishes_real_structure():
    """Rank and truncated width changes MUST re-key: different classes,
    different signature (and genuinely different counts)."""
    accel = GaussianFilter()

    def sig(names):
        circuits, ranks = _variant("mul8u", names)
        specs = [from_circuit(c, r)
                 for c, r in zip(circuits[:9], ranks)]
        return accel.deploy_signature(specs)

    base = sig(["mul8u_perf1"] * 9)
    assert sig(["mul8u_perf4"] * 9) == base            # same class
    assert sig(["mul8u_drum3"] * 9) != base            # rank 1 -> 2
    assert sig(["mul8u_trunc2"] * 9) != sig(["mul8u_trunc4"] * 9)


# ---------------------------------------------------------------------------
# (b) synthesize_batch == the serial per-genome loop, everywhere
# ---------------------------------------------------------------------------

def _accelerators():
    return [
        GaussianFilter(),
        MCMAccelerator(0),
        HEVCDct(),
        SmoothedDct(),
    ] + SmoothedDct().stage_views()


@pytest.mark.parametrize("rank_genes", [False, True])
def test_synthesize_batch_matches_serial_loop_all_accelerators(rank_genes):
    for seed, accel in enumerate(_accelerators()):
        genomes = _random_variants(accel, 4, 300 + seed, rank_genes)
        ref = _serial_reference(accel, genomes, rank_genes)
        synth.reset_fast_codegen()
        variants = [accel.decode(g, LIB, rank_genes=rank_genes)
                    for g in genomes]
        recs = synth.synthesize_batch(accel, variants, **CPU)
        for t, (a, b) in enumerate(zip(ref, recs)):
            for k in HW_KEYS:
                assert a[k] == b[k], (accel.name, t, k)


def test_label_variants_rides_batch_and_matches(tmp_path):
    accel = MCMAccelerator(1)
    genomes = _random_variants(accel, 5, 17)
    inputs = accel.sample_inputs(2, seed=5)
    synth.reset_fast_codegen()
    keep = synth.STRUCTURAL_KEYS
    synth.STRUCTURAL_KEYS = False
    try:
        ref = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                                   cache={}, **CPU)
    finally:
        synth.STRUCTURAL_KEYS = keep
    synth.reset_fast_codegen()
    new = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                               cache={}, **CPU)
    for k in ("qor",) + HW_KEYS:
        assert np.array_equal(ref[k], new[k]), k


# ---------------------------------------------------------------------------
# (c) persistent cache: cold-then-warm does zero runs, labels exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".jsonl", ".segd"])
def test_persistent_cache_cold_then_warm_zero_compiles(tmp_path, suffix):
    accel = GaussianFilter()
    genomes = _random_variants(accel, 4, 23)
    inputs = accel.sample_inputs(2, seed=2)
    path = str(tmp_path / ("synth" + suffix))

    cold = synth.open_synth_cache(path)
    ref = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                               synth_cache=cold, **CPU)
    assert cold.stats()["compiles"] > 0
    cold.close()

    # 'restart': cold module state, fresh cache object on the same file
    synth.reset_fast_codegen()
    warm = synth.open_synth_cache(path)
    new = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                               synth_cache=warm, **CPU)
    assert warm.stats()["compiles"] == 0, warm.stats()
    assert warm.stats()["identity_hits"] > 0
    for k in ("qor",) + HW_KEYS:
        assert np.array_equal(ref[k], new[k]), k
    warm.close()


def test_torn_tail_quarantined_and_jsonl_migrates_warm_to_segd(tmp_path):
    """A torn last line and a malformed line of a ``.jsonl`` cache are
    quarantined and counted, the good records still serve; with
    ``migrate=True`` the file moves into a ``.segd`` root (kept as
    ``.migrated``) that answers the same batch with zero runs."""
    import os

    accel = MCMAccelerator(0)
    genomes = _random_variants(accel, 6, 29)
    variants = [accel.decode(g, LIB) for g in genomes]
    path = str(tmp_path / "synth.jsonl")
    cold = synth.JsonlSynthCache(path)
    want = synth.synthesize_batch(accel, variants, synth_cache=cold, **CPU)
    n_entries = len(cold)
    cold.close()
    with open(path, "a") as f:
        f.write("not json\n")
        f.write('{"k": "torn", "c": {"flops"')       # no newline: torn
    warm = synth.JsonlSynthCache(path)
    assert warm.stats()["quarantined"] == 1 and len(warm) == n_entries
    warm.close()

    seg = synth.open_synth_cache(path, migrate=True)
    assert isinstance(seg, synth.SegmentedSynthCache)
    assert os.path.isfile(path + ".migrated") and not os.path.exists(path)
    got = synth.synthesize_batch(accel, variants, synth_cache=seg, **CPU)
    assert seg.stats()["compiles"] == 0 and len(seg) == n_entries
    for a, b in zip(want, got):
        for k in HW_KEYS:
            assert a[k] == b[k], k
    seg.close()
    # a replica opening the .jsonl path now finds the migrated root
    again = synth.open_synth_cache(path)
    assert isinstance(again, synth.SegmentedSynthCache)
    assert len(again) == n_entries
    again.close()


def test_persistent_cache_verification_state_survives_restart(tmp_path):
    """A family verified cold stays verified warm: a NEVER-seen identity
    of a known structure is served with zero runs after a restart."""
    accel = GaussianFilter()
    path = str(tmp_path / "synth.jsonl")
    same_class = [
        ["mul8u_perf1"] * 9, ["mul8u_perf2"] * 9, ["mul8u_perf3"] * 9,
        ["mul8u_perf4"] * 9,
    ]
    cold = synth.JsonlSynthCache(path)
    synth.synthesize_batch(
        accel, [_variant("mul8u", n) for n in same_class],
        synth_cache=cold, **CPU,
    )
    s = cold.stats()
    assert s["compiles"] == 3 and s["verify_compiles"] == 2   # 1 fresh + K
    assert s["structural_hits"] == 1
    cold.close()

    synth.reset_fast_codegen()
    warm = synth.JsonlSynthCache(path)
    synth.synthesize_batch(
        accel, [_variant("mul8u", ["mul8u_perf5"] * 9)], synth_cache=warm,
        **CPU,
    )
    assert warm.stats()["compiles"] == 0, warm.stats()
    assert warm.stats()["structural_hits"] == 1


# ---------------------------------------------------------------------------
# verification scheme + kill switch
# ---------------------------------------------------------------------------

def test_structural_kill_switch_pins_to_identity_keys():
    accel = MCMAccelerator(2)
    v1 = _variant("mul8s", ["mul8s_perf1"] * 4, n_adds=3)
    v2 = _variant("mul8s", ["mul8s_perf2"] * 4, n_adds=3)
    keep = synth.STRUCTURAL_KEYS
    try:
        synth.STRUCTURAL_KEYS = False
        cache = synth.SynthCache()
        synth.synthesize_batch(accel, [v1, v2], synth_cache=cache, **CPU)
        s = cache.stats()
        assert s["compiles"] == 2 and s["structural_hits"] == 0
    finally:
        synth.STRUCTURAL_KEYS = keep


def test_pinned_family_stops_structural_serving():
    """A family whose verification diverged must run every identity
    exactly (structural records stop serving)."""
    accel = MCMAccelerator(3)
    cache = synth.SynthCache()
    v1 = _variant("mul8s", ["mul8s_perf1"] * 4, n_adds=3)
    synth.synthesize_batch(accel, [v1], synth_cache=cache, **CPU)
    specs = [from_circuit(c, r) for c, r in zip(v1[0][:4], v1[1])]
    family, _ = accel.deploy_signature(specs)
    fam = synth._digest("fam", tuple(family))
    cache.verdict_pin(fam)
    assert cache.verdict(fam) is False
    v2 = _variant("mul8s", ["mul8s_perf3"] * 4, n_adds=3)
    synth.synthesize_batch(accel, [v2], synth_cache=cache, **CPU)
    s = cache.stats()
    assert s["compiles"] == 2 and s["structural_hits"] == 0
    assert s["pinned_families"] == 1


def test_pin_after_verified_persists_across_restart(tmp_path):
    """``False == 0`` in Python: a pin landing AFTER the countdown
    reached 0 (verified) must still be appended to the cache file — a
    warm replay that resurrects the family as 'verified' would serve
    structural records for a family proven divergent."""
    path = str(tmp_path / "synth.jsonl")
    cache = synth.JsonlSynthCache(path)
    fam = "famX"
    for _ in range(synth._STRUCT_VERIFY_SAMPLES):
        cache.verdict_pass(fam)
    assert cache.verdict(fam) == 0 and cache.verdict(fam) is not False
    cache.verdict_pin(fam)       # concurrent verifier saw a divergence
    assert cache.verdict(fam) is False
    assert cache.stats()["verified_families"] == 0
    cache.close()
    warm = synth.JsonlSynthCache(path)
    assert warm.verdict(fam) is False, "pin lost across restart"
    warm.close()


def test_reset_fast_codegen_clears_all_verification_state():
    shared = synth.shared_synth_cache()
    shared.store({"k": "x", "s": "y", "fam": "z",
                  "flops": 1.0, "hbm_bytes": 2.0})
    synth.reset_fast_codegen()
    assert len(synth.shared_synth_cache()) == 0
    assert synth.shared_synth_cache() is not shared
    assert synth.synth_stats()["cache"]["entries"] == 0


# ---------------------------------------------------------------------------
# cross-accelerator sharing: stage view == standalone accelerator
# ---------------------------------------------------------------------------

def test_stage0_view_shares_standalone_gaussian_compiles():
    """smoothed_dct/stage0 deploys the very graphs gaussian3x3 deploys
    (same shapes, same in-situ input): their structural signatures are
    EQUAL, so labeling the view after the standalone accelerator costs
    only the family's first-K verification runs — after which every
    further view identity is served without a run."""
    pipe = SmoothedDct()
    stage0 = pipe.stage_views()[0]
    gauss = GaussianFilter()
    rng = np.random.default_rng(41)
    sizes = gauss.gene_sizes(LIB)
    genomes = rng.integers(0, sizes[None, :], size=(4, len(sizes)))

    cache = synth.SynthCache()
    synth.synthesize_batch(
        gauss, [gauss.decode(g, LIB) for g in genomes], synth_cache=cache,
        **CPU,
    )
    n0 = cache.stats()["compiles"]
    recs = synth.synthesize_batch(
        stage0, [stage0.decode(g, LIB) for g in genomes], synth_cache=cache,
        **CPU,
    )
    s = cache.stats()
    # the view's identities are new (different accel name) but its
    # structures are gaussian3x3's: only verification runs are paid
    assert s["compiles"] == n0 + synth._STRUCT_VERIFY_SAMPLES, s
    assert s["verify_compiles"] == synth._STRUCT_VERIFY_SAMPLES
    assert s["structural_hits"] >= 2
    assert all(r["flops"] > 0 for r in recs)
    # family now verified: NEW view identities of KNOWN structures
    # (multiplier genes rotated -> same sorted class multiset) are free
    more = np.array(genomes[:2])
    more[:, :9] = np.roll(more[:, :9], 1, axis=1)
    synth.synthesize_batch(
        stage0, [stage0.decode(g, LIB) for g in more], synth_cache=cache,
        **CPU,
    )
    assert cache.stats()["compiles"] == n0 + synth._STRUCT_VERIFY_SAMPLES


# ---------------------------------------------------------------------------
# beyond the carried-over cases
# ---------------------------------------------------------------------------

LABEL_CHECK_KEYS = ("qor", "latency", "energy", "flops", "hbm_bytes")


def _four_accelerators():
    return {"gaussian3x3": (GaussianFilter, RefGaussian),
            "mcm2": (lambda: MCMAccelerator(1), lambda: RefMCM(1)),
            "hevc_dct4x4": (HEVCDct, RefHEVCDct),
            "smoothed_dct": (SmoothedDct, RefSmoothedDct)}


@pytest.mark.parametrize("name", list(_four_accelerators()))
def test_labels_equal_structural_on_off_and_warm(tmp_path, name):
    accel = _four_accelerators()[name][0]()
    genomes = _random_variants(accel, 10, 71)
    inputs = accel.sample_inputs(2, seed=9)
    keep = synth.STRUCTURAL_KEYS
    try:
        synth.STRUCTURAL_KEYS = False
        off_cache = synth.SynthCache()
        off = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                                   synth_cache=off_cache, **CPU)
    finally:
        synth.STRUCTURAL_KEYS = keep
    path = str(tmp_path / "synth.jsonl")
    cold = synth.JsonlSynthCache(path)
    on = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                              synth_cache=cold, **CPU)
    cold.close()
    warm = synth.open_synth_cache(path)
    again = synth.label_variants(accel, genomes, LIB, qor_inputs=inputs,
                                 synth_cache=warm, **CPU)
    assert warm.stats()["compiles"] == 0
    warm.close()
    for k in LABEL_CHECK_KEYS:
        assert off[k].tobytes() == on[k].tobytes() == again[k].tobytes(), k
    # structural keys run fewer deployments, never more
    assert cold.stats()["compiles"] <= off_cache.stats()["compiles"]


def _reference_structures(ref_accel, genomes):
    """{family: (identities, structures)} of a genome set, counted with
    the JAX package's own ``deploy_signature`` (no compile)."""
    mul_idx = ref_accel.mul_slot_indices()
    fams = {}
    for g in genomes:
        circuits, ranks = ref_accel.decode(g, RLIB)
        specs = [ref_from_circuit(circuits[i], r)
                 for i, r in zip(mul_idx, ranks)]
        family, classes = ref_accel.deploy_signature(specs)
        ids, structs = fams.setdefault(repr(family), (set(), set()))
        ids.add(ref_synth._identity_signature(ref_accel, specs))
        structs.add(repr(classes))
    return fams


@pytest.mark.parametrize("name", list(_four_accelerators()))
def test_runs_paid_match_reference_signatures(name):
    """On a fixed 48-genome set, the runs paid on a fresh cache are the
    distinct structures plus, per family, min(K, identities that collide
    with a structure already run) verification runs; the structures are
    counted with the JAX package's signatures."""
    make, make_ref = _four_accelerators()[name]
    accel, ref_accel = make(), make_ref()
    genomes = _random_variants(accel, 48, 1234)
    fams = _reference_structures(ref_accel, genomes)
    n_struct = sum(len(s) for _, s in fams.values())
    n_verify = sum(min(synth._STRUCT_VERIFY_SAMPLES, len(i) - len(s))
                   for i, s in fams.values())
    cache = synth.SynthCache()
    synth.synthesize_batch(accel, [accel.decode(g, LIB) for g in genomes],
                           synth_cache=cache, **CPU)
    s = cache.stats()
    assert s["structures"] == n_struct, (s, n_struct)
    assert s["verify_compiles"] == n_verify
    assert s["compiles"] == n_struct + n_verify
    assert s["pinned_families"] == 0
    assert s["entries"] == sum(len(i) for i, _ in fams.values())


def test_port_digests_differ_from_reference():
    """The salt names the port's analytic count: an identity digest of
    the port never equals the JAX package's, so a cache file written by
    one package is never served to the other."""
    accel, ref_accel = GaussianFilter(), RefGaussian()
    g = _random_variants(accel, 1, 5)[0]
    specs = [from_circuit(c, r) for c, r in zip(*accel.decode(g, LIB))]
    ref_specs = [ref_from_circuit(c, r)
                 for c, r in zip(*ref_accel.decode(g, RLIB))]
    ikey = synth._identity_signature(accel, specs)
    assert ikey == ref_synth._identity_signature(ref_accel, ref_specs)
    assert synth._digest("id", ikey) != ref_synth._digest("id", ikey)
    assert "jax" not in synth._cache_salt()
