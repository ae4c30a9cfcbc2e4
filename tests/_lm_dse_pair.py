"""The JAX package's and the port's LM accelerators on one arch's
carried parameters, and the checks ``tests/test_torch_lm_dse*.py`` hold
them to (one file an arch, so that no test worker carries the three
archs' XLA-compiled reference labels in a row).  A test file defines the
module-scoped fixture ``pair`` as ``make_pair(arch)`` and imports the
``test_*`` functions below, which pytest collects there."""

import jax
import numpy as np
import pytest
from scipy.stats import spearmanr

from repro.accel.lm import LMAccelerator as RefLM
from repro.configs import get_config as ref_get_config
from repro.core.acl.library import default_library as ref_library
from repro.core.features import synth as ref_synth
from repro_torch import convert
from repro_torch.accel import LMAccelerator
from repro_torch.configs import get_config
from repro_torch.core import qor
from repro_torch.core.acl.library import default_library
from repro_torch.core.features import synth
from repro_torch.core.hw import V5E
from repro_torch.models import reduced

LIB = default_library()
RLIB = ref_library()
ARCHS = ["granite-8b", "falcon-mamba-7b", "granite-moe-3b-a800m"]
MOE = "phi3.5-moe-42b-a6.6b"

# Both packages' logits are bf16 and differ by a rounding (0.12 at most,
# tests/test_models.py), which moves a design's PSNR a little: over 40
# numpy-seeded genomes of each reduced arch the two packages' QoR differ
# by at most 0.22 dB.  Half a dB holds that with room.
QOR_TOL_DB = 0.5
# flops and bytes are counted on the port's forward, XLA's on the JAX
# package's compile, which also counts the quantization passes, the
# casts of float32 parameters and other intermediates.  Spearman's rho
# between the two over numpy-seeded genomes of the reduced configs:
# flops 0.970-0.997, bytes 0.869-1.0 (these genomes; 0.916 and 0.928 on
# 24 others of each arch).  Bytes rank designs less alike: XLA charges
# the quantization a weight pays at every rank more than the count does.
RANK_RHO = {"flops": 0.95, "hbm_bytes": 0.8}
N_GENOMES = {"granite-8b": 10, "falcon-mamba-7b": 6,
             "granite-moe-3b-a800m": 8}


def _expert_slots(acc):
    return [i for i, s in enumerate(acc.slots)
            if s.name in ("expert_in", "expert_out")]


def _genomes(acc, n, seed):
    sizes = acc.gene_sizes(LIB)
    g = np.random.default_rng(seed).integers(0, sizes[None, :],
                                             size=(n, len(sizes)))
    g[0] = acc.exact_genome(LIB)
    # genome 2 is genome 1 with another LM-head circuit
    g[2] = g[1]
    g[2, -1] = (g[1, -1] + 1) % sizes[-1]
    # on an MoE arch, genomes 1 and 3 differ only in their expert genes:
    # a circuit deployed with a correction rank (costlier per product)
    # against the exact one
    ex = _expert_slots(acc)
    if ex:
        muls = LIB.kind("mul8s")
        ranked = next(i for i, c in enumerate(muls) if c.deploy_rank > 0)
        g[1, ex] = ranked
        g[3] = g[1]
        g[3, ex] = LIB.exact_index("mul8s")
    return np.asarray(g, dtype=np.int64)


def make_pair(arch):
    """(arch, the JAX package's accelerator, the port's on its carried
    parameters, genomes, the JAX package's labels under V5E, its
    synthesis records)."""
    racc = RefLM(ref_get_config(arch))
    tree = jax.tree.map(np.asarray, racc._ensure_params())
    cfg = get_config(arch)
    acc = LMAccelerator(cfg, device="cpu", params=convert.lm_params_from_numpy(
        tree, reduced(cfg)))
    g = _genomes(acc, N_GENOMES[arch], seed=7)
    inputs = acc.sample_inputs(2, seed=1234)
    ref_synth.reset_fast_codegen()
    rlab = ref_synth.label_variants(racc, g, RLIB, qor_inputs=inputs)
    rrecs = ref_synth.synthesize_batch(racc, [racc.decode(x, RLIB) for x in g])
    return arch, racc, acc, g, inputs, rlab, rrecs


def test_qor_batch_matches_reference(pair):
    arch, racc, acc, g, inputs, rlab, _ = pair
    got = acc.qor_batch(g, LIB, inputs, device="cpu")
    # the JAX package's QoR as its label_variants computed it (its
    # qor_batch), and its qor_batch called again on the first three
    # genomes (the exact one, one approximate, its LM-head twin): each
    # approximate genome is an XLA compile there
    want = rlab["qor"]
    assert np.array_equal(racc.qor_batch(g[:3], RLIB, inputs), want[:3])
    assert got[0] == want[0] == qor.PSNR_CAP
    assert np.all(got[1:] < qor.PSNR_CAP)
    assert np.max(np.abs(got - want)) <= QOR_TOL_DB
    # the LM head is never approximated: its gene leaves QoR unchanged;
    # nor are the experts
    assert got[1] == got[2] and want[1] == want[2]
    if _expert_slots(acc):
        assert not np.array_equal(g[1], g[3])
        assert got[1] == got[3] and want[1] == want[3]
    # again: the exact logits are cached, each distinct genome runs once
    # per input
    before = dict(acc.forwards)
    assert np.array_equal(acc.qor_batch(np.concatenate([g, g]), LIB, inputs,
                                        device="cpu"), np.concatenate([got, got]))
    assert acc.forwards["exact"] == before["exact"]
    assert (acc.forwards["qor"] - before["qor"]
            == len(np.unique(g, axis=0)) * len(inputs))


def test_hw_labels_match_reference_under_v5e(pair):
    arch, racc, acc, g, inputs, rlab, rrecs = pair
    lab = synth.label_variants(acc, g, LIB, qor_inputs=inputs, device="cpu",
                               hw=V5E, synth_cache=synth.SynthCache())
    recs = synth.synthesize_batch(acc, [acc.decode(x, LIB) for x in g],
                                  device="cpu", hw=V5E,
                                  synth_cache=synth.SynthCache())
    assert np.array_equal(lab["energy"], rlab["energy"])
    assert [r["mxu_flops_adjusted"] for r in recs] == [
        r["mxu_flops_adjusted"] for r in rrecs]
    assert np.max(np.abs(lab["qor"] - rlab["qor"])) <= QOR_TOL_DB
    for k in ("flops", "hbm_bytes"):
        rho = spearmanr(lab[k], rlab[k])[0]
        print(f"{arch} {k}: port/XLA {np.min(lab[k] / rlab[k]):.3f}.."
              f"{np.max(lab[k] / rlab[k]):.3f}, spearman {rho:.3f}")
        assert rho >= RANK_RHO[k]
        # the exact design is the cheapest in both; the LM head's gene is
        # a tie in both
        assert np.argmin(lab[k]) == np.argmin(rlab[k]) == 0
        assert lab[k][1] == lab[k][2] and rlab[k][1] == rlab[k][2]
        if _expert_slots(acc):
            # the expert genes do not change the graph in either package
            assert lab[k][1] == lab[k][3] and rlab[k][1] == rlab[k][3]
    if _expert_slots(acc):
        # ... but they move energy, by the same bits in both
        assert lab["energy"][1] != lab["energy"][3]
        assert lab["qor"][1] == lab["qor"][3]


def test_policy_for_genome_matches_reference(pair):
    arch, racc, acc, g, *_ = pair
    for rank_genes in (False, True):
        sizes = acc.gene_sizes(LIB, rank_genes=rank_genes)
        gs = np.random.default_rng(3).integers(0, sizes[None, :],
                                               size=(6, len(sizes)))
        for x in gs:
            got = acc.policy_for_genome(x, rank_genes=rank_genes)
            want = racc.policy_for_genome(x, rank_genes=rank_genes)
            assert dict(got.assignments) == dict(want.assignments)
    with pytest.raises(ValueError, match="expects"):
        acc.policy_for_genome(g[0][:-1])
    with pytest.raises(ValueError, match="expects"):
        racc.policy_for_genome(g[0][:-1])
