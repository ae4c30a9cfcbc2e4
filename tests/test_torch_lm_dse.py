"""The port's DSE on the LM (``repro_torch.accel.lm``, ``launch.dse_lm``,
``serving.catalog``, ``launch.serve --front``) on the CPU, against the
JAX package's, at the reduced configs:

* ``proj_classes_for`` on granite-8b, falcon-mamba-7b, granite-moe-3b
  and phi3.5-moe;
* with the JAX package's parameters carried across
  (``convert.lm_params_from_numpy``), QoR within ``QOR_TOL_DB`` (the
  exact genome at the cap in both), ``energy`` and ``mxu_flops_adjusted``
  bit for bit under ``hw=V5E``, ``flops`` and ``hbm_bytes`` ranking
  designs as XLA's do (``RANK_RHO``), the LM head's gene a tie in both;
  on granite-moe-3b, a genome that differs only in its expert genes
  keeps its QoR, flops and bytes and changes its energy in both (no
  policy reaches the experts);
* ``policy_for_genome``, the catalog and ``policy_from_front`` on a
  front the JAX package wrote;
* a tiny ``run_dse``, the CLI in-process (warm on its own store), the
  fingerprint's weight source and device, the per-call policy of one
  float32 model.

Genomes are drawn from numpy seeds."""

import json
import sys
import threading
from dataclasses import fields

import jax
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from repro.accel.lm import LMAccelerator as RefLM
from repro.accel.lm import proj_classes_for as ref_proj_classes_for
from repro.configs import get_config as ref_get_config
from repro.core import qor as ref_qor
from repro.core.acl.library import default_library as ref_library
from repro.core.features import synth as ref_synth
from repro.launch.serve import policy_from_front as ref_policy_from_front
from repro.models import reduced as ref_reduced
from repro.serving import FrontCatalog as RefFrontCatalog
from repro_torch import convert
from repro_torch.accel import LMAccelerator, fused, proj_classes_for
from repro_torch.configs import get_config
from repro_torch.core import qor
from repro_torch.core.acl.library import default_library
from repro_torch.core.dse import DSEConfig, run_dse
from repro_torch.core.features import synth
from repro_torch.core.hw import V5E
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.kernels.approx_matmul import from_circuit
from repro_torch.launch import dse_lm
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import build_model, policy_from_front
from repro_torch.models import ApproxPolicy, ModelConfig, Transformer, reduced
from repro_torch.serving import FrontCatalog
from repro_torch.service.store import EvalContext

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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, the JAX package's accelerator, the port's on its carried
    parameters, genomes, the JAX package's labels under V5E, its
    synthesis records)."""
    arch = request.param
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


@pytest.mark.parametrize("arch", ARCHS + [MOE])
@pytest.mark.parametrize("cut", ["reduced", "full"])
def test_proj_classes_match_reference(arch, cut):
    rcfg = ref_get_config(arch)
    if cut == "reduced":
        rcfg = ref_reduced(rcfg)
    cfg = get_config(arch)
    cfg = reduced(cfg) if cut == "reduced" else cfg
    # the port's config equals the JAX package's as data
    assert cfg == ModelConfig(**{f.name: getattr(rcfg, f.name)
                                 for f in fields(ModelConfig)})
    assert proj_classes_for(cfg) == ref_proj_classes_for(rcfg)
    acc = LMAccelerator(get_config(arch), use_reduced=cut == "reduced")
    assert [s.name for s in acc.slots] == [
        c for c, _ in ref_proj_classes_for(rcfg)]
    if cfg.n_experts:
        assert len(_expert_slots(acc)) == 2


def test_qor_batch_matches_reference(pair):
    arch, racc, acc, g, inputs, rlab, _ = pair
    got = acc.qor_batch(g, LIB, inputs, device="cpu")
    want = racc.qor_batch(g, RLIB, inputs)
    assert got[0] == want[0] == qor.PSNR_CAP
    assert np.all(got[1:] < qor.PSNR_CAP)
    assert np.max(np.abs(got - want)) <= QOR_TOL_DB
    assert np.array_equal(want, rlab["qor"])
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


def test_deploy_cost_and_signature():
    acc = LMAccelerator(get_config("granite-8b"), device="cpu")
    cfg = acc.cfg
    exact = [from_circuit(c) for c in acc.decode(acc.exact_genome(LIB),
                                                 LIB)[0]]
    m, d, hd = acc.batch * acc.seq, cfg.d_model, cfg.resolved_head_dim
    per_layer = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                 (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
                 (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    mats = per_layer * cfg.n_layers + [(d, cfg.padded_vocab)]
    pairs = acc.seq * (acc.seq + 1) / 2
    flops = sum(2.0 * m * k * n for k, n in mats)
    flops += cfg.n_layers * 4.0 * acc.batch * cfg.n_heads * hd * pairs
    assert acc.deploy_cost(exact)["flops"] == flops
    # an approximated class costs its rank's products and its gathers
    mitchell = from_circuit(LIB["mul8s_mitchell"])
    for i, slot in enumerate(acc.slots):
        specs = list(exact)
        specs[i] = mitchell
        cost = acc.deploy_cost(specs)
        fam, classes = acc.deploy_signature(specs)
        if slot.name == "lm_head":
            assert cost == acc.deploy_cost(exact)
            assert classes == acc.deploy_signature(exact)[1]
        else:
            assert cost["flops"] > flops
            assert classes != acc.deploy_signature(exact)[1]


def test_unfused_and_not_a_population_plan():
    acc = LMAccelerator(get_config("granite-8b"), device="cpu")
    assert fused._plan_for(acc, LIB, "cpu", required=False) is None
    with pytest.raises(NotImplementedError):
        acc.simulate_batch(acc.exact_genome(LIB)[None], LIB,
                           acc.sample_inputs(1), device="cpu")


def test_qor_helpers_match_reference():
    rng = np.random.default_rng(5)
    refs = rng.standard_normal((3, 4, 8, 16))
    outs = refs + 0.01 * rng.standard_normal(refs.shape)
    labels = rng.integers(0, 16, size=(4, 8))
    assert qor.mean_psnr(refs, outs) == ref_qor.mean_psnr(refs, outs)
    assert qor.mean_psnr(refs, outs, 4.0) == ref_qor.mean_psnr(refs, outs, 4.0)
    assert (qor.ce_delta(refs[0], outs[0], labels)
            == ref_qor.ce_delta(refs[0], outs[0], labels))


def test_tiny_run_dse():
    """tests/test_system.py's LM case, on the port."""
    cfg = get_config("granite-8b")
    classes = proj_classes_for(reduced(cfg))
    assert {"qkv", "ffn_in", "lm_head"} <= {c for c, _ in classes}
    accel = LMAccelerator(cfg, seq=16, device="cpu")
    res = run_dse(accel, LIB, DSEConfig(
        n_train=10, n_qor_samples=1,
        nsga=NSGA2Config(pop_size=8, n_parents=4, n_generations=2, seed=0),
    ), device="cpu")
    assert res.front_mask.any()
    assert res.true_objectives[:, 0].min() <= -20.0
    # the exact forward runs once for the run's one QoR input
    assert accel.forwards["exact"] == 1


def test_dse_lm_cli_in_process_warm_on_its_store(tmp_path, capsys):
    store = str(tmp_path / "lm.jsonl")
    common = ["--device", "cpu", "--n-train", "10", "--generations", "2",
              "--pop", "8", "--parents", "4", "--store", store]
    dse_lm.main(common + ["--out", str(tmp_path / "a.json")])
    cold = capsys.readouterr().out
    assert "0 store hits" in cold and "lm:granite-8b" in cold
    dse_lm.main(common + ["--out", str(tmp_path / "b.json")])
    warm = capsys.readouterr().out
    assert " 0 synthesized" in warm and "hit rate 100%" in warm
    a = json.loads((tmp_path / "a.json").read_text())
    b = json.loads((tmp_path / "b.json").read_text())
    for k in ("front", "front_genomes", "val_pcc"):
        assert a[k] == b[k]
    # --service posts the same search to a campaign service instead
    from repro_torch.service import CampaignManager
    from repro_torch.service.api import make_server

    mgr = CampaignManager(eval_workers=2, campaign_workers=1, device="cpu")
    srv = make_server(mgr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        res = dse_lm.main(common[:-2] + [
            "--service", f"http://127.0.0.1:{srv.server_address[1]}",
            "--out", str(tmp_path / "c.json")])
    finally:
        srv.shutdown()
        mgr.shutdown()
    remote = capsys.readouterr().out
    assert "remote" in remote and res["state"] == "done"
    c = json.loads((tmp_path / "c.json").read_text())
    assert c["front"] == res["front"] and len(c["front_genomes"]) > 0


@pytest.mark.parametrize("tier", ["exact", "balanced", "budget"])
def test_policy_from_front_reads_a_reference_front(tmp_path, tier):
    acc = LMAccelerator(get_config("granite-8b"), use_reduced=False)
    g = _genomes(acc, 12, seed=11)
    rng = np.random.default_rng(11)
    front = np.stack([-rng.uniform(10, 100, len(g)),
                      rng.uniform(1e-6, 1e-5, len(g))], axis=1)
    cat = RefFrontCatalog.from_front("lm:granite-8b", g, front)
    path = tmp_path / "front.json"
    path.write_text(json.dumps(cat.to_json()))
    port_cat = FrontCatalog.from_file(str(path))
    assert port_cat.to_json() == RefFrontCatalog.from_file(str(path)).to_json()
    assert port_cat.tiers == cat.tiers
    policy, sel = policy_from_front(get_config("granite-8b"), str(path), tier)
    rpolicy, rsel = ref_policy_from_front(ref_get_config("granite-8b"),
                                          str(path), tier)
    assert sel.point.genome == rsel.point.genome
    assert dict(policy.assignments) == dict(rpolicy.assignments)
    assert sel.point.genome == tuple(cat.points[cat.tiers[tier]].genome)


def test_serve_cli_front_tier(tmp_path, capsys):
    acc = LMAccelerator(get_config("granite-8b"))
    g = _genomes(acc, 4, seed=2)
    front = np.array([[-100.0, 4e-6], [-40.0, 3e-6], [-30.0, 2e-6],
                      [-20.0, 1e-6]])
    path = tmp_path / "front.json"
    path.write_text(json.dumps(
        FrontCatalog.from_front("lm:granite-8b-smoke", g, front).to_json()))
    serve_cli.main(["--arch", "granite-8b", "--reduced", "--front", str(path),
                    "--tier", "budget", "--device", "cpu", "--batch", "1",
                    "--prompt-len", "4", "--gen", "2"])
    out = capsys.readouterr().out
    assert f"tier=budget genome={g[3].tolist()}" in out
    assert "WARNING" not in out
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", "granite-8b", "--reduced", "--front",
                        str(path), "--approx", "mul8s_trunc2",
                        "--device", "cpu"])


def test_fingerprint_carries_weights_and_device():
    cfg = get_config("granite-8b")
    small = reduced(cfg)
    seeded = LMAccelerator(cfg, device="cpu")
    sd = build_model(small, seed=0, device="cpu").state_dict()
    carried = LMAccelerator(cfg, device="cpu", params=sd)
    on_card = LMAccelerator(cfg, device="cuda")
    fps = {a.label_fingerprint() for a in (seeded, carried, on_card)}
    assert len(fps) == 3
    ctxs = {EvalContext(a, LIB).fingerprint
            for a in (seeded, carried, on_card)}
    assert len(ctxs) == 3
    # an accelerator asked for its fingerprint first is pinned to the
    # default device, so no other device's labels land under it
    unpinned = LMAccelerator(cfg)
    assert "'device': 'cuda'" in unpinned.label_fingerprint()
    with pytest.raises(ValueError, match="lives on"):
        unpinned.qor_batch(unpinned.exact_genome(LIB)[None], LIB,
                           unpinned.sample_inputs(1), device="cpu")


def test_per_call_policy_on_one_float32_model():
    """One float32 model under a policy per call gives the bits of the
    model built under that policy; the LM head's assignment changes
    nothing."""
    cfg = reduced(get_config("granite-8b"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    pol = ApproxPolicy({"qkv": ("mul8s_mitchell", None),
                        "ffn_out": ("mul8s_trunc2", None)})
    one = Transformer(cfg, device="cpu", proj_dtype=torch.float32)
    one.init_weights(3)
    assert one.layers[0].attn.wq.dtype == torch.float32
    built = build_model(cfg, policy=pol, seed=3, device="cpu")
    exact = build_model(cfg, seed=3, device="cpu")
    assert torch.equal(one(toks, policy=pol), built(toks))
    assert torch.equal(one(toks, policy=ApproxPolicy.exact()), exact(toks))
    assert torch.equal(built(toks, policy=ApproxPolicy.exact()), exact(toks))
    head = ApproxPolicy({"lm_head": ("mul8s_mitchell", None)})
    assert torch.equal(one(toks, policy=head), exact(toks))


def test_one_model_and_exact_counts_under_threads():
    """The campaign service's eval threads label one accelerator at once:
    the model is built once and no forward count is lost."""
    acc = LMAccelerator(get_config("falcon-mamba-7b"), seq=8, device="cpu")
    inputs = acc.sample_inputs(1, seed=4)
    sizes = acc.gene_sizes(LIB)
    batches = [np.random.default_rng(i).integers(0, sizes[None, :],
                                                 size=(3, len(sizes)))
               for i in range(12)]
    models, errors = set(), []

    def work(g):
        try:
            acc.qor_batch(g, LIB, inputs, device="cpu")
            models.add(id(acc.model))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(g,)) for g in batches]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(models) == 1
    want = sum(len(np.unique(g, axis=0)) for g in batches) * len(inputs)
    assert acc.forwards["qor"] == want
    assert 1 <= acc.forwards["exact"] <= len(batches)

