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
  (the pair checks are ``tests/_lm_dse_pair.py``'s, run one arch a
  file: ``tests/test_torch_lm_dse_granite.py``, ``_falcon.py``,
  ``_moe.py``);
* a tiny ``run_dse``, the CLI in-process (warm on its own store), the
  fingerprint's weight source and device, the per-call policy of one
  float32 model.

Genomes are drawn from numpy seeds."""

import json
import sys
import threading
from dataclasses import fields

import numpy as np
import pytest
import torch

from repro.accel.lm import proj_classes_for as ref_proj_classes_for
from repro.configs import get_config as ref_get_config
from repro.core import qor as ref_qor
from repro.launch.serve import policy_from_front as ref_policy_from_front
from repro.models import reduced as ref_reduced
from repro.serving import FrontCatalog as RefFrontCatalog
from repro_torch.accel import LMAccelerator, fused, proj_classes_for
from repro_torch.configs import get_config
from repro_torch.core import qor
from repro_torch.core.acl.library import default_library
from repro_torch.core.dse import DSEConfig, run_dse
from repro_torch.core.nsga2 import NSGA2Config
from repro_torch.kernels.approx_matmul import from_circuit
from repro_torch.launch import dse_lm
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import build_model, policy_from_front
from repro_torch.models import ApproxPolicy, ModelConfig, Transformer, reduced
from repro_torch.serving import FrontCatalog
from repro_torch.service.store import EvalContext

from _lm_dse_pair import _expert_slots, _genomes
from _torch_threads import bounded_torch_threads  # noqa: F401

LIB = default_library()
ARCHS = ["granite-8b", "falcon-mamba-7b", "granite-moe-3b-a800m"]
MOE = "phi3.5-moe-42b-a6.6b"


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

