"""DSE-on-LM driver: run the paper's surrogate-guided NSGA-II exploration
over the approximate-projection space of an assigned architecture.

    PYTHONPATH=src python -m repro_torch.launch.dse_lm --arch granite-8b \\
        --n-train 48 --generations 12 --pop 32 --device cpu

Prints the validation PCC of the two surrogates (paper Fig. 6 analogue),
the discovered Pareto front (QoR vs energy), and per-stage timings
(paper Fig. 5 analogue).

Labels run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain PyTorch versions) with the cost model ``--hw`` (default ``h100``;
``v5e`` gives the JAX package's hardware labels).  The model is the
arch's reduced config, as in the JAX package.  ``--store`` and
``--synth-cache`` go through the port's label store, scheduler and
synthesis cache.

With ``--service http://host:port`` the search runs as a campaign on a
running ``python -m repro_torch.service`` instance instead of in this
process: the CLI submits the spec, polls status, and prints the
front the service computed, on the service's device and cost model
(``--device`` and ``--hw`` then stay unused).  All HTTP goes through
``repro_torch.fleet.http`` (bounded retry + backoff), so a briefly
restarting service does not kill the CLI.  Point the service at
``--eval-backend fleet`` and the labeling itself fans out across every
registered fleet worker.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..accel.lm import LMAccelerator
from ..configs import get_config
from ..core.acl.library import default_library
from ..core.dse import DSEConfig, default_labeler, run_dse
from ..core.hw import HW_MODELS
from ..core.nsga2 import NSGA2Config

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--generations", type=int, default=12)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--parents", type=int, default=12)
    ap.add_argument("--pipeline", default="D", choices=list("BCDEF"))
    from ..core.strategies import available_strategies

    ap.add_argument("--strategy", default="nsga2",
                    choices=available_strategies(),
                    help="explorer: nsga2 (paper), bo (expected-"
                         "improvement Bayesian optimization), random, or "
                         "any registered custom strategy")
    ap.add_argument("--rank-genes", action="store_true",
                    help="beyond-paper: correction rank as a DSE axis")
    ap.add_argument("--store", default=None,
                    help="persistent JSONL label store: ground-truth labels "
                         "are reused across runs (repro_torch.service.store)")
    ap.add_argument("--synth-cache", default=None,
                    help="persistent JSONL structural synthesis cache: "
                         "deployment runs are reused across runs and "
                         "evaluation contexts (core.features.synth)")
    ap.add_argument("--eval-workers", type=int, default=2,
                    help="labeling worker threads when --store is set")
    ap.add_argument("--service", default=None, metavar="URL",
                    help="run on a campaign service instead of in-process: "
                         "submit the spec to this base URL (python -m "
                         "repro_torch.service; with --eval-backend fleet "
                         "the labels come from the whole fleet)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds to wait for the remote campaign "
                         "(--service only)")
    ap.add_argument("--device", default="cuda",
                    help="where labels run: cuda (the kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--hw", choices=tuple(HW_MODELS), default="h100",
                    help="cost model of the hardware labels (v5e: the "
                         "JAX package's labels)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.service:
        return _run_on_service(args)

    hw = HW_MODELS[args.hw]
    accel = LMAccelerator(get_config(args.arch), seed=args.seed,
                          device=args.device)
    lib = default_library()
    cfg = DSEConfig(
        pipeline=args.pipeline,
        strategy=args.strategy,
        n_train=args.n_train,
        n_qor_samples=2,
        rank_genes=args.rank_genes,
        nsga=NSGA2Config(
            pop_size=args.pop, n_parents=args.parents,
            n_generations=args.generations, seed=args.seed,
        ),
        seed=args.seed,
    )

    if args.synth_cache:
        from ..core.features import synth

        cache = synth.open_synth_cache(args.synth_cache)
        synth.set_shared_synth_cache(cache)
        print(f"[dse-lm] synth cache {args.synth_cache}: "
              f"{len(cache)} compiled structures")

    scheduler = store = None
    if args.store:
        from ..service.scheduler import EvalScheduler
        from ..service.store import EvalContext, open_label_store

        store = open_label_store(args.store)
        scheduler = EvalScheduler(store, n_workers=args.eval_workers)
        ctx = EvalContext(accel, lib, rank_genes=args.rank_genes,
                          n_qor_samples=cfg.n_qor_samples,
                          device=args.device, hw=hw)
        print(f"[dse-lm] label store {args.store}: {len(store)} entries")

        def labeler(genomes):
            return scheduler.label(ctx, genomes)
    else:
        labeler = default_labeler(accel, lib, rank_genes=args.rank_genes,
                                  n_qor_samples=cfg.n_qor_samples,
                                  device=args.device, hw=hw)

    try:
        res = run_dse(accel, lib, cfg, labeler=labeler, verbose=True,
                      device=args.device)
    finally:
        if scheduler is not None:
            s = scheduler.stats()
            print(f"[dse-lm] labeling: {s['requests']} requests, "
                  f"{s['store_hits']} store hits, {s['labeled']} synthesized "
                  f"(hit rate {s['label_hit_rate']:.0%})")
            scheduler.shutdown()
            store.close()

    print(f"\n[dse-lm] {accel.name} (strategy={args.strategy}, "
          f"device={args.device}, hw={args.hw})")
    print(f"  surrogate validation PCC: "
          + ", ".join(f"{k}={v:.3f}" for k, v in res.val_pcc.items()))
    print(f"  timings: " + ", ".join(
        f"{k}={v:.1f}s" for k, v in res.timings.items()))
    # search.genomes already includes the stage-1 training sample
    print(f"  surrogate evaluations: {res.search.n_evaluated} "
          f"(vs {len(res.search.genomes)} synth calls)")
    print(f"  model forwards: " + ", ".join(
        f"{k}={v}" for k, v in accel.forwards.items()))
    front = res.front_objectives
    order = np.argsort(front[:, 0])
    print(f"  Pareto front ({len(front)} designs)  [PSNR dB, energy J]:")
    for i in order[:12]:
        g = res.front_genomes[i]
        circuits, _ = accel.decode(g, lib, rank_genes=args.rank_genes)
        names = {s.name: c.name for s, c in zip(accel.slots, circuits)
                 if not c.is_exact}
        print(f"    psnr={-front[i,0]:7.2f}  energy={front[i,1]:.3e}  {names}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "arch": args.arch,
                "val_pcc": res.val_pcc,
                "timings": res.timings,
                "front": front.tolist(),
                "front_genomes": res.front_genomes.tolist(),
            }, f, indent=1)
    return res


def _run_on_service(args) -> dict:
    """Submit the spec as a campaign on a running service and report its
    result — the remote twin of the in-process path above.  Returns the
    service's result record."""
    from ..service.api import Client

    cli = Client(args.service)
    cid = cli.submit(
        accel=f"lm:{args.arch}",
        strategy=args.strategy,
        pipeline=args.pipeline,
        n_train=args.n_train,
        n_qor_samples=2,
        rank_genes=args.rank_genes,
        pop_size=args.pop,
        n_parents=args.parents,
        n_generations=args.generations,
        seed=args.seed,
    )
    print(f"[dse-lm] campaign {cid} submitted to {args.service}")
    st = cli.wait(cid, timeout=args.timeout)
    if st["state"] != "done":
        raise SystemExit(f"[dse-lm] campaign {cid} ended {st['state']}: "
                         f"{st.get('error') or 'timeout'}")
    res = cli.result(cid)
    front = np.asarray(res["front"], dtype=float)
    print(f"\n[dse-lm] lm:{args.arch} (strategy={args.strategy}, remote)")
    if res.get("val_pcc"):
        print("  surrogate validation PCC: "
              + ", ".join(f"{k}={v:.3f}" for k, v in res["val_pcc"].items()))
    order = np.argsort(front[:, 0])
    print(f"  Pareto front ({len(front)} designs)  [PSNR dB, energy J]:")
    for i in order[:12]:
        print(f"    psnr={-front[i, 0]:7.2f}  energy={front[i, 1]:.3e}")
    if args.out:
        detail = cli.front(cid)
        with open(args.out, "w") as f:
            json.dump({
                "arch": args.arch,
                "campaign": cid,
                "service": args.service,
                "val_pcc": res.get("val_pcc"),
                "front": front.tolist(),
                "front_genomes": detail["genomes"],
            }, f, indent=1)
    return res


if __name__ == "__main__":
    main()
