"""Hierarchical DSE driver: staged-pipeline search via per-stage
campaigns, composition and end-to-end verification
(repro_torch.hierarchy).

    PYTHONPATH=src python -m repro_torch.launch.dse_hier \
        --accel smoothed_dct --n-train 36 --generations 6 --pop 24 \
        --store labels.jsonl

Labels run on ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain PyTorch versions) with the cost model ``--hw`` (default ``h100``;
``v5e`` gives the JAX package's labels and store keys), on the
``--eval-backend``: threads in this process, a spawned process pool on
``--device``, or a fleet of ``python -m repro_torch.fleet.worker``
processes that join the orchestrator this CLI starts.  Prints
per-stage campaign stats, the composition summary and the verified
application-level Pareto front, plus the ground-truth-call count
against the flat joint-genome space size.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .. import obs
from ..core.acl.library import default_library
from ..core.hw import HW_MODELS
from ..hierarchy.search import HierarchicalConfig, run_hierarchical
from ..service.campaigns import CampaignManager, make_accelerator

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--accel", default="smoothed_dct",
                    help="a staged pipeline accelerator name")
    ap.add_argument("--n-train", type=int, default=36)
    ap.add_argument("--generations", type=int, default=6)
    ap.add_argument("--pop", type=int, default=24)
    ap.add_argument("--parents", type=int, default=12)
    ap.add_argument("--pipeline", default="D", choices=list("BCDEF"))
    from ..core.strategies import available_strategies

    ap.add_argument("--strategy", default="nsga2",
                    choices=available_strategies(),
                    help="explorer for every stage campaign")
    ap.add_argument("--qor-samples", type=int, default=2)
    ap.add_argument("--k-per-stage", type=int, default=12)
    ap.add_argument("--max-candidates", type=int, default=64)
    ap.add_argument("--rank-genes", action="store_true")
    ap.add_argument("--store", default=None,
                    help="persistent JSONL label store shared by the "
                         "stage campaigns AND the final verification")
    ap.add_argument("--synth-cache", default=None,
                    help="persistent JSONL structural compile cache "
                         "shared by the stage campaigns (stage 0 rides "
                         "the standalone accelerator's compiles) and the "
                         "end-to-end verification")
    ap.add_argument("--eval-workers", type=int, default=2)
    ap.add_argument("--eval-backend", choices=("thread", "process", "fleet"),
                    default="thread",
                    help="ground-truth backend for every stage campaign: "
                         "threads, a process pool on --device, or a "
                         "multi-host fleet (an orchestrator HTTP listener "
                         "is started and 'python -m "
                         "repro_torch.fleet.worker' processes may join "
                         "mid-search)")
    ap.add_argument("--fleet-port", type=int, default=0,
                    help="orchestrator port for --eval-backend fleet "
                         "(0 = ephemeral)")
    ap.add_argument("--device", default="cuda",
                    help="where labels run: cuda (the kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--hw", choices=tuple(HW_MODELS), default="h100",
                    help="cost model of the hardware labels (v5e: the "
                         "JAX package's labels)")
    ap.add_argument("--campaign-workers", type=int, default=0,
                    help="0 = one worker per stage")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append finished spans (campaign ticks, label "
                         "batches, synth compiles) as JSON lines; export "
                         "with 'python -m repro_torch.obs.export PATH "
                         "--chrome-trace'")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.trace:
        obs.set_sink(args.trace)
        print(f"[dse-hier] tracing to {args.trace}")

    pipeline = make_accelerator(args.accel)
    if not hasattr(pipeline, "stage_views"):
        raise SystemExit(f"{args.accel!r} is not a staged pipeline")
    library = default_library()
    cfg = HierarchicalConfig(
        pipeline=args.pipeline,
        strategy=args.strategy,
        n_train=args.n_train,
        n_qor_samples=args.qor_samples,
        rank_genes=args.rank_genes,
        pop_size=args.pop,
        n_parents=args.parents,
        n_generations=args.generations,
        k_per_stage=args.k_per_stage,
        max_candidates=args.max_candidates,
        seed=args.seed,
    )

    store = None
    mgr_kw = dict(
        eval_workers=args.eval_workers,
        eval_backend=args.eval_backend,
        campaign_workers=args.campaign_workers or len(pipeline.stages),
        synth_cache=args.synth_cache or None,
        device=args.device,
        hw=HW_MODELS[args.hw],
    )
    if args.store:
        from ..service.store import open_label_store

        store = open_label_store(args.store)
        print(f"[dse-hier] label store {args.store}: {len(store)} entries")
    manager = CampaignManager(store, **mgr_kw)
    if manager.synth_cache is not None:
        print(f"[dse-hier] synth cache {args.synth_cache}: "
              f"{len(manager.synth_cache)} compiled structures")
    fleet_srv = None
    if args.eval_backend == "fleet":
        from ..fleet import serve_fleet

        fleet_srv = serve_fleet(manager.scheduler.fleet,
                                host="0.0.0.0", port=args.fleet_port)
        port = fleet_srv.server_address[1]
        print(f"[dse-hier] fleet orchestrator on :{port} — join workers "
              f"with: python -m repro_torch.fleet.worker --orchestrator "
              f"http://<this-host>:{port} --device {args.device}"
              + (f" --store {args.store}" if args.store else ""))
    try:
        res = run_hierarchical(pipeline, library, cfg,
                               manager=manager, verbose=True)
        sched = manager.scheduler.stats()
    finally:
        manager.shutdown()
        if fleet_srv is not None:
            fleet_srv.shutdown()
        if store is not None:
            store.close()

    print(f"\n[dse-hier] {pipeline.name}: "
          f"{len(pipeline.stages)} stages, flat space "
          f"{res.flat_space_size:.2e}")
    print(f"  per-stage campaigns: "
          + ", ".join(f"stage{i}={res.timings[f'stage{i}']:.1f}s"
                      for i in range(len(pipeline.stages)))
          + f" (max {res.max_concurrent_stages} in flight)")
    cs = res.compose_stats
    print(f"  composition: fronts {cs.stage_sizes} -> truncated "
          f"{cs.truncated_sizes} -> {cs.pairs_evaluated} pairs -> "
          f"{cs.survivors} survivors")
    gt = res.ground_truth_calls
    print(f"  ground truth: {gt['stage_campaigns']} stage + {gt['final']} "
          f"final = {gt['total']} calls")
    print(f"  eval backend {args.eval_backend}: "
          f"{sched['process_batches']} process / {sched['fleet_batches']} "
          f"fleet batches, {sched['process_fallbacks']} + "
          f"{sched['fleet_fallbacks']} fell back in-process")
    front = res.front_objectives
    order = np.argsort(front[:, 0])
    print(f"  verified front ({len(front)} designs) [PSNR dB, energy J]:")
    for i in order[:12]:
        print(f"    psnr={-front[i, 0]:7.2f}  energy={front[i, 1]:.3e}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "accel": args.accel,
                "timings": res.timings,
                "ground_truth_calls": gt,
                "flat_space_size": res.flat_space_size,
                "max_concurrent_stages": res.max_concurrent_stages,
                "front": front.tolist(),
                "front_genomes": res.front_genomes.tolist(),
                "val_pcc": res.val_pcc,
                "eval_backend": {
                    "backend": args.eval_backend,
                    **{k: sched[k] for k in (
                        "process_batches", "process_fallbacks",
                        "fleet_batches", "fleet_fallbacks")},
                },
            }, f, indent=1)


if __name__ == "__main__":
    main()
