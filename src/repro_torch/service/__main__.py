"""Entry point: ``PYTHONPATH=src python -m repro_torch.service``.

Starts the campaign service with a persistent on-disk label store —
every ground-truth label any campaign pays for is reused by all later
campaigns, across restarts.  Labels run on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain PyTorch versions; a missing
card is an error) with the cost model ``--hw`` (default ``h100``;
``v5e`` gives the JAX package's labels and store keys)."""

from __future__ import annotations

import argparse

from .. import obs
from ..core.hw import HW_MODELS
from .api import serve
from .campaigns import CampaignManager
from .store import open_label_store


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Pareto-as-a-service: concurrent DSE campaigns with a "
                    "persistent label store and coalesced evaluation batching",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8177)
    ap.add_argument("--store", default="runs/service_labels.jsonl",
                    help="JSONL label-store path (persistent across runs)")
    ap.add_argument("--synth-cache", default="runs/service_synth.jsonl",
                    help="persistent structural synthesis cache (JSONL "
                         "sidecar next to the label store): warm runs, "
                         "restarted services and every process-pool "
                         "labeler worker share its runs; '' disables "
                         "persistence (in-process sharing only)")
    ap.add_argument("--eval-workers", type=int, default=2,
                    help="ground-truth labeling worker threads")
    ap.add_argument("--eval-backend", choices=("thread", "process", "fleet"),
                    default="thread",
                    help="where batched ground truth runs: in-process "
                         "threads, a spawn-safe process pool on --device "
                         "(parallelizes the labels' GIL-bound host work on "
                         "one host), or a multi-host labeling fleet (remote "
                         "workers join via 'python -m "
                         "repro_torch.fleet.worker --orchestrator "
                         "http://this-host:port --device cuda')")
    ap.add_argument("--device", default="cuda",
                    help="where labels and served requests run: cuda (the "
                         "kernels) or cpu (their plain PyTorch versions)")
    ap.add_argument("--hw", choices=tuple(HW_MODELS), default="h100",
                    help="cost model of the hardware labels (v5e: the "
                         "JAX package's labels)")
    ap.add_argument("--process-workers", type=int, default=None,
                    help="process-pool size (default: --eval-workers)")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="genomes per process-pool chunk (default: "
                         "auto, ~2 chunks per worker)")
    ap.add_argument("--fleet-fallback", choices=("thread", "process"),
                    default="thread",
                    help="in-process backend used when the fleet is empty "
                         "or a context cannot cross hosts")
    ap.add_argument("--lease-ttl", type=float, default=30.0,
                    help="seconds a fleet worker may hold a leased chunk "
                         "before it requeues")
    ap.add_argument("--heartbeat-ttl", type=float, default=15.0,
                    help="seconds of heartbeat silence before a fleet "
                         "worker is declared dead (its leases requeue)")
    ap.add_argument("--fleet-chunk", type=int, default=None,
                    help="genomes per fleet lease (default: auto, ~2 "
                         "chunks per live worker)")
    ap.add_argument("--campaign-workers", type=int, default=2,
                    help="campaign stepper threads (campaigns multiplex "
                         "cooperatively, so many more campaigns than "
                         "workers can be in flight)")
    ap.add_argument("--snapshots", default="runs/service_snapshots.jsonl",
                    help="campaign snapshot file: killed campaigns are "
                         "resumable via POST /campaigns/<id>/resume after "
                         "a restart ('' disables)")
    ap.add_argument("--hier-workers", type=int, default=1,
                    help="concurrently running hierarchical jobs (their "
                         "per-stage campaigns use the campaign workers)")
    ap.add_argument("--max-batch", type=int, default=32,
                    help="max label requests coalesced per batch")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="batch admission window (milliseconds)")
    ap.add_argument("--log-level", default=None,
                    choices=("debug", "info", "warning", "error"),
                    help="log verbosity (default: info; every record "
                         "carries campaign/worker correlation ids)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="append finished spans as JSON lines; export a "
                         "Perfetto-loadable trace with 'python -m "
                         "repro_torch.obs.export PATH --chrome-trace'")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    resolve_device(args.device)   # a missing card fails here, loudly
    obs.setup_logging(args.log_level
                      or ("debug" if args.verbose else "info"))
    log = obs.get_logger("service")
    if args.trace:
        obs.set_sink(args.trace)
        log.info("tracing to %s", args.trace)

    store = open_label_store(args.store, migrate=True)
    log.info("label store %s: %d entries", args.store, len(store))
    manager = CampaignManager(
        store,
        eval_workers=args.eval_workers,
        eval_backend=args.eval_backend,
        process_workers=args.process_workers,
        chunk_size=args.chunk_size,
        fleet_fallback=args.fleet_fallback,
        lease_ttl_s=args.lease_ttl,
        heartbeat_ttl_s=args.heartbeat_ttl,
        fleet_chunk=args.fleet_chunk,
        campaign_workers=args.campaign_workers,
        hier_workers=args.hier_workers,
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        snapshot_path=args.snapshots or None,
        synth_cache=args.synth_cache or None,
        device=args.device,
        hw=HW_MODELS[args.hw],
    )
    if manager.synth_cache is not None:
        log.info("synth cache %s: %d compiled structures",
                 args.synth_cache, len(manager.synth_cache))
    if args.snapshots:
        resumable = manager.snapshot_ids()
        if resumable:
            log.info("%d resumable campaign(s): %s",
                     len(resumable), ", ".join(resumable))
    if args.eval_backend == "fleet":
        log.info(
            "fleet orchestrator mounted at POST /fleet/* — join workers "
            "with: python -m repro_torch.fleet.worker --orchestrator "
            "http://%s:%s --device %s --store %s%s",
            args.host, args.port, args.device, args.store,
            f" --synth-cache {args.synth_cache}" if args.synth_cache else "",
        )
    serve(manager, args.host, args.port, quiet=not args.verbose)


if __name__ == "__main__":
    main()
