"""Pareto-as-a-service: DSE campaigns as a long-lived service.

The one-shot ``run_dse`` pays the full ground-truth bill (deployment
synthesis + behavioral simulation per variant) on every invocation and
discards the labels at exit.  This package makes exploration a
*service*:

  * ``store``      — persistent, content-addressed ground-truth label
                     store; labels from any campaign's stage 1/3 are
                     reused by every later campaign (cross-process),
  * ``scheduler``  — continuous-batching evaluation scheduler: coalesces
                     label requests from concurrent campaigns, dedupes
                     identical genomes in flight, fans batches out to a
                     worker pool,
  * ``campaigns``  — campaign manager + surrogate registry (warm fitted
                     surrogates keyed by (accel, pipeline, model)),
  * ``api``        — stdlib HTTP front end (``python -m
                     repro_torch.service``) with submit/status/result,
                     Pareto-front queries and ``POST /serve``.

Ground truth runs on one of three scheduler backends, on the device the
manager is given: ``thread`` (in process), ``process`` (spawn-safe pool,
one host, ``workers.py``), or ``fleet`` — the multi-host
orchestrator/worker tier in ``repro_torch.fleet``, where remote
``python -m repro_torch.fleet.worker`` processes lease coalesced genome
chunks over HTTP, each labeling on its own device, and the service
degrades to the in-process backend whenever the fleet is empty.
"""

from .store import (
    EvalContext,
    InMemoryLabelStore,
    JsonlLabelStore,
    LabelStore,
    label_key,
)
from .scheduler import EvalScheduler
from .workers import ProcessPoolLabeler
from .campaigns import (
    CampaignManager,
    CampaignSpec,
    HierarchicalSpec,
    make_accelerator,
    register_accelerator,
    unregister_accelerator,
)

__all__ = [
    "EvalContext",
    "LabelStore",
    "InMemoryLabelStore",
    "JsonlLabelStore",
    "label_key",
    "EvalScheduler",
    "ProcessPoolLabeler",
    "CampaignManager",
    "CampaignSpec",
    "HierarchicalSpec",
    "make_accelerator",
    "register_accelerator",
    "unregister_accelerator",
]
