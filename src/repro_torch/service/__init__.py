"""Pareto-as-a-service: DSE campaigns as a long-lived service, in
process.

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
                     surrogates keyed by (accel, pipeline, model)).

The port's copy of the JAX package's service core.  Ground truth runs
on the ``thread`` backend, on the device the manager is given.  The
HTTP front end (``api.py``, ``__main__.py``), the process-pool labeler
(``workers.py``) and the fleet backend are not ported yet (ROADMAP §1
item 4).
"""

from .store import (
    EvalContext,
    InMemoryLabelStore,
    JsonlLabelStore,
    LabelStore,
    label_key,
)
from .scheduler import EvalScheduler
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
    "CampaignManager",
    "CampaignSpec",
    "HierarchicalSpec",
    "make_accelerator",
    "register_accelerator",
    "unregister_accelerator",
]
