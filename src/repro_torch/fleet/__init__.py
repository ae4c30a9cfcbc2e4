"""Multi-host labeling fleet: orchestrator/worker tier for ground truth.

One machine's process pool is the labeling economy's ceiling; this
package splits the campaign service's labeling across hosts:

  * ``orchestrator`` — ``FleetCoordinator``: leases coalesced genome
    batches to workers (pull-style), requeues on lease/heartbeat expiry,
    reclaims starved chunks in-process so batches always complete,
  * ``worker``       — ``python -m repro_torch.fleet.worker``: registers over
    HTTP, rebuilds evaluation contexts from wire descriptors behind the
    fingerprint gate, warm-starts from the shared label store + synth
    cache, labels leased chunks, streams results + heartbeats,
  * ``protocol``     — wire descriptors, label codecs, the portability
    gate shared with the process-pool labeler,
  * ``leases``       — worker/chunk/lease/batch records,
  * ``http``         — stdlib client with bounded retry, exponential
    backoff and jitter (every fleet edge and the service ``Client``).

The scheduler integration is ``EvalScheduler(backend="fleet")``: batches
go to the fleet when a live worker can serve them and degrade to the
in-process backend when the fleet is empty.  Worker failure is loss-free
by construction — labels are deterministic and content-addressed, so a
requeued chunk recomputes byte-identical records and duplicate commits
change nothing.
"""

from .http import HttpError, request_json
from .leases import Chunk, FleetBatch, Lease, WorkerRecord
from .orchestrator import FleetCoordinator, handle_fleet_request, serve_fleet
from .protocol import (
    PROTOCOL_VERSION,
    build_context,
    context_is_portable,
    ctx_descriptor,
    decode_labels,
    encode_labels,
)
# NOT imported eagerly: ``python -m repro_torch.fleet.worker`` first imports
# the package, and an eager ``from .worker import ...`` here would leave
# a half-initialized copy of the module runpy is about to execute
# (RuntimeWarning + double-import).  Lazy attribute access keeps
# ``from repro_torch.fleet import FleetWorker`` working for library users.


def __getattr__(name):
    if name == "FleetWorker":
        from .worker import FleetWorker

        return FleetWorker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "PROTOCOL_VERSION",
    "HttpError",
    "request_json",
    "Chunk",
    "FleetBatch",
    "Lease",
    "WorkerRecord",
    "FleetCoordinator",
    "handle_fleet_request",
    "serve_fleet",
    "FleetWorker",
    "ctx_descriptor",
    "build_context",
    "context_is_portable",
    "encode_labels",
    "decode_labels",
]
