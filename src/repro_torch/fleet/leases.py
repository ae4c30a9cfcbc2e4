"""Fleet bookkeeping records: workers, chunks, leases, batches.

The unit of remote work is a *chunk* — a contiguous slice of one
coalesced label batch, small enough that losing a worker mid-batch only
requeues a slice, large enough to keep the batched simulation
vectorized.  A *lease* binds one chunk to one worker for a bounded
time; a chunk whose lease expires (or whose worker's heartbeats stop)
goes back to the pending queue with its requeue count bumped.  Chunks
requeued past ``max_requeues`` — or stranded with no live worker — are
reclaimed by the orchestrator thread that owns the batch and labeled
in-process, so a batch ALWAYS completes: worker failure costs time,
never labels.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

__all__ = ["WorkerRecord", "Chunk", "Lease", "FleetBatch"]


@dataclass
class WorkerRecord:
    """One registered worker's live state and counters."""

    id: str
    accels: Set[str] = field(default_factory=lambda: {"*"})
    fingerprints: Set[str] = field(default_factory=set)
    host: str = ""
    pid: Optional[int] = None
    registered_at: float = field(default_factory=time.time)
    last_seen: float = field(default_factory=time.monotonic)  # monotonic
    alive: bool = True
    rejoin_count: int = 0
    # counters
    labels: int = 0
    chunks: int = 0
    store_hits: int = 0
    busy_s: float = 0.0
    rejected_fps: Set[str] = field(default_factory=set)
    # the worker's device and cumulative kernel launches, as its latest
    # result reported them (launch counts live per process)
    device: str = ""
    launches: Dict[str, int] = field(default_factory=dict)

    def can_serve(self, desc: Dict) -> bool:
        """Advertised-capability gate: the worker serves a context when
        it advertised its accelerator name (or the ``"*"`` wildcard =
        any builtin), has not rejected the fingerprint, and — when it
        advertises verified fingerprints — when the fingerprint is
        among them."""
        fp = desc.get("fingerprint")
        if fp in self.rejected_fps:
            return False
        if fp in self.fingerprints:
            return True
        if "*" in self.accels:
            return True
        # stage views ("smoothed_dct/stage0") ride their pipeline's name
        name = desc.get("accel", "")
        base = name.split("/stage")[0]
        return name in self.accels or base in self.accels

    def labels_per_sec(self) -> float:
        return (self.labels / self.busy_s) if self.busy_s > 0 else 0.0


@dataclass
class Chunk:
    """A slice of one label batch: the remote unit of work."""

    batch: "FleetBatch"
    index: int                      # position within the batch
    desc: Dict                      # wire context descriptor
    genomes: np.ndarray
    state: str = "pending"          # pending | leased | done
    requeues: int = 0
    worker: Optional[str] = None    # worker that completed it
    wire: Optional[Dict] = None     # trace context of the owning batch


@dataclass
class Lease:
    """One chunk bound to one worker until ``deadline`` (monotonic)."""

    id: str
    chunk: Chunk
    worker: str
    issued_at: float
    deadline: float
    span: Optional[object] = None   # fleet.lease lifecycle span handle


class FleetBatch:
    """One coalesced label batch in flight across the fleet.  The
    orchestrator thread that created it blocks on ``done`` and
    reassembles ``parts`` in chunk order."""

    def __init__(self, ctx, chunks: int):
        self.ctx = ctx
        self.parts: List[Optional[Dict[str, np.ndarray]]] = [None] * chunks
        self.remaining = chunks
        self.done = threading.Event()

    def complete(self, chunk: Chunk, labels: Dict[str, np.ndarray]) -> bool:
        """Deliver one chunk's labels (idempotent: a late duplicate of a
        completed chunk is dropped).  Returns True if this call newly
        completed the chunk."""
        if chunk.state == "done":
            return False
        chunk.state = "done"
        self.parts[chunk.index] = labels
        self.remaining -= 1
        if self.remaining == 0:
            self.done.set()
        return True

    def assemble(self) -> Dict[str, np.ndarray]:
        from ..service.store import LABEL_KEYS

        return {
            k: np.concatenate([p[k] for p in self.parts])
            for k in LABEL_KEYS
        }
