"""Persistent, content-addressed ground-truth label store.

A label is the full ``synth.label_variants`` record for ONE genome under
ONE evaluation context.  The key is a digest of everything the label is
a pure function of:

    (accelerator fingerprint, library fingerprint, rank_genes,
     QoR-input signature, genome bytes)

so a store written by one campaign (or one process) is safely readable
by any later campaign: a hit is bit-identical to re-running synthesis +
simulation, and a context change (different circuit library, different
accelerator wiring, different QoR sample set) changes the key and misses
cleanly instead of serving stale labels.

Two implementations of the small ``LabelStore`` interface:

  * ``InMemoryLabelStore`` — a dict; the service's hot tier and the
    drop-in replacement for the old per-call ``synth_cache``,
  * ``JsonlLabelStore``    — append-only JSON-lines file on disk with an
    in-memory index; concurrent writers append under a lock, readers
    see every record from any prior process.

The port's copy of the JAX package's store.  ``EvalContext`` carries
two more fields: ``device`` (where ground truth runs; machinery, out of
the fingerprint, since the image accelerators' labels are bit-identical
across devices; the LM's are float and differ, so ``LMAccelerator``
carries the device kind in its own ``label_fingerprint``) and
``hw``, the cost model of the hardware labels (semantics: every model
but ``V5E`` adds ``hw=<model>`` to the fingerprint, so an H100-costed
label never answers a v5e context or the reverse).  The fingerprint
also names how ``flops`` and ``hbm_bytes`` are counted
(``synth.LABEL_COUNT``: the port's analytic count, where the JAX
package reads XLA's ``cost_analysis``), under every ``hw``: only
``qor`` and ``energy`` are the same function in both packages, so a
store file the JAX package wrote misses here and its genomes are
labeled anew.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

import numpy as np

from .. import faults, obs
from ..core.acl.library import Library, library_fingerprint
from ..core.features import synth
from ..core.hw import H100_SXM, V5E, Hardware
from ..segments import SegmentedLog

__all__ = [
    "LABEL_KEYS",
    "STORE_SCHEMA_VERSION",
    "EvalContext",
    "label_key",
    "LabelStore",
    "InMemoryLabelStore",
    "JsonlLabelStore",
    "SegmentedLabelStore",
    "open_label_store",
]

_log = obs.get_logger("store")

# the per-genome record produced by synth.label_variants
LABEL_KEYS = synth.LABEL_KEYS

# bump when the label semantics change (e.g. a new energy model): old
# store files then miss instead of serving stale ground truth
STORE_SCHEMA_VERSION = 1


# Content digest of a library (moved to core.acl.library so the batched
# sim's LUT caches can key on it without importing the service tier).
_library_fingerprint = library_fingerprint


def _accel_fingerprint(accel) -> str:
    """Digest of the accelerator's labeling-relevant structure.

    Accelerators may expose ``label_fingerprint()`` for extra state their
    labels depend on; otherwise common identity knobs (init seed, input
    batch/seq) are picked up by attribute convention."""
    try:
        shape = tuple(int(v) for v in accel.matmul_shape())
    except NotImplementedError:
        shape = ()
    sig = {
        "name": accel.name,
        "slots": [(s.name, s.kind, float(s.weight)) for s in accel.slots],
        "matmul_shape": shape,
        "passes": int(getattr(accel, "deploy_passes", 1)),
    }
    if hasattr(accel, "label_fingerprint"):
        sig["extra"] = str(accel.label_fingerprint())
    else:
        sig["extra"] = {
            k: repr(getattr(accel, k))
            for k in ("seed", "batch", "seq") if hasattr(accel, k)
        }
    return hashlib.sha256(
        json.dumps(sig, sort_keys=True).encode()
    ).hexdigest()[:16]


@dataclass
class EvalContext:
    """Everything a ground-truth label is conditioned on, bundled with
    the machinery to produce labels for a genome batch.

    ``fingerprint`` keys the store; ``ground_truth`` is the slow path
    (deployment synthesis + behavioral simulation on ``device``, default
    ``"cuda"``, costed on ``hw``).  A per-context synthesis cache keeps
    the old spec-level compile reuse within a process."""

    accel: object
    library: Library
    rank_genes: bool = False
    n_qor_samples: int = 4
    qor_seed: int = synth.DEFAULT_QOR_SEED
    # shared/persistent compile cache (synth.SynthCache); None uses the
    # process-wide default.  Machinery, not semantics: deliberately NOT
    # part of the fingerprint — labels are identical with or without it
    synth_cache: Optional[object] = field(default=None, repr=False)
    # where ground truth runs (None: "cuda"); machinery like synth_cache
    device: Optional[object] = field(default=None, repr=False)
    # the hardware labels' cost model: semantics, in the fingerprint
    hw: Hardware = H100_SXM
    _fp: Optional[str] = field(default=None, repr=False)
    _qor_inputs: Optional[np.ndarray] = field(default=None, repr=False)
    _synth_cache: dict = field(default_factory=dict, repr=False)

    @property
    def fingerprint(self) -> str:
        if self._fp is None:
            sig = "|".join([
                f"v{STORE_SCHEMA_VERSION}",
                _accel_fingerprint(self.accel),
                _library_fingerprint(self.library),
                f"rank_genes={int(self.rank_genes)}",
                f"qor={self.n_qor_samples}@{self.qor_seed}",
                f"count={synth.LABEL_COUNT}",
            ] + ([] if self.hw == V5E else [f"hw={self.hw!r}"]))
            self._fp = hashlib.sha256(sig.encode()).hexdigest()[:24]
        return self._fp

    @property
    def qor_inputs(self) -> np.ndarray:
        if self._qor_inputs is None:
            self._qor_inputs = self.accel.sample_inputs(
                self.n_qor_samples, seed=self.qor_seed
            )
        return self._qor_inputs

    def key(self, genome: np.ndarray) -> str:
        return label_key(self.fingerprint, genome)

    def ground_truth(self, genomes: np.ndarray) -> Dict[str, np.ndarray]:
        """The slow path: label a genome batch from scratch."""
        return synth.label_variants(
            self.accel, np.atleast_2d(genomes), self.library,
            rank_genes=self.rank_genes, qor_inputs=self.qor_inputs,
            cache=self._synth_cache, synth_cache=self.synth_cache,
            device=self.device, hw=self.hw,
        )


def label_key(ctx_fingerprint: str, genome: np.ndarray) -> str:
    g = np.asarray(genome, dtype=np.int64)
    h = hashlib.sha256(ctx_fingerprint.encode())
    h.update(g.tobytes())
    return h.hexdigest()[:32]


class LabelStore:
    """Interface: map ``key -> {label name -> float}`` with hit/miss
    accounting.  Implementations must be thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        # standalone sharded instruments (race-free increments from any
        # worker thread); register_metrics() publishes THIS instance's
        # instruments to the scrape registry — the scheduler does that
        # for the store it owns, so GET /metrics shows the service
        # store, not whichever ephemeral store was built last
        self.hits = obs.Counter(
            "repro_store_hits_total", "label store lookups served")
        self.misses = obs.Counter(
            "repro_store_misses_total", "label store lookups missed")

    def register_metrics(self, registry=None) -> None:
        reg = registry or obs.REGISTRY
        for inst in (self.hits, self.misses):
            reg._register(inst)
        self._entries_gauge = reg.gauge(
            "repro_store_entries", "unique labels in the store")
        with self._lock:
            self._entries_gauge.set(self._len())

    def get(self, key: str) -> Optional[Dict[str, float]]:
        with self._lock:
            rec = self._get(key)
        if rec is None:
            self.misses.inc()
        else:
            self.hits.inc()
        return rec

    def put(self, key: str, labels: Dict[str, float]) -> None:
        rec = {k: float(labels[k]) for k in LABEL_KEYS}
        with self._lock:
            self._put(key, rec)

    def put_many(self, items) -> None:
        """Store a labeled batch under ONE lock acquisition.  ``items``
        is an iterable of ``(key, labels)`` pairs; implementations may
        override ``_put_batch`` to buffer the batch into a single
        backing write."""
        recs = [
            (key, {k: float(labels[k]) for k in LABEL_KEYS})
            for key, labels in items
        ]
        if not recs:
            return
        with self._lock:
            self._put_batch(recs)
            g = getattr(self, "_entries_gauge", None)
            if g is not None:
                g.set(self._len())

    def __len__(self) -> int:
        with self._lock:
            return self._len()

    def stats(self) -> Dict[str, float]:
        hits = int(self.hits.value)
        misses = int(self.misses.value)
        total = hits + misses
        with self._lock:
            n = self._len()
        return {
            "entries": n,
            "hits": hits,
            "misses": misses,
            "hit_rate": (hits / total) if total else 0.0,
        }

    def health(self) -> Dict[str, object]:
        """Readiness probe for ``GET /health``: can this store still
        accept writes?  Disk-backed stores check their directory."""
        with self._lock:
            n = self._len()
        return {"writable": True, "entries": n}

    # implementations override (called under the lock):
    def _get(self, key: str) -> Optional[Dict[str, float]]:
        raise NotImplementedError

    def _put(self, key: str, rec: Dict[str, float]) -> None:
        raise NotImplementedError

    def _put_batch(self, recs) -> None:
        for key, rec in recs:
            self._put(key, rec)

    def _len(self) -> int:
        raise NotImplementedError


class InMemoryLabelStore(LabelStore):
    """Dict-backed store — the service's hot tier, and what the old
    per-``run_dse`` ``synth_cache`` becomes under the store interface."""

    def __init__(self):
        super().__init__()
        self._data: Dict[str, Dict[str, float]] = {}

    def _get(self, key):
        return self._data.get(key)

    def _put(self, key, rec):
        self._data[key] = rec

    def _len(self):
        return len(self._data)


class JsonlLabelStore(LabelStore):
    """Append-only JSON-lines store with an in-memory index.

    One record per line: ``{"k": <key>, "l": {<labels>}, "t": <unix>}``.
    Appends are flushed per batch; a fresh process replays the file into
    its index at construction, so labels persist across campaigns AND
    processes.  Duplicate keys are benign (last write wins on replay —
    labels are deterministic, so duplicates carry identical values).

    Duplicates DO accumulate when several processes label overlapping
    genome sets against one file, making replay O(lines) instead of
    O(unique labels).  ``compact()`` rewrites the log with one line per
    key; ``auto_compact_ratio=r`` (opt-in) compacts automatically
    whenever the file holds more than ``r``x as many lines as unique
    keys.  Compaction is safe against concurrent writer PROCESSES (the
    fleet case): appends and the compaction's replay-rewrite-rename all
    run under one cross-process advisory file lock (``<path>.lock``),
    and every writer re-checks the backing inode under that lock — a
    writer whose handle points at a replaced file reopens and rescans
    instead of appending into the dropped inode."""

    def __init__(self, path: str, *, auto_compact_ratio: Optional[float] = None):
        super().__init__()
        if auto_compact_ratio is not None and auto_compact_ratio <= 1.0:
            raise ValueError("auto_compact_ratio must be > 1")
        self.path = str(path)
        self.auto_compact_ratio = auto_compact_ratio
        self.compactions = 0
        self.quarantined = 0  # malformed/torn records dropped, counted
        self._data: Dict[str, Dict[str, float]] = {}
        self._offset = 0  # bytes already replayed; refresh parses the tail
        self._n_lines = 0  # complete lines in the file (incl. duplicates)
        self._ino: Optional[int] = None  # inode the offset refers to
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        # append handle; opened lazily on first put
        self._fh = None
        self._replay()
        self._maybe_auto_compact()

    @contextlib.contextmanager
    def _write_lock(self):
        """Cross-process advisory lock serializing appends with
        compaction (``flock`` on a sidecar, so lock acquisition never
        touches — or keeps alive — the replaced data inode)."""
        faults.hit("store.lock", path=self.path)
        if fcntl is None:  # pragma: no cover - non-POSIX
            yield
            return
        with open(self.path + ".lock", "a+") as lk:
            fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lk.fileno(), fcntl.LOCK_UN)

    def _replay(self) -> None:
        """Parse records appended since the last replay (tail-seek, so a
        refresh is O(new bytes), not O(file)).  Detects a compaction by
        another process (inode change) and rescans the new file from the
        top — the index is keyed, so re-reading is idempotent."""
        if not os.path.exists(self.path):
            return
        # errors="replace": undecodable bit-rot must fail a line's CRC,
        # not crash the replay
        with open(self.path, errors="replace") as f:
            ino = os.fstat(f.fileno()).st_ino
            if self._ino is not None and ino != self._ino:
                # the path was atomically replaced under us: our offset
                # and line count describe the old inode
                self._offset = 0
                self._n_lines = 0
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
            self._ino = ino
            f.seek(self._offset)
            while True:
                pos = f.tell()
                line = f.readline()
                if not line or not line.endswith("\n"):
                    # EOF, or a torn tail from a concurrent writer:
                    # leave the offset here so it is re-read next time
                    self._offset = pos
                    return
                self._n_lines += 1
                try:
                    rec = json.loads(line)
                    self._data[rec["k"]] = rec["l"]
                except (json.JSONDecodeError, KeyError):
                    # malformed complete line: skipped permanently, but
                    # never silently — drills and /stats see the count
                    self.quarantined += 1
                    _log.warning("quarantined malformed record in %s @%d",
                                 self.path, pos)

    def refresh(self) -> int:
        """Re-read the backing file (pick up other processes' appends).
        Returns the number of entries after the refresh."""
        with self._lock:
            self._replay()
            self._maybe_auto_compact()
            return len(self._data)

    # --- compaction ---------------------------------------------------
    def compact(self) -> int:
        """Rewrite the log with one line per unique key (atomic rename).
        Returns the number of duplicate/malformed lines dropped."""
        with self._lock:
            return self._compact_locked()

    def _compact_locked(self) -> int:
        # the write lock spans replay -> rewrite -> rename: concurrent
        # appender processes either land before the replay (and are
        # folded into the compacted file) or block until the rename is
        # visible (and their next append detects the new inode) — no
        # torn tail, no dropped foreign records
        with obs.span("store.compact", path=self.path), self._write_lock():
            self._replay()
            dropped = max(self._n_lines - len(self._data), 0)
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            tmp = self.path + ".compact.tmp"
            with open(tmp, "w") as f:
                now = time.time()
                for k, rec in self._data.items():
                    f.write(json.dumps({"k": k, "l": rec, "t": now},
                                       sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # a kill here (mid-rename window) loses nothing: the rename
            # was atomic and the next writer re-checks the inode
            faults.hit("store.compact", path=self.path)
            self._offset = os.path.getsize(self.path)
            self._n_lines = len(self._data)
            self._ino = os.stat(self.path).st_ino
        self.compactions += 1
        return dropped

    def _maybe_auto_compact(self) -> None:
        r = self.auto_compact_ratio
        if r is None or self._n_lines <= len(self._data):
            return
        if self._n_lines >= r * max(len(self._data), 1):
            self._compact_locked()

    # ------------------------------------------------------------------
    def _get(self, key):
        return self._data.get(key)

    def _put(self, key, rec):
        self._put_batch([(key, rec)])

    def _put_batch(self, recs) -> None:
        """One buffered append/flush for a whole labeled batch (the
        per-label path syscalls once per record); duplicates of known
        keys update the index only (labels are deterministic)."""
        fresh = []
        for key, rec in recs:
            known = key in self._data
            self._data[key] = rec
            if not known:
                fresh.append((key, rec))
        if not fresh:
            return
        # the cross-process lock makes append-vs-compact atomic: the
        # replay consumes any foreign tail (and detects a compaction's
        # inode swap, reopening the handle) BEFORE we append, so
        # advancing the offset below cannot skip another process's
        # records and our records cannot land in a dropped inode
        with obs.span("store.put", n=len(fresh)), self._write_lock():
            self._replay()
            f = faults.check("store.append", n=len(fresh))
            if f is not None:
                if f.kind == "torn_write":
                    # simulate a foreign writer dying mid-append
                    with open(self.path, "a") as gf:
                        gf.write('{"k": "__torn__", "l": {')
                elif f.kind == "error":
                    f.raise_()
                elif f.delay_s > 0:
                    time.sleep(f.delay_s)
            if self._fh is None:
                self._fh = open(self.path, "a")
            # a torn tail left by a dead writer would merge with our
            # first record and destroy both; terminate it so it becomes
            # its own quarantined malformed line instead
            try:
                size = os.path.getsize(self.path)
            except OSError:
                size = 0
            if size > self._offset:
                torn = size - self._offset
                self._fh.write("\n")
                self._fh.flush()
                self._offset = self._fh.tell()
                self._n_lines += 1
                self.quarantined += 1
                _log.warning("repaired torn tail in %s (%d bytes"
                             " quarantined)", self.path, torn)
            now = time.time()
            self._fh.write("".join(
                json.dumps({"k": key, "l": rec, "t": now},
                           sort_keys=True) + "\n"
                for key, rec in fresh
            ))
            self._fh.flush()
            self._n_lines += len(fresh)
            self._offset = self._fh.tell()

    def _len(self):
        return len(self._data)

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        with self._lock:
            s["lines"] = self._n_lines
            s["compactions"] = self.compactions
            s["quarantined"] = self.quarantined
        return s

    def health(self) -> Dict[str, object]:
        h = super().health()
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        h["writable"] = os.access(d, os.W_OK)
        h["path"] = self.path
        h["quarantined"] = self.quarantined
        return h

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


class SegmentedLabelStore(LabelStore):
    """Label store on the segmented, CRC-framed log — the persistence
    tier for 10^6+ labels (see :mod:`repro_torch.segments`).

    Warm start is O(manifest + key sidecars), not O(records): sealed
    segments enter the in-memory index as *lazy references* (key →
    segment name) and a segment's bodies are parsed only when one of its
    keys is actually read (``segments_loaded`` counts those).  Damage is
    survived, not fatal: a CRC-failing record is quarantined and
    counted; a damaged sealed segment is moved to ``quarantine/`` and
    its unsalvaged keys become clean misses (relabeled on demand) while
    the campaign continues.  Appends, seals and retention run under one
    cross-process ``flock``, preserving the multi-writer-process safety
    the fleet relies on.  ``retention_segments`` (opt-in) bounds disk by
    evicting the oldest sealed segments — evicted keys miss and relabel.
    """

    def __init__(self, root: str, *, segment_records: int = 4096,
                 retention_segments: Optional[int] = None):
        super().__init__()
        self.root = str(root)
        self.segments_loaded = 0
        self._seglog = SegmentedLog(
            self.root, segment_records=segment_records,
            retention_segments=retention_segments,
            index_field="k", name="labels")
        # key -> label dict (loaded) | segment name (lazy reference)
        self._data: Dict[str, object] = {}
        self._known_segs = set()
        with self._seglog.lock():
            self._sync_locked()

    # -- reconcile index with the log ----------------------------------
    def _sync_locked(self) -> None:
        m, tail = self._seglog.sync_locked()
        live = {e["name"] for e in m["sealed"]}
        for e in m["sealed"]:
            name = e["name"]
            if name in self._known_segs:
                continue
            self._known_segs.add(name)
            keys = self._seglog.read_index(name)
            if keys is None:
                # sidecar missing/damaged: fall back to reading bodies
                self._load_segment_locked(name)
                continue
            for k in keys:
                cur = self._data.get(k)
                if cur is None or isinstance(cur, str):
                    self._data[k] = name
        # a foreign process may have quarantined/retired segments we
        # still reference: turn those refs back into clean misses
        stale = self._known_segs - live
        if stale:
            self._known_segs &= live
            for k in [k for k, v in self._data.items()
                      if isinstance(v, str) and v in stale]:
                del self._data[k]
        for rec in tail:
            if isinstance(rec, dict) and "k" in rec and "l" in rec:
                self._data[rec["k"]] = rec["l"]

    def _load_segment_locked(self, name: str) -> None:
        """Parse one sealed segment's bodies into the index; damaged
        segments are quarantined and their lost keys dropped."""
        self.segments_loaded += 1
        try:
            recs, bad = self._seglog.read_segment(name)
        except OSError as e:
            recs, bad = [], -1
            reason = f"unreadable: {e}"
        else:
            reason = f"{bad} damaged records"
        for rec in recs:
            if isinstance(rec, dict) and "k" in rec and "l" in rec:
                cur = self._data.get(rec["k"])
                if cur is None or isinstance(cur, str):
                    self._data[rec["k"]] = rec["l"]
        if bad:
            if bad > 0:
                self._seglog.quarantined_records += bad
            self._seglog.quarantine_locked(name, reason)
            self._known_segs.discard(name)
            for k in [k for k, v in self._data.items() if v == name]:
                del self._data[k]

    # -- LabelStore interface ------------------------------------------
    def _get(self, key):
        v = self._data.get(key)
        if v is None or isinstance(v, dict):
            return v
        with self._seglog.lock():  # lazy ref: materialize its segment
            if isinstance(self._data.get(key), str):
                self._load_segment_locked(v)
        v = self._data.get(key)
        return v if isinstance(v, dict) else None

    def _put(self, key, rec):
        self._put_batch([(key, rec)])

    def _put_batch(self, recs) -> None:
        fresh = []
        now = time.time()
        for key, rec in recs:
            known = key in self._data  # lazy ref counts: labels are
            self._data[key] = rec      # deterministic, values identical
            if not known:
                fresh.append({"k": key, "l": rec, "t": now})
        if not fresh:
            return
        with obs.span("store.put", n=len(fresh)), self._seglog.lock():
            self._sync_locked()
            res = self._seglog.append_locked(fresh)
            for k in res["dropped_keys"]:  # retention evictions
                self._data.pop(k, None)

    def _len(self):
        return len(self._data)

    def refresh(self) -> int:
        """Pick up other processes' appends/seals (fleet warm reuse)."""
        with self._lock:
            with self._seglog.lock():
                self._sync_locked()
            return len(self._data)

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        with self._lock:
            s.update(self._seglog.stats())
            s["segments_loaded"] = self.segments_loaded
        return s

    def health(self) -> Dict[str, object]:
        h = super().health()
        h["writable"] = os.access(self.root, os.W_OK)
        h["path"] = self.root
        h["quarantined"] = self._seglog.quarantined_records
        h["quarantined_segments"] = self._seglog.quarantined_segments
        return h

    def close(self) -> None:
        with self._lock:
            self._seglog.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


def open_label_store(path: str, *, migrate: bool = False,
                     **kw) -> LabelStore:
    """Open the right disk store for ``path``.

    * an existing directory (or any path without a ``.jsonl`` suffix)
      → :class:`SegmentedLabelStore` rooted there;
    * a legacy single-file ``<name>.jsonl`` with ``migrate=True`` (the
      service CLI) → a segmented store rooted at ``<name>.segd`` with
      the legacy records auto-migrated *warm* (every old label answers
      without recompute; the old file is kept as ``.jsonl.migrated``);
    * a ``.jsonl`` path without ``migrate`` (fleet workers, launch
      CLIs) → the already-migrated segmented root if one exists, else a
      plain :class:`JsonlLabelStore` — replicas never migrate a file
      another process may still be appending to.
    """
    p = str(path)
    if not p.endswith(".jsonl"):
        return SegmentedLabelStore(p, **kw)
    root = p[:-len(".jsonl")] + ".segd"
    if not migrate:
        if os.path.isdir(root) and not os.path.isfile(p):
            return SegmentedLabelStore(root, **kw)
        return JsonlLabelStore(p, **kw)
    store = SegmentedLabelStore(root, **kw)
    if os.path.isfile(p):
        migrated = 0
        batch = []
        with open(p) as f:
            for line in f:
                if not line.endswith("\n"):
                    continue  # torn legacy tail
                try:
                    rec = json.loads(line)
                    batch.append((rec["k"], rec["l"]))
                    migrated += 1
                except (json.JSONDecodeError, KeyError, TypeError):
                    continue
                if len(batch) >= 10000:
                    store.put_many(batch)
                    batch = []
        if batch:
            store.put_many(batch)
        try:
            os.replace(p, p + ".migrated")
        except OSError:  # a concurrent migrator beat us to the rename
            pass
        _log.info("migrated %d records from %s into %s",
                  migrated, p, root)
    return store
