"""'Synthesis' — our Vivado tool-chain analogue (ground-truth labels).

The paper's ground truth for one accelerator variant is a full Vivado
synthesis run: LUTs, power, delay.  Ours runs the variant's deployment
graph (``Accelerator.build_deploy``: rank-k matmuls, one launch per
grouped product) once on the device (that run is what ``synth_time``
times), costs the graph analytically, and turns the cost into roofline
latency and energy on a hardware cost model (``core/hw.py``: the H100 by
default, ``hw=V5E`` for the JAX package's TPU v5e model).  The QoR
ground truth is the bit-exact behavioural simulation
(``Accelerator.qor_batch``).

Cost of one grouped product (``grouped_cost``), per slot group g of
width w_g (its contraction columns), output m x n, spec rank r_g:

    flops     = sum_g 2*m*w_g*n*(1 + r_g)          base + r_g corrections
              + (n_groups - 1) * m*n                partial sums
    hbm_bytes = sum_g 4*(m*w_g + w_g*n + m*n)       operands, partial out
              + sum_g 2 * 256*r_g*4                 U and V tables

(int32 operands, float32 partials and tables, each read or written
once).  A plain deployment is one grouped product per pass; an
accelerator whose graph is more than that (the 2-D DCT's per-column
launches, a staged pipeline's chain) counts its own with a
``deploy_cost(specs, inputs=None)`` method.  These replace the JAX
package's XLA ``cost_analysis`` numbers, which have no torch meaning:
the two agree in rank order, not in value.  ``energy`` and the
dtype-adjusted compute are analytical; under ``hw=V5E`` they are
identical to the JAX package's.

Both this and the simulation are deliberately the *slow* path; the
whole point of the paper is to call them O(n_train + n_final) times
instead of O(|space|).

The synthesis cache (``SynthCache`` and its persistent tiers) follows
the JAX package's, with a "compile" read as one run of a deployment
(``_synthesize``).  Where it differs:

* Records hold only the graph's ``{flops, hbm_bytes}``; latency and
  energy are made on ``hw`` at every hit, so one cache serves the H100
  and the v5e cost models alike.
* The digest salt (``_cache_salt``) names the port's own count, so a
  cache file the JAX package wrote (XLA ``cost_analysis`` numbers)
  never serves the port, nor the reverse.
* The JAX package's fast-codegen verification (``FAST_CODEGEN``, its
  per-family verdicts, the XLA compiler options) has no meaning here:
  there is no compiler whose options could leak into the counts, which
  are analytic.  ``reset_fast_codegen`` keeps its name and resets the
  structural verdicts and the shared cache.
* Runs are serial (``COMPILE_WORKERS`` is 1): a run is Python packing,
  small uploads and launches on one card's stream, held by the
  interpreter lock and the stream alike, so threads would only queue.
* The legacy ``cache=`` dict keeps the graph counts per circuit
  identity, as before, and answers before the cache tiers.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # avoid circular import
    from ...accel.base import Accelerator
from ... import faults, obs
from ...core.acl.library import Circuit, Library
from ...device import resolve_device
from ...segments import SegmentedLog
from ..hw import H100_SXM, Hardware, roofline

__all__ = [
    "SynthResult",
    "SynthCache",
    "JsonlSynthCache",
    "SegmentedSynthCache",
    "open_synth_cache",
    "deploy_cost",
    "grouped_cost",
    "synthesize_variant",
    "synthesize_batch",
    "circuit_features_synth",
    "label_variants",
    "shared_synth_cache",
    "set_shared_synth_cache",
    "synth_stats",
    "reset_fast_codegen",
    "LABEL_KEYS",
    "LABEL_COUNT",
    "DEFAULT_QOR_SEED",
]

# the per-genome record label_variants produces (the same keys as the
# JAX package's, so label records interchange)
LABEL_KEYS = ("qor", "latency", "energy", "flops", "hbm_bytes",
              "synth_time", "sim_time")

# default seed for the QoR evaluation inputs (shared with the JAX
# package, so both label the same images)
DEFAULT_QOR_SEED = 1234


class SynthResult(dict):
    """{'flops', 'hbm_bytes', 'latency', 'energy', 'wall_time', ...}"""


# --- structural keying -------------------------------------------------------
# The graph counts the labels read (flops, hbm bytes) are determined by
# the deployment graph's STRUCTURE — matmul shapes, slot-group widths,
# per-slot deployment class (rank, truncated width, signedness), pass
# count — not by which named circuit fills a slot (the rank-1 family
# alone holds 7 interchangeable circuits, and slot PERMUTATIONS of
# equal-width groups build isomorphic graphs).  Keying runs on
# ``Accelerator.deploy_signature`` therefore collapses distinct runs
# from O(|library|^slots) circuit identities to O(distinct structures),
# and makes the cache survive context changes (QoR sample count / seed)
# and accelerator renames (a pipeline's stage view shares the standalone
# accelerator's runs).
#
# The invariance is VERIFIED, not assumed: the first
# ``_STRUCT_VERIFY_SAMPLES`` structural collisions of each graph FAMILY
# (one accelerator's builder; classes vary within it) run the colliding
# identity anyway and compare the counts the labels read.  A family
# whose numbers ever diverge is pinned to exact identity keys.  The
# counts are analytic and deterministic, so a pin means a signature
# that merges graphs of different cost.  REPRO_SYNTH_STRUCTURAL=0 kills
# structural sharing entirely (identity-keyed caching).
STRUCTURAL_KEYS = os.environ.get("REPRO_SYNTH_STRUCTURAL", "1") != "0"
_STRUCT_VERIFY_SAMPLES = 2

# A batch's runs are serial: each is host packing, small uploads and
# launches on the one card's stream (see the module docstring).
COMPILE_WORKERS = 1

# cache-key salt: a change of the count (or of label semantics) must
# MISS a persisted cache instead of serving stale numbers; it names the
# port's analytic count, so the JAX package's XLA-counted files never
# serve here
SYNTH_CACHE_SCHEMA_VERSION = 1
LABEL_COUNT = "torch-analytic"


def _cache_salt() -> str:
    return f"v{SYNTH_CACHE_SCHEMA_VERSION}|{LABEL_COUNT}"


def _digest(tag: str, payload: object) -> str:
    h = hashlib.sha256(f"{tag}|{_cache_salt()}|{payload!r}".encode())
    return h.hexdigest()[:24]


def _identity_signature(accel, specs) -> tuple:
    """Exact per-slot circuit identity (the cache key: the cached graph
    counts do not depend on the cost model).  An accelerator whose graph
    is not fixed by its name names it with ``deploy_identity``."""
    return (getattr(accel, "deploy_identity", accel.name),) + tuple(
        (s.name, s.rank, s.trunc_bits) for s in specs
    )


def _structural_signature(accel, specs) -> Optional[Tuple[tuple, tuple]]:
    """``(family, classes)`` from the accelerator's signature hook, or
    None when the accelerator opts out (no hook / hook returns None)."""
    hook = getattr(accel, "deploy_signature", None)
    if hook is None:
        return None
    try:
        sig = hook(specs)
    except NotImplementedError:
        return None
    if sig is None:
        return None
    family, classes = sig
    return tuple(family), tuple(classes)


class SynthCache:
    """Shared deployment-count cache with two tiers.

    * identity tier — keyed on the exact per-slot circuit assignment;
      hits are safe unconditionally (same graph, deterministic compile).
    * structural tier — keyed on ``deploy_signature``; a hit recorded by
      a DIFFERENT identity is only served after the graph family passed
      its first-K verification compiles (see module comment).

    One instance is shared process-wide by default (``shared_synth_
    cache``) so every evaluation context, campaign and scheduler worker
    reuses one pool of runs; ``JsonlSynthCache`` adds persistence.
    Thread-safe; records hold only the compile-derived numbers
    ({'flops', 'hbm_bytes'}) — everything else in a label is recomputed
    per variant from its circuits and ranks."""

    def __init__(self):
        self._lock = threading.RLock()
        self._by_id: Dict[str, dict] = {}
        self._by_struct: Dict[str, dict] = {}
        # family digest -> remaining verifications | False (pinned)
        self._verdicts: Dict[str, object] = {}
        # registry instruments (idempotent-replace: the live process-
        # shared cache is the one a /metrics scrape sees); increments
        # stay under the cache lock they always ran under
        reg = obs.REGISTRY
        self.hits_identity = reg.counter(
            "repro_synth_identity_hits_total",
            "compiles served from the identity tier")
        self.hits_structural = reg.counter(
            "repro_synth_structural_hits_total",
            "compiles served from the verified structural tier")
        self.compiles = reg.counter(
            "repro_synth_compiles_total", "deployment runs paid")
        self.verify_compiles = reg.counter(
            "repro_synth_verify_compiles_total",
            "runs spent verifying a structural family")
        self.pinned_families = reg.counter(
            "repro_synth_pinned_families_total",
            "graph families pinned to identity-only caching")
        self.compile_seconds = reg.histogram(
            "repro_synth_compile_seconds", "wall seconds per deployment run")

    # -- lookups -------------------------------------------------------
    def get_identity(self, idd: str) -> Optional[dict]:
        with self._lock:
            rec = self._by_id.get(idd)
            if rec is not None:
                self.hits_identity.inc()
            return rec

    def get_structural(self, sdd: str) -> Optional[dict]:
        with self._lock:
            return self._by_struct.get(sdd)

    # -- stores --------------------------------------------------------
    def store(self, rec: dict, *, verify: bool = False) -> None:
        """Record one compile: ``rec`` carries k (identity digest),
        flops, hbm_bytes and optionally s (structural digest) + fam."""
        with self._lock:
            self.compiles.inc()
            if verify:
                self.verify_compiles.inc()
            self._store_locked(dict(rec))

    def store_alias(self, rec: dict) -> None:
        """Record a STRUCTURAL SERVE: the identity now maps to numbers
        another identity compiled.  Counted as a hit, not a compile (and
        persisted, so a warm run answers it from the identity tier)."""
        with self._lock:
            self.hits_structural.inc()
            self._store_locked(dict(rec))

    def _store_locked(self, rec: dict) -> None:
        self._by_id[rec["k"]] = rec
        sdd = rec.get("s")
        if sdd is not None and sdd not in self._by_struct:
            self._by_struct[sdd] = rec

    # -- family verdicts -----------------------------------------------
    def verdict(self, fam: str):
        """Remaining verification compiles for a family (int countdown)
        or False once the family diverged and is identity-pinned."""
        with self._lock:
            return self._verdicts.get(fam, _STRUCT_VERIFY_SAMPLES)

    def verdict_pass(self, fam: str) -> None:
        with self._lock:
            v = self._verdicts.get(fam, _STRUCT_VERIFY_SAMPLES)
            if v is not False and v > 0:
                self._set_verdict_locked(fam, v - 1)

    def verdict_pin(self, fam: str) -> None:
        with self._lock:
            if self._verdicts.get(fam) is not False:
                self.pinned_families.inc()
            self._set_verdict_locked(fam, False)
            # structural records of a pinned family must never serve
            # other identities again
            self._by_struct = {
                s: r for s, r in self._by_struct.items()
                if r.get("fam") != fam
            }

    def _set_verdict_locked(self, fam: str, v) -> None:
        self._verdicts[fam] = v

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)

    def stats(self) -> Dict[str, float]:
        compiles = int(self.compiles.value)
        served = int(self.hits_identity.value) + int(
            self.hits_structural.value)
        total = served + compiles
        with self._lock:
            return {
                "entries": len(self._by_id),
                "structures": len(self._by_struct),
                "compiles": compiles,
                "verify_compiles": int(self.verify_compiles.value),
                "identity_hits": int(self.hits_identity.value),
                "structural_hits": int(self.hits_structural.value),
                "hit_rate": (served / total) if total else 0.0,
                "pinned_families": int(self.pinned_families.value),
                # v is False means PINNED, not verified — and False == 0
                # in Python, so the identity check is load-bearing
                "verified_families": sum(
                    1 for v in self._verdicts.values()
                    if v is not False and v == 0
                ),
            }


class JsonlSynthCache(SynthCache):
    """Persistent ``SynthCache``: an append-only JSON-lines file.

    One record per compile: ``{"k": <identity digest>, "s": <structural
    digest|null>, "fam": <family digest|null>, "c": {"flops", "hbm_
    bytes"}}``; family verification progress persists as ``{"fam": ...,
    "v": <countdown|"pinned">}`` lines so a warm process continues where
    the cold one stopped (a fully verified family does ZERO verification
    compiles after a restart).  Concurrent writers append under a
    torn-tail replay discipline: the tail is re-read before every
    append, so one cache file is safely shared by many processes."""

    def __init__(self, path: str):
        super().__init__()
        self.path = str(path)
        self._offset = 0
        self._fh = None
        self.quarantined = 0  # malformed/torn records dropped, counted
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        with self._lock:
            self._replay_locked()

    def _replay_locked(self) -> None:
        if not os.path.exists(self.path):
            return
        # errors="replace": undecodable bit-rot must fail a line's CRC,
        # not crash the replay
        with open(self.path, errors="replace") as f:
            f.seek(self._offset)
            while True:
                pos = f.tell()
                line = f.readline()
                if not line or not line.endswith("\n"):
                    self._offset = pos   # torn tail: re-read next time
                    return
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    # malformed complete line: dropped, but counted and
                    # logged — never a silent swallow
                    self.quarantined += 1
                    obs.get_logger("synth.cache").warning(
                        "quarantined malformed record in %s @%d",
                        self.path, pos)
                    continue
                if "k" in rec and "c" in rec:
                    # base-class store: replayed records must not be
                    # re-appended to the file they came from
                    SynthCache._store_locked(self, {
                        "k": rec["k"], "s": rec.get("s"),
                        "fam": rec.get("fam"),
                        "flops": float(rec["c"]["flops"]),
                        "hbm_bytes": float(rec["c"]["hbm_bytes"]),
                    })
                elif "fam" in rec and "v" in rec:
                    v = rec["v"]
                    SynthCache._set_verdict_locked(
                        self, rec["fam"], False if v == "pinned" else int(v)
                    )

    def refresh(self) -> int:
        """Pick up records other processes appended since the last read."""
        with self._lock:
            self._replay_locked()
            return len(self._by_id)

    def _append_locked(self, obj: dict) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        # consume any foreign tail BEFORE appending so advancing the
        # offset can never skip another process's records
        self._replay_locked()
        # a torn tail from a dead writer would merge with our record and
        # destroy both; newline-terminate it so it quarantines alone
        try:
            size = os.path.getsize(self.path)
        except OSError:
            size = 0
        if size > self._offset:
            torn = size - self._offset
            self._fh.write("\n")
            self._fh.flush()
            self._offset = self._fh.tell()
            self.quarantined += 1
            obs.get_logger("synth.cache").warning(
                "repaired torn tail in %s (%d bytes quarantined)",
                self.path, torn)
        self._fh.write(json.dumps(obj, sort_keys=True) + "\n")
        self._fh.flush()
        self._offset = self._fh.tell()

    def _store_locked(self, rec: dict) -> None:
        fresh = rec["k"] not in self._by_id
        super()._store_locked(rec)
        if fresh:
            self._append_locked({
                "k": rec["k"], "s": rec.get("s"), "fam": rec.get("fam"),
                "c": {"flops": rec["flops"], "hbm_bytes": rec["hbm_bytes"]},
            })

    def _set_verdict_locked(self, fam: str, v) -> None:
        cur = self._verdicts.get(fam, _STRUCT_VERIFY_SAMPLES)
        # False (pinned) and 0 (verified) compare equal in Python; a pin
        # arriving after the countdown reached 0 MUST still persist, or
        # a warm replay would serve a family proven divergent
        changed = (cur is False) != (v is False) or (
            v is not False and cur != v
        )
        super()._set_verdict_locked(fam, v)
        if changed:
            self._append_locked(
                {"fam": fam, "v": "pinned" if v is False else int(v)}
            )

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["path"] = self.path
        s["quarantined"] = self.quarantined
        return s

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


class SegmentedSynthCache(SynthCache):
    """Persistent ``SynthCache`` on the segmented CRC-framed log
    (:mod:`repro_torch.segments`) — the crash-safe replacement for one big
    ``JsonlSynthCache`` file.

    Record shapes are identical to ``JsonlSynthCache``'s (compiles and
    family-verdict lines), but they live in fixed-size sealed segments
    with per-record CRCs and a manifest: a damaged record or segment is
    quarantined and counted (the lost compiles simply re-compile)
    instead of poisoning a warm replay, and all appends/seals run under
    one cross-process ``flock``.  Replay is eager — the compile cache is
    small next to the label store and every record is needed to answer
    lookups — but it is CRC-verified end to end."""

    def __init__(self, path: str, *, segment_records: int = 4096):
        super().__init__()
        self.path = str(path)
        self._seglog = SegmentedLog(self.path,
                                    segment_records=segment_records,
                                    name="synth")
        self._known_segs = set()
        with self._lock:
            with self._seglog.lock():
                self._sync_cache_locked()

    # -- replay ---------------------------------------------------------
    def _ingest_locked(self, rec) -> None:
        if not isinstance(rec, dict):
            return
        if "k" in rec and "c" in rec:
            SynthCache._store_locked(self, {
                "k": rec["k"], "s": rec.get("s"),
                "fam": rec.get("fam"),
                "flops": float(rec["c"]["flops"]),
                "hbm_bytes": float(rec["c"]["hbm_bytes"]),
            })
        elif "fam" in rec and "v" in rec:
            v = rec["v"]
            SynthCache._set_verdict_locked(
                self, rec["fam"], False if v == "pinned" else int(v))

    def _sync_cache_locked(self) -> None:
        m, tail = self._seglog.sync_locked()
        for e in m["sealed"]:
            name = e["name"]
            if name in self._known_segs:
                continue
            self._known_segs.add(name)
            try:
                recs, bad = self._seglog.read_segment(name)
            except OSError as err:
                recs, bad, reason = [], -1, f"unreadable: {err}"
            else:
                reason = f"{bad} damaged records"
            if bad:
                if bad > 0:
                    self._seglog.quarantined_records += bad
                self._seglog.quarantine_locked(name, reason)
                self._known_segs.discard(name)
                # salvaged records still serve; the rest re-compile
            for rec in recs:
                self._ingest_locked(rec)
        for rec in tail:
            self._ingest_locked(rec)

    def refresh(self) -> int:
        """Pick up records other processes appended/sealed."""
        with self._lock:
            with self._seglog.lock():
                self._sync_cache_locked()
            return len(self._by_id)

    # -- writes ---------------------------------------------------------
    def _append(self, obj: dict) -> None:
        with self._seglog.lock():
            self._sync_cache_locked()
            self._seglog.append_locked([obj])

    def _store_locked(self, rec: dict) -> None:
        fresh = rec["k"] not in self._by_id
        super()._store_locked(rec)
        if fresh:
            self._append({
                "k": rec["k"], "s": rec.get("s"), "fam": rec.get("fam"),
                "c": {"flops": rec["flops"],
                      "hbm_bytes": rec["hbm_bytes"]},
            })

    def _set_verdict_locked(self, fam: str, v) -> None:
        cur = self._verdicts.get(fam, _STRUCT_VERIFY_SAMPLES)
        changed = (cur is False) != (v is False) or (
            v is not False and cur != v
        )
        super()._set_verdict_locked(fam, v)
        if changed:
            self._append(
                {"fam": fam, "v": "pinned" if v is False else int(v)}
            )

    def stats(self) -> Dict[str, float]:
        s = super().stats()
        s["path"] = self.path
        seg = self._seglog.stats()
        s["quarantined"] = seg.pop("quarantined")
        s.update(seg)
        return s

    def close(self) -> None:
        with self._lock:
            self._seglog.close()

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass


def open_synth_cache(path: str, *, migrate: bool = False,
                     **kw) -> SynthCache:
    """Open the right persistent compile cache for ``path``: a legacy
    single-file ``<name>.jsonl`` with ``migrate=True`` auto-migrates
    *warm* into a segmented root at ``<name>.segd`` (old file kept as
    ``.migrated``); without ``migrate`` a ``.jsonl`` path opens the
    already-migrated root when one exists, else the plain
    :class:`JsonlSynthCache` — replicas never rename a file another
    process may still be appending to.  Any other path is a segmented
    root directly."""
    p = str(path)
    if not p.endswith(".jsonl"):
        return SegmentedSynthCache(p, **kw)
    root = p[:-len(".jsonl")] + ".segd"
    if not migrate:
        if os.path.isdir(root) and not os.path.isfile(p):
            return SegmentedSynthCache(root, **kw)
        return JsonlSynthCache(p, **kw)
    cache = SegmentedSynthCache(root, **kw)
    if os.path.isfile(p):
        legacy = []
        with open(p) as f:
            for line in f:
                if not line.endswith("\n"):
                    continue  # torn legacy tail
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and (
                        ("k" in rec and "c" in rec)
                        or ("fam" in rec and "v" in rec)):
                    legacy.append(rec)
        if legacy:
            with cache._lock:
                for rec in legacy:
                    cache._ingest_locked(rec)
                with cache._seglog.lock():
                    cache._seglog.sync_locked()
                    cache._seglog.append_locked(legacy)
        try:
            os.replace(p, p + ".migrated")
        except OSError:  # a concurrent migrator won the rename
            pass
        obs.get_logger("synth.cache").info(
            "migrated %d records from %s into %s", len(legacy), p, root)
    return cache


# the process-wide default cache: every label_variants call that does
# not inject its own cache shares this one, so distinct evaluation
# contexts (different QoR sampling, stage views vs their standalone
# accelerator) stop recompiling each other's structures
_SHARED_CACHE = SynthCache()


def shared_synth_cache() -> SynthCache:
    return _SHARED_CACHE


def set_shared_synth_cache(cache: SynthCache) -> SynthCache:
    """Swap the process-default compile cache (e.g. for a persistent
    ``JsonlSynthCache``); returns the previous one."""
    global _SHARED_CACHE
    prev, _SHARED_CACHE = _SHARED_CACHE, cache
    return prev


def synth_stats() -> Dict[str, object]:
    """Process-wide synthesis engine counters."""
    return {
        "structural_keys": STRUCTURAL_KEYS,
        "compile_workers": COMPILE_WORKERS,
        "cache": _SHARED_CACHE.stats(),
    }


def reset_fast_codegen() -> None:
    """Reset every module-global verification/caching state: the
    structural verdicts and the shared cache (the JAX package's name;
    there is no fast-codegen state here).  Test fixtures call this so
    one test's verification history can never leak into another."""
    global _SHARED_CACHE
    _SHARED_CACHE = SynthCache()


def grouped_cost(m: int, n: int, groups, specs) -> Dict[str, float]:
    """Analytic {'flops', 'hbm_bytes'} of one grouped rank-k product:
    an (m, k) @ (k, n) matmul whose contraction is split into ``groups``
    with one spec each (the formula in the module docstring)."""
    flops = float((len(groups) - 1) * m * n)
    byts = 0.0
    for (s, e), sp in zip(groups, specs):
        w = e - s
        flops += 2.0 * m * w * n * (1 + sp.rank)
        byts += 4.0 * (m * w + w * n + m * n) + 2 * 256.0 * sp.rank * 4
    return {"flops": flops, "hbm_bytes": byts}


def deploy_cost(accel, specs, inputs=None) -> Dict[str, float]:
    """Analytic {'flops', 'hbm_bytes'} of ``build_deploy(specs, inputs)``'s
    graph: the accelerator's own count where it has one (``inputs``, the
    deploy input, sets its m), else one grouped product of
    ``matmul_shape()`` per deployment pass."""
    own = getattr(accel, "deploy_cost", None)
    if own is not None:
        return own(specs, inputs=inputs)
    m, _, n = accel.matmul_shape()
    passes = getattr(accel, "deploy_passes", 1)
    cost = grouped_cost(m, n, accel.slot_groups(), specs)
    return {k: v * passes for k, v in cost.items()}


def _adjusted_compute(accel, circuits, ranks, factor) -> float:
    """Dtype-aware MXU cost (bf16-MAC equivalents) of the variant's
    faithful deployment: per slot, 2*m*width*n * (factor(width) +
    rank) — truncation circuits deploy natively at narrow width (cheap),
    exotic circuits pay int8 base + bf16 corrections (DESIGN.md §2).
    ``factor`` is a cost model's ``dtype_cost_factor`` (time) or
    ``energy_factor``.  Reads ``matmul_shape()`` as the JAX package does,
    so that under ``V5E`` it is the reference's number."""
    if hasattr(accel, "adjusted_compute"):
        return accel.adjusted_compute(circuits, ranks, factor)
    mul_idx = accel.mul_slot_indices()
    m, ktot, n = accel.matmul_shape()
    groups = accel.slot_groups()
    passes = getattr(accel, "deploy_passes", 1)
    total = 0.0
    for (s0, e0), i, r in zip(groups, mul_idx, ranks):
        c = circuits[i]
        base = factor(c.deploy_width)
        rank = c.deploy_rank if r is None else (
            0 if c.native_width is not None else int(r)
        )
        total += 2.0 * m * (e0 - s0) * n * (base + rank)
    return total * passes


def _finish_record(accel, circuits, ranks, specs, synth: dict,
                   wall: float, cache_hit: bool,
                   hw: Hardware = H100_SXM) -> SynthResult:
    """Full per-variant label record from the graph's cost numbers;
    latency and energy are computed per variant from its circuits and
    ranks on the cost model ``hw``: latency at each width's rate,
    energy at each width's energy per MAC."""
    out = SynthResult()
    out["flops"] = synth["flops"]
    out["hbm_bytes"] = synth["hbm_bytes"]
    out["wall_time"] = wall
    adj = _adjusted_compute(accel, circuits, ranks, hw.dtype_cost_factor)
    out["mxu_flops_adjusted"] = adj
    rt = roofline(adj, out["hbm_bytes"], 0.0, hw=hw)
    out["latency"] = rt.t_serial
    # energy = the MARGINAL arithmetic energy of the variant (MXU MACs at
    # their dtype rate + the rank-k lookup-table traffic).  Input/output
    # streaming bytes are identical across variants of one accelerator
    # (board-level cost in the paper's terms) and would flatten the
    # objective to a ~0.2% spread on the small MCM matmuls.
    lut_bytes = sum(256.0 * 4 * 2 * sp.rank for sp in specs)
    adj_e = _adjusted_compute(accel, circuits, ranks, hw.energy_factor)
    out["energy"] = adj_e * hw.e_flop + lut_bytes * hw.e_hbm_byte
    out["cache_hit"] = cache_hit
    return out


def _synthesize(accel, specs, device: torch.device) -> Tuple[dict, float]:
    """One "compile": run one variant's deployment graph once on
    ``device`` (the rank-k route) and cost it; returns ({'flops',
    'hbm_bytes'}, wall seconds until the card has finished the graph)."""
    t0 = time.perf_counter()
    fn, args = accel.build_deploy(specs, device=device)
    with torch.no_grad():
        fn(*args, path="mxu")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return deploy_cost(accel, specs), wall


class _Variant:
    """Per-genome bookkeeping inside synthesize_batch."""

    __slots__ = ("index", "circuits", "ranks", "specs", "ikey", "idd")

    def __init__(self, index, circuits, ranks, specs, ikey, idd):
        self.index = index
        self.circuits = circuits
        self.ranks = ranks
        self.specs = specs
        self.ikey = ikey
        self.idd = idd


def synthesize_batch(
    accel: Accelerator,
    variants: Sequence[Tuple[Sequence[Circuit], Sequence[Optional[int]]]],
    *,
    cache: Optional[dict] = None,
    synth_cache: Optional[SynthCache] = None,
    progress: Optional[callable] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> List[SynthResult]:
    """Population-scale synthesis: one call for a whole genome batch.

    ``variants`` is a list of decoded ``(circuits, ranks)`` pairs.  The
    batch is deduplicated at two levels before anything runs — exact
    circuit identity, then the structural ``deploy_signature``
    (first-K-verified per graph family; see the module comment) — and
    each surviving deployment runs once on ``device`` (default
    ``"cuda"``).  Results scatter back per genome with the same values
    the per-genome loop would produce; the genome that paid a run
    carries its wall time, riders carry 0.0.

    ``cache`` (a dict) keeps each deployment's graph counts keyed on
    circuit identity across calls and answers first; ``synth_cache`` is
    the shared/persistent tier (default: the process-wide
    ``shared_synth_cache()``).  Latency and energy are made from the
    counts on ``hw`` at every hit, so one cache serves any cost model."""
    from ...kernels.approx_matmul import from_circuit

    dev = resolve_device(device)
    scache = synth_cache if synth_cache is not None else _SHARED_CACHE
    mul_idx = accel.mul_slot_indices()
    n = len(variants)
    results: List[Optional[SynthResult]] = [None] * n
    done = 0

    def _emit(t: int, rec: SynthResult) -> None:
        nonlocal done
        results[t] = rec
        done += 1
        if progress is not None:
            progress(done, n)

    # -- pass 1: decode specs, serve legacy-dict hits, group identities --
    order: List[str] = []                 # unique identity digests, FIFO
    groups: Dict[str, List[_Variant]] = {}
    for t, (circuits, ranks) in enumerate(variants):
        specs = [from_circuit(circuits[i], r)
                 for i, r in zip(mul_idx, ranks)]
        ikey = _identity_signature(accel, specs)
        if cache is not None and ikey in cache:
            _emit(t, _finish_record(accel, circuits, ranks, specs,
                                    cache[ikey], 0.0, cache_hit=True, hw=hw))
            continue
        idd = _digest("id", ikey)
        v = _Variant(t, list(circuits), list(ranks), specs, ikey, idd)
        if idd not in groups:
            order.append(idd)
            groups[idd] = []
        groups[idd].append(v)

    structural = STRUCTURAL_KEYS
    sigs: Dict[str, Optional[Tuple[str, str]]] = {}  # idd -> (sdd, fam)
    if structural:
        for idd in order:
            sig = _structural_signature(accel, groups[idd][0].specs)
            if sig is None:
                sigs[idd] = None
            else:
                family, classes = sig
                fam = _digest("fam", family)
                sigs[idd] = (_digest("st", (family, classes)), fam)

    # -- pass 2: resolve each unique identity against the cache tiers --
    # counted[idd] = (graph counts, wall paid here)
    counted: Dict[str, Tuple[dict, float]] = {}

    def _needs_run(idd: str):
        """None if served from a cache tier, else the run plan ('fresh'
        stores structurally, 'verify' compares against the colliding
        record, 'pinned' stores identity-only)."""
        rec = scache.get_identity(idd)
        if rec is not None:
            counted[idd] = ({"flops": rec["flops"],
                             "hbm_bytes": rec["hbm_bytes"]}, 0.0)
            return None
        sd = sigs.get(idd) if structural else None
        if sd is None:
            return ("pinned", None, None)
        sdd, fam = sd
        verdict = scache.verdict(fam)
        if verdict is False:
            return ("pinned", None, None)
        srec = scache.get_structural(sdd)
        if srec is None:
            return ("fresh", sdd, fam)
        if verdict == 0:
            scache.store_alias({"k": idd, "s": sdd, "fam": fam,
                                "flops": srec["flops"],
                                "hbm_bytes": srec["hbm_bytes"]})
            counted[idd] = ({"flops": srec["flops"],
                             "hbm_bytes": srec["hbm_bytes"]}, 0.0)
            return None
        return ("verify", sdd, fam)

    def _run(idd: str, plan) -> None:
        kind, sdd, fam = plan
        specs = groups[idd][0].specs
        faults.hit("synth.compile", kind=kind, identity=idd[:12])
        with obs.span("synth.compile", kind=kind, identity=idd[:12]):
            cost, wall = _synthesize(accel, specs, dev)
        cs = getattr(scache, "compile_seconds", None)
        if cs is not None:
            cs.observe(wall)
        if kind == "verify":
            srec = scache.get_structural(sdd)
            same = (srec is not None
                    and cost["flops"] == srec["flops"]
                    and cost["hbm_bytes"] == srec["hbm_bytes"])
            if srec is None:
                pass          # record vanished (pin race): treat as fresh
            elif same:
                scache.verdict_pass(fam)
            else:
                scache.verdict_pin(fam)
            scache.store({"k": idd, "s": sdd if srec is None or same
                          else None,
                          "fam": fam, **cost}, verify=srec is not None)
        else:
            scache.store({"k": idd,
                          "s": sdd if kind == "fresh" else None,
                          "fam": fam, **cost})
        counted[idd] = (cost, wall)

    # Structural dedup WITHIN the batch needs the first run of a
    # structure to land before its siblings resolve, so resolution runs
    # in waves: every identity that must run under the current cache
    # state runs, then the remainder re-resolves against the now-warmer
    # cache.
    batch_span = (
        obs.start_span("synth.batch", n=n, unique=len(order))
        if order else None
    )
    n_waves = n_run = 0
    pending = list(order)
    while pending:
        plans = []
        deferred = []
        seen_struct: set = set()
        verify_used: Dict[str, int] = {}
        for idd in pending:
            plan = _needs_run(idd)
            if plan is None:
                continue
            kind, sdd, fam = plan
            if kind == "fresh" and sdd in seen_struct:
                deferred.append(idd)     # a sibling runs it this wave
                continue
            if kind == "verify":
                # spend at most the family's REMAINING countdown on
                # verification this wave; the rest re-resolves next wave
                # (and serves structurally once the family is verified)
                used = verify_used.get(fam, 0)
                verdict = scache.verdict(fam)
                if verdict is False or used >= verdict:
                    deferred.append(idd)
                    continue
                verify_used[fam] = used + 1
            if sdd is not None:
                seen_struct.add(sdd)
            plans.append((idd, plan))
        n_waves += 1
        n_run += len(plans)
        for p in plans:
            _run(*p)
        if not deferred:
            break
        pending = deferred
    if batch_span is not None:
        batch_span.end(waves=n_waves, compiled=n_run)

    # -- pass 3: assemble + scatter ------------------------------------
    for idd in order:
        cost, wall = counted[idd]
        for j, v in enumerate(groups[idd]):
            if cache is not None and v.ikey not in cache:
                cache[v.ikey] = dict(cost)
            _emit(v.index, _finish_record(
                accel, v.circuits, v.ranks, v.specs, cost,
                wall if j == 0 else 0.0,
                cache_hit=(wall == 0.0 or j > 0), hw=hw,
            ))
    return results


def synthesize_variant(
    accel: Accelerator,
    circuits: Sequence[Circuit],
    ranks: Sequence[Optional[int]],
    *,
    cache: Optional[dict] = None,
    synth_cache: Optional[SynthCache] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> SynthResult:
    """Hardware labels for one variant: ``synthesize_batch`` of one."""
    return synthesize_batch(
        accel, [(circuits, ranks)], cache=cache, synth_cache=synth_cache,
        device=device, hw=hw,
    )[0]


def circuit_features_synth(
    c: Circuit, *, rank: Optional[int] = None, m: int = 256, n: int = 128,
    device=None, hw: Hardware = H100_SXM,
) -> np.ndarray:
    """Per-AC synthesis features (Vivado-on-AC analogue, pipelines B/E):
    run a canonical (m,256)@(256,n) deployment of this single circuit
    once on ``device`` (default ``"cuda"``) through the rank-k kernel,
    count it with ``grouped_cost``, and cost it on ``hw``.  Returns
    [flops, log10(1 + hbm_bytes), latency, energy, rank, wall_time]:
    flops is the dtype-adjusted compute and energy the arithmetic plus
    table traffic, as ``_finish_record`` makes them, so under
    ``hw=V5E`` flops, energy and rank are the JAX package's.  Adders
    deploy as an elementwise segmented add (cost-flat by design): the
    JAX package's constant row."""
    from ...kernels.approx_matmul import approx_matmul, from_circuit

    if c.kind == "add16":
        return np.array([256.0 * n, np.log10(256.0 * n * 8), 0.0, 0.0, 0.0, 0.0])
    dev = resolve_device(device)
    spec = from_circuit(c, rank)
    rng = np.random.default_rng(0)
    lo, hi = (-128, 128) if c.signed else (0, 256)
    x = torch.from_numpy(rng.integers(lo, hi, (m, 256)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.integers(lo, hi, (256, n)).astype(np.int32)).to(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        approx_matmul(x, w, spec, path="mxu")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    byts = grouped_cost(m, n, [(0, 256)], [spec])["hbm_bytes"]
    rank_c = float(c.deploy_rank)
    adj = 2.0 * m * 256 * n * (hw.dtype_cost_factor(c.deploy_width) + rank_c)
    adj_e = 2.0 * m * 256 * n * (hw.energy_factor(c.deploy_width) + rank_c)
    return np.array(
        [
            adj,
            np.log10(1.0 + byts),
            roofline(adj, byts, 0.0, hw=hw).t_serial,
            adj_e * hw.e_flop + 256.0 * 4 * 2 * c.deploy_rank * hw.e_hbm_byte,
            float(spec.rank),
            wall,
        ]
    )


def label_variants(
    accel: Accelerator,
    genomes: np.ndarray,
    library: Library,
    *,
    rank_genes: bool = False,
    qor_inputs: Optional[np.ndarray] = None,
    cache: Optional[dict] = None,
    synth_cache: Optional[SynthCache] = None,
    progress: Optional[callable] = None,
    device=None,
    hw: Hardware = H100_SXM,
) -> Dict[str, np.ndarray]:
    """Ground-truth labels for a genome batch on ``device`` (default
    ``"cuda"``) on the cost model ``hw`` (default the H100's; ``hw.V5E``
    gives the JAX package's labels): hardware via ``synthesize_batch``
    (identity + structural dedup across the whole batch, shared or
    persistent ``synth_cache``), QoR via ONE batched behavioural
    ``qor_batch`` call — values bit-exact versus the per-genome loop.
    Returns arrays keyed
    {'qor','latency','energy','flops','hbm_bytes','synth_time','sim_time'}.
    ``sim_time`` is the batch's wall clock amortized evenly per genome."""
    dev = resolve_device(device)
    genomes = np.atleast_2d(genomes)
    n = len(genomes)
    if qor_inputs is None:
        qor_inputs = accel.sample_inputs(4, seed=DEFAULT_QOR_SEED)
    out = {k: np.zeros(n) for k in LABEL_KEYS}
    t0 = time.perf_counter()
    out["qor"][:] = accel.qor_batch(
        genomes, library, qor_inputs, rank_genes=rank_genes, device=dev
    )
    out["sim_time"][:] = (time.perf_counter() - t0) / max(n, 1)
    variants = [accel.decode(g, library, rank_genes=rank_genes)
                for g in genomes]
    records = synthesize_batch(
        accel, variants, cache=cache, synth_cache=synth_cache,
        progress=progress, device=dev, hw=hw,
    )
    for t, sr in enumerate(records):
        out["latency"][t] = sr["latency"]
        out["energy"][t] = sr["energy"]
        out["flops"][t] = sr["flops"]
        out["hbm_bytes"][t] = sr["hbm_bytes"]
        out["synth_time"][t] = sr["wall_time"]
    return out
