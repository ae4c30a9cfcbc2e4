"""Segmented, CRC-framed, crash-safe append-log machinery.

One big JSONL file was fine for one host; a fleet needs durability the
replay loop can *prove*.  A :class:`SegmentedLog` is a directory of
fixed-size segments::

    root/
      MANIFEST.json      # sealed-segment catalog + generation counter
      active.jsonl       # current append segment (CRC-framed lines)
      seg-000001.jsonl   # sealed, immutable
      seg-000001.idx     # optional key sidecar (O(1) warm start)
      quarantine/        # corrupt segments end up here, not in a stack
      .lock              # cross-process flock sidecar

Every record line is ``<crc32:08x> <compact json>\\n`` — a torn write,
a bit flip, or a merged line fails the checksum and is *quarantined and
counted* instead of silently skipped or fatally raised.  Sealing renames
``active.jsonl`` to ``seg-NNNNNN.jsonl`` (atomic), writes a key sidecar,
then updates the manifest; a crash between those steps leaves an orphan
segment that the next open adopts back into the manifest.  All mutation
runs under one advisory ``flock`` so concurrent writer *processes*
(the fleet case) interleave safely, exactly like the single-file
``JsonlLabelStore`` did — but a reader warm-starts from the manifest +
sidecars without parsing a single record body.

Owners (``SegmentedLabelStore``, ``SegmentedSynthCache``) drive the log
under its lock: ``sync_locked`` reconciles with foreign writers,
``append_locked`` frames + appends + seals.  The log knows framing and
files; it never interprets records beyond the optional ``index_field``
used to build sidecars.  The port's own copy of the JAX package's
``segments``: the same files and framing, so a log written by either
package replays in the other.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX
    fcntl = None

from . import faults, obs

__all__ = ["SegmentedLog", "frame_record", "parse_line"]

_SEG_RE = re.compile(r"^seg-(\d{6})\.jsonl$")
ACTIVE = "active.jsonl"
MANIFEST = "MANIFEST.json"


def frame_record(obj: Any) -> str:
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(payload.encode()) & 0xFFFFFFFF
    return f"{crc:08x} {payload}\n"


def parse_line(line: str) -> Optional[Any]:
    """CRC-checked parse of one framed line (no trailing newline).
    Returns None for anything damaged — torn, merged, flipped."""
    if len(line) < 10 or line[8] != " ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:]
    if zlib.crc32(payload.encode()) & 0xFFFFFFFF != crc:
        return None
    try:
        return json.loads(payload)
    except json.JSONDecodeError:
        return None


class SegmentedLog:
    """Files, framing, manifest, locking — no record semantics."""

    def __init__(self, root: str, *, segment_records: int = 4096,
                 retention_segments: Optional[int] = None,
                 index_field: Optional[str] = None, name: str = "store"):
        if segment_records < 1:
            raise ValueError("segment_records must be >= 1")
        if retention_segments is not None and retention_segments < 1:
            raise ValueError("retention_segments must be >= 1")
        self.root = str(root)
        self.segment_records = int(segment_records)
        self.retention_segments = retention_segments
        self.index_field = index_field
        self.name = name
        self.log = obs.get_logger(f"segments.{name}")
        # durability accounting (exposed via owner stats())
        self.quarantined_records = 0
        self.quarantined_segments = 0
        self.repaired_tails = 0
        self.seals = 0
        # active-segment replay cursor (same tail-seek discipline as the
        # single-file store: refresh is O(new bytes))
        self._offset = 0
        self._records = 0          # good records replayed/appended
        self._damage = 0           # quarantined lines still in the file
        self._keys: List[str] = []  # index_field values in the active seg
        self._ino: Optional[int] = None
        self._fh = None
        self._thread_lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _p(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    @property
    def active_path(self) -> str:
        return self._p(ACTIVE)

    # -- cross-process lock --------------------------------------------
    @contextlib.contextmanager
    def lock(self):
        """Advisory cross-process lock (plus an in-process mutex so the
        flock's per-process semantics never bite threads)."""
        faults.hit("store.lock", root=self.root)
        with self._thread_lock:
            if fcntl is None:  # pragma: no cover - non-POSIX
                yield
                return
            with open(self._p(".lock"), "a+") as lk:
                fcntl.flock(lk.fileno(), fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lk.fileno(), fcntl.LOCK_UN)

    # -- manifest -------------------------------------------------------
    def manifest(self) -> Dict[str, Any]:
        try:
            with open(self._p(MANIFEST)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"version": 1, "gen": 0, "seq": 0, "sealed": []}

    def _write_manifest_locked(self, m: Dict[str, Any]) -> None:
        m["gen"] = int(m.get("gen", 0)) + 1
        tmp = self._p(MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(m, f, sort_keys=True, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._p(MANIFEST))

    # -- segment IO -----------------------------------------------------
    def read_segment(self, seg_name: str) -> Tuple[List[Any], int]:
        """Parse a sealed segment; returns (records, damaged lines).
        Raises OSError only if the file itself cannot be read."""
        recs: List[Any] = []
        bad = 0
        # errors="replace": bit-rot can make bytes undecodable; a mangled
        # line must fail its CRC and count as damage, not crash the read
        with open(self._p(seg_name), errors="replace") as f:
            for line in f:
                if not line.endswith("\n"):
                    bad += 1  # sealed segments must not have torn tails
                    continue
                obj = parse_line(line[:-1])
                if obj is None:
                    bad += 1
                else:
                    recs.append(obj)
        return recs, bad

    def read_index(self, seg_name: str) -> Optional[List[str]]:
        """Key sidecar for a sealed segment (None if absent/corrupt)."""
        idx = self._p(seg_name[:-len(".jsonl")] + ".idx")
        try:
            with open(idx, errors="replace") as f:
                line = f.readline()
        except OSError:
            return None
        obj = parse_line(line.rstrip("\n"))
        if not isinstance(obj, dict) or "keys" not in obj:
            return None
        return list(obj["keys"])

    def _write_index_locked(self, seg_name: str, keys: List[str]) -> None:
        idx = self._p(seg_name[:-len(".jsonl")] + ".idx")
        tmp = idx + ".tmp"
        with open(tmp, "w") as f:
            f.write(frame_record({"keys": keys}))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, idx)

    def quarantine_locked(self, seg_name: str, reason: str) -> None:
        """Move a damaged segment aside and drop it from the manifest —
        the store keeps serving; the evidence keeps existing."""
        qdir = self._p("quarantine")
        os.makedirs(qdir, exist_ok=True)
        for suffix in (".jsonl", ".idx"):
            src = self._p(seg_name[:-len(".jsonl")] + suffix)
            if os.path.exists(src):
                os.replace(src, os.path.join(
                    qdir, os.path.basename(src)))
        m = self.manifest()
        m["sealed"] = [e for e in m["sealed"] if e["name"] != seg_name]
        self._write_manifest_locked(m)
        self.quarantined_segments += 1
        self.log.warning("quarantined segment %s (%s)", seg_name, reason)

    # -- reconcile with foreign writers --------------------------------
    def sync_locked(self) -> Tuple[Dict[str, Any], List[Any]]:
        """Adopt orphan segments (a sealer died between rename and
        manifest write), then replay the active tail.  Returns the
        manifest and the newly visible tail records; the owner diffs the
        manifest's sealed list against what it already indexed."""
        m = self._adopt_orphans_locked()
        tail = self._read_tail_locked()
        return m, tail

    def _adopt_orphans_locked(self) -> Dict[str, Any]:
        m = self.manifest()
        known = {e["name"] for e in m["sealed"]}
        orphans = sorted(
            n for n in os.listdir(self.root)
            if _SEG_RE.match(n) and n not in known)
        if not orphans:
            return m
        for name in orphans:
            recs, bad = self.read_segment(name)
            self.quarantined_records += bad
            keys: List[str] = []
            if self.index_field is not None:
                keys = [r[self.index_field] for r in recs
                        if isinstance(r, dict) and self.index_field in r]
                self._write_index_locked(name, keys)
            m["sealed"].append({"name": name, "records": len(recs)})
            m["seq"] = max(int(m.get("seq", 0)),
                           int(_SEG_RE.match(name).group(1)))
            self.log.warning("adopted orphan segment %s (%d records)",
                             name, len(recs))
        m["sealed"].sort(key=lambda e: e["name"])
        self._write_manifest_locked(m)
        return self.manifest()

    def _read_tail_locked(self) -> List[Any]:
        path = self.active_path
        try:
            f = open(path, errors="replace")
        except OSError:
            # active was sealed away by another process; start fresh
            self._reset_active_locked()
            return []
        out: List[Any] = []
        with f:
            ino = os.fstat(f.fileno()).st_ino
            if self._ino is not None and ino != self._ino:
                self._reset_active_locked()
            self._ino = ino
            f.seek(self._offset)
            while True:
                pos = f.tell()
                line = f.readline()
                if not line or not line.endswith("\n"):
                    # EOF or torn tail from a live foreign writer: leave
                    # the cursor so the bytes are re-read next time (or
                    # repaired before our next append)
                    self._offset = pos
                    break
                obj = parse_line(line[:-1])
                if obj is None:
                    self.quarantined_records += 1
                    self._damage += 1
                    self.log.warning(
                        "quarantined damaged record in %s @%d", ACTIVE, pos)
                else:
                    out.append(obj)
                    self._records += 1
                    if (self.index_field is not None
                            and isinstance(obj, dict)
                            and self.index_field in obj):
                        self._keys.append(obj[self.index_field])
        return out

    def _reset_active_locked(self) -> None:
        self._offset = 0
        self._records = 0
        self._damage = 0
        self._keys = []
        self._ino = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- append + seal --------------------------------------------------
    def append_locked(self, objs: List[Any]) -> Dict[str, Any]:
        """Frame and append records to the active segment (repairing any
        torn tail first), sealing as the size threshold crosses.
        Returns {"dropped_keys": [...]} when retention evicted sealed
        segments."""
        f = faults.check("store.append", n=len(objs))
        if f is not None:
            if f.kind == "torn_write":
                # simulate a writer that died mid-append: a partial,
                # newline-less record lands ahead of ours.  Written via
                # a separate handle so OUR replay cursor stays put — the
                # repair below must see it as a foreign torn tail
                garbage = frame_record(
                    {"k": "__torn__", "chaos": True})[:-1]
                cut = max(int(len(garbage) * f.fraction), 1)
                with open(self.active_path, "a") as gf:
                    gf.write(garbage[:cut])
            elif f.kind == "error":
                f.raise_()
            elif f.delay_s > 0:
                time.sleep(f.delay_s)
        self._repair_tail_locked()
        dropped: List[str] = []
        i = 0
        while i < len(objs):
            # fill the active segment to its fixed size, then seal —
            # a big batch becomes several uniform segments, not one blob
            room = max(self.segment_records - self._records, 1)
            chunk = objs[i:i + room]
            i += len(chunk)
            self._append_raw("".join(frame_record(o) for o in chunk))
            self._records += len(chunk)
            if self.index_field is not None:
                self._keys.extend(
                    o[self.index_field] for o in chunk
                    if isinstance(o, dict) and self.index_field in o)
            if self._records >= self.segment_records:
                dropped.extend(self._seal_locked())
        return {"dropped_keys": dropped}

    def _append_raw(self, text: str) -> None:
        if self._fh is None:
            self._fh = open(self.active_path, "a")
            self._ino = os.fstat(self._fh.fileno()).st_ino
        self._fh.write(text)
        self._fh.flush()
        self._offset = self._fh.tell()

    def _repair_tail_locked(self) -> None:
        """A torn tail left by a dead writer would otherwise merge with
        our first record and silently destroy BOTH — terminate it with a
        newline so it fails CRC as its own quarantined line instead."""
        try:
            size = os.path.getsize(self.active_path)
        except OSError:
            return
        if size <= self._offset:
            return
        torn = size - self._offset
        self._append_raw("\n")
        self.quarantined_records += 1
        self.repaired_tails += 1
        self._damage += 1
        self.log.warning(
            "repaired torn tail in %s (%d bytes quarantined)",
            ACTIVE, torn)

    def _seal_locked(self) -> List[str]:
        """active.jsonl -> seg-NNNNNN.jsonl + idx + manifest; returns
        keys dropped by retention (for the owner's index)."""
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        m = self.manifest()
        seq = int(m.get("seq", 0)) + 1
        name = f"seg-{seq:06d}.jsonl"
        records, keys = self._records, list(self._keys)
        if self._damage:
            # quarantined (CRC-failing) lines must not fossilize into an
            # immutable sealed segment — every future load would re-flag
            # the whole segment as damaged.  Scrub them now, atomically.
            with open(self.active_path, errors="replace") as f:
                good = [ln for ln in f.read().splitlines()
                        if parse_line(ln) is not None]
            tmp = self.active_path + ".tmp"
            with open(tmp, "w") as f:
                f.write("".join(ln + "\n" for ln in good))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.active_path)
            self._damage = 0
        os.replace(self.active_path, self._p(name))
        # a kill here leaves an orphan segment; sync_locked adopts it
        faults.hit("store.seal", segment=name)
        if self.index_field is not None:
            self._write_index_locked(name, keys)
        m["sealed"].append({"name": name, "records": records})
        m["seq"] = seq
        dropped_keys: List[str] = []
        if (self.retention_segments is not None
                and len(m["sealed"]) > self.retention_segments):
            n_drop = len(m["sealed"]) - self.retention_segments
            for entry in m["sealed"][:n_drop]:
                dropped_keys.extend(self.read_index(entry["name"]) or [])
                for suffix in (".jsonl", ".idx"):
                    p = self._p(entry["name"][:-len(".jsonl")] + suffix)
                    with contextlib.suppress(OSError):
                        os.remove(p)
            m["sealed"] = m["sealed"][n_drop:]
        self._write_manifest_locked(m)
        self._reset_active_locked()
        self.seals += 1
        with obs.span("store.seal", segment=name, records=records):
            pass
        return dropped_keys

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        m = self.manifest()
        return {
            "segments": len(m["sealed"]),
            "active_records": self._records,
            "seals": self.seals,
            "quarantined": self.quarantined_records,
            "quarantined_segments": self.quarantined_segments,
            "repaired_tails": self.repaired_tails,
        }

    def close(self) -> None:
        with self._thread_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
