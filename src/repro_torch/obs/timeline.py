"""Per-campaign search telemetry time series.

``BENCH_strategies.json`` only shows hypervolume-per-label curves after
a run finishes; this module samples the same signals live at campaign
tick boundaries so ``GET /campaigns/<id>/timeline`` can answer "is this
campaign still buying front?" while it runs.

Each campaign gets a bounded ring of samples.  Hypervolume is computed
against a per-campaign reference point frozen at the first sample that
carries objectives (2-D only — the exact ``hypervolume_2d`` kernel);
freezing the reference keeps the series monotone-comparable even as the
front pushes past early extremes.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..core.pareto import hypervolume_2d, non_dominated_mask

__all__ = ["Timeline"]


class Timeline:
    """Bounded per-campaign sample rings, thread-safe."""

    def __init__(self, maxlen: int = 1024):
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._refs: Dict[str, np.ndarray] = {}
        self._t0: Dict[str, float] = {}

    def sample(
        self,
        campaign: str,
        *,
        objectives: Optional[np.ndarray] = None,
        **fields,
    ) -> Dict:
        """Append one sample.  ``objectives`` (n, 2) adds hypervolume +
        front_size; other keyword fields pass through verbatim (labels
        requested/served, cache hit rate, stage, ...)."""
        now = time.time()
        rec: Dict = {"t": round(now, 3)}
        if objectives is not None:
            obj = np.asarray(objectives, dtype=np.float64)
            obj = obj[np.all(np.isfinite(obj), axis=1)] if obj.size else obj
            if obj.ndim == 2 and obj.shape[0] and obj.shape[1] == 2:
                with self._lock:
                    ref = self._refs.get(campaign)
                if ref is None:
                    # frozen at first sight: worst corner plus 10% of the
                    # span (or +1 on a degenerate axis) so boundary
                    # points contribute nonzero volume
                    span = obj.max(axis=0) - obj.min(axis=0)
                    pad = np.where(span > 0, 0.1 * span, 1.0)
                    ref = obj.max(axis=0) + pad
                    with self._lock:
                        self._refs.setdefault(campaign, ref)
                        ref = self._refs[campaign]
                rec["hypervolume"] = hypervolume_2d(obj, ref)
                rec["front_size"] = int(non_dominated_mask(obj).sum())
        for k, v in fields.items():
            if v is None:
                continue
            rec[k] = float(v) if isinstance(v, (int, float, np.floating,
                                                np.integer)) else v
        with self._lock:
            ring = self._series.get(campaign)
            if ring is None:
                ring = self._series[campaign] = deque(maxlen=self.maxlen)
                self._t0[campaign] = now
            rec["rel_s"] = round(now - self._t0[campaign], 3)
            ring.append(rec)
        return rec

    def series(self, campaign: str) -> List[Dict]:
        with self._lock:
            ring = self._series.get(campaign)
            return list(ring) if ring is not None else []

    def reference(self, campaign: str) -> Optional[List[float]]:
        with self._lock:
            ref = self._refs.get(campaign)
            return [float(x) for x in ref] if ref is not None else None

    def campaigns(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def forget(self, campaign: str) -> None:
        with self._lock:
            self._series.pop(campaign, None)
            self._refs.pop(campaign, None)
            self._t0.pop(campaign, None)
