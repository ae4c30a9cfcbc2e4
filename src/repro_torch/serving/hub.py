"""ServingHub: one ServingEngine per accelerator, fed by a manager.

The hub is the glue between the search tier and the serving tier: it
lazily builds an engine the first time an accelerator is served (seeding
its catalog from the manager's merged global front), subscribes once to
the manager's front-update notifications so every engine hot-swaps when
a campaign improves its front, and aggregates per-engine stats for
``GET /serving/stats``.  ``service.campaigns.CampaignManager`` owns one
hub (created on first use, its engines on the manager's device) and
closes it at shutdown.  ``register`` installs an engine for an
accelerator object the caller already holds (an ``LMAccelerator`` whose
one model is in memory) with a front of the caller's, so serving it
builds no second model.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from .. import obs
from .catalog import FrontCatalog, NoFrontError
from .engine import ServingEngine

__all__ = ["ServingHub"]

_log = obs.get_logger("serving")


class ServingHub:
    """Engines keyed by accelerator name over one CampaignManager."""

    def __init__(self, manager, **engine_kw):
        self.manager = manager
        self.engine_kw = dict(engine_kw)
        self._engines: Dict[str, ServingEngine] = {}
        self._lock = threading.Lock()
        self._closed = False
        manager.subscribe_front(self._on_front)

    def engine_for(
        self,
        accel: str,
        objectives: Optional[Sequence[str]] = None,
        *,
        rank_genes: bool = False,
        create: bool = True,
    ) -> ServingEngine:
        """The engine serving ``accel``, building it (and its catalog,
        from the manager's merged global front) on first use.  Raises
        NoFrontError when no completed campaign has produced a front."""
        with self._lock:
            if self._closed:
                raise RuntimeError("serving hub is closed")
            eng = self._engines.get(accel)
        if eng is not None:
            return eng
        if not create:
            raise NoFrontError(f"no serving engine for {accel!r}")
        objectives = tuple(objectives or ("qor", "energy"))
        cat = FrontCatalog.from_manager(
            self.manager, accel, objectives, rank_genes=rank_genes,
        )
        if cat.empty:
            raise NoFrontError(
                f"no completed campaign has produced a front for "
                f"{accel!r} over objectives {list(objectives)}"
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("serving hub is closed")
            eng = self._engines.get(accel)
            if eng is None:
                eng = ServingEngine(
                    accel, catalog=cat, rank_genes=rank_genes,
                    **self.engine_kw,
                )
                eng._manager = self.manager
                self._engines[accel] = eng
                _log.info("serving hub: engine for %s (%d-point front)",
                          accel, len(cat))
        return eng

    def register(self, accel, catalog: FrontCatalog, *,
                 rank_genes: bool = False, **engine_kw) -> ServingEngine:
        """Serve the accelerator object ``accel`` under ``catalog`` (its
        name's engine; ``engine_kw`` override the hub's).  A campaign
        that later completes for the same name hot-swaps the merged
        front in, as for any engine.  Raises if the name is served."""
        kw = {**self.engine_kw, **engine_kw}
        with self._lock:
            if self._closed:
                raise RuntimeError("serving hub is closed")
            if accel.name in self._engines:
                raise ValueError(f"{accel.name!r} is already served")
            eng = ServingEngine(accel, catalog=catalog,
                                rank_genes=rank_genes, **kw)
            eng._manager = self.manager
            self._engines[accel.name] = eng
        _log.info("serving hub: engine for %s (%d-point front, registered)",
                  accel.name, len(catalog))
        return eng

    def _on_front(self, accel: str) -> None:
        """Manager callback: a campaign finished for ``accel`` — refresh
        the engine already serving it (never auto-creates one)."""
        with self._lock:
            eng = self._engines.get(accel)
        if eng is None:
            return
        try:
            eng.refresh_from(self.manager)
        except Exception:  # noqa: BLE001 - must not break the campaign tick
            _log.exception("serving hub: front refresh failed for %s", accel)

    def stats(self) -> Dict:
        with self._lock:
            engines = dict(self._engines)
        return {
            "engines": {name: eng.stats() for name, eng in engines.items()},
        }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            engines = list(self._engines.values())
            self._engines.clear()
        for eng in engines:
            eng.close()
