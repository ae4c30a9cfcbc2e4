"""repro_torch.obs — flight recorder: tracing, metrics, search telemetry.

Zero-dependency observability for the DSE service and fleet:

  * ``obs.span("synth.compile", attrs=...)`` — context-var spans with
    campaign/batch/lease correlation that survives thread, process and
    fleet-HTTP boundaries (`trace.wire_context`/`trace.attach` ride the
    existing wire payloads); bounded ring + optional ``--trace`` JSONL
    sink; ``python -m repro_torch.obs.export --chrome-trace`` for Perfetto.
  * ``obs.REGISTRY`` — per-thread-sharded counters/gauges/histograms
    behind ``GET /metrics`` (Prometheus text) and ``GET /stats``.
  * ``obs.Timeline`` — per-campaign hypervolume/front/labels series
    behind ``GET /campaigns/<id>/timeline``.

``REPRO_OBS=0`` (or ``obs.set_enabled(False)``) no-ops the span layer;
metrics stay on (they are the stats() substrate).

The port's own copy of the JAX package's ``obs``: the same span and
metric names (``repro_synth_*``, ``repro_sim_fused_*``) and the same
``REPRO_OBS`` switch, so a scrape of either package reads the same.
Its loggers live under ``repro_torch``.
"""

from .logs import get_logger, parse_level, setup_logging
from .metrics import (
    REGISTRY, Counter, Gauge, Histogram, Registry, render_prometheus,
)
from .timeline import Timeline
from .trace import (
    Recorder, attach, context, current_baggage, enabled, recorder,
    set_enabled, set_sink, span, start_span, wire_context,
)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "Recorder", "Registry",
    "Timeline", "attach", "context", "current_baggage", "enabled",
    "get_logger", "parse_level", "recorder", "render_prometheus",
    "set_enabled", "set_sink", "setup_logging", "span", "start_span",
    "wire_context",
]
