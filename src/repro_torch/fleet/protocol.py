"""Fleet wire protocol: context descriptors, label codecs, portability.

A fleet ships *descriptions*, never objects: an evaluation context
crosses the wire as the 5-tuple a fresh process can rebuild it from
(accelerator name, rank-gene setting, QoR sample count + seed, the cost
model's name in ``core.hw.HW_MODELS``) plus the parent's context
fingerprint.  The worker rebuilds the context from the description on
its OWN device and refuses the lease unless its fingerprint matches the
parent's bit for bit — the same gate the process-pool labeler uses, so
a drifted worker (different library build, different cost model) can
never poison the label store.  The cost model must travel: every model
but ``V5E`` is in the fingerprint, so a worker that rebuilt on its
default would fail the gate of every context costed on another.  The
parent's device never travels: the image accelerators' labels are
bit-identical across devices, and an ``lm:`` context carries its device
kind in the fingerprint, so a worker on another kind fails the gate.

Labels cross the wire as JSON floats.  Python's ``json`` emits the
shortest round-tripping ``repr`` for every finite float, so a label
that travels orchestrator -> worker -> orchestrator is byte-identical
to one computed in-process (tests pin this end to end).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "PROTOCOL_VERSION",
    "ctx_descriptor",
    "build_context",
    "context_is_portable",
    "encode_labels",
    "decode_labels",
]

# bump on any incompatible wire change; register() rejects mismatches so
# an old worker fails loudly at join time instead of mid-lease.  2: the
# descriptor carries ``hw`` and the fingerprint names the label count,
# so a JAX-package worker (protocol 1, XLA-counted labels) cannot join
PROTOCOL_VERSION = 2


def ctx_descriptor(ctx) -> Dict:
    """The JSON-safe description of an ``EvalContext`` a worker rebuilds
    it from.  ``fingerprint`` is the parent's ground truth: the worker
    must derive the same one or reject the lease."""
    from ..core.hw import hw_name

    return {
        "accel": ctx.accel.name,
        "rank_genes": bool(ctx.rank_genes),
        "n_qor_samples": int(ctx.n_qor_samples),
        "qor_seed": int(ctx.qor_seed),
        "hw": hw_name(ctx.hw),
        "fingerprint": ctx.fingerprint,
    }


def build_context(desc: Dict, library=None, *, device=None):
    """Rebuild an ``EvalContext`` from a wire descriptor (builtin
    accelerator names only — a remote worker has no registry) on
    ``device`` (None: ``"cuda"``) and verify its fingerprint against the
    parent's.  Raises ValueError on unknown names, KeyError on an
    unknown cost model and RuntimeError on fingerprint drift."""
    from ..core.acl.library import default_library
    from ..core.hw import HW_MODELS
    from ..service.campaigns import make_accelerator
    from ..service.store import EvalContext

    ctx = EvalContext(
        make_accelerator(desc["accel"], builtin_only=True, device=device),
        library if library is not None else default_library(),
        rank_genes=bool(desc["rank_genes"]),
        n_qor_samples=int(desc["n_qor_samples"]),
        qor_seed=int(desc["qor_seed"]),
        device=device,
        hw=HW_MODELS[desc["hw"]],
    )
    expected = desc.get("fingerprint")
    if expected and ctx.fingerprint != expected:
        raise RuntimeError(
            f"context fingerprint {ctx.fingerprint} != parent {expected} "
            f"for {desc['accel']!r}"
        )
    return ctx


def context_is_portable(ctx, library=None, *, device=None) -> bool:
    """True iff a fresh process on ``device`` (None: the context's own),
    given only the context's descriptor, would rebuild a context with
    the SAME fingerprint (identical labels and store keys) — the
    dispatch gate shared by the process-pool labeler and the fleet
    orchestrator.  Ad-hoc registered pipelines, subset libraries,
    parameterized accelerators and unnamed cost models fail it and stay
    on the in-process path.  No model is built: an ``lm:`` context's
    fingerprint needs only its config, seed and device kind."""
    try:
        if not getattr(ctx.accel, "name", None):
            return False
        build_context(ctx_descriptor(ctx), library=library,
                      device=ctx.device if device is None else device)
        return True
    except Exception:  # noqa: BLE001 - unresolvable name == not portable
        return False


def encode_labels(labels: Dict[str, np.ndarray]) -> Dict[str, List[float]]:
    """Label arrays -> JSON-safe lists (order-preserving)."""
    from ..service.store import LABEL_KEYS

    return {k: [float(v) for v in np.asarray(labels[k])] for k in LABEL_KEYS}


def decode_labels(obj: Dict[str, List[float]],
                  n: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Wire labels -> arrays; validates every label key is present with
    ``n`` rows, so a truncated or mangled result fails the lease instead
    of committing short labels."""
    from ..service.store import LABEL_KEYS

    out = {}
    for k in LABEL_KEYS:
        if k not in obj:
            raise ValueError(f"result is missing label key {k!r}")
        arr = np.asarray(obj[k], dtype=np.float64)
        if n is not None and arr.shape != (n,):
            raise ValueError(
                f"label {k!r} has shape {arr.shape}, expected ({n},)"
            )
        out[k] = arr
    return out
