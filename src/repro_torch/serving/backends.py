"""Model-execution backends for the serving engine.

A backend executes ONE batch group — requests that resolved to the same
operating point (genome) and compatible input shapes — in a single
batched call on its device:

  * ``SimBackend`` — table-driven accelerators (gaussian3x3, the HEVC
    DCTs, staged pipelines): one ``simulate_batch(..., per_genome_
    inputs=True)`` over the stacked request inputs, which runs the
    population engine's kernels (``accel/fused.py``: the population LUT
    gather on the card), plus the exact reference batch on the host —
    each request gets its output and its *measured* QoR (PSNR vs exact
    on ITS inputs, bit-identical for identical genome+inputs, which is
    what the hot-swap pinning drill asserts).
  * ``LMBackend``  — ``lm:<arch>`` accelerators: the genome decodes to
    an ``ApproxPolicy`` and the group runs batched greedy decoding
    (``train/serve.py`` ``Generator``) on the accelerator's ONE model,
    the policy given per call (at full width a model per genome would
    not fit the card).  Policies are cached per genome.

Backends are pure executors: selection, batching and hot-swap live in
``engine.py``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core import qor as qor_mod
from .catalog import OperatingPoint

__all__ = ["SimBackend", "LMBackend", "make_backend"]

# genomes whose policies LMBackend keeps (least recently served dropped)
LM_POLICY_CACHE = 8


class SimBackend:
    """Batched behavioral execution + per-request measured QoR.

    A request's ``inputs`` is a BATCH of accelerator inputs — the shape
    ``accel.sample_inputs(n)`` returns (``(n, H, W)`` images for
    gaussian3x3 / the DCTs, ``(n, 4)`` operand rows for the MCM blocks)
    — so the stacked group forms the ``(G, n, ...)`` per-genome stack
    ``simulate_batch(..., per_genome_inputs=True)`` consumes.  Inputs
    arriving over the wire (JSON) are coerced to the accelerator's
    native dtype: integral floats cast silently, non-integral values
    for an integer-operand accelerator are a ``ValueError`` (HTTP
    400)."""

    kind = "sim"

    def __init__(self, accel, library, *, rank_genes: bool = False,
                 device=None):
        self.accel = accel
        self.library = library
        self.rank_genes = bool(rank_genes)
        self.device = device
        self._in_dtype = None

    def group_key(self, req) -> Tuple:
        return (tuple(np.shape(req.inputs)),)

    def _coerce(self, inputs) -> np.ndarray:
        arr = np.asarray(inputs)
        if self._in_dtype is None:
            self._in_dtype = np.asarray(
                self.accel.sample_inputs(1, 0)).dtype
        dt = self._in_dtype
        if arr.dtype == dt:
            return arr
        if np.issubdtype(dt, np.integer) and \
                not np.issubdtype(arr.dtype, np.integer):
            if arr.size and (not np.all(np.isfinite(arr))
                             or np.any(np.mod(arr, 1) != 0)):
                raise ValueError(
                    f"{self.accel.name} takes integer operands; got "
                    f"non-integral inputs (dtype {arr.dtype})")
        return arr.astype(dt)

    def run(self, point: OperatingPoint, reqs: Sequence) -> List[Dict]:
        X = np.stack([self._coerce(r.inputs) for r in reqs])
        G = np.tile(point.genome_array()[None, :], (len(reqs), 1))
        outs = self.accel.simulate_batch(
            G, self.library, X,
            rank_genes=self.rank_genes, per_genome_inputs=True,
            device=self.device,
        )
        refs = self.accel.exact_output_batch(X, per_genome_inputs=True)
        results = []
        for i, r in enumerate(reqs):
            res = {"qor": qor_mod.psnr(refs[i], outs[i])}
            if r.return_outputs:
                res["outputs"] = np.asarray(outs[i]).tolist()
            results.append(res)
        return results


class LMBackend:
    """Continuous-batching greedy decode through an ApproxPolicy given
    per call to the accelerator's one model: one prefill + per-token
    decode per batch group, on the accelerator's device."""

    kind = "lm"

    def __init__(self, accel, library, *, rank_genes: bool = False,
                 device=None):
        self.accel = accel
        self.library = library
        self.rank_genes = bool(rank_genes)
        self.device = device
        self._policies: "OrderedDict[bytes, object]" = OrderedDict()
        self._lock = threading.Lock()

    def group_key(self, req) -> Tuple:
        return (tuple(np.shape(req.inputs)), int(req.gen or 0))

    def _policy(self, point: OperatingPoint):
        """The genome's policy, cached (its correction factors are built
        on first use and kept with it)."""
        key = point.genome_array().tobytes()
        with self._lock:
            pol = self._policies.get(key)
            if pol is not None:
                self._policies.move_to_end(key)
                return pol
        pol = self.accel.policy_for_genome(
            point.genome_array(), self.library, rank_genes=self.rank_genes
        )
        with self._lock:
            self._policies[key] = pol
            while len(self._policies) > LM_POLICY_CACHE:
                self._policies.popitem(last=False)
        return pol

    def run(self, point: OperatingPoint, reqs: Sequence) -> List[Dict]:
        import torch

        from ..train.serve import Generator

        prompts = np.stack(
            [np.asarray(r.inputs, dtype=np.int32) for r in reqs]
        )
        if prompts.ndim != 2:
            raise ValueError(
                f"LM requests carry 1-D prompt token arrays; got batch "
                f"shape {prompts.shape}"
            )
        n_gen = int(reqs[0].gen or 16)
        model = self.accel._ensure_model(self.device)
        gen = Generator(model, policy=self._policy(point))
        tokens, tps = gen.generate(torch.from_numpy(prompts), n_gen)
        tokens = tokens.cpu().numpy()
        results = []
        for i, r in enumerate(reqs):
            res = {
                # per-request QoR is the genome's catalog label (logits
                # PSNR of the policy'd model vs exact); a per-request
                # exact forward would double every group's cost
                "qor": float(point.labels.get("qor", float("nan"))),
                "tokens_per_s": tps,
                "n_generated": n_gen,
                "prefill_s": gen.timings["prefill_s"],
                "decode_s": gen.timings["decode_s"],
            }
            if r.return_outputs:
                res["tokens"] = np.asarray(tokens[i]).tolist()
            else:
                res["tokens"] = np.asarray(tokens[i, -n_gen:]).tolist()
            results.append(res)
        return results


def make_backend(accel, library, *, rank_genes: bool = False, device=None):
    """SimBackend for table-driven accelerators, LMBackend for
    ``lm:<arch>`` (anything exposing ``policy_for_genome``)."""
    if hasattr(accel, "policy_for_genome"):
        return LMBackend(accel, library, rank_genes=rank_genes,
                         device=device)
    return SimBackend(accel, library, rank_genes=rank_genes, device=device)
