"""The torch population engine: the batched behavioural hot path on the
device.

One call evaluates a whole genome population: the (G, M, S) LUT gather
(``kernels.population_lut``), the adder-tree reduction, normalization
and — where the outputs are integral — the QoR reduction itself, with no
``(G, M, S)`` intermediate ever copied to the host.  Only the (G,) SSE
vector comes back; the float64 PSNR finish runs on the host through the
same ``psnr_from_sse`` the numpy path uses, so the bits match.

Bit-exactness rules, in the order they are enforced:

* Genomes are data, so the adder choice per slot cannot branch per
  genome: the engine evaluates every adder circuit's closed-form int32
  twin on the full operand stack and selects per genome.  Each twin is
  verified against the library's numpy model on a dense probe when the
  engine is built; a missing or divergent twin RAISES.
* The (C, S, 256) LUT is checked to fit int32 on upload and RAISES if it
  does not.
* Adders operate on 16-bit-masked operands so int32 intermediates match
  the numpy int64 semantics (``>>`` on int32 is arithmetic in torch, as
  in numpy).
* The SSE is an exact int64 sum on the device (``core.qor.sse_batch``).

PyTorch runs eagerly, so the engine has no compile cache, no population
bucketing and no fallback: on a CUDA device it launches its kernels or
raises.  Each device run is an ``obs`` span ``sim.fused`` and counts in
``stats()`` and in the ``repro_sim_fused_*_total`` counters
(``fused_calls`` for a population's outputs, ``fused_qor_calls`` for
its QoR with the SSE on the device), the JAX package's names.  Plans
are registered per accelerator class with ``register_fused``; a
``StagedPipeline`` runs its whole chain on the device through
``staged_plan`` when every stage has a plan and every coupling a torch
twin (``register_coupling``), and raises otherwise.

A plan whose device output is not the final output (the 2-D DCT returns
integer coefficients; its float64 inverse transform stays on the host,
where float64 contraction order, and so the bits, is the numpy path's)
has no integer QoR reference: ``qor_batch`` then finishes PSNR on the
host from the plan's ``simulate_batch`` output, as the JAX package does.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core.acl import adders as _adders
from ..core.acl.library import Library, library_fingerprint
from ..device import resolve_device

__all__ = [
    "FusedPlan", "register_fused", "register_coupling", "staged_plan",
    "simulate_batch", "qor_batch", "build_engine", "stats",
]

_M16 = (1 << 16) - 1

_STATS: Dict[str, int] = {}
_STATS_LOCK = threading.Lock()


def _bump(key: str, n: int = 1) -> None:
    name = f"repro_sim_fused_{key}_total"
    with _STATS_LOCK:
        _STATS[key] = _STATS.get(key, 0) + n
        # registered once and then found: registering again would replace
        # the counter (the JAX package's does, so its total reads the
        # last call's n)
        counter = obs.REGISTRY.get(name) or obs.REGISTRY.counter(
            name, f"fused sim engine: {key}")
    counter.inc(n)


def stats() -> Dict[str, int]:
    """Snapshot of the engine counters."""
    with _STATS_LOCK:
        out = dict(_STATS)
    for k in ("fused_calls", "fused_qor_calls"):
        out.setdefault(k, 0)
    return out


# ---------------------------------------------------------------------------
# closed-form adder twins
# ---------------------------------------------------------------------------
# Each twin is written with plain operators so the SAME code runs under
# numpy (build-time verification against the library's int64 models) and
# on int32 torch tensors.  Operands arrive 16-bit masked; results may
# carry bit 16 (the adders' carry-out), exactly like the numpy models.


def _shared(a, b):
    """Subexpressions shared across all adder circuit twins."""
    a = a & _M16
    b = b & _M16
    s = a + b
    p = a ^ b
    return {"a": a, "b": b, "s": s, "p": p, "ab": a & b, "c": s ^ p}


def _tw_exact(sh):
    return sh["s"]


def _tw_loa(sh, k):
    # LOA: high sum + OR of low bits == s - (a AND b AND lowmask)
    return sh["s"] - (sh["ab"] & ((1 << k) - 1))


def _tw_trunc(sh, k):
    m = (1 << k) - 1
    return sh["s"] - (sh["a"] & m) - (sh["b"] & m)


def _tw_seg(sh, seg):
    # independent per-segment sums; only the top segment keeps its carry
    a, b = sh["a"], sh["b"]
    out = None
    nseg = 16 // seg
    for i in range(nseg):
        lo = i * seg
        m = (1 << seg) - 1
        ssum = ((a >> lo) & m) + ((b >> lo) & m)
        if i < nseg - 1:
            ssum = ssum & m
        part = ssum << lo
        out = part if out is None else out + part
    return out


def _tw_eta1(sh, k):
    # ETA1 low part: OR of the operands, flooded to ones strictly below
    # the highest generate position (downward smear of a AND b)
    lowm = (1 << k) - 1
    g = sh["ab"] & lowm
    g = g | (g >> 1)
    g = g | (g >> 2)
    g = g | (g >> 4)  # k <= 8
    low = ((sh["p"] | sh["ab"]) & lowm) | (g >> 1)
    return (((sh["a"] >> k) + (sh["b"] >> k)) << k) + low


def _tw_aca(sh, la):
    # ACA(la): carry into bit i is the exact carry unless ALL la
    # propagate bits below i are set (a carry chain longer than the
    # window); window-AND of p computes in log2(la) shift-ANDs.
    r = sh["p"]
    shift = 1
    while shift < la:
        r = r & (r >> shift)
        shift <<= 1
    c_aca = sh["c"] & ~(r << la)
    return sh["p"] ^ c_aca


_TWIN_FAMILIES = {
    "add_exact": lambda kw: _tw_exact,
    "add_loa": lambda kw: functools.partial(_tw_loa, k=kw["k"]),
    "add_trunc": lambda kw: functools.partial(_tw_trunc, k=kw["k"]),
    "add_segmented": lambda kw: functools.partial(_tw_seg, seg=kw["seg"]),
    "add_eta1": lambda kw: functools.partial(_tw_eta1, k=kw["k"]),
    "add_speculative": lambda kw: functools.partial(_tw_aca, la=kw["la"]),
}


def _resolve_twin(fn) -> Optional[Callable]:
    """Map a library adder model to its closed-form twin by introspecting
    the ``functools.partial`` over the ``core.acl.adders`` module."""
    base, kw = fn, {}
    if isinstance(fn, functools.partial):
        base, kw = fn.func, dict(fn.keywords)
    if getattr(_adders, getattr(base, "__name__", ""), None) is not base:
        return None  # not a stock adder model
    maker = _TWIN_FAMILIES.get(base.__name__)
    return None if maker is None else maker(kw)


def _probe_operands() -> Tuple[np.ndarray, np.ndarray]:
    """Dense verification probe: random 16-bit pairs + a corner grid of
    carry-chain patterns (all-ones runs, alternating bits, boundaries)."""
    rng = np.random.default_rng(0xF05ED)
    a = rng.integers(0, 1 << 16, size=1 << 15, dtype=np.int64)
    b = rng.integers(0, 1 << 16, size=1 << 15, dtype=np.int64)
    corners = np.array(
        [0, 1, 2, 3, 0x000F, 0x00FF, 0x0FFF, 0x7FFF, 0x8000, 0x8001,
         0xAAAA, 0x5555, 0xFF00, 0xF0F0, 0xFFFE, 0xFFFF],
        dtype=np.int64,
    )
    ca, cb = np.meshgrid(corners, corners)
    return (np.concatenate([a, ca.ravel()]),
            np.concatenate([b, cb.ravel()]))


def _build_twins(library: Library) -> List[Callable]:
    """One verified twin per ``add16`` circuit, in library order.
    Raises when a circuit has no twin or its twin diverges on the probe:
    the engine has no other way to evaluate that adder."""
    pa, pb = _probe_operands()
    ref_shared = _shared(pa, pb)
    twins: List[Callable] = []
    for c in library.kind("add16"):
        twin = _resolve_twin(c.fn)
        if twin is None:
            raise NotImplementedError(
                f"population engine: no closed-form twin for adder {c.name!r}")
        want = np.asarray(c.fn(pa, pb), dtype=np.int64)
        got = np.asarray(twin(ref_shared), dtype=np.int64)
        if not np.array_equal(want, got):
            raise RuntimeError(
                f"population engine: twin for adder {c.name!r} diverges "
                "from its numpy model on the probe")
        twins.append(twin)
    return twins


class _Engine:
    """Per-(library, device) engine state: verified adder twins and
    device LUTs."""

    def __init__(self, library: Library, device: torch.device):
        self.library = library
        self.device = device
        self.twins = _build_twins(library)
        self._luts: Dict[tuple, torch.Tensor] = {}

    def lut(self, kind: str, constants, tag: str) -> torch.Tensor:
        """Device (C, S, 256) int32 LUT stack with checked narrowing."""
        key = (kind, tag, tuple(int(c) for c in constants))
        dev = self._luts.get(key)
        if dev is None:
            from ._batchsim import mul_lut

            lut64 = mul_lut(self.library, kind, constants)
            info = np.iinfo(np.int32)
            if lut64.max() > info.max or lut64.min() < info.min:
                raise OverflowError(f"LUT for {kind}/{tag} exceeds int32")
            dev = torch.from_numpy(
                np.ascontiguousarray(lut64, dtype=np.int32)).to(self.device)
            self._luts[key] = dev
        return dev

    def gather(self, lut_dev: torch.Tensor, genes: torch.Tensor,
               cols: torch.Tensor, *, per_genome: bool) -> torch.Tensor:
        """Population LUT gather (the CUDA kernel on the card, the plain
        version on the CPU)."""
        from ..kernels.population_lut import population_lut_gather

        return population_lut_gather(
            lut_dev, genes.contiguous(), cols.contiguous(),
            per_genome=per_genome,
        )

    def select_add(self, gene_col: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor, *, signed: bool) -> torch.Tensor:
        """All-circuits adder stack + per-genome selection.  ``a``/``b``:
        (G, ...) int32 operand stacks; ``gene_col``: (G,) circuit
        indices."""
        sh = _shared(a, b)
        allr = torch.stack([tw(sh) for tw in self.twins])  # (A, G, ...)
        idx = gene_col.long().reshape((1, -1) + (1,) * (a.dim() - 1))
        r = torch.gather(allr, 0, idx.expand((1,) + tuple(a.shape)))[0]
        if signed:
            # signed16 semantics: wrap to 16 bits, sign-extend
            r = r & _M16
            r = (r ^ 0x8000) - 0x8000
        return r


# (library fingerprint, device) -> engine, so the twins are verified and
# each LUT stack uploaded once per process rather than once per batch
_ENGINES: Dict[tuple, _Engine] = {}
# held while an engine is built: threads labeling one library at once
# (the campaign service's eval workers) wait for the first build
_ENGINES_LOCK = threading.Lock()


def build_engine(library: Library, device=None) -> _Engine:
    """The verified engine for ``library`` on ``device``, built on first
    use, at most once per library and device, and cached (raises when an
    adder of the library has no verified twin; nothing is cached
    then)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (library_fingerprint(library), str(dev))
    eng = _ENGINES.get(key)
    if eng is None:
        with _ENGINES_LOCK:
            eng = _ENGINES.get(key)
            if eng is None:
                eng = _ENGINES[key] = _Engine(library, dev)
    return eng


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@dataclass
class FusedPlan:
    """One accelerator's population pipeline.

    ``stage_fn(genes, x, per_genome)`` is the device core: (G, n_genes)
    int32 genes and the ``prep``-ed inputs in, integer outputs out.
    ``prep(inputs, device)`` and ``post(raw, inputs, per_genome)`` are the
    host-side shims (``post`` turns the device output into the numpy
    ``simulate_batch`` output); ``qor_ref`` (when set) provides the
    integer exact reference that lets the QoR reduce on the device.
    ``device_natural`` is True iff ``stage_fn``'s output IS the
    ``simulate_batch`` output (modulo dtype): a plan with a host-side
    tail sets False and can only end a staged chain, not feed a later
    stage."""

    stage_fn: Callable
    prep: Callable
    post: Callable
    qor_ref: Optional[Callable] = None
    device_natural: bool = True


def host_int64(raw: torch.Tensor, inputs, per_genome: bool) -> np.ndarray:
    """The ``post`` of a plan whose device output is the final output:
    an int64 host copy."""
    return raw.cpu().numpy().astype(np.int64)


_PLANS: Dict[type, Callable] = {}
# coupling name -> torch twin of its ``sim`` map (None: the identity)
_COUPLINGS: Dict[str, Optional[Callable]] = {"identity": None}


def register_fused(cls):
    """Decorator: ``@register_fused(Accel)`` marks ``make(accel,
    library, engine) -> FusedPlan`` as the plan factory for ``cls`` (and,
    via MRO lookup, its subclasses)."""

    def deco(make):
        _PLANS[cls] = make
        return make

    return deco


def register_unfused(cls) -> None:
    """Pin an accelerator type to its own per-genome path (a workload
    that is not table-driven, like the LM, whose QoR path is its own):
    ``_plan_for`` finds no plan for it and its subclasses."""
    _PLANS[cls] = None


def register_coupling(name: str, fn: Callable) -> None:
    """Torch twin of a ``Coupling.sim`` map, by coupling name: a staged
    chain runs on the device only when every coupling has one."""
    _COUPLINGS[name] = fn


def _plan_for(accel, library: Library, device, *,
              required: bool = True) -> Optional[FusedPlan]:
    """The plan of ``accel``'s class (MRO lookup); a class without one
    raises, or gives None where ``required`` is False."""
    for cls in type(accel).__mro__:
        if cls in _PLANS:
            if _PLANS[cls] is None:
                break
            return _PLANS[cls](accel, library, build_engine(library, device))
    if required:
        raise NotImplementedError(
            f"no population plan for {type(accel).__name__} in this port yet")
    return None


def staged_plan(pipe, library: Library, eng: _Engine) -> FusedPlan:
    """The plan factory of a ``StagedPipeline``: every stage's
    ``stage_fn`` chained on the device through the couplings' torch
    twins.  Raises when a stage has no plan, when a host-tailed plan is
    not the last stage, or when a coupling has no twin."""
    stage_plans = []
    last = len(pipe.stages) - 1
    for i, st in enumerate(pipe.stages):
        p = _plan_for(st, library, eng.device)
        if not p.device_natural and i < last:
            raise NotImplementedError(
                f"{pipe.name}: stage {st.name}'s plan ends on the host and "
                "cannot feed a later stage")
        stage_plans.append(p)
    twins = []
    for c in pipe.couplings:
        name = "identity" if c.sim is None else c.name
        if name not in _COUPLINGS:
            raise NotImplementedError(
                f"{pipe.name}: coupling {name!r} has no torch twin")
        twins.append(_COUPLINGS[name])
    counts = pipe.stage_slot_counts()

    def stage_fn(genes, x, per_genome):
        per, off = per_genome, 0
        for i, (sp, ns) in enumerate(zip(stage_plans, counts)):
            y = sp.stage_fn(genes[:, off:off + ns], x, per)
            off += ns
            per = True  # stage outputs always carry the genome axis
            x = twins[i](y) if (i < last and twins[i] is not None) else y
        return x

    tail = stage_plans[last]
    return FusedPlan(
        stage_fn=stage_fn, prep=stage_plans[0].prep, post=tail.post,
        qor_ref=tail.qor_ref, device_natural=tail.device_natural,
    )


def _upload_genes(accel, genomes, library: Library,
                  device: torch.device) -> torch.Tensor:
    """(G, n) int64 numpy genomes -> (G, n) int32 on ``device``, once.
    Slot genes are range-checked on the host; trailing rank genes ride
    along unread."""
    genomes = np.atleast_2d(np.asarray(genomes, dtype=np.int64))
    n_slots = len(accel.slots)
    sizes = accel.gene_sizes(library)
    slot_genes = genomes[:, :n_slots]
    if slot_genes.shape[1] != n_slots or (
            len(slot_genes) and ((slot_genes < 0).any()
                                 or (slot_genes >= sizes[None]).any())):
        raise IndexError(
            f"genomes do not index {accel.name}'s {n_slots} slots "
            f"(sizes {sizes.tolist()})")
    return torch.from_numpy(
        np.ascontiguousarray(genomes, dtype=np.int32)).to(device)


def simulate_batch(
    accel, genomes, library: Library, inputs, *,
    rank_genes: bool = False, per_genome_inputs: bool = False, device=None,
) -> np.ndarray:
    """(G, ...) int64 behavioural outputs of a genome population, computed
    on ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)
    return _run_plan(_plan_for(accel, library, dev), accel, genomes,
                     library, inputs, per_genome_inputs, dev)


def _run_plan(plan: FusedPlan, accel, genomes, library: Library, inputs,
              per_genome_inputs: bool, dev: torch.device) -> np.ndarray:
    """``simulate_batch`` through a plan already built."""
    genes = _upload_genes(accel, genomes, library, dev)
    x = plan.prep(inputs, dev)
    if per_genome_inputs and x.shape[0] != genes.shape[0]:
        raise ValueError(
            f"{x.shape[0]} per-genome input sets for {genes.shape[0]} genomes")
    with obs.span("sim.fused", g=int(genes.shape[0]), sse=False), \
            torch.no_grad():
        raw = plan.stage_fn(genes, x, per_genome_inputs)
    _bump("fused_calls")
    return plan.post(raw, inputs, per_genome_inputs)


def qor_batch(
    accel, genomes, library: Library, inputs, *,
    rank_genes: bool = False, peak=None, device=None,
) -> np.ndarray:
    """``(genomes, inputs) → QoR`` on ``device``.  A plan with an integer
    exact reference keeps the outputs and their integer SSE on the
    device; the host finishes PSNR from the (G,) SSE vector.  Otherwise
    (a plan whose output is finished on the host, or an accelerator with
    no plan but a ``simulate_batch`` of its own) the host takes
    ``psnr_batch`` of the population's outputs, computed on the device
    by that plan or by ``accel.simulate_batch``, against the exact
    output."""
    from ..core.qor import psnr_batch, psnr_from_sse, sse_batch

    dev = resolve_device(device)
    plan = _plan_for(accel, library, dev, required=False)
    if plan is None or plan.qor_ref is None:
        ref = accel.exact_output(inputs)
        if plan is None:
            outs = accel.simulate_batch(genomes, library, inputs,
                                        rank_genes=rank_genes, device=dev)
        else:
            outs = _run_plan(plan, accel, genomes, library, inputs, False,
                             dev)
        return psnr_batch(ref, outs, peak)
    genes = _upload_genes(accel, genomes, library, dev)
    ref = np.asarray(plan.qor_ref(accel, inputs))
    if peak is None:
        pk = float(np.max(np.abs(ref))) or 1.0
    else:
        pk = float(peak)
    x = plan.prep(inputs, dev)
    with obs.span("sim.fused", g=int(genes.shape[0]), sse=True), \
            torch.no_grad():
        out = plan.stage_fn(genes, x, False)
        sse = sse_batch(torch.from_numpy(ref).to(dev), out).cpu().numpy()
    _bump("fused_qor_calls")
    return psnr_from_sse(sse, ref.size, pk)
