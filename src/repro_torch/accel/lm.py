"""LMAccelerator — the paper's DSE applied to the transformer stack.

The 'accelerator' is a language model; the *slots* are its projection
classes (qkv / attn_out / ffn_in / ffn_out / experts / ssm / lm_head),
each deployable as an int8 rank-k-corrected approximate matmul
(``models/approx_linear``).  The genome assigns one mul8s circuit per
class — the accelerator-variant semantics of the paper, with

  QoR        = logits-PSNR of the approximate model against the exact
               model (behavioural simulation),
  hw labels  = one run of the policy'd forward on the device, costed by
               an analytic count of that forward (``deploy_cost``) and
               the roofline model (synthesis).

The port's copy of the JAX package's ``accel/lm.py``, with three
differences:

* One model, float32 projections, a policy per forward: the weights are
  drawn once, lazily, on the device of the first call (``init_weights``
  from ``seed``; torch's RNG, so not the JAX package's numbers) or
  loaded from ``params`` (a state_dict, e.g. the JAX package's tree
  through ``convert.lm_params_from_numpy``).  At full width a model per
  genome would not fit: granite-8b's float32 projections alone are
  about 31 GB.
* The deployment's flops and bytes are counted on the forward's own
  graph (``deploy_cost``) where the JAX package reads XLA's
  ``cost_analysis``.
* ``label_fingerprint`` carries the weights' source and the device
  kind.  LM labels are float: they differ between the CPU's plain route
  and the kernels, and between torch-seeded and JAX-seeded weights, so
  no store written on another device or from other weights may answer
  for them.

The LM head and the experts are never approximated (as in the JAX
package): their genes move only ``adjusted_compute``
(``models/transformer.py``, ``models/moe.py``).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.acl.library import Circuit
from ..device import resolve_device
from ..models import ApproxPolicy
from ..models.config import ModelConfig, reduced
from .base import Accelerator, Slot

__all__ = ["LMAccelerator", "proj_classes_for"]


def proj_classes_for(cfg: ModelConfig) -> List[Tuple[str, float]]:
    """[(projection class, relative FLOP share)] for this family."""
    d, ff, hd = cfg.d_model, max(cfg.d_ff, 1), cfg.resolved_head_dim
    qkv = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads)
    attn_out = d * hd * cfg.n_heads
    head = d * cfg.padded_vocab / max(cfg.n_layers, 1)
    out: List[Tuple[str, float]] = []
    has_attn = any(k.mixer == "attn" for k in cfg.block_pattern)
    if has_attn:
        out += [("qkv", qkv), ("attn_out", attn_out)]
    if any(k.mlp == "dense" for k in cfg.block_pattern):
        out += [("ffn_in", 2.0 * d * ff), ("ffn_out", d * ff)]
    if cfg.n_experts:
        act = cfg.n_experts_active
        out += [("expert_in", 2.0 * d * ff * act), ("expert_out", d * ff * act)]
    if any(k.mixer == "mamba" for k in cfg.block_pattern):
        di = cfg.d_inner
        out += [("ssm_in", 2.0 * d * di), ("ssm_out", di * d)]
    out += [("lm_head", head)]
    total = sum(w for _, w in out)
    return [(c, w / total) for c, w in out]


# encoder frames of an encoder-decoder's forward (the JAX package's
# ``_forward`` and ``build_deploy`` draw 16)
ENC_FRAMES = 16


def _projections(cfg: ModelConfig, m: int,
                 m_enc: int = 0) -> List[Tuple[str, int, int, int]]:
    """(class, rows, k, n) of every projection matmul of one forward over
    ``m`` decoder rows (and ``m_enc`` encoder rows): an encoder-decoder's
    encoder layers first, over ``m_enc``; each decoder layer's cross
    attention projects its queries and output over ``m``, the encoder's
    keys and values over ``m_enc``; the LM head last."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_n, kv_n = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def attn(rows, kv_rows):
        return [("qkv", rows, d, q_n), ("qkv", kv_rows, d, kv_n),
                ("qkv", kv_rows, d, kv_n), ("attn_out", rows, q_n, d)]

    def mlp(rows):
        return [("ffn_in", rows, d, cfg.d_ff), ("ffn_in", rows, d, cfg.d_ff),
                ("ffn_out", rows, cfg.d_ff, d)]

    out: List[Tuple[str, int, int, int]] = []
    if cfg.is_encoder_decoder:
        for _ in range(cfg.n_enc_layers):
            out += attn(m_enc, m_enc) + mlp(m_enc)
    for _ in range(cfg.n_superblocks):
        for kind in cfg.block_pattern:
            if kind.mixer == "attn":
                out += attn(m, m)
            else:
                di, n, dtr = cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
                out += [("ssm_in", m, d, 2 * di),
                        ("ssm_out", m, di, dtr + 2 * n),
                        ("ssm_out", m, dtr, di), ("ssm_out", m, di, d)]
            if kind.cross_attn:
                out += attn(m, m_enc)
            if kind.mlp == "dense":
                out += mlp(m)
    return out + [("lm_head", m, d, cfg.padded_vocab)]


def _attention_calls(cfg: ModelConfig, s: int,
                     s_enc: int = 0) -> List[Tuple[int, int, float]]:
    """(query rows, key rows, visible pairs) of each attention core of one
    forward over ``s`` positions: the encoder's (non-causal over
    ``s_enc``), each self-attention layer's (causal) and each cross
    attention's (non-causal, ``s`` queries over ``s_enc`` keys)."""
    out: List[Tuple[int, int, float]] = []
    if cfg.is_encoder_decoder:
        out += [(s_enc, s_enc, float(s_enc * s_enc))] * cfg.n_enc_layers
    for _ in range(cfg.n_superblocks):
        for kind in cfg.block_pattern:
            if kind.mixer == "attn":
                out.append((s, s, s * (s + 1) / 2.0))
            if kind.cross_attn:
                out.append((s, s_enc, float(s * s_enc)))
    return out


# the expert classes: the MoE layer never applies a policy to them
# (``models/moe.py``), so their genes change neither the forward's graph
# nor its logits, only ``adjusted_compute``
_EXPERT_CLASSES = ("expert_in", "expert_out")


def _moe_cost(cfg: ModelConfig, b: int, s: int) -> Tuple[float, float]:
    """(flops, bytes) of the MoE layers of one forward over ``b`` x ``s``
    tokens, exact under every genome: the float32 router (m x d x e) and
    the three bf16 expert products over every slot at capacity (each
    expert's ``cap`` slots a routing group, empty ones included), each
    operand read and each output written once."""
    from ..models.moe import MOE_GROUP

    n_moe = sum(kd.mlp == "moe" for kd in cfg.block_pattern) * cfg.n_superblocks
    if not n_moe:
        return 0.0, 0.0
    d, f, e = cfg.d_model, cfg.d_ff, cfg.padded_experts
    k = cfg.n_experts_active
    if MOE_GROUP and s > MOE_GROUP and s % MOE_GROUP == 0:
        b, s = b * (s // MOE_GROUP), MOE_GROUP
    cap = max(int(s * k / e * cfg.capacity_factor), 1)
    m, rows = b * s, e * b * cap
    flops = 2.0 * m * d * e + 3 * 2.0 * rows * d * f
    byts = (4.0 * (m * d + d * e + m * e)
            + 2.0 * 2 * (rows * d + e * d * f + rows * f)     # wi, wg
            + 2.0 * (rows * f + e * f * d + rows * d))        # wo
    return n_moe * flops, n_moe * byts


def _tensor_digest(state: Mapping[str, object]) -> str:
    h = hashlib.sha256()
    for name in sorted(state):
        t = torch.as_tensor(state[name]).detach().cpu().contiguous()
        h.update(repr((name, str(t.dtype), tuple(t.shape))).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


class LMAccelerator(Accelerator):
    """``cfg`` (reduced unless ``use_reduced=False``) as a DSE target of
    ``batch`` x ``seq`` token inputs.  ``device`` fixes where the model
    lives; left None it is fixed by the first call that runs the model
    (its ``device`` argument, default ``"cuda"``) or asks for the
    fingerprint.  ``forwards`` counts the model's forwards by kind
    (``qor``, ``exact``, ``deploy``)."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        use_reduced: bool = True,
        batch: int = 2,
        seq: int = 32,
        seed: int = 0,
        device=None,
        params: Optional[Mapping[str, object]] = None,
    ):
        self.full_cfg = cfg
        self.cfg = reduced(cfg) if use_reduced else cfg
        self.name = f"lm:{cfg.name}"
        self.classes = proj_classes_for(self.cfg)
        self.slots = [Slot(c, "mul8s", w) for c, w in self.classes]
        self.batch, self.seq, self.seed = batch, seq, seed
        self.device = None if device is None else torch.device(device)
        self._params = None if params is None else dict(params)
        self.weights = (f"torch-seed={seed}" if params is None
                        else f"params={_tensor_digest(self._params)}")
        # the synthesis cache's identity key: the counts depend on the
        # config and the input shape, which the name does not fix (and a
        # JAX-written cache holds XLA's counts under the bare name)
        self.deploy_identity = (f"{self.name}|{self.cfg.name}|"
                                f"L{self.cfg.n_layers}d{self.cfg.d_model}|"
                                f"{batch}x{seq}")
        self._model = None
        self._logits_cache: Dict[tuple, np.ndarray] = {}
        self._lock = threading.RLock()
        self.forwards = {"qor": 0, "exact": 0, "deploy": 0}

    # -- device and lazy shared weights -------------------------------------
    def _pin(self, device=None) -> torch.device:
        """The device a call runs on: ``device`` (default: the pinned one,
        else ``"cuda"``), pinned on first use; another raises."""
        with self._lock:
            want = torch.device(device) if device is not None else (
                self.device or torch.device("cuda"))
            if self.device is None:
                self.device = want
            elif want.type != self.device.type:
                raise ValueError(
                    f"{self.name} lives on {self.device}, not {want}: build "
                    "another LMAccelerator for that device")
            return self.device

    def _ensure_model(self, device=None):
        from ..models.transformer import Transformer

        dev = resolve_device(self._pin(device))
        with self._lock:
            if self._model is None:
                model = Transformer(self.cfg, device=dev,
                                    proj_dtype=torch.float32)
                if self._params is None:
                    model.init_weights(self.seed)
                else:
                    model.load_state_dict(self._params)
                self._model = model
        return self._model

    @property
    def model(self):
        """The one model every call runs (built on first use)."""
        return self._ensure_model()

    def release(self) -> None:
        """Free the model's device memory (it is rebuilt on next use)."""
        with self._lock:
            self._model = None
            self._logits_cache.clear()

    def label_fingerprint(self) -> str:
        """Extra labeling state: the JAX package's seed/batch/seq, plus the
        config, the weights' source and the device kind (pinned here)."""
        return repr({"seed": self.seed, "batch": self.batch,
                     "seq": self.seq, "config": self.cfg.name,
                     "weights": self.weights,
                     "device": self._pin().type})

    def sample_inputs(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.integers(
            0, self.cfg.vocab_size, size=(n, self.batch, self.seq)
        ).astype(np.int32)

    def _enc_embeds(self, device, zeros: bool = False):
        """An encoder-decoder forward's source frames (else None): (batch,
        16, d) drawn as the JAX package's ``_forward`` draws them, from
        ``np.random.default_rng(seed)`` x 0.1, so both packages label on
        the same inputs; zeros in bf16 for the deployment, as its
        ``build_deploy``.  The vision front end gets no embeddings here,
        as in the JAX package."""
        if not self.cfg.is_encoder_decoder:
            return None
        shape = (self.batch, ENC_FRAMES, self.cfg.d_model)
        if zeros:
            return torch.zeros(shape, dtype=torch.bfloat16, device=device)
        rng = np.random.default_rng(self.seed)
        enc = rng.standard_normal(shape).astype(np.float32) * 0.1
        return torch.from_numpy(enc).to(device)

    # -- policy plumbing ------------------------------------------------------
    def _policy(self, circuits: Sequence[Circuit],
                ranks: Optional[Sequence[Optional[int]]] = None) -> ApproxPolicy:
        ranks = ranks or [None] * len(circuits)
        assignments = {}
        for slot, c, r in zip(self.slots, circuits, ranks):
            if not c.is_exact:
                assignments[slot.name] = (c.name, r)
        return ApproxPolicy(assignments)

    def policy_for_genome(
        self,
        genome,
        library=None,
        *,
        rank_genes: bool = False,
    ) -> ApproxPolicy:
        """Decode one front genome to the ``ApproxPolicy`` a served model
        runs under (``launch.serve --front``): the bridge from a stored
        Pareto point to a runnable model configuration.  Draws no
        weights."""
        if library is None:
            from ..core.acl.library import default_library

            library = default_library()
        genome = np.asarray(genome, dtype=np.int64).reshape(-1)
        width = len(self.slots) + (
            len(self.mul_slot_indices()) if rank_genes else 0
        )
        if len(genome) != width:
            raise ValueError(
                f"genome has {len(genome)} genes; {self.name} expects "
                f"{width} (rank_genes={rank_genes})"
            )
        circuits, ranks = self.decode(genome, library, rank_genes=rank_genes)
        return self._policy(circuits, ranks)

    def _forward(self, policy: ApproxPolicy, inputs: np.ndarray, kind: str,
                 *, device=None, impl: str = "kernel") -> np.ndarray:
        """float32 logits (n, batch, seq, padded_vocab) of each input's
        forward under ``policy``, on the host."""
        model = self._ensure_model(device)
        dev = model.device
        outs = []
        for tok in inputs:
            t = torch.from_numpy(np.ascontiguousarray(tok)).to(dev)
            logits = model(t, policy=policy, impl=impl,
                           enc_embeds=self._enc_embeds(dev))
            with self._lock:
                self.forwards[kind] += 1
            outs.append(logits.float().cpu().numpy())
        return np.stack(outs)

    # -- Accelerator interface ------------------------------------------------
    def simulate(self, circuits: Sequence[Circuit], inputs: np.ndarray, *,
                 device=None, impl: str = "kernel") -> np.ndarray:
        return self._forward(self._policy(circuits), inputs, "qor",
                             device=device, impl=impl)

    def exact_output(self, inputs: np.ndarray, *, device=None,
                     impl: str = "kernel") -> np.ndarray:
        key = (impl, inputs.shape, inputs.tobytes())
        with self._lock:
            hit = self._logits_cache.get(key)
        if hit is None:
            hit = self._forward(ApproxPolicy.exact(), inputs, "exact",
                                device=device, impl=impl)
            with self._lock:
                self._logits_cache[key] = hit
        return hit

    def qor_batch(
        self,
        genomes: np.ndarray,
        library,
        inputs: np.ndarray,
        *,
        rank_genes: bool = False,
        peak: float | None = None,
        device=None,
        impl: str = "kernel",
    ) -> np.ndarray:
        """Population path for the LM: the exact forward runs once per
        input set (cached logits), distinct genomes run once each
        (NSGA-II survivor sets repeat genomes heavily), and each genome's
        logits are scored as soon as they are computed, so the
        population's logits are never stacked."""
        from ..core import qor as qor_mod

        genomes = np.atleast_2d(np.asarray(genomes))
        ref = self.exact_output(inputs, device=device, impl=impl)
        uniq, inverse = np.unique(genomes, axis=0, return_inverse=True)
        vals = np.empty(len(uniq), dtype=np.float64)
        for i, g in enumerate(uniq):
            circuits, _ = self.decode(g, library, rank_genes=rank_genes)
            vals[i] = qor_mod.psnr(
                ref, self.simulate(circuits, inputs, device=device,
                                   impl=impl), peak)
        return vals[inverse.reshape(-1)]

    # -- deployment (synthesis) ----------------------------------------------
    @staticmethod
    def _deploy_policy(slots, specs) -> ApproxPolicy:
        return ApproxPolicy({
            slot.name: (spec.name, spec.rank)
            for slot, spec in zip(slots, specs)
            if not spec.is_exact
        })

    def build_deploy(self, specs: Sequence, inputs: Optional[np.ndarray] = None,
                     *, device=None):
        """-> (fn, args): ``fn(*args, path=...)`` runs the policy'd forward
        of one ``batch`` x ``seq`` input once on ``device`` (the model's;
        ``path`` is the image accelerators' route argument, unused)."""
        policy = self._deploy_policy(self.slots, specs)
        model = self._ensure_model(device)
        tok = torch.from_numpy(self.sample_inputs(1, seed=1)[0]).to(
            model.device)
        enc = self._enc_embeds(model.device, zeros=True)

        def fn(model, tok, *, path="mxu"):
            out = model(tok, policy=policy, enc_embeds=enc)
            with self._lock:
                self.forwards["deploy"] += 1
            return out

        return fn, (model, tok)

    def deploy_signature(self, specs: Sequence):
        """The base class's conservative signature, with each slot's
        class extended by exactness (an exact projection runs bf16, an
        approximated one int8 plus corrections, at any rank) and the
        classes no policy reaches constant: the forward never
        approximates the LM head or the experts, so their genes do not
        change the graph."""
        family, _ = super().deploy_signature(specs)
        classes = tuple(
            (slot.name,) if slot.name in ("lm_head",) + _EXPERT_CLASSES else
            (int(sp.rank), int(sp.trunc_bits), bool(sp.signed),
             bool(sp.is_exact))
            for slot, sp in zip(self.slots, specs)
        )
        return family, classes

    def deploy_cost(self, specs: Sequence, inputs=None) -> Dict[str, float]:
        """Analytic {'flops', 'hbm_bytes'} of ``build_deploy(specs)``'s
        forward over m = batch x seq tokens (and batch x 16 encoder rows
        for an encoder-decoder, ``_projections``): each exact projection
        2·m·k·n flops and its bf16 operands; each approximated one as
        ``synth.grouped_cost`` counts a one-group rank-k product ((1 +
        rank) products, float32 operands, the U/V tables) plus its
        gathers, U[x] (m·k·r) and V[w] (k·n·r) in float32, each written
        and read once (the route materializes them); each attention core
        (q·k and p·v over its visible pairs, bf16: causal self-attention,
        the encoder's and cross attention's non-causal pairs,
        ``_attention_calls``), the scan (``chip_smoke.py``'s count) and
        the MoE layers (``_moe_cost``); the LM head and the experts
        always exact."""
        from ..core.features.synth import grouped_cost

        cfg = self.cfg
        exact_only = ("lm_head",) + _EXPERT_CLASSES
        spec_of = {slot.name: sp for slot, sp in zip(self.slots, specs)
                   if slot.name not in exact_only and not sp.is_exact}
        b, s = self.batch, self.seq
        s_enc = ENC_FRAMES if cfg.is_encoder_decoder else 0
        flops = byts = 0.0
        for cls, m, k, n in _projections(cfg, b * s, b * s_enc):
            sp = spec_of.get(cls)
            if sp is None:
                flops += 2.0 * m * k * n
                byts += 2.0 * (m * k + k * n + m * n)
            else:
                c = grouped_cost(m, n, [(0, k)], [sp])
                flops += c["flops"]
                byts += c["hbm_bytes"] + 2 * 4.0 * sp.rank * (m * k + k * n)
        hd, h, kvh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        for sq, sk, pairs in _attention_calls(cfg, s, s_enc):
            flops += 4.0 * b * h * hd * pairs
            byts += 2.0 * (2 * b * h * sq * hd + 2 * b * kvh * sk * hd)
        n_mamba = sum(kd.mixer == "mamba" for kd in cfg.block_pattern
                      ) * cfg.n_superblocks
        if n_mamba:
            di, n = cfg.d_inner, cfg.ssm_state
            flops += n_mamba * float(b) * s * di * (7 * n + 1)
            byts += n_mamba * 4.0 * (3 * b * s * di + 2 * b * s * n + di * n
                                     + 2 * b * di * n)
        moe_flops, moe_bytes = _moe_cost(cfg, b, s)
        return {"flops": flops + moe_flops, "hbm_bytes": byts + moe_bytes}

    def mul_slot_constants(self):
        return [None] * len(self.slots)

    def adjusted_compute(self, circuits, ranks, factor) -> float:
        """Dtype-aware compute of one forward step: per projection class,
        (2 * N_class * tokens) MACs scaled by ``factor`` of the circuit's
        deployment width plus its correction rank (unapproximated work —
        attention cores, norms — rides along).  ``factor`` is a cost
        model's ``dtype_cost_factor`` or ``energy_factor``; under
        ``V5E``'s this is the JAX package's number."""
        tokens = self.batch * self.seq
        n_active = self.cfg.active_param_count()
        total = 0.0
        for (cls, share), c, r in zip(self.classes, circuits, ranks):
            base = factor(c.deploy_width)
            rank = c.deploy_rank if r is None else (
                0 if c.native_width is not None else int(r)
            )
            total += 2.0 * n_active * share * tokens * (base + rank)
        return total


# The LM is not a LUT workload: its QoR path is a deduped forward per
# distinct genome, not a table-driven population simulation.  Opt it out
# of the population engine explicitly.
from . import fused as _fused  # noqa: E402

_fused.register_unfused(LMAccelerator)
