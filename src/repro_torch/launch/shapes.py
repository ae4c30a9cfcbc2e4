"""The assigned input-shape cells and their abstract inputs, the JAX
package's ``launch/shapes.py``.

Four shapes per architecture (40 cells):
    train_4k     seq 4,096   global batch 256   -> train_step
    prefill_32k  seq 32,768  global batch 32    -> prefill_step
    decode_32k   seq 32,768  global batch 128   -> serve_step (1 token,
                                                  KV cache of seq_len)
    long_500k    seq 524,288 global batch 1     -> serve_step; SSM/hybrid
                                                  only (sub-quadratic);
                                                  SKIP for full-attention
                                                  archs per the brief.

``input_specs`` returns every input of a cell as an ``Abstract``: a
tensor on the ``meta`` device (shape and dtype, no storage) with its
resolved ``PartitionSpec`` and DTensor placements, plus the cell's
sharding-rule overrides (decode cells shard the KV sequence on "model";
long-context also on "data").  Nothing is allocated, so a full-size
cell resolves on any host.  The mesh is read only through its axis
sizes (``dist.sharding``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..dist.sharding import (DEFAULT_RULES, AxisRules, PartitionSpec,
                             mesh_sizes, placements_for, spec_for)
from ..models.config import ModelConfig
from ..models.transformer import param_specs

__all__ = ["Abstract", "ShapeCell", "SHAPES", "cell_rules", "input_specs",
           "runnable", "n_microbatches", "ENC_CONTEXT"]

ENC_CONTEXT = 4096  # encoder context length for enc-dec decode cells


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


class Abstract(NamedTuple):
    """One abstract input: a ``meta`` tensor, its spec, its placements."""
    tensor: torch.Tensor
    spec: PartitionSpec
    placements: List[Any]


def runnable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(runnable?, reason-if-skip) for one (arch, shape) cell."""
    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, "SKIP(full-attn): 512k dense-KV decode out of scope"
    return True, ""


def cell_rules(cfg: ModelConfig, shape: str, mesh=None) -> AxisRules:
    """Per-cell sharding-rule overrides (see module docstring)."""
    cell = SHAPES[shape]
    n_pods = mesh_sizes(mesh).get("pod", 1) if mesh is not None else 1
    # kv_seq -> "model" is the global default (dist.sharding).  Arch-level
    # overrides (jamba's cross-pod FSDP) come from the config; experiments
    # pass rules_override on top.
    rules: AxisRules = dict(cfg.sharding_rules)
    # archs whose head count cannot shard on the 16-way model axis
    # (gemma 8, granite-moe 24) would replicate attention across TP, so
    #   * prefill: context-parallel queries (seq -> model)
    #   * train:   batch over (pod, data, model)
    # (no-ops for shardable-head archs: the heads rule wins the axis)
    if cfg.n_heads % 16 != 0 and not cfg.is_attention_free:
        if cell.kind == "prefill" and not (cfg.n_experts and n_pods > 1):
            # (except on the multi-pod mesh for MoE, where the routing
            # group's reshape would cross seq shards)
            rules.setdefault("seq", "model")
        if cell.kind == "train":
            rules.setdefault("batch", ("pod", "data", "model"))
    return rules


def n_microbatches(cfg: ModelConfig, mesh,
                   global_batch: Optional[int] = None) -> int:
    """Gradient-accumulation depth for train_4k: enough that a per-device
    microbatch is 1-2 rows (activation memory), shard-aligned to the
    cell's batch sharding (cell_rules).  ``global_batch`` takes the same
    rule to another batch than the cell's 256 (``launch/cluster.py``)."""
    rules = {**DEFAULT_RULES, **cell_rules(cfg, "train_4k", mesh)}
    axes = rules.get("batch") or ()
    if isinstance(axes, str):
        axes = (axes,)
    b = global_batch or SHAPES["train_4k"].global_batch
    batch_shards = 1
    for a in axes:
        n = mesh_sizes(mesh).get(a, 1)
        if b % (batch_shards * n) == 0:
            batch_shards *= n
    per_dev = b // batch_shards
    rows = 1 if cfg.d_model >= 4096 else 2
    return max(per_dev // rows, 1)


def _abstract(shape: Sequence[int], dtype: torch.dtype,
              logical: Sequence[Optional[str]], mesh,
              rules: AxisRules) -> Abstract:
    shape = tuple(int(n) for n in shape)
    spec = spec_for(logical, shape, mesh, rules)
    return Abstract(torch.empty(shape, dtype=dtype, device="meta"), spec,
                    placements_for(spec, mesh))


def _tokens(shape, mesh, rules) -> Abstract:
    return _abstract(shape, torch.int32, ("batch",) + (None,) * (
        len(shape) - 1), mesh, rules)


def _embeds(b, s, d, mesh, rules) -> Abstract:
    return _abstract((b, s, d), torch.bfloat16, ("batch", None, None), mesh,
                     rules)


def _caches(cfg, b, max_len, enc_len, mesh, rules) -> List[Dict[str, Any]]:
    """The decode caches of ``Transformer.init_caches``, one dict a layer
    (the JAX package's ``cache_specs`` logical axes)."""
    hd, kvh = cfg.resolved_head_dim, cfg.n_kv_heads
    di, n, ck = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    out = []
    for _ in range(cfg.n_superblocks):
        for kind in cfg.block_pattern:
            if kind.mixer == "attn":
                kv = ("batch", "kv_heads", "kv_seq", None)
                c = {k: _abstract((b, kvh, max_len, hd), torch.bfloat16, kv,
                                  mesh, rules) for k in ("k", "v")}
            else:
                c = {"conv": _abstract((b, ck - 1, di), torch.float32,
                                       ("batch", None, "mlp"), mesh, rules),
                     "ssm": _abstract((b, di, n), torch.float32,
                                      ("batch", "mlp", "state"), mesh,
                                      rules)}
            if kind.cross_attn:
                cross = ("batch", "kv_heads", None, None)
                c["cross"] = {k: _abstract((b, kvh, enc_len, hd),
                                           torch.bfloat16, cross, mesh, rules)
                              for k in ("k", "v")}
            out.append(c)
    return out


def input_specs(
    cfg: ModelConfig,
    shape: str,
    mesh,
    *,
    serve_dtype: str = "bfloat16",
    rules_override: Optional[AxisRules] = None,
) -> Dict[str, Any]:
    """Abstract inputs for one cell.

    Returns {"kind", "rules", "cell", "params" ({name: Abstract} under
    the ``Transformer``'s names), "batch" | ("caches", "tokens", "pos"),
    ...}.  ``rules_override`` re-shards a cell for an experiment."""
    cell = SHAPES[shape]
    rules = {**cell_rules(cfg, shape, mesh), **(rules_override or {})}
    d = cfg.d_model
    out: Dict[str, Any] = {"kind": cell.kind, "rules": rules, "cell": cell}

    # train: master-weight dtype from the config (jamba: bf16 to fit HBM);
    # serving: bf16 weights
    dtype = getattr(torch, cfg.param_dtype if cell.kind == "train"
                    else serve_dtype)
    out["params"] = {name: _abstract(s.shape, dtype, s.logical, mesh, rules)
                     for name, s in param_specs(cfg).items()}

    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        batch: Dict[str, Any] = {}
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = _embeds(b, s, d, mesh, rules)
            batch["tokens"] = _tokens((b, s), mesh, rules)
        elif cfg.frontend == "vision":
            batch["embeds"] = _embeds(b, cfg.frontend_len, d, mesh, rules)
            batch["tokens"] = _tokens((b, s - cfg.frontend_len), mesh, rules)
        else:
            batch["tokens"] = _tokens((b, s), mesh, rules)
        batch["labels"] = _tokens(batch["tokens"].tensor.shape, mesh, rules)
        out["batch"] = batch
        return out

    if cell.kind == "prefill":
        batch = {}
        cache_len = s
        if cfg.is_encoder_decoder:
            # long source (the 32k audio), short decoder prime
            batch["enc_embeds"] = _embeds(b, s, d, mesh, rules)
            batch["tokens"] = _tokens((b, 128), mesh, rules)
            cache_len = 128
        elif cfg.frontend == "vision":
            batch["embeds"] = _embeds(b, cfg.frontend_len, d, mesh, rules)
            batch["tokens"] = _tokens((b, s - cfg.frontend_len), mesh, rules)
        else:
            batch["tokens"] = _tokens((b, s), mesh, rules)
        out["batch"] = batch
        out["caches"] = _caches(cfg, b, cache_len, s, mesh, rules)
        return out

    # decode
    enc_len = ENC_CONTEXT if cfg.is_encoder_decoder else 0
    out["caches"] = _caches(cfg, b, s, enc_len, mesh, rules)
    out["tokens"] = _tokens((b, 1), mesh, rules)
    out["pos"] = Abstract(torch.empty((), dtype=torch.int32, device="meta"),
                          PartitionSpec(), placements_for((), mesh))
    if cfg.is_encoder_decoder:
        out["enc_out"] = _embeds(b, enc_len, d, mesh, rules)
    return out
