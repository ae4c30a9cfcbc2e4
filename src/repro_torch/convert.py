"""Carry circuit state and model parameters across from the JAX package
as plain numpy.

The port imports nothing of the JAX package; state crosses as numpy
arrays.  ``library_arrays`` dumps any circuit library (the port's, or
one with the same duck-typed ``Circuit`` attributes) to numpy, so two
libraries can be compared array by array; ``spec_from_arrays`` builds
the port's ``ApproxSpec`` from the arrays of a spec made elsewhere, so
both packages' matmuls can be fed the same spec;
``lm_params_from_numpy`` turns an LM parameter tree into the port's
``state_dict``, and ``train_state_from_numpy`` a whole train state
(parameters, AdamW moments and step, error-feedback residuals) into the
port's train state tree, keyed as ``train.step.init_state``'s.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .kernels.approx_matmul import ApproxSpec

__all__ = ["spec_from_arrays", "library_arrays", "lm_params_from_numpy",
           "train_state_from_numpy"]

# fixed adder probe: 16-bit operand pairs covering carry-chain corners
_ADD_PROBE = (np.arange(0, 1 << 16, 257, dtype=np.int64),
              np.arange((1 << 16) - 1, -1, -257, dtype=np.int64))


def spec_from_arrays(
    name: str,
    signed: bool,
    rank: int,
    u: np.ndarray,
    v: np.ndarray,
    table: Optional[np.ndarray],
    trunc_bits: int,
) -> ApproxSpec:
    """The port's ``ApproxSpec`` from a spec's numpy fields."""
    u = np.ascontiguousarray(u, dtype=np.float32)
    v = np.ascontiguousarray(v, dtype=np.float32)
    if u.shape != (256, int(rank)) or v.shape != (256, int(rank)):
        raise ValueError(f"u, v must be (256, {rank}), got {u.shape}, {v.shape}")
    if table is not None:
        table = np.ascontiguousarray(table, dtype=np.int32)
        if table.shape != (256, 256):
            raise ValueError(f"table must be (256, 256), got {table.shape}")
    return ApproxSpec(name=str(name), signed=bool(signed), rank=int(rank),
                      u=u, v=v, table=table, trunc_bits=int(trunc_bits))


def library_arrays(lib) -> Dict[str, np.ndarray]:
    """``{"<circuit>/<field>": array}`` for every circuit of ``lib``:
    multipliers give their product ``table`` and the ``u``/``v`` factors
    at their deployment rank; adders give their outputs on a fixed
    operand probe.  Every circuit also gives ``meta``: (kind index,
    deploy rank, native width or -1, is_exact)."""
    kinds = ("mul8u", "mul8s", "add16")
    out: Dict[str, np.ndarray] = {}
    for c in lib.circuits:
        native = -1 if c.native_width is None else int(c.native_width)
        out[f"{c.name}/meta"] = np.array(
            [kinds.index(c.kind), int(c.deploy_rank), native, int(c.is_exact)],
            dtype=np.int64)
        if c.kind == "add16":
            out[f"{c.name}/probe"] = np.asarray(
                c.fn(*_ADD_PROBE), dtype=np.int64)
            continue
        out[f"{c.name}/table"] = np.asarray(c.table, dtype=np.int64)
        if c.deploy_rank:
            f = c.factors(c.deploy_rank)
            out[f"{c.name}/u"] = np.asarray(f.u, dtype=np.float32)
            out[f"{c.name}/v"] = np.asarray(f.v, dtype=np.float32)
    return out


def lm_params_from_numpy(tree: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The port's ``Transformer`` state_dict from the JAX package's LM
    parameter tree, given as nested dicts of numpy arrays.

    ``tree["blocks"]["layer<i>"]`` leaves carry a leading super-block
    axis; super-block ``sb``'s position ``i`` becomes layer
    ``sb * len(cfg.block_pattern) + i`` (its ``cross`` module, where the
    layer has one, the layer's cross attention).  An encoder-decoder's
    ``tree["encoder"]["blocks"]`` leaves (``attn``, ``mlp``) carry a
    leading axis of ``n_enc_layers`` and become ``encoder.layers.<j>``;
    ``tree["encoder"]["final_norm"]`` the encoder's final norm.  Tensors
    keep the tree's dtype; ``load_state_dict`` casts each to its
    parameter's storage dtype."""
    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    def unstack(blocks, n, unit, what, prefix, period=1, i=0):
        for mod_name, params in blocks.items():
            for name, arr in params.items():
                arr = np.asarray(arr)
                if arr.shape[0] != n:
                    raise ValueError(
                        f"{what}.{mod_name}.{name}: leading axis "
                        f"{arr.shape[0]}, expected {n} {unit}")
                for sb in range(n):
                    out[f"{prefix}.{sb * period + i}.{mod_name}.{name}"] = (
                        t(arr[sb]))

    pattern = cfg.block_pattern
    out: Dict[str, torch.Tensor] = {"embed": t(tree["embed"])}
    for i, _kind in enumerate(pattern):
        unstack(tree["blocks"][f"layer{i}"], cfg.n_superblocks,
                "super-blocks", f"layer{i}", "layers", len(pattern), i)
    out["final_norm"] = t(tree["final_norm"])
    if "lm_head" in tree:
        out["lm_head"] = t(tree["lm_head"])
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        unstack(enc["blocks"], cfg.n_enc_layers, "encoder layers",
                "encoder", "encoder.layers")
        out["encoder.final_norm"] = t(enc["final_norm"])
    return out


def train_state_from_numpy(state: Mapping, cfg) -> Dict[str, object]:
    """The port's train state tree from the JAX package's (``init_state``
    and ``make_train_step``'s ``{"params", "opt": {"m", "v", "step"},
    "ef_err"?}``, given as nested dicts of numpy arrays): every tree of
    parameter shape through ``lm_params_from_numpy``'s name map, the step
    as an int32 scalar tensor."""
    opt = state["opt"]
    out: Dict[str, object] = {
        "params": lm_params_from_numpy(state["params"], cfg),
        "opt": {"m": lm_params_from_numpy(opt["m"], cfg),
                "v": lm_params_from_numpy(opt["v"], cfg),
                "step": torch.tensor(int(np.asarray(opt["step"])),
                                     dtype=torch.int32)},
    }
    if "ef_err" in state:
        out["ef_err"] = lm_params_from_numpy(state["ef_err"], cfg)
    return out
