"""Training step: CE loss (+ MoE aux), microbatched gradient
accumulation, AdamW update, optional int8 error-feedback gradient
compression; the JAX package's ``train/step.py`` over a ``Transformer``
built with ``trainable=True``.

A train state is ``{"params": {name: parameter}, "opt": {"m", "v",
"step"}}``, plus ``"ef_err"`` with compression; its ``params`` are the
model's own parameters, and a step updates the state in place (the JAX
package donates its buffers).  Micro-batch ``i`` of ``n_micro`` holds
rows ``i, i + n_micro, ...`` of the batch, as the reference's reshape
``(B/n, n, ...)`` and axis move give it; gradients accumulate in
``.grad``, in the master dtype, which is the reference's accumulator
rule (float32, or bf16 for bf16 masters).  With ``n_micro > 1`` the
reported ``aux`` is 0, as in the reference.  Compression quantizes each of the reference's parameter
leaves with one scale: a layer's tensor is stacked with the same tensor
of the other super-blocks, as the reference's scanned parameter tree
holds them (``_leaf_groups``).  Its sharding constraints have no
meaning on one device and are dropped.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch

from ..models import ApproxPolicy
from ..models.transformer import Transformer
from ..optim.adamw import AdamW
from ..optim.compress import ef_quantize

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step", "init_state",
           "AUX_COEF"]

AUX_COEF = 0.01


def cross_entropy(
    logits: torch.Tensor,     # (b, s, padded_vocab)
    labels: torch.Tensor,     # (b, s)
    vocab_size: int,
) -> torch.Tensor:
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(model: Transformer, policy: Optional[ApproxPolicy] = None,
                 *, impl: str = "kernel") -> Callable:
    """``loss_fn(batch) -> (loss, {"ce", "aux"})`` through
    ``model.forward_train``, with the batch's ``embeds`` and
    ``enc_embeds`` where it holds them; where the logits are longer than
    the labels (a front end's embeddings come first), the loss is taken
    on the last ``labels.shape[1]`` positions, the text's."""
    cfg = model.cfg

    def loss_fn(batch: Mapping[str, torch.Tensor]):
        logits, aux = model.forward_train(
            batch.get("tokens"), embeds=batch.get("embeds"),
            enc_embeds=batch.get("enc_embeds"), impl=impl, policy=policy)
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        ce = cross_entropy(logits, labels, cfg.vocab_size)
        return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}

    return loss_fn


def _split_micro(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B/n_micro, ...)."""
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is no multiple of n_micro {n_micro}")
    return x.reshape(b // n_micro, n_micro, *x.shape[1:]).movedim(1, 0)


def _leaf_groups(names, cfg) -> List[List[str]]:
    """The port's parameter names grouped into the JAX package's leaves:
    ``layers.<j>.<rest>`` joins leaf ``layer<j % len(block_pattern)>``
    of its stacked ``blocks`` tree, ``encoder.layers.<j>.<rest>`` the
    encoder's leaf ``<rest>``, stacked over its layers; the embedding,
    the final norms and the head are leaves of their own."""
    period = len(cfg.block_pattern)
    groups: Dict[str, List[str]] = {}
    for name in names:
        head, _, rest = name.partition(".")
        key = name
        if head == "layers":
            j, _, rest = rest.partition(".")
            key = f"layer{int(j) % period}.{rest}"
        elif name.startswith("encoder.layers."):
            key = "encoder." + name.split(".", 3)[3]
        groups.setdefault(key, []).append(name)
    return list(groups.values())


def init_state(params: Mapping[str, torch.Tensor], opt: AdamW, *,
               compress: bool = False) -> Dict[str, object]:
    state = {"params": dict(params), "opt": opt.init(params)}
    if compress:
        state["ef_err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for k, p in params.items()}
    return state


def make_train_step(
    model: Transformer,
    opt: AdamW,
    *,
    n_micro: int = 1,
    policy: Optional[ApproxPolicy] = None,
    compress: bool = False,
    grad_reduce: Optional[Callable] = None,
) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; batch
    holds ``tokens`` and ``labels``, (B, S) integer tensors on the
    model's device, and an encoder-decoder's ``enc_embeds`` or a front
    end's ``embeds``, (B, n, d_model), split into micro-batches as the
    tokens are.  ``grad_reduce``, where given, maps a gradient to its
    mean over the data-parallel ranks (``launch/cluster.py``) before the
    optimizer: each parameter's accumulated gradient, or with
    compression each leaf's error-feedback-quantized gradient, so the
    residual a rank carries is that of its own gradient."""
    if not model.trainable:
        raise ValueError("the model was not built with trainable=True")
    loss_fn = make_loss_fn(model, policy)
    leaves = _leaf_groups([k for k, _ in model.named_parameters()],
                          model.cfg)

    def train_step(state: Dict[str, object],
                   batch: Mapping[str, torch.Tensor]):
        params = state["params"]
        for p in params.values():
            p.grad = None
        if n_micro == 1:
            loss, parts = loss_fn(batch)
            loss.backward()
            grads = {k: p.grad for k, p in params.items()}
            loss, parts = loss.detach(), {k: v.detach()
                                          for k, v in parts.items()}
        else:
            micro = {k: _split_micro(v, n_micro) for k, v in batch.items()}
            loss = torch.zeros((), device=model.device)
            ce = torch.zeros((), device=model.device)
            for i in range(n_micro):
                l_i, parts = loss_fn({k: v[i] for k, v in micro.items()})
                l_i.backward()
                loss = loss + l_i.detach()
                ce = ce + parts["ce"].detach()
            grads = {k: p.grad for k, p in params.items()}
            for g in grads.values():
                g.div_(n_micro)
            loss, parts = loss / n_micro, {
                "ce": ce / n_micro,
                "aux": torch.zeros((), device=model.device)}

        if compress:
            err = state["ef_err"]
            for names in leaves:
                deq, new_err = ef_quantize(
                    torch.stack([grads[k] for k in names]),
                    torch.stack([err[k] for k in names]))
                if grad_reduce is not None:
                    deq = grad_reduce(deq)
                for i, k in enumerate(names):
                    grads[k], err[k] = deq[i], new_err[i]
        elif grad_reduce is not None:
            grads = {k: grad_reduce(g) for k, g in grads.items()}

        _, state["opt"], opt_metrics = opt.update(grads, state["opt"], params)
        for p in params.values():
            p.grad = None
        metrics = {"loss": loss, **parts, **opt_metrics}
        return state, metrics

    return train_step
