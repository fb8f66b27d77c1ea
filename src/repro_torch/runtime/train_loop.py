"""Train, serve and prefill step factories on one device.

The port of ``repro/runtime/train_loop.py``.  The gradient is autograd
over the families' ``train_loss`` (the reference differentiates its XLA
ops the same way: the JAX package has no backward kernel).  With
``cfg.grad_accum`` > 1 the batch is cut into that many microbatches in
order; their gradients accumulate in the parameters' ``.grad`` (f32 for
f32 parameters), first plus second plus ..., as the reference's scan
adds them, and are then scaled by ``1/accum``; the loss is the mean.
The step then runs :func:`optim.adamw.update` on the cosine schedule's
learning rate.

The reference's pod-compressed step (``compressed=True`` with
``n_pods`` > 1: posit16 gradients on a pod mesh's wire) needs a pod
mesh, which one device does not have: it raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.models import get_family
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def make_grad_fn(cfg: ModelConfig):
    """``grads_of(params, batch) -> (loss, grads)``: the mean loss (a 0-d
    f32 tensor) and a tree of f32 gradients shaped like ``params`` (the
    parameters' ``.grad`` tensors, which the next call replaces)."""
    fam = get_family(cfg)
    accum = max(1, cfg.grad_accum)

    def grads_of(params, batch):
        leaves = T.leaves(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        b = batch["tokens"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {accum}")
        mb = b // accum
        lsum = None
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss = fam.train_loss(params, micro, cfg)
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.requires_grad_(False)
        if accum > 1:
            for p in leaves:
                p.grad.mul_(1.0 / accum)
            lsum = lsum * (1.0 / accum)
        return lsum, T.tree_map(lambda p: p.grad, params)

    return grads_of


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, n_pods: int = 1, compressed: bool = False,
                    total_steps: int = 10_000):
    """``train_step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss", "grad_norm"})``; the parameters and ``v`` update
    in place, and each parameter's ``.grad`` is released after the
    update."""
    if compressed and n_pods > 1 and cfg.grad_compress:
        raise NotImplementedError(
            "the pod-compressed train step needs a pod mesh (several devices); "
            "it is not ported to one device")
    grads_of = make_grad_fn(cfg)

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        dev = loss.device
        lr_scale = adamw.cosine_schedule(torch.tensor(int(step), device=dev),
                                         total=total_steps)
        params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg,
                                                  lr_scale)
        del grads
        for p in T.leaves(params):
            p.grad = None
        return params, opt_state, {"loss": loss, **metrics}

    return train_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: ``(params, cache, token) -> (logits, cache)``."""
    fam = get_family(cfg)

    def serve_step(params, cache, token):
        return fam.decode_step(params, cache, token, cfg)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """``(params, batch) -> (cache, logits)``, with whisper's ``frames``
    and a visual prefix passed on from the batch."""
    fam = get_family(cfg)

    def prefill_step(params, batch):
        kwargs = {k: batch[k] for k in ("frames", "visual") if k in batch}
        return fam.prefill(params, batch["tokens"], cfg, **kwargs)

    return prefill_step
