"""MoCo and SimCLR contrastive training steps.

Counterpart of `wespeaker_hubert_tpu/ssl/contrastive.py`:

  * MoCo: the key encoder's parameter EMA is taken first, from the query
    parameters before this step's update; the key forward runs in train
    mode under no_grad (it updates the key encoder's BatchNorm statistics);
    the L2-normalised query meets its key (`l_pos`) and the (K, D) float32
    queue (`l_neg`); cross-entropy at label 0 and the accuracy; then the
    key batch is written into the queue at `queue_ptr`, which advances
    modulo K (K must be a multiple of the batch);
  * SimCLR: InfoNCE over the two views' concatenated batch
    (`info_nce_logits`: positives first, then the negatives in column
    order).

Both update with the JAX trainer's `optax.sgd(lr, momentum, nesterov)`:
torch's SGD with the same momentum and nesterov, a constant learning rate
and no weight decay (bin/train_contrastive.py ignores
`optimizer_args.weight_decay`, as the JAX trainer does).
`compute_dtype=torch.bfloat16` runs the encoders on bf16 working copies of
the float32 parameters; embeddings, queue and loss stay float32.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dino import _forward

__all__ = [
    "MoCoState",
    "SimCLRState",
    "create_moco_state",
    "create_simclr_state",
    "info_nce_logits",
    "make_contrastive_optimizer",
    "make_moco_train_step",
    "make_simclr_train_step",
]


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def make_contrastive_optimizer(params, lr: float, momentum: float = 0.9,
                               nesterov: bool = False) -> torch.optim.Optimizer:
    """optax.sgd(lr, momentum, nesterov): no weight decay."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                           nesterov=bool(nesterov and momentum), weight_decay=0.0)


@dataclasses.dataclass
class MoCoState:
    """The query encoder, the key encoder (outside autograd), the (K, D)
    queue of normalised keys, the write pointer, the optimizer, the step."""

    encoder_q: nn.Module
    encoder_k: nn.Module
    queue: torch.Tensor
    queue_ptr: int
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass
class SimCLRState:
    encoder: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_moco_state(net: nn.Module, embed_dim: int, K: int = 65536, lr: float = 0.05,
                      momentum: float = 0.9, nesterov: bool = False,
                      generator: Optional[torch.Generator] = None) -> MoCoState:
    """`net` (on its device) as the query encoder, a copy as the key
    encoder, and K random unit rows drawn on the CPU from `generator`."""
    device = next(net.parameters()).device
    encoder_k = copy.deepcopy(net)
    for p in encoder_k.parameters():
        p.requires_grad_(False)
    queue = _l2(torch.randn(K, embed_dim, generator=generator)).to(device)
    opt = make_contrastive_optimizer(net.parameters(), lr, momentum, nesterov)
    return MoCoState(net, encoder_k, queue, 0, opt)


def create_simclr_state(net: nn.Module, lr: float = 0.05, momentum: float = 0.9,
                        nesterov: bool = False) -> SimCLRState:
    return SimCLRState(net, make_contrastive_optimizer(net.parameters(), lr, momentum, nesterov))


def _embed(net, feats, compute_dtype):
    return _l2(_forward(net, feats, compute_dtype))


def _sgd_step(optimizer, params, loss):
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in params:  # JAX's zero gradient where the loss does not reach
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()


def make_moco_train_step(m: float = 0.999, T: float = 0.07,
                         compute_dtype: Optional[torch.dtype] = None):
    """The MoCo step: (state, {'query_feat', 'key_feat': (B, T, F)}) ->
    {loss, acc} (device tensors), updating `state` in place."""

    def step_fn(state: MoCoState, batch: Dict[str, torch.Tensor]) -> Dict:
        k_total = state.queue.shape[0]
        bsz = batch["key_feat"].shape[0]
        if k_total % bsz:
            raise ValueError(f"the queue ({k_total}) must be a multiple of the batch ({bsz})")
        q_params = list(state.encoder_q.parameters())
        with torch.no_grad():
            k_params = list(state.encoder_k.parameters())
            torch._foreach_mul_(k_params, m)
            torch._foreach_add_(k_params, q_params, alpha=1.0 - m)
        state.encoder_q.train()
        state.encoder_k.train()
        with torch.no_grad():
            k_emb = _embed(state.encoder_k, batch["key_feat"], compute_dtype)
        q_emb = _embed(state.encoder_q, batch["query_feat"], compute_dtype)
        l_pos = (q_emb * k_emb).sum(1, keepdim=True)
        l_neg = q_emb @ state.queue.T
        logits = torch.cat([l_pos, l_neg], dim=1) / T
        labels = torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(1) == 0).float().mean()
        _sgd_step(state.optimizer, q_params, loss)
        with torch.no_grad():
            ptr = state.queue_ptr
            state.queue[ptr:ptr + bsz] = k_emb
        state.queue_ptr = (ptr + bsz) % k_total
        state.step += 1
        return {"loss": loss.detach(), "acc": acc}

    return step_fn


def info_nce_logits(features: torch.Tensor, n_views: int, T: float):
    """(n_views * B, D) -> (logits, labels): each row's n_views - 1
    positives first, then its n - n_views negatives, in column order (the
    order JAX's stable argsort gives), over T; the labels all 0."""
    n = features.shape[0]
    b = n // n_views
    feats = _l2(features)
    sim = feats @ feats.T
    ids = torch.arange(b, device=features.device).repeat(n_views)
    same = ids[None, :] == ids[:, None]
    eye = torch.eye(n, dtype=torch.bool, device=features.device)
    positives = sim[same & ~eye].view(n, n_views - 1)
    negatives = sim[~same].view(n, n - n_views)
    logits = torch.cat([positives, negatives], dim=1) / T
    return logits, torch.zeros(n, dtype=torch.long, device=features.device)


def make_simclr_train_step(T: float = 0.07, compute_dtype: Optional[torch.dtype] = None):
    """The SimCLR step: (state, {'query_feat', 'key_feat'}) -> {loss, acc}."""

    def step_fn(state: SimCLRState, batch: Dict[str, torch.Tensor]) -> Dict:
        feats = torch.cat([batch["query_feat"], batch["key_feat"]], dim=0)
        state.encoder.train()
        emb = _forward(state.encoder, feats, compute_dtype)
        logits, labels = info_nce_logits(emb, 2, T)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(1) == 0).float().mean()
        _sgd_step(state.optimizer, list(state.encoder.parameters()), loss)
        state.step += 1
        return {"loss": loss.detach(), "acc": acc}

    return step_fn
