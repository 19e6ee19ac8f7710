"""DINO self-supervised training: a student and an EMA teacher distilled
over multi-crop views.

Counterpart of `wespeaker_hubert_tpu/ssl/dino.py`: `cosine_schedule`,
`DINOHead`, `DINONet`, `DINOState`, `create_dino_state` and
`make_dino_train_step`, with the JAX step's order and semantics:

  * features crops-major, (n * B, T, F);
  * the student's global crops, then its local crops, as two train-mode
    forwards (BatchNorm's batch statistics are per call, and its running
    statistics update twice); the teacher's global crops in train mode
    under no_grad (its own batch statistics, its own running statistics,
    which are not an EMA);
  * the crop-pair cross-entropy over the centred, sharpened teacher
    (`_dino_loss`), pairs with v == iq skipped, the mean over the terms;
  * each gradient clipped by its own L2 norm (`clip / (norm + 1e-6)`), the
    `last_layer*` gradients zeroed while `step < freeze_last_layer_steps`,
    and the coupled decay `g + wd * p` on every trainable tensor, biases and
    norms included;
  * the update (`make_dino_optimizer`), then the teacher EMA over the
    parameters at the scheduled momentum, from the updated student, then
    the centre's EMA of the teacher output's batch mean.

During the freeze the last layer still moves, by the decay and the
momentum, as in JAX.  `compute_dtype=torch.bfloat16` (the `enable_amp`
role) runs the three forwards on bf16 working copies of every float32
parameter (`torch.func.functional_call`, as `train/executor.py` does) and
of the features; BatchNorm's statistics, the head's output, the loss, the
EMAs and the centre stay float32 over float32 masters.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.norm import BatchNorm1d, upcast
from ..models.registry import embedding_from_outputs

__all__ = [
    "DINOHead",
    "DINONet",
    "DINOState",
    "cosine_schedule",
    "create_dino_state",
    "make_dino_optimizer",
    "make_dino_train_step",
]


def cosine_schedule(
    base_value: float,
    final_value: float,
    total_steps: int,
    warmup_steps: int = 0,
    start_warmup_value: float = 0.0,
) -> Callable[[int], float]:
    """Linear warmup, then a cosine from `base_value` to `final_value`, as a
    function of the step (the JAX function's, in float64)."""

    def fn(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return start_warmup_value + (base_value - start_warmup_value) * (
                step / max(warmup_steps, 1))
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return final_value + 0.5 * (base_value - final_value) * (1.0 + math.cos(math.pi * t))

    return fn


def _l2_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


class WeightNormLinear(nn.Module):
    """`nn.utils.weight_norm(nn.Linear(in_dim, out_dim, bias=False))` in its
    parameter names: `weight_v` (out, in) and `weight_g` (out, 1), the weight
    g * v with every row of v normalised (JAX's (in, out) kernel normalised
    over axis 0, with its 1e-12 clamp).  `train_g=False` fixes g at 1."""

    def __init__(self, in_dim: int, out_dim: int, train_g: bool = False):
        super().__init__()
        self.weight_v = nn.Parameter(nn.init.trunc_normal_(torch.empty(out_dim, in_dim), std=0.02))
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1), requires_grad=train_g)

    def weight(self) -> torch.Tensor:
        return self.weight_g * _l2_rows(self.weight_v)


class DINOHead(nn.Module):
    """MLP -> L2 normalise -> weight-normed linear, in WeSpeaker's names:
    `mlp.0` / `mlp.2` / `mlp.4` (with `use_bn`, BatchNorm after each hidden
    Linear: `mlp.0`, `mlp.1`, `mlp.3`, ...; with `nlayers` 1, `mlp` alone),
    exact GELU, `last_layer.weight_v` / `.weight_g`.  With `norm_last_layer`
    (the default) g stays 1 and is not trained.  The output is float32 (or
    float64): a bf16 input meets the bf16 weight in a float32 product, as
    JAX's `preferred_element_type=float32`."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hidden_dim: int = 2048,
        bottleneck_dim: int = 256,
        nlayers: int = 3,
        use_bn: bool = False,
        norm_last_layer: bool = True,
        normalize_input: bool = False,
    ):
        super().__init__()
        self.normalize_input = normalize_input
        if nlayers == 1:
            self.mlp = nn.Linear(in_dim, bottleneck_dim)
        else:
            layers: List[nn.Module] = []
            dims = [in_dim] + [hidden_dim] * (nlayers - 1)
            for d_in, d_out in zip(dims[:-1], dims[1:]):
                layers.append(nn.Linear(d_in, d_out))
                if use_bn:
                    layers.append(BatchNorm1d(d_out))
                layers.append(nn.GELU())
            layers.append(nn.Linear(hidden_dim, bottleneck_dim))
            self.mlp = nn.Sequential(*layers)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)
        self.last_layer = WeightNormLinear(bottleneck_dim, out_dim, train_g=not norm_last_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalize_input:
            x = _l2_rows(x)
        x = _l2_rows(self.mlp(x))
        return F.linear(upcast(x), upcast(self.last_layer.weight()))


class DINONet(nn.Module):
    """backbone -> embedding -> DINOHead, on (N, T, F) crops."""

    def __init__(self, backbone: nn.Module, head: DINOHead):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.head(embedding_from_outputs(self.backbone(feats)))

    def embed(self, feats: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return embedding_from_outputs(self.backbone(feats, mask=mask))


@dataclasses.dataclass
class DINOState:
    """The student, the teacher (its parameters outside autograd), the
    (1, out_dim) float32 centre, the student's optimizer and the step."""

    student: DINONet
    teacher: DINONet
    center: torch.Tensor
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_dino_optimizer(params, optimizer: str = "SGD"):
    """The update of the JAX trainer's `optimizer` key over `params`; the
    learning rate is set per step and the step applies the decay itself.

    * `SGD`: optax.trace(0.9), i.e. torch's SGD(momentum=0.9, dampening=0,
      nesterov=False), the first buffer being the gradient.
    * `ADAMW`: optax.scale_by_adam() after the step's coupled decay, i.e.
      torch's Adam(weight_decay=0) on the already-decayed gradient (optax's
      defaults).  The name is misleading: this is not a decoupled AdamW.
    * `LARS` is refused: the JAX trainer builds optax.lars(learning_rate=1.0),
      whose chain already ends in a negation, and its step multiplies by
      -lr again, so its update climbs the loss.  The port does not copy it.
    """
    kind = optimizer.upper()
    if kind == "SGD":
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, dampening=0.0,
                               nesterov=False, weight_decay=0.0)
    if kind == "ADAMW":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    if kind == "LARS":
        raise NotImplementedError(
            "optimizer LARS is not ported: the JAX trainer's optax.lars(learning_rate=1.0) "
            "already negates its update and its step scales by -lr again, so it ascends the "
            "loss (a sign fault of the JAX package; ROADMAP queue 3)")
    raise ValueError(f"unknown DINO optimizer {optimizer!r} (SGD or ADAMW)")


def create_dino_state(net: DINONet, out_dim: int, optimizer: str = "SGD") -> DINOState:
    """The student `net` (on its device), a copy of it as the teacher, a zero
    centre and the optimizer over the student's trainable parameters."""
    teacher = copy.deepcopy(net)
    for p in teacher.parameters():
        p.requires_grad_(False)
    device = next(net.parameters()).device
    opt = make_dino_optimizer([p for p in net.parameters() if p.requires_grad], optimizer)
    return DINOState(net, teacher, torch.zeros(1, out_dim, device=device), opt)


def _dino_loss(student_out, teacher_out, center, n_s, n_t, s_temp, t_temp):
    """Crop-pair cross-entropy (the JAX function's): the teacher centred and
    sharpened, each of its n_t chunks against every student chunk of
    another index, the mean over the terms."""
    s_logp = F.log_softmax(torch.stack(student_out.chunk(n_s)) / s_temp, dim=-1)
    t_probs = F.softmax((teacher_out - center) / t_temp, dim=-1).detach().chunk(n_t)
    total, n_terms = 0.0, 0
    for iq in range(n_t):
        for v in range(n_s):
            if v == iq:
                continue
            total = total + (-(t_probs[iq] * s_logp[v]).sum(-1)).mean()
            n_terms += 1
    return total / n_terms


def clip_grads_per_param(grads: List[torch.Tensor], clip: float) -> None:
    """Scale each gradient in place by min(clip / (||g|| + 1e-6), 1)."""
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads))
    coef = torch.clamp(clip / (norms + 1e-6), max=1.0)
    torch._foreach_mul_(grads, list(coef.unbind()))


def _crops_major(x: torch.Tensor) -> torch.Tensor:
    """(B, n, T, F) -> (n * B, T, F), crop by crop."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def _forward(net: nn.Module, feats: torch.Tensor, compute_dtype) -> torch.Tensor:
    """net(feats) in float32 (float64 stays float64); with `compute_dtype`,
    on working copies of the float32 parameters and of the features in that
    dtype (the buffers, BatchNorm's statistics, stay the module's own)."""
    if compute_dtype is None:
        return upcast(embedding_from_outputs(net(feats)))
    params = {k: p.to(compute_dtype) if p.dtype == torch.float32 else p
              for k, p in net.named_parameters()}
    out = torch.func.functional_call(net, params, (feats.to(compute_dtype),), strict=False)
    return upcast(embedding_from_outputs(out))


def make_dino_train_step(
    lr_schedule: Callable[[int], float],
    wd_schedule: Callable[[int], float],
    momentum_schedule: Callable[[int], float],
    teacher_temp_schedule: Callable[[int], float],
    n_global: int = 2,
    n_local: int = 4,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
    clip_grad: float = 3.0,
    freeze_last_layer_steps: int = 0,
    preprocess_fn: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable:
    """The DINO step: (state, batch, generator=None) -> metrics, updating
    `state` in place (module doc).

    Batch: {'global_feat': (B, n_global, Tg, F), 'local_feat': (B, n_local,
    Tl, F)} on the state's device, or the raw-crop fields that
    `preprocess_fn(batch, generator) -> (global_feat, local_feat or None)`
    maps to features on the device.  Metrics: loss (a device tensor), lr,
    wd, teacher_momentum and teacher_temp (the schedules at the step), and
    batch_center, the teacher output's batch mean the centre moved toward.
    """

    def step_fn(state: DINOState, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        step = state.step
        lr, wd = lr_schedule(step), wd_schedule(step)
        m, t_temp = momentum_schedule(step), teacher_temp_schedule(step)
        if preprocess_fn is not None:
            g, loc = preprocess_fn(batch, generator)
        else:
            g, loc = batch["global_feat"], batch.get("local_feat")
        has_local = loc is not None and loc.shape[1] > 0
        student, teacher = state.student, state.teacher
        student.train()
        teacher.train()
        g_flat = _crops_major(g)
        outs = [_forward(student, g_flat, compute_dtype)]
        if has_local:
            outs.append(_forward(student, _crops_major(loc), compute_dtype))
        with torch.no_grad():
            t_out = _forward(teacher, g_flat, compute_dtype)
        n_s = n_global + (n_local if has_local else 0)
        loss = _dino_loss(torch.cat(outs), t_out, state.center, n_s, n_global,
                          student_temp, t_temp)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()

        named = [(k, p) for k, p in student.named_parameters() if p.requires_grad]
        with torch.no_grad():
            for _, p in named:  # a parameter the loss does not reach: JAX's zero gradient
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            clip_grads_per_param([p.grad for _, p in named], clip_grad)
            if step < freeze_last_layer_steps:
                for k, p in named:
                    if any(part.startswith("last_layer") for part in k.split(".")):
                        p.grad.zero_()
            torch._foreach_add_([p.grad for _, p in named], [p for _, p in named], alpha=wd)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            # the teacher EMA over the parameters, from the updated student
            t_params = dict(teacher.named_parameters())
            t_list = [t_params[k] for k, _ in named]
            torch._foreach_mul_(t_list, m)
            torch._foreach_add_(t_list, [p for _, p in named], alpha=1.0 - m)
            batch_center = t_out.mean(0, keepdim=True)
            state.center.mul_(center_momentum).add_(batch_center, alpha=1.0 - center_momentum)
        state.step += 1
        return {"loss": loss.detach(), "lr": lr, "wd": wd, "teacher_momentum": m,
                "teacher_temp": t_temp, "batch_center": batch_center}

    return step_fn
