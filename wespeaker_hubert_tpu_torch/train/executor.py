"""The train step and batched, masked embedding extraction.

Counterpart of `wespeaker_hubert_tpu/train/executor.py`:

    wav -> speed perturb -> reverb / noise -> SSL frontend -> CMVN ->
        SpecAug -> backbone -> margin head -> cross-entropy -> gradients ->
        SGD update

(`make_train_step`), `make_eval_embed` and `cast_variables_bf16`.  One call
of the step is one optimizer step; the LR and margin are the schedules'
values at the state's step.  Mixed precision is the JAX package's: the step
runs the model on bf16 working copies of the float32 parameters
(`torch.func.functional_call`), so the gradients land in float32 on the
master weights; BatchNorm statistics stay float32 and the logits are
float32.  (`torch.autocast` would compute another function, and would hand
the flash-attention kernel a float32 bias with bf16 q, k, v.)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.augment import add_reverb_noise, add_reverb_noise_packed, speed_perturb
from ..ops.feature_utils import apply_cmvn, spec_aug
from ..ops.pipeline import FeaturePipelineConfig, wav_to_features

__all__ = ["make_train_step", "make_eval_embed", "cast_variables_bf16", "cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


class _TrainForward(torch.nn.Module):
    """The differentiable part of a step, as one module whose only child is
    the SpeakerNet, so that `functional_call` can hand it bf16 parameters."""

    def __init__(self, net: torch.nn.Module, fcfg: FeaturePipelineConfig,
                 compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.net = net
        self.fcfg = fcfg
        self.compute_dtype = compute_dtype

    def forward(self, batch: Dict[str, torch.Tensor], wav: Optional[torch.Tensor],
                margin: float, generator: Optional[torch.Generator]):
        fcfg, net = self.fcfg, self.net
        mask = None
        if "feat" in batch:
            # precomputed features: CMVN and SpecAug, no waveform augmentation
            feats = apply_cmvn(batch["feat"], norm_mean=fcfg.cmvn_norm_mean,
                               norm_var=fcfg.cmvn_norm_var)
        elif net.frontend is None:
            feats, mask = wav_to_features(wav, fcfg, lengths=batch.get("length"), train=True)
        else:
            if self.compute_dtype is not None:
                # the frontend follows its input's dtype
                wav = wav.to(self.compute_dtype)
            feats, feat_lengths = net.features(wav, lengths=batch.get("length"))
            feats = apply_cmvn(feats, norm_mean=fcfg.cmvn_norm_mean,
                               norm_var=fcfg.cmvn_norm_var, lengths=feat_lengths)
            if feat_lengths is not None:
                mask = torch.arange(feats.shape[1], device=feats.device)[None, :] < feat_lengths[:, None]
        if fcfg.spec_aug and (("feat" in batch) or net.frontend is not None):
            feats = spec_aug(
                feats, generator, num_t_mask=fcfg.spec_aug_num_t_mask,
                num_f_mask=fcfg.spec_aug_num_f_mask, max_t=fcfg.spec_aug_max_t,
                max_f=fcfg.spec_aug_max_f, prob=fcfg.spec_aug_prob,
            )
        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        _, logits, aux = net(feats, batch["label"], margin, mask=mask)
        return logits.float(), aux


def make_train_step(
    model: torch.nn.Module,
    lr_schedule: Callable[[int], float],
    margin_schedule: Callable[[int], float],
    feature_cfg: Optional[FeaturePipelineConfig] = None,
    chunk_samples: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    seed: int = 0,
    num_steps: int = 1,
    mesh=None,
    aug_blocks: int = 1,
    pipeline_microbatches: Optional[int] = None,
) -> Callable:
    """The train step: (state, batch) -> metrics {loss, acc, lr, margin},
    updating `state` (train/state.py:TrainState over `model`) in place.

    The batch is a dict of tensors on the model's device: {'wav': (B, W)}
    or {'feat': (B, T, F)}, 'label' (B,), optional 'length', and the
    augmentation fields of data/dataset.py:TrainPipeline ('speed_idx', and
    'aug_type', 'rir', 'noise', 'snr' unpacked or 'rir', 'noise', 'snr'
    packed [reverb | noise | clean]).  `chunk_samples` is the chunk length
    after speed perturbation, needed only for a speed-perturbed batch
    without noise rows.  SpecAugment draws from a torch.Generator seeded
    from (`seed`, step), so a resumed run draws the same masks.  Loss and
    acc are returned as device tensors (no host synchronization).
    """
    if num_steps > 1:
        raise NotImplementedError("num_steps > 1 (scanned steps) is not ported yet")
    if mesh is not None or pipeline_microbatches:
        raise NotImplementedError("mesh / pipeline-parallel training is not ported yet")
    if aug_blocks > 1:
        raise NotImplementedError("aug_blocks > 1 (multi-host packed batches) is not ported yet")
    fwd = _TrainForward(model, feature_cfg or FeaturePipelineConfig(), compute_dtype)

    def prepare_wav(batch):
        wav = batch["wav"]
        if "speed_idx" in batch:
            # noise rows (packed or unpacked) are exactly chunk_samples wide
            has_noise = "noise" in batch and batch["noise"].shape[0]
            out_len = batch["noise"].shape[1] if has_noise else chunk_samples
            if out_len is None:
                raise ValueError(
                    "speed-perturbed batch without noise rows: pass chunk_samples"
                )
            wav = speed_perturb(wav, batch["speed_idx"], out_len)
        if "aug_type" in batch:
            wav = add_reverb_noise(wav, batch["rir"], batch["noise"], batch["aug_type"],
                                   batch["snr"])
        elif "rir" in batch:  # packed layout
            wav = add_reverb_noise_packed(wav, batch["rir"], batch["noise"], batch["snr"],
                                          batch["rir"].shape[0])
        return wav

    generator = None

    def step_fn(state, batch: Dict[str, torch.Tensor]) -> Dict:
        nonlocal generator
        step = state.step
        margin = margin_schedule(step)
        device = batch["label"].device
        if generator is None or generator.device != device:
            generator = torch.Generator(device=device)
        generator.manual_seed(seed * 1000003 + step)
        model.train()
        wav = prepare_wav(batch) if "feat" not in batch else None
        state.optimizer.zero_grad(set_to_none=True)
        if compute_dtype is not None:
            params = {
                "net." + k: p.to(compute_dtype) if p.dtype == torch.float32 else p
                for k, p in model.named_parameters()
            }
            logits, aux = torch.func.functional_call(
                fwd, params, (batch, wav, margin, generator), strict=False)
        else:
            logits, aux = fwd(batch, wav, margin, generator)
        labels = batch["label"].long()
        loss = aux if aux is not None else cross_entropy(logits, labels)
        loss.backward()
        lr = state.apply_gradients()
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc, "lr": lr, "margin": margin}

    return step_fn


def cast_variables_bf16(model: torch.nn.Module) -> torch.nn.Module:
    """Cast every float32 parameter and buffer to bf16, BatchNorm running
    statistics included, as the JAX function casts every f32 leaf; the
    companion of compute_dtype=torch.bfloat16.  Casts in place and returns
    the module."""
    return model.to(torch.bfloat16)


def make_eval_embed(
    model: torch.nn.Module,
    feature_cfg: Optional[FeaturePipelineConfig] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """Embedding extraction: batch -> (B, emb_dim) float32.

    Batch: {'wav': (B, W), 'length': (B,)} or {'feat': (B, T, F),
    'feat_length': (B,)}, on the model's device; lengths are optional.
    Padded batches are exact: CMN and pooling only see valid frames.  A
    SpeakerNet with a frontend takes the wav (cast to `compute_dtype`)
    through it, then CMVN over the valid frames.
    """
    fcfg = feature_cfg or FeaturePipelineConfig()
    use_frontend = getattr(model, "frontend", None) is not None

    def embed_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            if "feat" in batch:
                lengths = batch.get("feat_length")
                feats = apply_cmvn(
                    batch["feat"],
                    norm_mean=fcfg.cmvn_norm_mean,
                    norm_var=fcfg.cmvn_norm_var,
                    lengths=lengths,
                )
                mask = None
                if lengths is not None:
                    t = feats.shape[1]
                    mask = (
                        torch.arange(t, device=feats.device)[None, :]
                        < lengths[:, None]
                    )
            elif use_frontend:
                wav = batch["wav"]
                if compute_dtype is not None:
                    wav = wav.to(compute_dtype)
                feats, feat_lengths = model.features(wav, lengths=batch.get("length"))
                feats = apply_cmvn(
                    feats,
                    norm_mean=fcfg.cmvn_norm_mean,
                    norm_var=fcfg.cmvn_norm_var,
                    lengths=feat_lengths,
                )
                mask = None
                if feat_lengths is not None:
                    mask = (
                        torch.arange(feats.shape[1], device=feats.device)[None, :]
                        < feat_lengths[:, None]
                    )
            else:
                feats, mask = wav_to_features(
                    batch["wav"], fcfg, lengths=batch.get("length")
                )
            if compute_dtype is not None:
                feats = feats.to(compute_dtype)
            return model.embed(feats, mask=mask).float()

    return embed_fn
