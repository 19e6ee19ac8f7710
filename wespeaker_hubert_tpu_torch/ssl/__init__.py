"""Self-supervised training: DINO, MoCo and SimCLR (counterpart of
`wespeaker_hubert_tpu/ssl/`)."""

from .contrastive import (
    MoCoState,
    SimCLRState,
    create_moco_state,
    create_simclr_state,
    info_nce_logits,
    make_moco_train_step,
    make_simclr_train_step,
)
from .dataset import SSLPipeline
from .dino import (
    DINOHead,
    DINONet,
    DINOState,
    cosine_schedule,
    create_dino_state,
    make_dino_optimizer,
    make_dino_train_step,
)

__all__ = [
    "MoCoState",
    "SimCLRState",
    "create_moco_state",
    "create_simclr_state",
    "info_nce_logits",
    "make_moco_train_step",
    "make_simclr_train_step",
    "SSLPipeline",
    "DINOHead",
    "DINONet",
    "DINOState",
    "cosine_schedule",
    "create_dino_state",
    "make_dino_optimizer",
    "make_dino_train_step",
]
