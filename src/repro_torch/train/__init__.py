"""The port's training path (``repro.train``): data, AdamW, checkpoints and
the train step, on the hand-written forward and backward kernels."""
from .checkpoint import CheckpointManager
from .data import RecordIOReader, RecordIOWriter, SyntheticTokenDataset, make_loader
from .optimizer import OptimizerConfig, adamw_update, init_opt_state, lr_at, opt_state_defs
from .step import make_loss_fn, make_train_step

__all__ = [
    "CheckpointManager",
    "OptimizerConfig",
    "RecordIOReader",
    "RecordIOWriter",
    "SyntheticTokenDataset",
    "adamw_update",
    "init_opt_state",
    "lr_at",
    "make_loader",
    "make_loss_fn",
    "make_train_step",
    "opt_state_defs",
]
