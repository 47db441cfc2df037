"""losses of the PyTorch port (mirrors mulactseg_tpu/losses)."""

from mulactseg_tpu_torch.losses.partial import (
    group_multi_label_ce,
    lossdecomp,
    multi_choice_ce,
    multi_choice_ent,
    onehot_ce_multihot_choice,
    rc_multi_choice_ce,
)
from mulactseg_tpu_torch.losses.standard import (
    cross_entropy,
    focal_loss,
    rcce,
    rcce_asym,
)

__all__ = [
    "multi_choice_ce",
    "group_multi_label_ce",
    "onehot_ce_multihot_choice",
    "lossdecomp",
    "rc_multi_choice_ce",
    "multi_choice_ent",
    "cross_entropy",
    "focal_loss",
    "rcce",
    "rcce_asym",
]
