"""plbl of the PyTorch port (mirrors mulactseg_tpu/plbl): cosine-prototype
pseudo labels and their generator."""

from mulactseg_tpu_torch.plbl.cosine_prop import (
    cosine_prototype_plbl,
    selected_spx_adjacency,
)
from mulactseg_tpu_torch.plbl.generator import (
    METHOD_TO_PLBL,
    PLBL_TYPES,
    PseudoLabelGenerator,
    plbl_save_dir,
)

__all__ = [
    "cosine_prototype_plbl",
    "selected_spx_adjacency",
    "METHOD_TO_PLBL",
    "PLBL_TYPES",
    "PseudoLabelGenerator",
    "plbl_save_dir",
]
