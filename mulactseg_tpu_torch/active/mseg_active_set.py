"""Mixed-superpixel-scale (mseg) active-set state: the port's copy of
mulactseg_tpu/active/mseg_active_set.py (the reference's multi-nseg
bookkeeping, mseg_region_active_dataset.py:15-120). Selection rows are
keyed by "nseg/file_id"; each labelled image carries a
{nseg: [lbl_path, spx_path]} dict, so one image can hold selections at
several superpixel granularities. The JSON files are the JAX package's
byte for byte.
"""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

IMG_TPL = "leftImg8bit/train/{}/{}_leftImg8bit.png"
LBL_TPL = "superpixel_seed/cityscapes/seeds_{}/train/gtFine_dominant_ignore/{}.png"
SPX_TPL = "superpixel_seed/cityscapes/seeds_{}/train/label/{}.pkl"


class MsegRegionActiveSet:
    def __init__(self, cfg, trg_pool_dataset, trg_label_dataset,
                 root: str = ""):
        self.cfg = cfg
        self.selection_iter = 0
        self.trg_pool_dataset = trg_pool_dataset
        self.trg_label_dataset = trg_label_dataset
        self.root = root or getattr(trg_pool_dataset, "root", "")
        # path templates are the reference's hardcoded cityscapes tree
        # (mseg_region_active_dataset.py:10-12); overridable for other roots
        self.img_tpl = IMG_TPL
        self.lbl_tpl = LBL_TPL
        self.spx_tpl = SPX_TPL

    def _paths(self, nseg: int, file_id: str) -> Tuple[str, str, str]:
        city = file_id.split("_")[0]
        return (os.path.join(self.root, self.img_tpl.format(city, file_id)),
                os.path.join(self.root, self.lbl_tpl.format(nseg, file_id)),
                os.path.join(self.root, self.spx_tpl.format(nseg, file_id)))

    def expand_training_set(self, sample_region: Sequence[Tuple[float, str, int]],
                            selection_count: int, selection_method: str):
        """sample_region rows: (score, 'nseg/file_id', spx_id)."""
        pool, label = self.trg_pool_dataset, self.trg_label_dataset
        selected = 0
        chosen = []
        for x in sample_region:
            _, key, spx_id = x
            spx_id = int(spx_id)
            nseg_s, file_id = key.split("/")
            nseg = int(nseg_s)
            img_p, lbl_p, spx_p = self._paths(nseg, file_id)

            img_list = [i[0] for i in label.im_idx]
            if img_p not in img_list:
                label.im_idx.append([img_p, {str(nseg): [lbl_p, spx_p]}])
            else:
                entry = label.im_idx[img_list.index(img_p)][1]
                entry.setdefault(str(nseg), [lbl_p, spx_p])
            label.suppix.setdefault(spx_p, []).append(spx_id)

            pool.suppix[spx_p].remove(spx_id)
            if not pool.suppix[spx_p]:
                pool.suppix.pop(spx_p)

            chosen.append(x)
            selected += 1
            if selected > selection_count:
                break
        self._save_selection(chosen, selection_method)
        return selected

    def _save_selection(self, chosen, selection_method):
        os.makedirs(self.cfg.model_save_dir, exist_ok=True)
        path = os.path.join(
            self.cfg.model_save_dir,
            f"{selection_method}_selection_{self.selection_iter:02d}.json")
        with open(path, "w") as f:
            json.dump([(float(s), k, int(i)) for s, k, i in chosen], f)

    def dump_datalist(self, path=None):
        os.makedirs(self.cfg.model_save_dir, exist_ok=True)
        if path is None:
            path = os.path.join(self.cfg.model_save_dir,
                                f"datalist_{self.selection_iter:02d}.json")
        with open(path, "w") as f:
            json.dump({
                "trg_label_im_idx": self.trg_label_dataset.im_idx,
                "trg_pool_suppix": self.trg_pool_dataset.suppix,
                "trg_label_suppix": self.trg_label_dataset.suppix,
            }, f)

    def load_datalist(self, path=None):
        if path is None:
            path = os.path.join(self.cfg.model_save_dir,
                                f"datalist_{self.selection_iter:02d}.json")
        with open(path) as f:
            data = json.load(f)
        self.trg_label_dataset.im_idx = data["trg_label_im_idx"]
        self.trg_pool_dataset.suppix = data["trg_pool_suppix"]
        self.trg_label_dataset.suppix = data["trg_label_suppix"]

    def get_trainset(self):
        return self.trg_label_dataset
