"""Active-set bookkeeping, the port's copy of
mulactseg_tpu/active/active_set.py: which superpixels of which images are
labelled.

A pool dataset and a labelled dataset share im_idx (path triples) and
suppix (spx path -> selected ids); `expand_training_set` walks a
score-sorted region list moving ids pool -> labelled until the budget is
passed, where `fair_counting` (with or_labeling) charges the number of
classes in the region's multi-hot annotation (clicks) instead of 1. The
selection and the datalist persist as JSON, byte for byte the JAX
package's files. Under data parallelism every rank holds the same sets
and rank 0 alone writes the files.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

from mulactseg_tpu_torch.parallel import mesh


class RegionActiveSet:
    def __init__(self, cfg, pool_dataset, label_dataset):
        self.cfg = cfg
        self.selection_iter = 0
        self.trg_pool_dataset = pool_dataset
        self.trg_label_dataset = label_dataset

    # -- selection ------------------------------------------------------------
    def expand_training_set(self, sample_region: Sequence[Tuple[float, str, int]],
                            selection_count: int, selection_method: str):
        """sample_region: sorted desc list of (score, 'img,lbl,spx', spx_id).
        Returns (regions selected, clicks charged)."""
        cfg = self.cfg
        pool, label = self.trg_pool_dataset, self.trg_label_dataset
        selected_count = 0
        selected_sup_count = 0
        chosen = []
        for x in sample_region:
            _, scan_file_path, suppix_id = x
            suppix_id = int(suppix_id)
            paths = scan_file_path.split(",")
            spx_path = paths[2]

            if paths not in label.im_idx:
                label.im_idx.append(paths)
                label.suppix[spx_path] = [suppix_id]
            else:
                label.suppix[spx_path].append(suppix_id)

            pool.suppix[spx_path].remove(suppix_id)
            if len(pool.suppix[spx_path]) == 0:
                pool.suppix.pop(spx_path)
                pool.im_idx.remove(paths)

            if hasattr(pool, "isselected"):
                fid = spx_path.split("/")[-1].split(".")[0].replace("spx", "lbl")
                idx = label.id_to_index.get(
                    paths[1].split("/")[-1].split(".")[0],
                    label.id_to_index.get(fid))
                if idx is not None:
                    pool.isselected[idx, suppix_id] = 1

            chosen.append(x)
            if cfg.fair_counting and cfg.or_labeling:
                lbl_id = paths[1].split("/")[-1].split(".")[0]
                idx = label.id_to_index[lbl_id]
                selected_count += int(label.multi_hot_cls[idx, suppix_id].sum())
            else:
                selected_count += 1
            selected_sup_count += 1

            if selected_count > selection_count:
                self._save_selection(chosen, selection_method)
                break
        return selected_sup_count, selected_count

    def _save_selection(self, chosen, selection_method):
        if not mesh.is_main():  # every rank selected the same regions
            return
        os.makedirs(self.cfg.model_save_dir, exist_ok=True)
        fname = f"{selection_method}_selection_{self.selection_iter:02d}.json"
        path = os.path.join(self.cfg.model_save_dir, fname)
        with open(path, "w") as f:
            json.dump([(float(s), p, int(i)) for s, p, i in chosen], f)

    # -- persistence -----------------------------------------------------------
    def dump_datalist(self, path: Optional[str] = None):
        if not mesh.is_main():
            return
        os.makedirs(self.cfg.model_save_dir, exist_ok=True)
        if path is None:
            path = os.path.join(self.cfg.model_save_dir,
                                f"datalist_{self.selection_iter:02d}.json")
        store = {
            "trg_label_im_idx": self.trg_label_dataset.im_idx,
            "trg_pool_im_idx": self.trg_pool_dataset.im_idx,
            "trg_label_suppix": self.trg_label_dataset.suppix,
            "trg_pool_suppix": self.trg_pool_dataset.suppix,
        }
        with open(path, "w") as f:
            json.dump(store, f)

    def load_datalist(self, path: Optional[str] = None):
        if path is None:
            path = os.path.join(self.cfg.model_save_dir,
                                f"datalist_{self.selection_iter:02d}.json")
        with open(path) as f:
            data = json.load(f)
        self.trg_label_dataset.im_idx = [list(x) for x in data["trg_label_im_idx"]]
        self.trg_pool_dataset.im_idx = [list(x) for x in data["trg_pool_im_idx"]]
        self.trg_label_dataset.suppix = {
            k: list(v) for k, v in data["trg_label_suppix"].items()}
        self.trg_pool_dataset.suppix = {
            k: list(v) for k, v in data["trg_pool_suppix"].items()}

    def get_trainset(self):
        return self.trg_label_dataset
