"""Region selectors: the port of mulactseg_tpu/acquisition/selectors.py.

Each selector scores every unlabelled superpixel, builds the
(score, 'img,lbl,spx', spx_id) list, sorts it descending as tuples (ties
broken by path, then id) and expands the active set. The scoring runs
where the trainer's logits are (the card by default); the per-batch rows
stay there until the sweep ends, then come to the host once.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np
import torch

from mulactseg_tpu_torch.acquisition import scoring
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.parallel import mesh


class RegionSelector:
    """Base: select_next_batch -> calculate_scores -> expand_training_set."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.num_superpixels = cfg.nseg
        self.num_class = cfg.num_classes
        self.active_method = type(self).__module__.split(".")[-1]

    # -- shared helpers --------------------------------------------------------
    def _pool_loader(self, pool_set):
        return DataProvider(pool_set, batch_size=self.cfg.val_batch_size,
                            shuffle=False, drop_last=False, infinite=False,
                            num_workers=self.cfg.val_num_workers)

    def _sweep(self, trainer, pool_set):
        """(logits on the trainer's device, spx there, fnames) per pool
        batch, in loader order."""
        loader = self._pool_loader(pool_set)
        try:
            for batch in loader:
                logits = trainer.predict_logits(batch["images"])
                spx = torch.as_tensor(batch["spx"]).to(logits.device)
                yield logits, spx, batch["fnames"]
        finally:
            loader.close()

    def gen_score_list_from_tensor(self, pool_set, scores_tensor: np.ndarray,
                                   keys: List) -> List[Tuple[float, str, int]]:
        """Only superpixels still in the pool get rows."""
        scores = []
        sp_dict = pool_set.suppix
        for kdx, key in enumerate(keys):
            path = ",".join(key)
            spxids = sp_dict.get(key[2], [])
            row = scores_tensor[kdx]
            scores.extend([(float(row[i]), path, int(i)) for i in spxids])
        return scores

    def calculate_scores(self, trainer, pool_set):
        raise NotImplementedError

    def select_next_batch(self, trainer, active_set, selection_count):
        scores = self.calculate_scores(trainer, active_set.trg_pool_dataset)
        if self.cfg.save_scores and mesh.is_main():
            d = os.path.join(self.cfg.model_save_dir, "AL_record")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(
                    d, f"region_val_{active_set.selection_iter}.json"), "w") as f:
                json.dump(scores, f)
        selected = sorted(scores, reverse=True)
        return active_set.expand_training_set(selected, selection_count,
                                              self.active_method)


class RandomSelector(RegionSelector):
    """my_random: a uniform random score per pool superpixel."""

    def __init__(self, cfg, seed=0):
        super().__init__(cfg)
        self.active_method = "my_random"
        self.rng = np.random.RandomState(seed)

    def calculate_scores(self, trainer, pool_set):
        scores = []
        for key in pool_set.im_idx:
            path = ",".join(key)
            for i in pool_set.suppix.get(key[2], []):
                scores.append((float(self.rng.rand()), path, int(i)))
        return scores


class DummySelector(RegionSelector):
    """dummy: no selection (the resume path)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.active_method = "dummy"

    def select_next_batch(self, trainer, active_set, selection_count):
        return 0, 0


class BvsbSelector(RegionSelector):
    """my_bvsb / my_bvsb_banignore: region-mean BvSB, min-max normalised;
    optionally the ignore-dominant ban."""

    def __init__(self, cfg, ban_ignore=False):
        super().__init__(cfg)
        self.ban_ignore = ban_ignore
        self.active_method = "my_bvsb_banignore" if ban_ignore else "my_bvsb"

    def calculate_scores(self, trainer, pool_set):
        cfg = self.cfg
        drop_last = "predignore" in cfg.method
        rows, votes_rows, keys = [], [], []
        for logits, spx, fnames in self._sweep(trainer, pool_set):
            rows.append(scoring.region_bvsb_scores(
                logits, spx, nseg=self.num_superpixels, temp=cfg.ce_temp,
                drop_last=drop_last))
            keys.extend(fnames)
            if self.ban_ignore:
                _, votes = scoring.region_weighted_bvsb_and_votes(
                    logits, spx, torch.ones(logits.shape[1]),
                    nseg=self.num_superpixels, temp=cfg.ce_temp)
                votes_rows.append(votes)
        scores = scoring.minmax_normalize(torch.cat(rows))
        if self.ban_ignore:
            scores = scoring.ban_ignore_dominant(
                scores, torch.cat(votes_rows))
        return self.gen_score_list_from_tensor(pool_set,
                                               scores.cpu().numpy(), keys)


class BvsbPredClsbalPwrSelector(RegionSelector):
    """The paper's selector: pass 1 estimates the predicted label
    distribution (the mean of the per-batch mean softmax, so a short last
    batch weighs as much as a full one); class weights (k p + 1)^-2; pass
    2 scores regions with pixel-wise weighted BvSB and bans
    ignore-dominant regions."""

    def __init__(self, cfg, ban_ignore=True):
        super().__init__(cfg)
        self.ban_ignore = ban_ignore
        self.active_method = ("my_bvsb_predclsbal_pwr_banignore"
                              if ban_ignore else "my_bvsb_predclsbal_pwr")

    def calculate_scores(self, trainer, pool_set):
        cfg = self.cfg
        cum = None
        nb = 0
        for logits, _, _ in self._sweep(trainer, pool_set):
            m = scoring.mean_softmax(logits, cfg.ce_temp)
            cum = m if cum is None else cum + m
            nb += 1
        cls_weight = scoring.cls_weight_pwr(cum / nb, cfg.cls_weight_coeff)

        rows, votes_rows, keys = [], [], []
        for logits, spx, fnames in self._sweep(trainer, pool_set):
            r, v = scoring.region_weighted_bvsb_and_votes(
                logits, spx, cls_weight, nseg=self.num_superpixels,
                temp=cfg.ce_temp)
            rows.append(r)
            votes_rows.append(v)
            keys.extend(fnames)
        scores = torch.cat(rows)
        if self.ban_ignore:
            scores = scoring.ban_ignore_dominant(
                scores, torch.cat(votes_rows))
        return self.gen_score_list_from_tensor(pool_set,
                                               scores.cpu().numpy(), keys)


class BvsbClsbalV2Selector(RegionSelector):
    """my_bvsb_clsbal_v2: BvSB region means, min-max normalised, then
    weighted by exp(-estimated dominant-label distribution), the
    distribution coming from each region's top-1-vote class. The weighting
    runs on the host in float64, as the JAX package's; the ban casts to
    float32."""

    def __init__(self, cfg, ban_ignore=False):
        super().__init__(cfg)
        self.ban_ignore = ban_ignore
        self.active_method = ("my_bvsb_clsbal_v2_banignore" if ban_ignore
                              else "my_bvsb_clsbal_v2")

    def calculate_scores(self, trainer, pool_set):
        cfg = self.cfg
        rows, votes_rows, keys = [], [], []
        for logits, spx, fnames in self._sweep(trainer, pool_set):
            r, v = scoring.region_weighted_bvsb_and_votes(
                logits, spx, torch.ones(logits.shape[1]),
                nseg=self.num_superpixels, temp=cfg.ce_temp)
            rows.append(r)
            votes_rows.append(v)
            keys.extend(fnames)
        scores = scoring.minmax_normalize(torch.cat(rows)).cpu().numpy()
        votes_t = torch.cat(votes_rows).cpu()
        votes = votes_t.numpy()
        flat_votes = votes.reshape(-1, votes.shape[-1])
        dominant = flat_votes.argmax(axis=1)
        dist = np.bincount(dominant, minlength=votes.shape[-1]).astype(
            np.float64)
        dist = dist / max(dist.sum(), 1)
        cls_weight = np.exp(-dist)
        weighted = (cls_weight[dominant] *
                    scores.reshape(-1)).reshape(scores.shape)
        if self.ban_ignore:
            weighted = scoring.ban_ignore_dominant(
                torch.from_numpy(weighted.astype(np.float32)),
                votes_t).numpy()
        return self.gen_score_list_from_tensor(pool_set, weighted, keys)


SELECTORS = {
    "my_random": lambda cfg: RandomSelector(cfg, seed=cfg.seed),
    "dummy": DummySelector,
    "my_bvsb": lambda cfg: BvsbSelector(cfg, ban_ignore=False),
    "my_bvsb_banignore": lambda cfg: BvsbSelector(cfg, ban_ignore=True),
    "my_bvsb_predclsbal_pwr": lambda cfg: BvsbPredClsbalPwrSelector(
        cfg, ban_ignore=False),
    "my_bvsb_predclsbal_pwr_banignore": lambda cfg:
        BvsbPredClsbalPwrSelector(cfg, ban_ignore=True),
    "my_bvsb_clsbal_v2": lambda cfg: BvsbClsbalV2Selector(
        cfg, ban_ignore=False),
    "my_bvsb_clsbal_v2_banignore": lambda cfg: BvsbClsbalV2Selector(
        cfg, ban_ignore=True),
}


def get_selector(name: str, cfg) -> RegionSelector:
    if name not in SELECTORS:
        raise KeyError(f"unknown selector {name!r}; have {sorted(SELECTORS)}")
    return SELECTORS[name](cfg)
