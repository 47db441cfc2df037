"""Checkpoint evaluation, analysis and pseudo-label generation CLI, the port
of mulactseg_tpu/cli/eval_al.py:

    # plain evaluation (eval_naive; --sliding_eval for the crop grid)
    python -m mulactseg_tpu_torch.cli.eval_al --init_checkpoint CKPT ...

    # pseudo-labels of the labelled set (the recipe's
    # eval_save_cosplbl_prop_includeonehot; with --dataset voc or a method
    # ending in _ms, the VOC recipe's, through the 10-view test-time
    # augmentation of engine/tta.py; every eval_save_* method of
    # plbl/generator.METHOD_TO_PLBL, or --plbl_type)
    python -m mulactseg_tpu_torch.cli.eval_al --resume_checkpoint CKPT \\
        --method eval_save_cosplbl_prop_includeonehot \\
        --datalist_path datalist_01.json ...

    # an analysis eval of engine/analysis.ANALYSIS_METHODS, or the top-1
    # selection probe (active_joint_multi_analysis)
    python -m mulactseg_tpu_torch.cli.eval_al --init_checkpoint CKPT \\
        --method eval_cosplbl_within_multihot \\
        --datalist_path datalist_02.json ...

Under torchrun the plain eval, the analysis evals and the probe split
the images over the ranks (whole images, each rank's overlays written by
it; the matrices and counts summed over the ranks), and rank 0 alone
pseudo-labels while the others wait.

The PNGs go to plbl_gen_<type>/round_<NN> beside --resume_checkpoint,
where train_stage2 reads them; an analysis eval's overlays to
vis_<method>_<NN> in the run directory. Runs on the card;
main(argv, device="cpu") runs on the CPU.

The JAX package's loaders hand EvalRegionDatasetAll's multi-hot 'target'
to every method, where eval_all_dominant and the cosprop_onehot types
read a per-pixel dominant map: the JAX CLI fails on them, and this one
raises, saying so (ROADMAP.md, open question 7). Their evaluator
and generator run on batches that carry the map.
"""

from __future__ import annotations

import json
import os

from mulactseg_tpu_torch.cli.common import build_active_datasets, setup_run
from mulactseg_tpu_torch.config import parse_config
from mulactseg_tpu_torch.data.datasets import EvalRegionDatasetAll
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.engine.analysis import (
    ANALYSIS_METHODS,
    AnalysisEvaluator,
    SelectionAccuracyEvaluator,
)
from mulactseg_tpu_torch.engine.rounds import ALTrainer
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.plbl.generator import (
    METHOD_TO_PLBL,
    PseudoLabelGenerator,
    plbl_save_dir,
)


def _needs_dominant_map(name):
    raise ValueError(
        f"{name!r} reads 'target' as a per-pixel dominant-label map, and no "
        "loader of the eval CLI gives one (ROADMAP.md, open question 7); "
        "run its evaluator or generator on batches that carry the map")


def _labelled_set(cfg, active_set):
    if cfg.datalist_path:
        active_set.selection_iter = cfg.init_iteration
        active_set.load_datalist(cfg.datalist_path)
    return active_set.trg_label_dataset


def _provider(ds, batch, cfg, split=None):
    return DataProvider(ds, batch, shuffle=False, drop_last=False,
                        infinite=False, num_workers=cfg.val_num_workers,
                        split=split)


def main(argv=None, device="cuda"):
    mesh.init_from_env(device)
    cfg = parse_config(argv)
    if not cfg.plbl_type and cfg.method in METHOD_TO_PLBL:
        # the reference's command lines name the plbl type by --method
        cfg.plbl_type = METHOD_TO_PLBL[cfg.method]
    logger, sink = setup_run(cfg)
    active_set, val = build_active_datasets(cfg)
    trainer = ALTrainer(cfg, cfg.init_iteration, val_dataset=val,
                        eval_dataset=val, device=device)
    # the reference evaluates --init_checkpoint; the resume checkpoint
    # (the same file in the recipe) anchors the plbl directory
    ckpt = cfg.init_checkpoint or cfg.resume_checkpoint
    if ckpt:
        trainer.load(ckpt)

    if cfg.method == "active_joint_multi_analysis":
        # top-1 selection accuracy over the labelled set
        # (trainer/active_joint_multi_analysis.py:27-102)
        label_ds = _labelled_set(cfg, active_set)
        label_ds.load_gt = True  # the probe reads the precise GT
        loader = _provider(label_ds, cfg.train_batch_size, cfg, "batches")
        try:
            res = SelectionAccuracyEvaluator(
                trainer.model, cfg, device=device).run(
                None, loader, selection_iter=cfg.init_iteration,
                logger=logger)
        finally:
            loader.close()
        sink.log({"top1_selection_acc": res["acc_total"],
                  "round": cfg.init_iteration})
        return res["acc_total"]

    if cfg.method in ANALYSIS_METHODS:
        opts = ANALYSIS_METHODS[cfg.method]
        if opts.get("pred") == "target":
            _needs_dominant_map(cfg.method)
        label_ds = _labelled_set(cfg, active_set)
        if opts.get("pred") == "argmax":
            # eval_naive_vis evaluates the val set (eval_naive_vis.py:25-29)
            if val is None:
                raise SystemExit("eval_naive_vis needs a validation datalist")
            eval_ds = val
        else:
            # the analyses drop single-candidate superpixels
            # (eval_region_cityscapes_all.py:18-24); withinmulti also
            # 255-masks the GT outside spmask
            eval_ds = EvalRegionDatasetAll(
                cfg, label_ds, label_ds.suppix, remove_dominant=True,
                mask_unselected="withinmulti" in cfg.loader, emit_u8=True)
        prev_suppix = None
        if opts.get("exclude_round"):
            # eval_selected_spx_plbl.py:40-44: without the round-1
            # selections
            r1 = os.path.join(os.path.dirname(cfg.datalist_path or
                                              cfg.model_save_dir),
                              "datalist_01.json")
            if os.path.exists(r1):
                with open(r1) as f:
                    prev_suppix = json.load(f)["trg_label_suppix"]
        save_dir = (os.path.join(cfg.model_save_dir,
                                 f"vis_{cfg.method}_{cfg.init_iteration:02d}")
                    if cfg.save_vis or opts.get("save_vis") else None)
        loader = _provider(eval_ds, 1, cfg, "batches")
        try:
            res = AnalysisEvaluator(trainer.model, cfg, cfg.method,
                                    device=device).run(
                None, loader, suppix=label_ds.suppix,
                prev_suppix=prev_suppix, save_dir=save_dir, logger=logger)
        finally:
            loader.close()
        sink.log({"analysis_miou": res["miou"], "round": cfg.init_iteration})
        return res["miou"]

    if cfg.plbl_type:
        if cfg.plbl_type.startswith("cosprop_onehot"):
            _needs_dominant_map(cfg.plbl_type)
        label_ds = _labelled_set(cfg, active_set)
        # eval_save_* keeps the single-candidate superpixels; uint8 images,
        # the generator normalises on the device
        eval_all = EvalRegionDatasetAll(
            cfg, label_ds, label_ds.suppix,
            mask_unselected="withinmulti" in cfg.loader, emit_u8=True)
        loader = _provider(eval_all, 1, cfg)
        gen = PseudoLabelGenerator(trainer.model, cfg,
                                   plbl_type=cfg.plbl_type,
                                   use_tta=cfg.dataset == "voc" or
                                   cfg.method.endswith("_ms"),
                                   device=device)
        round_id = f"{cfg.init_iteration:02d}"
        save_dir = plbl_save_dir(
            cfg.resume_checkpoint or os.path.join(cfg.model_save_dir, "x"),
            cfg.plbl_type, round_id)
        try:
            miou, iou_t, prec_t, rec_t = gen.generate(
                None, loader, save_dir=save_dir, suppix=label_ds.suppix)
        finally:
            loader.close()
        logger.info("[plbl round %s] IoU: %s", round_id, iou_t)
        logger.info("[plbl round %s] Precision: %s", round_id, prec_t)
        logger.info("[plbl round %s] Recall: %s", round_id, rec_t)
        sink.log({"plbl_miou": miou, "round": cfg.init_iteration})
        return miou

    if val is None:
        raise SystemExit("no validation datalist found for evaluation")
    miou, table = trainer.eval()
    sink.log({"eval_miou": miou})
    return miou


if __name__ == "__main__":
    main()
