"""Checkpoint evaluation and pseudo-label generation CLI, the port of
mulactseg_tpu/cli/eval_al.py:

    # plain evaluation (eval_naive)
    python -m mulactseg_tpu_torch.cli.eval_al --init_checkpoint CKPT ...

    # pseudo-labels of the labelled set (the recipe's
    # eval_save_cosplbl_prop_includeonehot)
    python -m mulactseg_tpu_torch.cli.eval_al --resume_checkpoint CKPT \\
        --method eval_save_cosplbl_prop_includeonehot \\
        --datalist_path datalist_01.json ...

The PNGs go to plbl_gen_<type>/round_<NN> beside --resume_checkpoint,
where train_stage2 reads them. The analysis evals raise (ROADMAP.md queue
A, item 15). Runs on the card; main(argv, device="cpu") runs on the CPU.
"""

from __future__ import annotations

import os

from mulactseg_tpu_torch.cli.common import build_active_datasets, setup_run
from mulactseg_tpu_torch.config import parse_config
from mulactseg_tpu_torch.data.datasets import EvalRegionDatasetAll
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.engine.rounds import ALTrainer
from mulactseg_tpu_torch.plbl.generator import (
    METHOD_TO_PLBL,
    PseudoLabelGenerator,
    plbl_save_dir,
)

# the JAX package's engine/analysis.py ANALYSIS_METHODS and the selection
# accuracy probe
ANALYSIS_METHODS = (
    "active_joint_multi_analysis", "eval_cosplbl_within_multihot",
    "eval_ensemble_plbl_within_multihot", "eval_maxcosplbl_within_multihot",
    "eval_cosplbl_filt_within_multihot", "eval_within_multihot",
    "eval_within_multihot_voc", "eval_all_cosplbl_prop", "eval_all_dominant",
    "eval_naive_vis", "eval_vistopone_within_multihot",
    "eval_selected_spx_plbl")


def main(argv=None, device="cuda"):
    cfg = parse_config(argv)
    if cfg.method in ANALYSIS_METHODS:
        raise NotImplementedError(
            f"the analysis eval {cfg.method!r} is not ported yet: ROADMAP.md "
            "queue A, item 15")
    logger, sink = setup_run(cfg)
    if not cfg.plbl_type and cfg.method in METHOD_TO_PLBL:
        # the reference's command lines name the plbl type by --method
        cfg.plbl_type = METHOD_TO_PLBL[cfg.method]
    active_set, val = build_active_datasets(cfg)
    trainer = ALTrainer(cfg, cfg.init_iteration, val_dataset=val,
                        eval_dataset=val, device=device)
    # the reference evaluates --init_checkpoint; the resume checkpoint
    # (the same file in the recipe) anchors the plbl directory
    ckpt = cfg.init_checkpoint or cfg.resume_checkpoint
    if ckpt:
        trainer.load(ckpt)

    if cfg.plbl_type:
        if cfg.datalist_path:
            active_set.selection_iter = cfg.init_iteration
            active_set.load_datalist(cfg.datalist_path)
        label_ds = active_set.trg_label_dataset
        # uint8 images; the generator normalises on the device
        eval_all = EvalRegionDatasetAll(
            cfg, label_ds, label_ds.suppix,
            mask_unselected="withinmulti" in cfg.loader, emit_u8=True)
        loader = DataProvider(eval_all, 1, shuffle=False, drop_last=False,
                              infinite=False, num_workers=cfg.val_num_workers)
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
