"""Stage-2 retraining CLI, the port of mulactseg_tpu/cli/train_stage2.py:
plain CE on the saved pseudo-label maps, a fresh model a round (C+1
classes under active_predignore, the reference's
trainer/active_predignore.py:12-95; VOC's 21 under active), through
rescale_769_nospx on Cityscapes and rescale_513_notrg elsewhere.

    python -m mulactseg_tpu_torch.cli.train_stage2 --stage2 \\
        --method active_predignore --loader region_cityscapes_plbl \\
        --datalist_path datalist_01.json --resume_checkpoint CKPT \\
        --plbl_type cosprop_includeonehot ...

The pseudo-labels are read from the directory eval_al wrote them to,
derived from --resume_checkpoint. Runs on the card; main(argv,
device="cpu") runs on the CPU.
"""

from __future__ import annotations

import os

from mulactseg_tpu_torch.cli.common import build_active_datasets, setup_run
from mulactseg_tpu_torch.config import parse_config
from mulactseg_tpu_torch.data.datasets import RegionDatasetPlbl
from mulactseg_tpu_torch.data.transforms import get_train_transform
from mulactseg_tpu_torch.engine.rounds import ALTrainer
from mulactseg_tpu_torch.plbl.generator import plbl_save_dir


class _Stage2Set:
    """The active-set surface ALTrainer.train reads."""

    def __init__(self, dataset):
        self.dataset = dataset

    def get_trainset(self):
        return self.dataset


def main(argv=None, device="cuda"):
    cfg = parse_config(argv)
    logger, sink = setup_run(cfg)
    active_set, val = build_active_datasets(cfg)
    if cfg.datalist_path:
        active_set.selection_iter = cfg.init_iteration
        active_set.load_datalist(cfg.datalist_path)

    round_id = f"{cfg.init_iteration:02d}"
    plbl_dir = plbl_save_dir(
        cfg.resume_checkpoint or os.path.join(cfg.model_save_dir, "x"),
        cfg.plbl_type, round_id)
    tf_name = ("rescale_769_nospx" if cfg.dataset == "cityscapes"
               else "rescale_513_notrg")
    stage2_ds = RegionDatasetPlbl(
        cfg, active_set.trg_label_dataset.im_idx, plbl_dir,
        transform=get_train_transform(tf_name, cfg, seed=cfg.seed))

    trainer = ALTrainer(cfg, cfg.init_iteration, val_dataset=val,
                        eval_dataset=val, device=device)
    if cfg.init_checkpoint:
        trainer.load(cfg.init_checkpoint)
    trainer.checkpoint_file = os.path.join(
        cfg.model_save_dir, f"stage2_checkpoint{round_id}")
    trainer.train(_Stage2Set(stage2_ds),
                  metrics_cb=lambda step, aux: sink.log(aux, step=step))
    if trainer.best_iou == 0.0:
        trainer.save()
    if val is not None:
        miou, table = trainer.eval()
        sink.log({"stage2_eval_miou": miou, "round": cfg.init_iteration})
        logger.info("stage2 round %s eval miou: %.2f", round_id, miou)
        return miou


if __name__ == "__main__":
    main()
