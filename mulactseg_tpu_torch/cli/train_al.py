"""Stage-1 active-learning round loop CLI, the port of
mulactseg_tpu/cli/train_al.py:

    python -m mulactseg_tpu_torch.cli.train_al --dataset cityscapes \\
        --method active_joint_multi_predignore_lossdecomp \\
        --active_method my_bvsb_predclsbal_pwr_banignore ...

Resume: --init_iteration k with --datalist_path restores the selection
state; --resume_checkpoint warm-starts the model; --init_checkpoint is the
per-round (ImageNet) init. --debug_nans turns on autograd's anomaly
detection. Runs on the card; main(argv, device="cpu") runs on the CPU.
On several cards, one rank each (data parallelism at the same global
batch, parallel/mesh.py):

    torchrun --nproc_per_node N -m mulactseg_tpu_torch.cli.train_al ...

with --train_batch_size a multiple of N; rank 0 writes the logs, metrics,
checkpoints and JSON files. The same holds for train_stage2 and eval_al.
"""

from __future__ import annotations

import torch

from mulactseg_tpu_torch.cli.common import build_active_datasets, setup_run
from mulactseg_tpu_torch.config import parse_config
from mulactseg_tpu_torch.engine.rounds import run_al_rounds
from mulactseg_tpu_torch.parallel import mesh


def main(argv=None, device="cuda"):
    mesh.init_from_env(device)
    cfg = parse_config(argv)
    if cfg.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    logger, sink = setup_run(cfg)
    logger.info("config: %s", cfg)
    active_set, val = build_active_datasets(cfg)
    if cfg.datalist_path:
        active_set.selection_iter = cfg.init_iteration - 1
        active_set.load_datalist(cfg.datalist_path)

    def metrics_cb(step, aux):
        sink.log(aux, step=step)

    results = run_al_rounds(
        cfg, active_set, val_dataset=val, eval_dataset=val,
        init_checkpoint=cfg.init_checkpoint or None,
        metrics_cb=metrics_cb, device=device)
    for rnd, miou in results.items():
        logger.info("round %d eval miou: %.2f", rnd, miou)
        sink.log({"eval_miou": miou, "round": rnd})
    return results


if __name__ == "__main__":
    main()
