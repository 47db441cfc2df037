#!/bin/bash
# Plain mIoU evaluation of the five per-round stage-2 checkpoints on the
# PyTorch/CUDA port: the flags of scripts/open_source/eval_city_mul_res50.sh
# through mulactseg_tpu_torch's eval_al.
set -eu
DATA_ROOT=${DATA_ROOT:-data/cityscapes}

for round in 1 2 3 4 5; do
python -m mulactseg_tpu_torch.cli.eval_al -p checkpoint/eval \
--data_root "$DATA_ROOT" \
--init_checkpoint checkpoint/stage2_checkpoint0"$round" \
--model deeplabv3pluswn_resnet50deepstem \
--separable_conv \
--stage2 \
--method eval_naive \
--loader region_cityscapes_all \
--train_transform eval_spx \
--nseg 2048 \
--val_batch_size 1 \
--dontlog
done
