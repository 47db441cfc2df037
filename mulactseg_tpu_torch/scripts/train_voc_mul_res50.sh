#!/bin/bash
# PASCAL VOC paper recipe on the PyTorch/CUDA port: the flags of
# scripts/open_source/train_voc_mul_res50.sh, driven through
# mulactseg_tpu_torch's CLIs on one CUDA card (same argparse names; `-p` =
# model save dir; `--dataset voc` with the VOC defaults passed explicitly:
# 21 classes, nseg 150, batch 12, crop 513). --steps-per-dispatch is dropped
# (one optimizer step a call; it has no counterpart), --dtype bfloat16 kept
# (bf16 autocast, float32 parameters). Two flags differ from the JAX
# script where the JAX package itself fails on it (ROADMAP.md, "Open
# question for the reference's owners"); each carries a comment.
#
# Expects under $DATA_ROOT: VOC2012/JPEGImages/*.jpg,
# VOC2012/SegmentationClass/*.png (palette label maps), the superpixel
# maps under superpixels/pascal_voc_seg/seeds_150/train/label/, the
# datalists and region dict under dataloader/init_data/voc
# (python -m mulactseg_tpu_torch.tools.gen_datalists) and the multi-hot
# tensors (python -m mulactseg_tpu_torch.tools.label_assignment
# --label-encoding identity --num_classes 21);
# python -m mulactseg_tpu_torch.tools.voc_tree writes such a tree.
set -eu
DATA_ROOT=${DATA_ROOT:-data/VOCdevkit/VOC2012}

### =======
### Stage 1
### =======
python -m mulactseg_tpu_torch.cli.train_al -p checkpoint/voc_mul_res50 \
--dataset voc \
--data_root "$DATA_ROOT" \
--num_classes 21 \
--crop_size 513 513 \
--train_batch_size 12 \
--model deeplabv3pluswn_resnet50deepstem \
--init_checkpoint checkpoint/res50wndeepstem_imagenet_pretrained.tar \
--method active_joint_multi_lossdecomp \
--active_method my_bvsb_predclsbal_pwr \
--cls_weight_coeff 12.0 \
--or_labeling \
--fair_counting \
--loss_type joint_multi_loss \
--nseg 150 \
--scheduler poly \
--separable_conv \
--train_lr 0.00001 \
--start_over \
--num_workers 12 \
--finetune_itrs 30000 \
--val_period 2500 \
--val_start 0 \
--max_iterations 5 \
--train_transform rescale_513_multi_notrg \
--loader region_voc_or_tensor \
--active_selection_size 10000 \
--multi_ce_temp 0.1 \
--group_ce_temp 0.1 \
--ce_temp 0.1 \
--coeff 16.0 \
--coeff_mc 8.0 \
--coeff_gm 1.0 \
--trim_kernel_size 5 \
--trim_multihot_boundary \
--init_iteration 1 \
--val_batch_size 1 `# added: batches of mixed-size VOC images fail to collate in the JAX package (ROADMAP.md, reference question 3)` \
--dtype bfloat16

### =======
### Stage 2  (per round: 10-view TTA pseudo-labels, then CE retrain)
### =======
checkpoint_path=checkpoint/voc_mul_res50
for round in 1 2 3 4 5; do
python -m mulactseg_tpu_torch.cli.eval_al -p "$checkpoint_path" \
--dataset voc \
--data_root "$DATA_ROOT" \
--num_classes 21 \
--crop_size 513 513 \
--stage2 \
--datalist_path "$checkpoint_path"/datalist_0"$round".json \
--init_checkpoint "$checkpoint_path"/checkpoint0"$round" \
--resume_checkpoint "$checkpoint_path"/checkpoint0"$round" \
--init_iteration "$round" \
--method eval_save_cosplbl_prop_includeonehot_voc_ms \
--or_labeling \
--train_transform eval_spx_identity `# the JAX script's is eval_spx_identity_ms, which the JAX package does not know (ROADMAP.md, reference question 2)` \
--loader eval_region_voc_all_ms \
--trim_multihot_boundary \
--trim_kernel_size 5 \
--nseg 150 \
--model deeplabv3pluswn_resnet50deepstem \
--separable_conv \
--val_batch_size 1 \
--num_workers 8 \
--dontlog

python -m mulactseg_tpu_torch.cli.train_stage2 -p "$checkpoint_path" \
--dataset voc \
--data_root "$DATA_ROOT" \
--num_classes 21 \
--crop_size 513 513 \
--stage2 \
--init_iteration "$round" \
--datalist_path "$checkpoint_path"/datalist_0"$round".json \
--resume_checkpoint "$checkpoint_path"/checkpoint0"$round" \
--init_checkpoint checkpoint/res50wndeepstem_imagenet_pretrained.tar \
--finetune_itrs 30000 \
--val_period 2500 \
--val_start 0 \
--active_selection_size 10000 \
--loader region_voc_plbl \
--train_transform rescale_513_notrg \
--model deeplabv3pluswn_resnet50deepstem \
--separable_conv \
--optimizer adamw \
--train_lr 0.00001 \
--ce_temp 0.1 \
--cls_lr_scale 10.0 \
--scheduler poly \
--train_batch_size 4 \
--num_workers 10 \
--val_batch_size 1 `# the JAX script's is 4: batches of mixed-size VOC images fail to collate in the JAX package (ROADMAP.md, reference question 3)` \
--nseg 150 \
--dominant_labeling \
--method active \
--plbl_type cosprop_includeonehot \
--dtype bfloat16
done
