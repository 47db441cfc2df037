#!/bin/bash
# Cityscapes paper recipe on the PyTorch/CUDA port: the flags of
# scripts/open_source/train_city_mul_res50.sh, driven through
# mulactseg_tpu_torch's CLIs on one CUDA card (same argparse names; `-p` =
# model save dir). --steps-per-dispatch is dropped (one optimizer step a
# call; it has no counterpart), --dtype bfloat16 kept (bf16 autocast,
# float32 parameters).
#
# Expects under $DATA_ROOT: leftImg8bit/, gtFine/, the superpixel maps,
# the datalists and region dict under dataloader/init_data/cityscapes
# (python -m mulactseg_tpu_torch.tools.gen_datalists) and the multi-hot
# tensors (python -m mulactseg_tpu_torch.tools.label_assignment).
set -eu
DATA_ROOT=${DATA_ROOT:-data/cityscapes}

### =======
### Stage 1
### =======
python -m mulactseg_tpu_torch.cli.train_al -p checkpoint/city_mul_res50 \
--data_root "$DATA_ROOT" \
--model deeplabv3pluswn_resnet50deepstem \
--init_checkpoint checkpoint/city_res50deepstem_imagenet_pretrained.tar \
--method active_joint_multi_predignore_lossdecomp \
--active_method my_bvsb_predclsbal_pwr_banignore \
--cls_weight_coeff 6.0 \
--or_labeling \
--fair_counting \
--loss_type joint_multi_loss \
--nseg 2048 \
--scheduler poly \
--train_lr 0.00002 \
--start_over \
--num_workers 12 \
--finetune_itrs 80000 \
--val_period 5000 \
--val_start 0 \
--separable_conv \
--max_iterations 5 \
--train_transform rescale_769_multi_notrg \
--loader region_cityscapes_or_tensor \
--active_selection_size 100000 \
--multi_ce_temp 0.1 \
--group_ce_temp 0.1 \
--ce_temp 0.1 \
--coeff 16.0 \
--coeff_mc 8.0 \
--coeff_gm 1.0 \
--trim_kernel_size 5 \
--trim_multihot_boundary \
--init_iteration 1 \
--dtype bfloat16

### =======
### Stage 2  (per round: pseudo-label generation, then CE retrain)
### =======
checkpoint_path=checkpoint/city_mul_res50
for round in 1 2 3 4 5; do
python -m mulactseg_tpu_torch.cli.eval_al -p "$checkpoint_path" \
--data_root "$DATA_ROOT" \
--stage2 \
--datalist_path "$checkpoint_path"/datalist_0"$round".json \
--init_checkpoint "$checkpoint_path"/checkpoint0"$round" \
--resume_checkpoint "$checkpoint_path"/checkpoint0"$round" \
--init_iteration "$round" \
--method eval_save_cosplbl_prop_includeonehot \
--or_labeling \
--train_transform eval_spx \
--loader eval_region_cityscapes_all \
--trim_multihot_boundary \
--trim_kernel_size 5 \
--nseg 2048 \
--model deeplabv3pluswn_resnet50deepstem \
--separable_conv \
--val_batch_size 1 \
--num_workers 8 \
--dontlog

python -m mulactseg_tpu_torch.cli.train_stage2 -p "$checkpoint_path" \
--data_root "$DATA_ROOT" \
--stage2 \
--init_iteration "$round" \
--datalist_path "$checkpoint_path"/datalist_0"$round".json \
--resume_checkpoint "$checkpoint_path"/checkpoint0"$round" \
--init_checkpoint checkpoint/city_res50deepstem_imagenet_pretrained.tar \
--finetune_itrs 80000 \
--val_period 5000 \
--val_start 0 \
--active_selection_size 50000 \
--train_transform rescale_769_nospx \
--model deeplabv3pluswn_resnet50deepstem \
--separable_conv \
--optimizer adamw \
--train_lr 0.00004 \
--ce_temp 0.1 \
--cls_lr_scale 10.0 \
--scheduler poly \
--train_batch_size 4 \
--num_workers 10 \
--val_batch_size 4 \
--nseg 2048 \
--dominant_labeling \
--method active_predignore \
--loader region_cityscapes_plbl \
--plbl_type cosprop_includeonehot \
--dtype bfloat16
done
