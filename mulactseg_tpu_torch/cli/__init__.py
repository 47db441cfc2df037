"""The port's command lines (mirrors mulactseg_tpu/cli): train_al,
eval_al and train_stage2, the three commands of the recipe
(mulactseg_tpu_torch/scripts/train_city_mul_res50.sh)."""
