"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the hand-written CUDA
   kernels of mulactseg_tpu_torch/csrc/ (one nvcc per source, in parallel)
   and prints the build time and each kernel's registers and spills.
2. Builds the Cityscapes stage-1 model at full width
   (deeplabv3pluswn_resnet50deepstem, separable convs, 20 outputs, output
   stride 16) and carries a seeded numpy init into it through
   models/convert.py; makes synthetic batches the way bench.py does
   (irregular superpixels, multi-hot 15%, selection 50%, uint8 images,
   batch 4, 768x768), at nseg 2048 and at nseg 4096.
3. Holds each kernel (K1-K4) against its plain PyTorch version on the card
   at those shapes (nseg 2048), on logits from a forward pass of the model,
   and times both with CUDA events (windows of 5 back-to-back calls, the
   kernels as CUDA graph replays, median of 20 windows); K4 is also timed
   beside the library's softmax backward. K1 must give the same bits on a
   second call, and K1 and K2 are also held and timed on their 4-byte
   path (the logits one float into a larger storage, so not 16-byte
   aligned). K3 is held as well on
   adversarial ids at full size (one id per run of 4 pixels, ids equal
   modulo its shared slot count, more segments in a span than slots).
   Before K4 runs, every live argmax pixel must lie in its own segment
   (K4's precondition).
4. The same for the kernels past the reference's K3 guard
   (num_segments + 1 > 9216, mulactseg_tpu/ops/segment.py:653-654): K6
   with the nseg-4096 batch (S = 16,384), also on its 4-byte path (the
   logits one float into a larger storage; bitwise the same), K5 on K6's
   planes under the retired ids (bitwise, timed: the K5 of the nseg-4096
   step), and K4 on the pre-reduced term's outputs (precondition first);
   then, on the logits as
   (2,359,296, 20) rows, K7 and K8 (the row-major group term, rows divided
   by T) and K9 and K10 (the row-major pixel loss). K7 is held against
   its plain version (absent sets exact, maxima within 1e-6, argmax rows
   at the plain maximum within 1e-6: the plain version sums the softmax
   with torch's sum, the kernel in class order), and bitwise against the
   segment max of the softmax summed in class order (class_order_softmax,
   a reference of this script); K10, whose exp2 and reciprocal differ
   from the plain version's exp and divisions, within 1e-6 of max |dl|.
   Both are also held and timed on their 4-byte
   instances (the rows one float into a larger storage), which must give
   the 16-byte instances' bits. K6 and K8 write
   bf16-rounded values: bf16-exact, within one bf16 ulp of the plain
   version's and equal for > 99.9% of them, and a choice that differs
   from the plain version's must reach the block max within 1e-6. Behind
   each, K5 on the card's planes is held bitwise against its plain
   version, the op's output must be exactly K5's winners mapped back to
   pixels, and against the all-plain chain its maxima lie within one bf16
   ulp and its argmax pixels are equal or near-ties.
5. Drives the main path: make_train_step at nseg 2048 for 3 warm-up and 20
   timed steps (4 windows of 5 steps, each timed to a synchronise at its
   end), with every launch counter set to 0 just before and read just
   after; K1-K4 must have launched exactly once per step (and each BN
   kernel once a BN and step), and the loss and its three parts must be
   finite.
5a. FastBatchNorm's training pass (bn_slice): at each BN shape of
   city_stage1 and voc_stage1 and at SegFormer-B5's channels-last one
   (BN_CELLS) in bf16, the six kernels of csrc/batch_norm.cu (BN1-BN6,
   one launch each) held against the float64 function and the plain
   version (y, the running statistics, dx, dw and db within
   BN_BF16_EXACT and BN_BF16_PLAIN of their operands' magnitude); then
   forward and backward through the kernels, the plain version and
   F.batch_norm (cuDNN, a yardstick the port never calls), each as CUDA
   graph replays; summed over a step's BNs, each kernel's ms
   (torch.profiler over replays) beside its bound and the whole pass's
   ms, bound, plain and cuDNN ms, and the largest errors: the bn line.
   Every launch check of a main path in this script counts the BN
   kernels too: each once a FastBatchNorm in each train-mode forward and
   backward (bn_launches), none in eval mode.
6. The same at nseg 4096 from the seeded weights again: 2 warm-up and 10
   timed steps; K1, K2, K6, K5 and K4 once per step, K3 never.
7. One autograd pass through each row-major op on those rows, counted:
   segment_softmax_max launches K7, with prereduce=True K8 and K5, and
   pixel_partial_ce K9 and K10, once each; each loss equals its plain
   versions' (rtol 1e-5).
8. Holds lossdecomp_fused on the card (the kernels) against the CPU (the
   plain versions) on small inputs, loss, its parts and the logits
   gradient: at 96x80, nseg 24 (K3), and at 192x192, nseg 4608 (S + 1 =
   9217, so K6 and K5; about 8 pixels per segment). Every gradient entry
   must lie within 1e-5 of the largest, except in a segment holding a K6
   value that rounds to bf16 the other way on the card.
8.1. The rest of the model zoo (zoo): each of ZOO_NAMES (the DeepLabV3
   and DeepLabV2 heads over ResNet-50/101 and MobileNetV2, and DeepLabV3+
   over MobileNetV2, separable) at full width, 20 outputs, OS16, from its
   own seeded weights carried by models/convert.py: its eval logits on
   the card against the CPU at 96x80 in float32 with TF32 off (max abs
   error within 1e-4 of the largest logit), then 1 + 5 stage-1 steps of
   the recipe's fused lossdecomp at batch 4, 768x768, nseg 2048, bf16,
   counted: K1-K4 once a step, finite losses. Per model: parameters,
   step ms, img/s, peak GiB.
8.2. The criteria beside the recipe's (criteria), on the recipe model at
   the same shape from the seeded weights each time, on batches that also
   carry what the last ten criteria read (more_regions): a finer map of
   SMALL_NSEG superpixels, each image's weak view uncut at 1024x2048 with
   its maps, and the mixed-scale levels MSEG_LEVELS. First K5 held
   bitwise against its plain version and timed at three instances
   (k5_instances): the group term's, one image's softmax planes at T =
   0.1 under the ids of its selected superpixels (about half); and the
   two only the async hierarchy criteria reach, the weak view's planes
   under its 2,048 superpixels' ids and under the fine map's 8,192. Then
   the online criteria's prototype candidates per image and how many the
   256-slot cap drops (prototype_counts). Then every criterion of
   CRITERIA_CASES and MORE_CRITERIA_CASES (the joint criterion for 3 + 20 steps, the others and
   the unfused lossdecomp, a batch without target bits, for 1 + 5; the
   online family with dorampup on for one), and the joint criterion once
   more with SGD and the constant schedule, each with every launch
   counter set to 0 just before and read just after: K5 once an image
   and step for a group term (twice for wgroup, the _domc pair and
   async_weight, once per level for mseg, never for multice_precise),
   K1-K4 never, finite losses. Then every criterion of CRITERIA_CASES on
   the card against the CPU at 96x80, nseg 24 (small_criteria_check), and the group term
   on N(0, 1) logits, which saturate the softmax, on the card and on the
   CPU against a float64 run (saturated_group_check).
8a. The active-learning main path, from a file of the seeded weights
   named like the recipe's ImageNet init (so the final classifier is
   stripped): run_al_rounds for 2 rounds on a SyntheticRegionDataset at
   768x768, nseg 2048, 19 classes (pool and label sets of AL_POOL images,
   val and eval sets of AL_VAL), my_random then
   my_bvsb_predclsbal_pwr_banignore with a budget of AL_BUDGET clicks,
   AL_ITRS stage-1 steps a round with the val_period gate firing twice
   (best-val checkpoints, the best one reloaded before eval); then the
   recipe's cosprop_includeonehot pseudo-labelling of the label set with
   round 2's best checkpoint (every PNG decoded and compared), and stage 2:
   AL_ITRS CE steps (active_predignore) on RegionDatasetPlbl over the
   images written as RGB PNGs and those PNGs (its items built in the
   loader's worker processes, started before the clock), from the
   classifier-stripped init file, then eval. Every launch counter is set to 0 just before the
   rounds and read just after, and again around the pseudo-labelling and
   stage 2: K1-K4 once per stage-1 step, K5 once per pseudo-labelled
   image, no kernel in selection or stage 2. Outside those windows K5 is
   held bitwise against its plain version (values and argmax pixels) on
   one label-set image's softmax planes and ids at 768x768, built as the
   generator builds them. The datalists, selections
   and checkpoints must exist, round 2 must select its budget, a
   checkpoint loaded back must be bitwise what was saved, and the losses
   must be finite. Then the paper's selector on the card against the CPU
   on two 96x80 images in float32 with the same weights: scores within
   1e-4, the same selected regions.
8h. The round loop against itself across devices (round_parity), after
   the paper's selector's check: run_al_rounds for RP_ROUNDS free-running
   rounds of RP_FIXTURE (the CPU tests' small model twin from its seeded
   init, SyntheticRegionDataset, float32, TF32 off, SGD, two validations
   a round and the best one's checkpoint kept: the fixture on which
   tools_dev/round_parity_port_fixture.py holds the port against the JAX
   package), on the card, then on the CPU through
   the plain versions, from one init file. Every launch counter is set to
   0 just before the card's rounds and read just after: K1-K4 once a
   stage-1 step, no other kernel. Each round's selected regions must be
   the CPU's (Jaccard 1.0); each round's Jaccard and step-0 loss gap
   print on a line of their own. Then the recipe's pseudo-labels of the
   last round's label set from the card's last checkpoint, on the card
   (counted: K5 once an image) and on the CPU: the maps must be equal.
   Its line: the fixture, per round the Jaccard, regions, step-0 gap and
   both eval mIoUs, the pixels that differ at synced weights and against
   the CPU's own last checkpoint, the seconds.
8i. The bf16 recipe paths against the JAX package (bf16_parity), after
   the round loop: tests/data/bf16_reference.npz and
   bf16_reference_voc.npz (BF16_FILES), written on the CPU by
   tools_dev/bf16_reference.py, hold the JAX package's dtype=bfloat16
   path on the fixtures of BF16_FIXTURES (the Cityscapes recipe's model
   at full width, batch 4, 96x96, nseg 24; the CPU tests' twin at batch
   4, 64x64, nseg 16; the VOC recipe's model at full width, 21 outputs,
   batch 4, 97x97, so that K1-K5 take the instances VOC's 513x513 takes),
   whose weights (bf16_variables, checked against the file's digest) and
   inputs (bf16_inputs) come from seeds. On each, the port's entry points
   with cfg.dtype "bfloat16" (bf16_port_outputs): make_eval_step and the
   features' eval forward, a train-mode forward, BF16_STEPS
   make_train_step steps (AdamW, poly), the recipe's
   PseudoLabelGenerator.generate (for VOC the 10-view TTA one, with each
   view's stem and decoder outputs of the first image) and the recipe's
   selector on a pool of 4 images, for VOC stage 2's step 0 (CE on the
   reference's pseudo-labels), on the card with every launch counter set
   to 0 just before and read just after (K1-K4 once a step, K5 once a
   pseudo-labelled image, nothing else) and each kernel's instance
   recorded (kernel_instances: for VOC K1-K5 at C = 21 at run time, no
   16-byte path), then on the CPU in float32 and under CPU bfloat16
   autocast. Each float output's distance (bf16_distance) on the card
   must lie within BF16_TOL, twice the JAX package's own spread under
   one bf16 ulp on 1% of its input pixels; the seven eval-mode stage
   outputs (and the TTA views') are held by the share of their values
   that differ bitwise, so a stage whose casts are not the JAX package's
   fails; the step by its gradient, the norms per leaf of the gradient
   and of the update, and the change of the BN statistics, which a step
   that does nothing misses by 100%; each exact output (the argmax map
   over the real classes and its confusion matrix, the pseudo-labels,
   the selected regions) must equal the file's outside the pixels or
   regions that flip under its perturbations. The CPU's float32 run is
   the control: it must fall outside on an eval output, or the check
   could not tell a bf16 path from a float32 one. Every distance prints
   beside its tolerance and the CPU's two. Its line: per fixture and
   output the three distances and the tolerance, the kernels' instances,
   the seconds on the card and on the CPU.
8j. The bf16 step at world 2 against the JAX package's 2-device step
   (bf16_world2), after 8i: for each fixture whose recipe holds it (VOC,
   whose batch of 12 is the job users spread over cards), two processes
   sharing the card under gloo (each device cuda:<this card>) take the
   port's make_train_step on half of the first batch each, from the
   seeded weights, in bf16 (bf16_world2_rank). The step-0 gradient summed
   over the ranks (the same on both) must lie within the fixture's grad0
   and grad0_norm tolerances of the reference's 'world2/' entries (the
   JAX package's step on a 2-device mesh of host devices), the loss and
   its parts within loss0's; K1-K4 once on each rank, counted from 0 on
   each rank. The card's world 2 against its own world 1 (8i's card
   run) and the JAX package's 2 devices against 1 print beside it,
   reported, not held. Its line: per fixture the distances and
   tolerances, the loss, the ranks' seconds.
8f. Data parallelism (dp; mulactseg_tpu_torch/parallel/mesh.py), the
   recipe model at the stage-1 shape from the seeded weights, global
   batch 4, bf16. (a) World 1: a group of one rank under NCCL
   (parallel.spawn) takes DP_STEPS recipe steps (AdamW) and, from the
   seeded weights again, DP_SGD_STEPS SGD steps; the same AdamW steps run
   twice in this process without a group. Step 0's losses must be
   bitwise those without a group, every collective must give back its
   input bitwise, and the steps must stay within 0.05 of the run without
   a group. The card's step is not bitwise reproducible (atomic adds in
   the backward: the two runs without a group differ too), so the line
   reports how far each run strays and how many tensors differ. (b) World
   2: two processes sharing the card (each device cuda:<i>, gloo with
   CUDA tensors) take the DP_SGD_STEPS SGD steps, each on its two rows,
   in float32 (TF32 off) and in bf16: against world 1, step 0's loss
   within 1e-3 relative and the losses within 0.05, and in float32 the
   gradient's cosine >= 0.99 and norm within 1e-2 (the JAX dryrun's
   bounds, __graft_entry__.py:116-242, whose runs are float32); K1-K4
   once a step on each rank. In bf16 the convolutions at 2 images a rank
   take other cuDNN algorithms and round otherwise, and the seeded
   model's step-0 gradient is chaotic in its input (the group term's
   argmax: one grey level on 1% of the pixels turns it to a cosine of
   0.02), so its gradient agreement is reported, not held. Two ranks on
   one card measure the collectives' cost, not a speed-up. (c) One active-learning round at world 2 on the al_rounds
   fixture from a classifier-stripped init file: the paper's selector
   (pool scoring split by rows, val_batch_size 1), whose regions must
   match this process's world-1 selection from the same file with
   Jaccard >= 0.99; DP_ITRS steps (K1-K4 once a step on each rank) with
   two validations, the best checkpoint (rank 0 writes, every rank
   reads) back, eval split by images, whose confusion matrix must equal
   world 1's eval of that checkpoint at batch 1 here; the recipe's
   pseudo-labels by rank 0 (K5 once a label-set image there, none on
   rank 1), then DP_ITRS stage-2 steps at world 2 on them (no kernel).
   Every launch counter is reset in each rank just before its steps and
   read just after. Its line: per world the backend, step ms, img/s, the
   gradient bytes all-reduced a step, peak GiB per rank, the deviations;
   the round's Jaccard, seconds, mIoUs, launches per rank.
8g. Data parallelism for every other criterion and the analysis evals
   (dp_criteria), after the evals phase (8e) and on its tree. Step 0 of
   each criterion of CRITERIA_CASES and MORE_CRITERIA_CASES on the recipe
   model from the seeded weights, global batch 4 at the stage-1 shape on
   one more_regions batch (the async pair's weak view uncut), float32
   with TF32 off: world 1 in this process without a group, then world 2
   as two processes sharing the card under gloo, one warm-up step first
   in each. Each criterion must hold the dp phase's float32 bounds (step
   0's loss within 1e-3 relative, the gradient's cosine >= 0.99 and norm
   within 1e-2), both ranks log the same losses, and K5 is launched k5
   times an image: k5 * 4 at world 1, k5 * 2 on each rank (every counter
   set to 0 just before each step and read just after). Then DPC_ANALYSIS
   and the probe (the 19-class checkpoint, --train_batch_size 2) through
   eval_al.main in bf16 at world 1 here and at world 2 (every rank
   scoring whole images): the confusion matrices, mIoUs and the probe's
   counts exactly equal, the overlays world 1's byte for byte and each
   written once, K5 once an image on the rank that scores it. Its line:
   per criterion the deviations, the step's ms on each rank at world 2
   and at world 1, K5 per rank; per eval the seconds and K5 per rank.
8b. The recipe's three commands over files (cli_recipe): a Cityscapes-
   format tree written by tools/cityscapes_tree.py (CLI_TRAIN training
   and CLI_VAL validation images at 1024x2048, adaptive-filtered RGB PNGs,
   8-bit label ids, .pkl superpixels at nseg 2048, the multi-hot tensors
   of tools/label_assignment with the 5x5 trim, the datalists and region
   dict of tools/gen_datalists), the seeded weights saved as the recipe's
   ImageNet init file, and the command lines of
   mulactseg_tpu_torch/scripts/train_city_mul_res50.sh (recorded by a stub
   `python`, so with the script's flags), cut to --finetune_itrs CLI_ITRS,
   --val_period CLI_VAL_PERIOD, --max_iterations CLI_ROUNDS and
   --active_selection_size at the recipe's 100,000 clicks for 2,975
   images, run in order through train_al.main, then eval_al.main and
   train_stage2.main for each of the CLI_ROUNDS rounds, on the card.
   Every launch counter is set to 0 just before each command and read
   just after: train_al launches K1-K4 once per stage-1 step, eval_al K5
   once per labelled image, stage 2 nothing; one pseudo-label PNG per
   labelled image, each decoding to a 1024x2048 map; finite losses and
   mIoUs, every checkpoint written. Then the loader alone over fresh
   copies of the training files, on worker processes and on threads, and
   one item's time by part. Its line: per-command seconds, per round
   train img/s (whole, first epoch with cold decode caches, the rest
   warm, validations taken out), plbl img/s, stage-2 img/s and mIoU,
   loader files/s, item ms by part, launches, peak GiB.
8d. The loader arms (loader_arms): a Cityscapes-format tree as in 8b
   (LA_TRAIN training and LA_VAL validation images at 1024x2048) that
   also holds superpixel maps at 512, 1,024 and 8,192 with their
   datalists, region dicts and multi-hot tensors, and the dominant labels
   of tools/label_assignment's dominant mode; the recipe's stage-1 command
   cut to 1 round of LA_ITRS steps and run through train_al.main for the
   dominant arm (--or_labeling false, RegionDatasetDominant with
   predignore, plain CE), the async hierarchy arm
   (region_cityscapes_or_tensor_ignore_async,
   active_joint_hier_multi_async_weight: every item carries its
   1024x2048 weak view, checked) and a research rewrite
   (region_cityscapes_or_tensor_ratiosample_gt); then the mixed-scale
   arm as its loaders, MsegRegionActiveSet.expand_training_set with given
   rows over two or three levels an image, and LA_ITRS steps. Every
   launch counter is set to 0 just before each arm and read just after:
   nothing for the dominant arm, K5 twice an image and step for the async
   arm and once an image, level and step for mseg (as in 8.2), K1-K4 once
   a step for the rewrite. The async and mixed-scale arms gather NaN
   target rows at padded pixels, as the JAX package does (ROADMAP.md,
   open question 4), so their weights go NaN after the first step whose
   batch holds crop padding: each arm's losses must be finite up to that
   step, and at least one step must be finite and free of padding. Its
   line: per arm seconds, train img/s, loader items/s over the round's
   labelled set, the losses and each batch's padded pixels, finite_steps
   (how many losses were finite), weights_finite (after training), and
   eval mIoU, null where the weights went NaN (eval_miou_nan_weights then
   holds what the NaN model scored); launches.
8c. The VOC recipe's commands over files (voc_recipe): a VOC-format tree
   written by tools/voc_tree.py (VOC_TRAIN training and VOC_VAL validation
   images at VOC's sizes, 375x500 to 500x500: baseline 4:2:0 JPEGs,
   palette label PNGs, .pkl superpixels at nseg 150, the 5x5-trimmed
   multi-hot tensors), a seeded 21-class model saved as the recipe's
   ImageNet init file, and the command lines of
   mulactseg_tpu_torch/scripts/train_voc_mul_res50.sh. First K1-K4 at the
   VOC stage-1 instance, held and timed as in item 3: logits (12, 21,
   513 * 513) of the seeded model on a stage-1 batch of the tree's files
   (C = 21 takes the kernels' run-time-C instance, the odd HW their 4-byte
   path), nseg 150 (S = 1,812: K3). Then the commands, cut to
   --finetune_itrs VOC_ITRS, --val_period VOC_VAL_PERIOD, --max_iterations
   VOC_ROUNDS and --active_selection_size at the recipe's 10,000 clicks
   for 1,464 images in stage 1 and VOC_S2_ITRS steps in stage 2, run as in
   item 8b: train_al launches K1-K4 once per stage-1 step, each eval_al
   (10-view TTA pseudo-labels) K5 once per labelled image, stage 2
   nothing; one pseudo-label PNG per labelled image, each the size of its
   JPEG. Then K5 held bitwise and timed on one pseudo-labelling image's
   TTA softmax planes (last round's checkpoint, its selected
   superpixels), and JPEG decoding timed a file at a time. Its line:
   per-command seconds, per round train img/s (whole, first epoch, the
   rest), plbl img/s and mIoU, stage-2 img/s and mIoU, JPEG decode ms per
   file, launches, peak GiB.
8e. The remaining evals over files (evals): a Cityscapes-format tree of
   EV_TRAIN training and EV_VAL validation images at 1024x2048 with
   dominant labels, a checkpoint of the seeded recipe model and one of a
   seeded 19-output model (the probe's and the _voc methods' head), and
   round-1 and round-2 datalists labelling EV_SELECT of each image's
   superpixels (a third of them in round 1). First K5, held bitwise and
   timed as in item 8.2 at two instances: one image's softmax of the
   sliding-summed logits under its labelled superpixels' ids (slide_plbl)
   and one 768x768 crop's T = 1 softmax over the 19-output model's
   channels under its spmask ids (probe).
   Then through eval_al.main, every launch counter set to 0 just before
   each command and read just after: eval_naive with --sliding_eval
   (EV_WINDOWS windows an image, no kernel); the eight plbl types of the
   ten ported last that the CLI reaches (one with --save_vis), K5 once an
   image for the three cosine ones and never for the five simple ones,
   every PNG decoded; nine of the eleven analysis methods, K5 once an
   image for the cosine-backed ones, never for eval_within_multihot and
   eval_naive_vis, every overlay decoded; active_joint_multi_analysis, K5
   once an image. Then the sliding eval again, warm, beside the direct
   one on the validation images in memory (img/s, peak GiB; the same
   mIoU as the command's). The JAX CLI reaches neither eval_all_dominant
   nor the cosprop_onehot types (their 'target' is a per-pixel dominant
   map; its loaders give the multi-hot, ROADMAP.md question 7), nor a
   _voc method on Cityscapes: those run at the generator and evaluator
   level on the label set's items with the tree's dominant labels,
   counted alike. Then
   each statistics loader's items/s over the label set (worker
   processes), its item's keys, dtypes and shapes checked; train_al cut
   to 1 round of EV_ITRS steps through dom_w_gt and dominant_all_sample
   (the dominant arm) and through active_slide with --sliding_eval (one
   sliding validation): finite losses, no kernel. Last, the small checks:
   SlidingEval at crop EV_CROP on an EV_HW image with the seeded model in
   float32, TF32 off, card against CPU within 1e-4 of the largest logit,
   and the simple pseudo-labels, boundary_mask and top1_selection_counts
   equal on both. Its line: per method seconds, img/s, the result (mIoU
   or accuracy), K5 launches, PNGs and overlays decoded; the loaders'
   items/s; the trainings' losses and mIoU; the feature-summing sliding
   forward's peak GiB and the phase's.
9. Reloads the seeded weights and, at full resolution (1x3x1024x2048,
   nseg 2048), holds K5 against its plain version, bitwise, on the
   softmax planes of an eval forward with ~30% of superpixels selected,
   and on signed values rounded to 1/8 (negative values and ties); times
   both.
10. Evaluation: Evaluator.run with predignore on 4 synthetic 1024x2048
   uint8 images (img/s, finite mIoU).
11. Pseudo-labelling, the recipe's cosprop_includeonehot step with
   cfg.dtype bfloat16 (so bf16 features and similarities):
   PseudoLabelGenerator.generate on tools_dev/bench_round.py's fixture
   (two base superpixel maps, 30% selected, 1-3 classes per superpixel),
   1 warm-up image and 8 timed ones, with every launch counter set to 0
   just before the 8 and read just after (K5 once per image, no other
   kernel); each PNG must decode to the map the generator computes. Then
   a profiled pass over the same 8 gives ms per image for each part and
   the device's idle share.
12. cosine_prototype_plbl on the card against the CPU at 96x80, nseg 24,
   sim_bf16 off: K5's outputs equal, the maps agree on >= 99.5% of pixels
   (the matmuls sum in another order, so near-ties may flip).
13. Profiles 1 + 3 stage-1 steps at each nseg with torch.profiler: the
   device time per step by kind of kernel and of each loss kernel, the
   top kernels and the device's idle share. Every timed run comes before these passes.
14. The profiler switch (profile), last: ALTrainer at cfg.profile
   (engine/rounds.py) with the recipe model from the seeded weights at
   the stage-1 shape (batch 4, 768x768, nseg 2048, bf16) trains
   PROF_ITRS steps on a SyntheticRegionDataset label set of PROF_IMAGES
   images, no validation, every launch counter set to 0 just before and
   read just after (K1-K4 once a step). Its one trace,
   profile/rank0.round01.pt.trace.json, is read back: it must hold
   device spans, every __global__ kernel that K1-K4 launch
   (COUNTER_KERNELS, by the launch counters' accounting) exactly once a
   step and each BN kernel once a BN and step, and the losses must be
   finite. Its line: the device busy ms a
   step and the idle share of the traced window (from the trace's
   kernel, copy and memset spans), the 10 host ops with the most self
   time, the profiler's stop and export seconds, the file's MB.

Prints, at the end and in compact JSON (about 37 kB in all: send the
output to a file where only a tail of it comes back), the slices'
numbers (the zoo and criteria lines, items 8.1-8.2; the cli_recipe line,
item 8b; the loader_arms line, item 8d; the voc_recipe line, item 8c;
the evals line, item 8e; the dp line, item 8f; the dp_criteria line,
item 8g; the profile_phase line, item 14; the round_parity line, item
8h; the bf16_parity line, item 8i; the bf16_world2 line, item 8j;
evaluation;
stage 1 at both nseg; plbl; the al_rounds line: per round the selection
seconds, train img/s, validations, eval mIoU, checkpoint save and load
seconds; then plbl img/s, stage-2 img/s and mIoU, peak memory and the
card), the card's name and power limit, and one JSON line with each
kernel's check and times (K5 eight times: at plbl's shapes, on K6's
planes, on a VOC plbl image, at the group term's instance, on the async
weak view and over its fine map, at the sliding pseudo-labeller's and at
the probe's instance; K1-K4 twice: at Cityscapes' and VOC's stage-1
shapes; BN1-BN6 three times: at city_stage1's, voc_stage1's and
SegFormer-B5's BN shapes, summed over a step, each with the largest
error of the outputs it writes, relative to their operands), its
launches on each main path (launches_by_path) and their sum
(launches); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

B, NUM_CLASSES, H, W, NSEG = 4, 20, 768, 768, 2048
NSEG_LARGE, WARMUP_LARGE, TIMED_LARGE = 4096, 2, 10  # past the K3 guard
PH, PW, PLBL_IMAGES, EVAL_IMAGES = 1024, 2048, 8, 4  # plbl/eval resolution
WARMUP, TIMED, WINDOW = 3, 20, 5
# the active-learning phase: 768x768 grid-superpixel fixture at nseg 2048,
# pool and label sets of AL_POOL images, val and eval sets of AL_VAL
AL_POOL, AL_VAL, AL_ITRS, AL_VAL_PERIOD, AL_BUDGET = 8, 4, 12, 6, 3000
# the recipe's commands over files: a generated Cityscapes-format tree of
# CLI_TRAIN training and CLI_VAL validation images at PHxPW, the recipe's
# flags cut to CLI_ROUNDS rounds of CLI_ITRS steps, validating every
# CLI_VAL_PERIOD steps
CLI_TRAIN, CLI_VAL, CLI_ITRS, CLI_VAL_PERIOD, CLI_ROUNDS = 16, 4, 12, 6, 2
# the VOC recipe's commands over files: a generated VOC-format tree of
# VOC_TRAIN training and VOC_VAL validation images at VOC's sizes, the
# recipe's flags (batch VOC_B, VOC_CROP crops, nseg VOC_NSEG, VOC_CLASSES
# classes) cut to VOC_ROUNDS rounds of VOC_ITRS stage-1 steps validating
# every VOC_VAL_PERIOD, and VOC_S2_ITRS stage-2 steps a round validating
# every VOC_S2_VAL_PERIOD
VOC_TRAIN, VOC_VAL, VOC_ITRS, VOC_VAL_PERIOD, VOC_ROUNDS = 16, 4, 12, 6, 2
VOC_S2_ITRS, VOC_S2_VAL_PERIOD = 10, 5
VOC_B, VOC_CROP, VOC_NSEG, VOC_CLASSES = 12, 513, 150, 21
# the rest of the model zoo: each model at full width (20 outputs, OS16,
# separable where "plus") for ZOO_WARMUP + ZOO_TIMED stage-1 steps on the
# recipe's fused criterion; its eval logits on the card against the CPU
# at ZOO_EVAL_HW in float32, TF32 off, within ZOO_EVAL_RTOL of the largest
ZOO_NAMES = ("deeplabv3_resnet50", "deeplabv3_resnet101",
             "deeplabv3_mobilenet", "deeplabv3plus_mobilenet",
             "deeplabv2_resnet101", "deeplabv2_mobilenet")
ZOO_WARMUP, ZOO_TIMED, ZOO_EVAL_HW, ZOO_EVAL_RTOL = 1, 5, (96, 80), 1e-4
# the criteria beside the recipe's, at the stage-1 shape: CRIT_WARMUP +
# CRIT_TIMED steps each (the joint criterion as many as stage 1)
CRIT_WARMUP, CRIT_TIMED = 1, 5
# the criteria that read more than a region batch: the hierarchy's finer
# map of SMALL_NSEG superpixels (4x finer), the async criteria's weak view
# of each image uncut at WEAK_HW, the mixed-scale levels MSEG_LEVELS
SMALL_NSEG, WEAK_HW, MSEG_LEVELS = 8192, (1024, 2048), (512, 1024, 2048)
# the loader arms over files: a generated tree of LA_TRAIN training and
# LA_VAL validation images at PHxPW with the extra granularities and the
# dominant labels; each arm cut to 1 round of LA_ITRS steps
LA_TRAIN, LA_VAL, LA_ITRS = 8, 2, 6
# the remaining evals over files: a tree of EV_TRAIN training and EV_VAL
# validation images at PHxPW with dominant labels, EV_SELECT of each
# image's superpixels labelled (a third of them in round 1); the sliding
# window of cfg.slide_crop (800) at stride 0.6667: EV_WINDOWS windows an
# image; the two train_al commands of the statistics loaders and
# active_slide cut to 1 round of EV_ITRS steps
EV_TRAIN, EV_VAL, EV_SELECT, EV_WINDOWS, EV_ITRS = 4, 2, 0.3, 8, 3
# the small checks of the evals: SlidingEval at crop EV_CROP on an
# EV_HW image, float32, TF32 off, within 1e-4 of the largest logit
EV_CROP, EV_HW = 64, (96, 160)
# the data-parallel phase: DP_STEPS recipe steps at world 1 (a group of one
# rank), step 0 and a DP_SGD_STEPS-step SGD trajectory at world 2 (two
# processes sharing the card), one active-learning round at world 2 with
# DP_ITRS stage-1 and stage-2 steps; every group joined within DP_TIMEOUT s
DP_STEPS, DP_SGD_STEPS, DP_ITRS, DP_TIMEOUT = 6, 3, 4, 400
# the criteria's data-parallel phase: two cosine-backed analysis methods
# (the first writes overlays) and the probe through eval_al at world 2
DPC_ANALYSIS = ("eval_vistopone_within_multihot", "eval_all_cosplbl_prop")
# the profiler switch: ALTrainer at cfg.profile for PROF_ITRS stage-1 steps
# on a label set of PROF_IMAGES synthetic images
PROF_ITRS, PROF_IMAGES = 4, 8
# the round loop's parity fixture (round_parity): the small model twin of
# the CPU tests with RP_CLASSES outputs from the seeded init RP_SEED, on a
# SyntheticRegionDataset of hh x hh images with nseg grid superpixels,
# pool and label sets of `pool` images and a val set of `val`; `budget`
# clicks a round, `steps` SGD steps a round at batch `batch` and learning
# rate `lr`, validation every `val_period` steps (None: off, each round
# keeps its last step); RP_ROUNDS rounds. tools_dev/
# round_parity_port_fixture.py chose it and holds the JAX package to it
RP_CLASSES, RP_SEED, RP_ROUNDS = 7, 0, 5
# two devices' (or packages') pseudo-labels from one checkpoint may differ
# only at float32 ties: at most RP_PLBL_TIES of the pixels, each a decision
# within RP_TIE_MARGIN of flipping (plbl_margins: a cosine similarity's
# distance to its rival or threshold, where float32 forwards that part by
# ~1e-6 can reach)
RP_PLBL_TIES, RP_TIE_MARGIN = 2e-2, 1e-5
RP_FIXTURE = dict(hh=64, nseg=16, pool=6, val=3, budget=24, batch=4,
                  steps=8, lr=3e-3, val_period=4)
# the bf16 recipe paths against the JAX package's dtype=bfloat16 model
# (bf16_parity, bf16_world2): the references tools_dev/bf16_reference.py
# writes, and three fixtures: the Cityscapes recipe's model at full width,
# rp_model's twin, and the VOC recipe's model at full width at an odd size
# (97 x 97, so the kernels take the instances VOC's 513 x 513 takes), each
# at batch `batch`, hw x hw, nseg superpixels, `classes` outputs, a
# selector pool of `pool` images and `budget` clicks, weights and inputs
# from `seed`, and the recipe of BF16_RECIPES
BF16_REFERENCE = HERE / "tests" / "data" / "bf16_reference.npz"
BF16_REFERENCE_VOC = HERE / "tests" / "data" / "bf16_reference_voc.npz"
BF16_FIXTURES = {
    "full": dict(batch=4, hw=96, nseg=24, classes=NUM_CLASSES, pool=4,
                 budget=24, seed=0, recipe="cityscapes"),
    "twin": dict(batch=4, hw=64, nseg=16, classes=RP_CLASSES, pool=4,
                 budget=16, seed=1, recipe="cityscapes"),
    "voc": dict(batch=4, hw=97, nseg=48, classes=21, pool=4, budget=24,
                seed=2, recipe="voc")}
BF16_FILES = {"full": BF16_REFERENCE, "twin": BF16_REFERENCE,
              "voc": BF16_REFERENCE_VOC}
# each recipe's Config keys (its criterion; for VOC the script's selector,
# flags and learning rate, scripts/open_source/train_voc_mul_res50.sh:
# 16-51), its pseudo-labeller's method and whether that runs the 10-view
# TTA, whether the model has the predignore class, stage 2's Config keys
# (lines 80-113: CE on the pseudo-labels), None where stage 2 is not
# held, and whether the step is held at world 2 (the batch of 12 is the
# job users spread over cards)
BF16_RECIPES = {
    "cityscapes": dict(
        config=dict(method="active_joint_multi_predignore_lossdecomp"),
        plbl_method="eval_save_cosplbl_prop_includeonehot", tta=False,
        predignore=True, stage2=None, world2=False),
    "voc": dict(
        config=dict(dataset="voc", train_lr=1e-5,
                    method="active_joint_multi_lossdecomp",
                    active_method="my_bvsb_predclsbal_pwr",
                    cls_weight_coeff=12.0, fair_counting=True,
                    or_labeling=True),
        plbl_method="eval_save_cosplbl_prop_includeonehot_voc_ms", tta=True,
        predignore=False,
        stage2=dict(method="active", stage2=True, dominant_labeling=True,
                    cls_lr_scale=10.0), world2=True)}
# the stages of the TTA forward's views that the reference keeps, of the
# first pseudo-labelled image
BF16_TTA_STAGES = ("stem", "decoder")
# BF16_STEPS train steps; the reference keeps the float maps at a seeded
# sample of BF16_LOGIT_PIXELS (logits) and BF16_FEAT_PIXELS (features),
# each stage output at BF16_STAGE_VALUES values and the step-0 gradient
# at BF16_GRAD_VALUES
BF16_STEPS, BF16_LOGIT_PIXELS, BF16_FEAT_PIXELS = 3, 2048, 256
BF16_STAGE_VALUES, BF16_GRAD_VALUES = 4096, 65536
# the last BN of each residual block at this share of its scale: at full
# scale the JAX package's own bf16 train step is chaotic at random weights
# (one bf16 ulp on 1% of the pixels moves its step-0 gradient by 85-100%
# at batches 4-16, 64-128 px), at a tenth by 34-40%; the VOC fixture at
# nseg 24 stayed chaotic at a tenth for 4 of 4 seeds, at nseg 48 it moves
# by 35% (PERF.md, the searches; tools_dev/bf16_reference.py --search)
BF16_RESIDUAL_SCALE = 0.1
BF16_PARTS = ("ce_loss", "mc_loss", "group_loss", "train_loss")
# the parts of bf16_port_outputs: eval step and stages; train-mode forward
# and the steps; pseudo-labels (with the TTA views' stages); selection;
# stage 2's step 0 (the recipes that hold it)
BF16_OUTPUT_PARTS = ("eval", "train", "plbl", "select", "stage2")
# the stages whose eval and train-mode outputs place a gap
BF16_STAGE_MODULES = {
    "stem": "backbone.maxpool", "layer1": "backbone.layer1",
    "layer2": "backbone.layer2", "layer3": "backbone.layer3",
    "layer4": "backbone.layer4", "aspp": "classifier.aspp",
    "decoder": "classifier.classifier"}
# the exact outputs: equal to the reference's but where they flip under
# the JAX package's own perturbations
BF16_EXACT = ("eval_pred", "plbl", "selected")
# each float output's tolerance: twice the JAX package's own spread under
# one bf16 ulp on 1% of its input pixels (its 'spread_input/<key>' in
# BF16_REFERENCE, tools_dev/bf16_reference.py), rounded up to two
# significant digits; set before the first card run, and never raised
# after one
BF16_TOL = {
    "full": {"eval_logits": 0.0043, "eval_feat": 0.0064,
             "stage_eval/stem": 0.32, "stage_eval/layer1": 0.72,
             "stage_eval/layer2": 0.83, "stage_eval/layer3": 0.98,
             "stage_eval/layer4": 0.96, "stage_eval/aspp": 0.69,
             "stage_eval/decoder": 0.66, "stage_train/stem": 0.02,
             "stage_train/layer1": 0.036, "stage_train/layer2": 0.046,
             "stage_train/layer3": 0.053, "stage_train/layer4": 0.066,
             "stage_train/aspp": 0.12, "stage_train/decoder": 0.13,
             "train_logits": 0.037, "bn_delta": 0.013, "loss0": 0.008,
             "losses": 0.0087, "grad0": 0.83, "grad0_norm": 0.18,
             "update_norm": 0.0087, "scores": 0.0056},
    "twin": {"eval_logits": 0.0062, "eval_feat": 0.012,
             "stage_eval/stem": 0.33, "stage_eval/layer1": 0.61,
             "stage_eval/layer2": 0.77, "stage_eval/layer3": 0.79,
             "stage_eval/layer4": 0.83, "stage_eval/aspp": 0.62,
             "stage_eval/decoder": 0.63, "stage_train/stem": 0.02,
             "stage_train/layer1": 0.033, "stage_train/layer2": 0.046,
             "stage_train/layer3": 0.064, "stage_train/layer4": 0.083,
             "stage_train/aspp": 0.072, "stage_train/decoder": 0.11,
             "train_logits": 0.058, "bn_delta": 0.017, "loss0": 0.022,
             "losses": 0.023, "grad0": 0.86, "grad0_norm": 0.15,
             "update_norm": 0.025, "scores": 0.0018},
    "voc": {"eval_logits": 0.0035, "eval_feat": 0.006,
            "stage_eval/aspp": 0.76, "stage_eval/decoder": 0.72,
            "stage_eval/layer1": 0.71, "stage_eval/layer2": 0.9,
            "stage_eval/layer3": 1.0, "stage_eval/layer4": 0.89,
            "stage_eval/stem": 0.3, "stage_train/aspp": 0.11,
            "stage_train/decoder": 0.15, "stage_train/layer1": 0.036,
            "stage_train/layer2": 0.061, "stage_train/layer3": 0.054,
            "stage_train/layer4": 0.094, "stage_train/stem": 0.021,
            "train_logits": 0.038, "bn_delta": 0.011, "loss0": 0.0038,
            "losses": 0.014, "grad0": 0.68, "grad0_norm": 0.074,
            "update_norm": 0.042, "stage_tta/0.5/stem": 0.36,
            "stage_tta/0.5/decoder": 0.77, "stage_tta/0.75/stem": 0.32,
            "stage_tta/0.75/decoder": 0.76, "stage_tta/1.0/stem": 0.28,
            "stage_tta/1.0/decoder": 0.76, "stage_tta/1.25/stem": 0.24,
            "stage_tta/1.25/decoder": 0.73, "stage_tta/1.5/stem": 0.22,
            "stage_tta/1.5/decoder": 0.74, "stage_tta/0.5f/stem": 0.33,
            "stage_tta/0.5f/decoder": 0.74, "stage_tta/0.75f/stem": 0.33,
            "stage_tta/0.75f/decoder": 0.74, "stage_tta/1.0f/stem": 0.27,
            "stage_tta/1.0f/decoder": 0.74, "stage_tta/1.25f/stem": 0.24,
            "stage_tta/1.25f/decoder": 0.75, "stage_tta/1.5f/stem": 0.2,
            "stage_tta/1.5f/decoder": 0.75, "scores": 0.018,
            "s2_loss0": 0.0016, "s2_grad0_norm": 0.061}}
# the __global__ kernels of csrc/ that each launch counter's wrapper
# launches, one of each a count
COUNTER_KERNELS = {"pixel_ce_fwd": ("pixel_ce_fwd_kernel",),
                   "pixel_ce_bwd": ("pixel_ce_bwd_kernel",),
                   "ssm_fwd": ("ssm_span_kernel", "ssm_decode_kernel"),
                   "ssm_bwd": ("ssm_bwd_kernel",),
                   **{k: (f"{k}_kernel",) for k in (
                       "bn_stats", "bn_finalize", "bn_apply", "bn_bwd_stats",
                       "bn_bwd_finalize", "bn_dx")}}
TIMING_RUNS, REPEATS = 20, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

KERNELS = {
    "pixel_ce_fwd": ("K1", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                     "mulactseg_tpu/ops/pixel_loss_pallas.py:257"),
    "pixel_ce_bwd": ("K2", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                     "mulactseg_tpu/ops/pixel_loss_pallas.py:292"),
    "ssm_fwd": ("K3", "mulactseg_tpu_torch/csrc/segment.cu",
                "mulactseg_tpu/ops/segment_pallas.py:560"),
    "ssm_bwd": ("K4", "mulactseg_tpu_torch/csrc/segment.cu",
                "mulactseg_tpu/ops/segment_pallas.py:641"),
    "seg_max_fwd": ("K5", "mulactseg_tpu_torch/csrc/segment_max.cu",
                    "mulactseg_tpu/ops/segment_pallas.py:295"),
    "prereduce_nchw": ("K6", "mulactseg_tpu_torch/csrc/prereduce.cu",
                       "mulactseg_tpu/ops/segment_pallas.py:665"),
    "ssm_rows_fwd": ("K7", "mulactseg_tpu_torch/csrc/segment.cu",
                     "mulactseg_tpu/ops/segment_pallas.py:230"),
    "prereduce_rows": ("K8", "mulactseg_tpu_torch/csrc/prereduce.cu",
                       "mulactseg_tpu/ops/segment_pallas.py:351"),
    "pixel_ce_rows_fwd": ("K9", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                          "mulactseg_tpu/ops/pixel_loss_pallas.py:94"),
    "pixel_ce_rows_bwd": ("K10", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                          "mulactseg_tpu/ops/pixel_loss_pallas.py:130"),
    # FastBatchNorm's training pass: no pallas_call, the JAX package
    # leaves it to XLA
    **{k: (f"BN{i + 1}", "mulactseg_tpu_torch/csrc/batch_norm.cu",
           "no pallas_call; FastBatchNorm (mulactseg_tpu/models/layers.py) "
           "was left to XLA")
       for i, k in enumerate(("bn_stats", "bn_finalize", "bn_apply",
                              "bn_bwd_stats", "bn_bwd_finalize", "bn_dx"))},
}
STAGE1_KERNELS = ("pixel_ce_fwd", "pixel_ce_bwd", "ssm_fwd", "ssm_bwd")
STAGE1_LARGE_KERNELS = ("pixel_ce_fwd", "pixel_ce_bwd", "prereduce_nchw",
                        "seg_max_fwd", "ssm_bwd")
ROW_OP_KERNELS = ("ssm_rows_fwd", "prereduce_rows", "seg_max_fwd",
                  "pixel_ce_rows_fwd", "pixel_ce_rows_bwd")
BF16_ULP = 2.0 ** -7  # of the larger value; + 1e-38 for subnormals
PLBL_PARTS = ("plbl.forward", "plbl.softmax", "plbl.k5", "plbl.pass1",
              "plbl.threshold", "plbl.pass2", "plbl.fetch", "plbl.save")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, graph=False):
    """Per-call device time of fn(): CUDA events around REPEATS back-to-back
    calls, divided by REPEATS; the median of TIMING_RUNS such windows,
    after one warm-up call. With graph=True the calls are replays of one
    captured call (a CUDA graph), which keeps the Python wrapper's host
    time off the device's clock; the plain versions, which synchronise on
    boolean indexing, run eagerly."""
    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPEATS)
    return statistics.median(times)


def ptxas_summary(log):
    """One line per kernel of an nvcc -Xptxas -v report: its name
    (demangled by cu++filt, which ships beside nvcc, without its namespace
    and parameters), registers and spills."""
    from mulactseg_tpu_torch.ops import _build

    rows = re.findall(r"Compiling entry function '(\w+)'.*?"
                      r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                      r"Used (\d+) registers", log, flags=re.S)
    if not rows:
        return []
    names = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cu++filt"))],
        input="\n".join(r[0] for r in rows), check=True, capture_output=True,
        text=True).stdout.splitlines()
    # "void <unnamed>::k<(int)20>(const float *, ...)" -> "k<20>"
    names = [re.sub(r"\([\w ]+\)(?=-?\d)|<unnamed>::|\(anonymous "
                    r"namespace\)::", "", n).split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{name}: {regs} registers, {st}/{ld} bytes spilled "
            f"(stores/loads)"
            for name, (_, st, ld, regs) in zip(names, rows)]


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def class_order_softmax(scaled):
    """K7's probabilities in the kernel's own order: the float32 softmax of
    the bf16-rounded rows, exp(u - max) summed in class order, then e / z.
    The plain version sums with torch's sum; only this order lets K7 be
    held bitwise."""
    from mulactseg_tpu_torch.ops import segment

    u = segment._round_bf16(scaled)
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    z = e[:, 0]
    for c in range(1, e.shape[1]):
        z = z + e[:, c]
    return e / z[:, None]


def make_batches(n, seed, nseg=None):
    """bench.py's synthetic stage-1 batches, as numpy arrays (nseg NSEG
    unless given)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.fused import pixel_target_bits

    nseg = nseg or NSEG
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        target = (rng.rand(B, nseg, NUM_CLASSES) < 0.15).astype(np.float32)
        spx = np.stack([irregular_superpixels(H, W, nseg, rng)
                        for _ in range(B)]).astype(np.int32)
        sel = rng.rand(B, nseg) < 0.5
        spmask = np.take_along_axis(sel, spx.reshape(B, H * W),
                                    axis=1).reshape(B, H, W)
        bits = np.stack([pixel_target_bits(target[b], spx[b], spmask[b])
                         for b in range(B)])
        images = rng.randint(0, 256, (B, 3, H, W)).astype(np.uint8)
        out.append({"images": images, "target": target,
                    "target_bits": bits, "spx": spx})
    return out


def stage1_ids(batch, dev, nseg):
    """(bits3, candidate counts, sid3) of lossdecomp_fused's group term,
    for a batch of any (B, H, W) and class count."""
    from mulactseg_tpu_torch.losses.fused import _popcount

    B, H, W = batch["spx"].shape
    C = batch["target"].shape[-1]
    HW, P = H * W, B * H * W
    bits3 = torch.as_tensor(batch["target_bits"]).to(dev).reshape(
        B, 1, HW).contiguous()
    spx = torch.as_tensor(batch["spx"]).to(dev).reshape(P).long()
    n_cand = _popcount(bits3.reshape(P).long() & ((1 << C) - 1))
    off = torch.arange(B, device=dev).repeat_interleave(HW) * nseg
    sid3 = torch.where(n_cand > 1, spx + off, B * nseg).int().reshape(
        B, 1, HW)
    return bits3, n_cand, sid3


def check_in_segment(sid3, pix, what):
    """K4's precondition: every live argmax pixel lies in its own segment
    (sid3[pix[s, c]] == s wherever pix[s, c] < P)."""
    S, C = pix.shape
    P = sid3.numel()
    live = pix < P
    seg = torch.arange(S, device=pix.device)[:, None].expand(S, C)[live]
    check(bool((sid3.reshape(P)[pix[live].long()].long() == seg).all()),
          f"{what}: an argmax pixel lies outside its segment")


def check_k3(xc, sid3, S, temp, vals, pix, what):
    """K3's (vals, pix) against its plain version on the same inputs:
    absent sets equal with value 0.0, maxima within 1e-6, each argmax pixel
    attaining the plain max within 1e-6 (ties may resolve to another pixel
    only where probabilities agree within rounding) and lying in its
    segment. Returns the max abs error of the values."""
    from mulactseg_tpu_torch.ops import segment

    _, C, HW = xc.shape
    P = sid3.numel()
    pvals, ppix = segment.ssm_fwd_plain(xc, sid3, S, temp)
    torch.cuda.synchronize()
    absent = pix == P
    check(torch.equal(absent, ppix == P), f"{what}: absent sets differ")
    check(bool((vals[absent] == 0).all()), f"{what}: absent value is not 0.0")
    err = (vals - pvals).abs().max().item()
    check(err <= 1e-6, f"{what}: max values differ by {err}")
    probs = segment._softmax(xc, temp)
    q = pix[~absent].long()
    cls = torch.arange(C, device=xc.device).expand(S, C)[~absent]
    tie_err = (probs[q // HW, cls, q % HW] - pvals[~absent]).abs().max()
    check(tie_err.item() <= 1e-6,
          f"{what}: argmax pixel off the max by {tie_err.item()}")
    check_in_segment(sid3, pix, what)
    return err


def colliding_ids(dev, S, B, HW):
    """Adversarial ids for K3 on (B, 1, HW) logits: one id per run of 4
    pixels (the last run cut short), ids equal modulo K3's shared slot
    count in groups of 32 runs (so most runs of a span find their slot
    held), a quarter of the runs invalid."""
    from mulactseg_tpu_torch.ops import segment

    gen = torch.Generator(device="cpu").manual_seed(1)
    runs = -(-B * HW // 4)
    r = torch.arange(runs)
    ids = (r * segment.K3_SLOTS + r // 32) % S
    ids = torch.where(torch.rand(runs, generator=gen) < 0.25, S, ids)
    return ids.repeat_interleave(4)[:B * HW].int().reshape(B, 1, HW).to(dev)


def group_cotangent(vals, pix, target, P):
    """The group term's cotangent of the max values, as lossdecomp_fused
    makes it: -log(max + 1e-8) over the present target entries, over one
    plus their count; P pixels in all."""
    mx = vals.clone().requires_grad_(True)
    present = (pix[:, 0] < P).reshape(target.shape[:2])
    entry = (target > 0.5) & present[:, :, None]
    gnll = -torch.log(mx.reshape(target.shape) + 1e-8)
    (torch.where(entry, gnll, 0.0).sum() / (1.0 + entry.sum())).backward()
    return mx.grad.contiguous()


def check_k4(xc, sid3, vals, pix, gv, temp, what):
    """K4's precondition on (vals, pix), then K4 against the dense plain
    backward: max abs error within 1e-6 of max |dl|. Returns (the kernel's
    dl, the error)."""
    from mulactseg_tpu_torch.ops import segment

    check_in_segment(sid3, pix, what)
    got = segment.ssm_bwd(xc, sid3, vals, pix, gv, temp)
    want = segment.ssm_bwd_plain(xc, vals, pix, gv, temp)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(scale > 0 and err <= 1e-6 * scale,
          f"{what}: dl differs, max abs err {err} vs max |dl| {scale}")
    return got, err


def kernel_checks(logits, batch, dev, nseg=NSEG, label=""):
    """K1-K4 against their plain versions at a main path's shapes: the
    (B, C, H, W) logits and the batch's ids at nseg. Returns one row per
    kernel: (name + label, max abs err, ms, plain ms, (bound ms, bound
    by), library ms or None)."""
    from mulactseg_tpu_torch.ops import pixel_loss, segment

    B, C, H, W = logits.shape
    HW = H * W
    P = B * HW
    S = B * nseg
    temp = 0.1
    xc = logits.reshape(B, C, HW).contiguous()
    bits3, n_cand, sid3 = stage1_ids(batch, dev, nseg)
    target = torch.as_tensor(batch["target"]).to(dev)
    # bytes each kernel must move: its inputs once, its outputs once, and
    # the logits only of the pixels this data needs (a pixel without
    # candidates, or outside the group term, needs none of them)
    n_live = int((n_cand > 0).sum())
    n_valid = int((n_cand > 1).sum())
    row_bytes = C * 4
    rows = []

    # K1, bitwise the same on a second call, and K1 and K2 on the 4-byte
    # path too: the logits one float into a larger storage (not 16-byte
    # aligned). The instance: C compiled where it is 20, else C at run
    # time; 16-byte loads where HW % 4 == 0 and the logits are aligned.
    store = torch.empty(xc.numel() + 1, device=dev)
    store[1:] = xc.reshape(-1)
    xu = store[1:].view(B, C, HW)
    nc = pixel_loss.compiled_classes(C)
    check(pixel_loss.instance(xc, bits3) == (nc, HW % 4 == 0)
          and pixel_loss.instance(xu, bits3) == (nc, False),
          f"K1/K2 instances: want C {nc or 'at run time'}, 16-byte path "
          f"{HW % 4 == 0} on the model's logits, 4-byte path on the "
          "shifted copy")
    got = pixel_loss.pixel_ce_fwd(xc, bits3, temp)
    want = pixel_loss.pixel_ce_fwd_plain(xc, bits3, temp)
    got_u = pixel_loss.pixel_ce_fwd(xu, bits3, temp)
    torch.cuda.synchronize()
    for what, k1 in (("K1", got), ("K1 on the 4-byte path", got_u)):
        check(torch.equal(k1[1::2], want[1::2]),
              f"{what} counts differ: {k1.tolist()} vs {want.tolist()}")
        check(torch.allclose(k1[0::2], want[0::2], rtol=1e-5, atol=0),
              f"{what} sums differ: {k1.tolist()} vs {want.tolist()}")
    check(torch.equal(pixel_loss.pixel_ce_fwd(xc, bits3, temp), got),
          "K1 is not bitwise reproducible")
    rows.append(("pixel_ce_fwd" + label, (got - want).abs().max().item(),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd(xc, bits3, temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd_plain(xc, bits3,
                                                               temp)),
                 bound(P * 4 + n_live * row_bytes + 16, 8 * n_live * C),
                 None))

    # K2, with the cotangents the loss gives (coeff / (1 + count))
    g = torch.stack([16.0 / (1.0 + want[1]), 8.0 / (1.0 + want[3])]
                    ).float().contiguous()
    want_dl = pixel_loss.pixel_ce_bwd_plain(xc, bits3, g, temp)
    scale = want_dl.abs().max().item()
    errs = []
    for what, x_in in (("K2", xc), ("K2 on the 4-byte path", xu)):
        got = pixel_loss.pixel_ce_bwd(x_in, bits3, g, temp)
        torch.cuda.synchronize()
        errs.append((got - want_dl).abs().max().item())
        check(scale > 0 and errs[-1] <= 1e-6 * scale,
              f"{what} dl differs: max abs err {errs[-1]} vs max |dl| "
              f"{scale}")
        del got
    err = errs[0]
    print(json.dumps({"pixel_loss_4byte_path" + label: {
        "K1_ms": time_ms(lambda: pixel_loss.pixel_ce_fwd(xu, bits3, temp),
                         graph=True),
        "K2_ms": time_ms(lambda: pixel_loss.pixel_ce_bwd(xu, bits3, g,
                                                         temp), graph=True),
        "K1_max_abs_err": (got_u - want).abs().max().item(),
        "K2_max_abs_err": errs[1]}}), flush=True)
    del store, xu
    rows.append(("pixel_ce_bwd" + label, err,
                 time_ms(lambda: pixel_loss.pixel_ce_bwd(xc, bits3, g, temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_bwd_plain(xc, bits3, g,
                                                               temp)),
                 bound(P * 4 + n_live * row_bytes + P * row_bytes + 8,
                       12 * n_live * C),
                 None))
    del want_dl

    # K3, on the recipe's ids and on adversarial ones
    vals, pix = segment.ssm_fwd(xc, sid3, S, temp)
    err = check_k3(xc, sid3, S, temp, vals, pix, "K3")
    adv = colliding_ids(dev, S, B, HW)
    adv_err = check_k3(xc, adv, S, temp, *segment.ssm_fwd(xc, adv, S, temp),
                       "K3 on colliding ids")
    print(f"K3 on colliding ids (one id per run of 4, slots held by other "
          f"ids): max abs err {adv_err}", flush=True)
    del adv
    rows.append(("ssm_fwd" + label, max(err, adv_err),
                 time_ms(lambda: segment.ssm_fwd(xc, sid3, S, temp),
                         graph=True),
                 time_ms(lambda: segment.ssm_fwd_plain(xc, sid3, S, temp)),
                 bound(P * 4 + n_valid * row_bytes + S * C * 8,
                       8 * n_valid * C),
                 None))

    # K4, with the group term's cotangent of the max values
    gv = group_cotangent(vals, pix, target, P)
    got, err = check_k4(xc, sid3, vals, pix, gv, temp, "K4")
    scale = got.abs().max().item()
    # the library's softmax backward computes the same dl from the softmax
    # and the dense cotangent of the probabilities (g / T at each argmax)
    probs = segment._softmax(xc, temp)
    live = (pix < P) & (gv != 0)
    qa = pix[live].long()
    dense_g = torch.zeros(B, C, HW, device=dev)
    dense_g[qa // HW, torch.arange(C, device=dev).expand(S, C)[live],
            qa % HW] = gv[live] / temp
    lib = torch.ops.aten._softmax_backward_data(dense_g, probs, 1,
                                               torch.float32)
    lib_err = (lib - got).abs().max().item()
    check(lib_err <= 1e-6 * scale,
          f"K4 dl differs from the softmax backward by {lib_err}")
    del got, lib
    n_live_pix = int(torch.unique(qa).numel())
    rows.append(("ssm_bwd" + label, err,
                 time_ms(lambda: segment.ssm_bwd(xc, sid3, vals, pix, gv,
                                                 temp), graph=True),
                 time_ms(lambda: segment.ssm_bwd_plain(xc, vals, pix, gv,
                                                       temp)),
                 bound(P * row_bytes + 3 * S * C * 4 + n_live_pix * row_bytes,
                       12 * n_live_pix * C),
                 time_ms(lambda: torch.ops.aten._softmax_backward_data(
                     dense_g, probs, 1, torch.float32), graph=True)))
    del probs, dense_g
    return rows


def check_prereduce(got, want, probs, sid, nimg, hw, what):
    """K6 or K8 against its plain version: values bf16-exact, within one
    bf16 ulp of the plain ones (the exps may differ by a float32 ulp, which
    can move a value across a rounding boundary) and equal for more than
    99.9% of them; retired ids equal; and each choice that differs from the
    plain one picks a pixel of its leader's segment whose float32
    probability (probs, (C, P)) is within 1e-6 of the plain pick's.
    Returns (max abs error of the values, number of differing values,
    number of differing choices)."""
    from mulactseg_tpu_torch.ops.segment import _round_bf16

    (planes, choice, sid2), (pplanes, pchoice, psid2) = got, want
    check(torch.equal(planes, _round_bf16(planes)),
          f"{what} values are not rounded to bf16")
    err = (planes - pplanes).abs()
    tol = BF16_ULP * torch.maximum(planes.abs(), pplanes.abs()) + 1e-38
    check(bool((err <= tol).all()),
          f"{what} values differ by more than one bf16 ulp")
    n_vals = int((planes != pplanes).sum())
    check(n_vals < 1e-3 * planes.numel(),
          f"{what}: {n_vals} of {planes.numel()} values differ")
    check(torch.equal(sid2, psid2), f"{what} retired ids differ")
    C, NB = choice.shape
    nb = NB // nimg
    blk = torch.arange(NB, device=choice.device)
    lead = (blk // nb) * hw + (blk % nb) * 4
    check(bool(((blk % nb) * 4 + choice < hw).all()),
          f"{what} choice past its image")
    differ = choice != pchoice
    q = (lead + choice.long())[differ]
    pq = (lead + pchoice.long())[differ]
    cls = torch.arange(C, device=choice.device)[:, None].expand(C, NB)[differ]
    check(bool((sid[q] == sid[lead.expand(C, NB)[differ]]).all()),
          f"{what} choice outside its leader's segment")
    gap = (probs[cls, q] - probs[cls, pq]).abs()
    gap = gap.max().item() if gap.numel() else 0.0
    check(gap <= 1e-6, f"{what} choice off the block max by {gap}")
    return err.max().item(), n_vals, int(differ.sum())


def check_prereduced_term(got, want, term, probs, sid, nimg, hw, counts,
                          what):
    """The pre-reduced group term behind K6 or K8 (got, want: the kernel's
    and the plain version's (planes, choices, retired ids); term: the
    (values, pixels) the op returned on the card; counts: the numbers of
    values and choices in which got and want differ).
    1. K5 on the card's planes and retired ids is bitwise equal to its
       plain version, and the op's output is exactly K5's winners mapped
       back through the card's choices: K5 and the map back are exact.
    2. Against the plain chain (prereduce_plain, segment_max_plain, map
       back): absent sets equal, maxima within one bf16 ulp, and each
       argmax pixel equal, or a pixel of the same segment whose float32
       probability is within one bf16 ulp of the plain pick's (a value that
       rounded the other way can move the first maximum among bf16 ties).
    Returns the number of maxima and pixels that differ from the plain
    chain."""
    from mulactseg_tpu_torch.ops.segment import _pixel_of_row
    from mulactseg_tpu_torch.ops.segment_max import (
        seg_max_fwd,
        segment_max_plain,
    )

    (planes, choice, sid2), (pplanes, pchoice, psid2) = got, want
    vals, pix = term
    S, C = vals.shape
    P = nimg * hw
    kv, krow = seg_max_fwd(planes.t(), sid2, S)
    pv, prow = segment_max_plain(planes.t(), sid2, S)
    torch.cuda.synchronize()
    check(torch.equal(krow, prow) and torch.equal(kv.view(torch.int32),
                                                  pv.view(torch.int32)),
          f"K5 behind {what} differs from its plain version")
    check(torch.equal(vals.view(torch.int32), kv.view(torch.int32))
          and torch.equal(pix, _pixel_of_row(krow, choice, nimg, hw)),
          f"the group term behind {what} is not K5's winners mapped back")
    wv, wrow = segment_max_plain(pplanes.t(), psid2, S)
    wpix = _pixel_of_row(wrow, pchoice, nimg, hw)
    absent = pix == P
    check(torch.equal(absent, wpix == P) and bool(absent.any())
          and bool((~absent).any()),
          f"the group term behind {what}: absent sets differ")
    check(bool(((vals - wv).abs() <= BF16_ULP * torch.maximum(vals, wv)
                + 1e-38).all()),
          f"the group term behind {what}: maxima off by more than a bf16 ulp")
    cls = torch.arange(C, device=pix.device).expand(S, C)
    q, wq = pix.clamp(max=P - 1).long(), wpix.clamp(max=P - 1).long()
    pq, pw = probs[cls, q], probs[cls, wq]
    differ = pix != wpix
    near = (pq - pw).abs() <= BF16_ULP * torch.maximum(pq, pw) + 1e-38
    check(bool((near | ~differ).all()),
          f"the group term behind {what}: an argmax pixel is off the max")
    seg = torch.arange(S, device=pix.device)[:, None].expand(S, C)
    check(torch.equal(sid[q[~absent]], seg[~absent]),
          f"the group term behind {what}: argmax outside its segment")
    # a maximum can differ only through a differing value, a pixel only
    # through a differing value or choice, each at most one entry
    n_vals, n_pix = int((vals != wv).sum()), int(differ.sum())
    check(n_vals <= counts[0] and n_pix <= counts[0] + counts[1],
          f"the group term behind {what}: {n_vals} maxima and {n_pix} "
          f"pixels differ, from {counts} differing values and choices")
    return n_vals, n_pix


def large_kernel_checks(logits, batch, dev):
    """K6 at the stage-1 shapes with nseg 4096 (S = 16,384), then K7 and K8
    on the logits as pre-scaled (P, C) rows and K9 and K10 on them as
    rows, each against its plain version and timed beside it. Returns the
    kernels-line rows, the row inputs (rows, scaled rows, ids, bits) and
    K4's max abs error on the pre-reduced term's outputs."""
    from mulactseg_tpu_torch.ops import pixel_loss, segment
    from mulactseg_tpu_torch.ops.segment_max import (
        seg_max_fwd,
        segment_max_plain,
    )

    HW, P, C = H * W, B * H * W, NUM_CLASSES
    S = B * NSEG_LARGE
    temp = 0.1
    xc = logits.reshape(B, C, HW).contiguous()
    bits3, n_cand, sid3 = stage1_ids(batch, dev, NSEG_LARGE)
    sid = sid3.reshape(P)
    n_live = int((n_cand > 0).sum())
    n_valid = int((n_cand > 1).sum())
    row_bytes = C * 4
    # K6 and K8 write dense planes, choices and ids, so they need every
    # pixel's logits: read logits and ids, write planes, ids and choices
    def pre_bytes(nblocks):
        return 2 * P * row_bytes + 2 * P * 4 + nblocks * C * 4
    rows = []

    # K6, then the pre-reduced group term it feeds (K6, K5, map back)
    sid2d = sid3.reshape(B, HW)
    got = segment.prereduce_softmax_nchw(xc, sid3, S, temp)
    want = segment.prereduce_plain(xc, sid2d, S, temp)
    probs = segment._softmax(xc, temp).permute(1, 0, 2).reshape(C, P)
    torch.cuda.synchronize()
    err, *counts = check_prereduce(got, want, probs, sid, B, HW, "K6")
    pre_vals, pre_pix = segment._ssm_prereduced(xc, sid3, S, temp)
    term = check_prereduced_term(got, want, (pre_vals, pre_pix), probs, sid,
                                 B, HW, counts, "K6")
    print(f"K6: values within one bf16 ulp of the plain version; "
          f"{counts[0]} of {want[0].numel()} values and {counts[1]} of "
          f"{want[1].numel()} choices differ (each a near-tie). K6 -> K5 -> "
          f"map back: K5 bitwise; against the plain chain {term[0]} maxima "
          f"and {term[1]} argmax pixels of {S * C} differ (near-ties)",
          flush=True)
    # K6 on its 4-byte path too: the logits one float into a larger
    # storage (HW % 4 == 0, but not 16-byte aligned); bitwise the same
    store = torch.empty(xc.numel() + 1, device=dev)
    store[1:] = xc.reshape(-1)
    xu = store[1:].view(B, C, HW)
    check(segment.prereduce_instance(xc, sid3) == (C, True)
          and segment.prereduce_instance(xu, sid3) == (C, False),
          "K6 instances: want the C = 20 one, 16-byte path on the model's "
          "logits, 4-byte path on the shifted copy")
    got_u = segment.prereduce_softmax_nchw(xu, sid3, S, temp)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, got_u)),
          "K6 differs between its 16-byte and 4-byte paths")
    print(json.dumps({"prereduce_4byte_path": {
        "K6_ms": time_ms(lambda: segment.prereduce_softmax_nchw(
            xu, sid3, S, temp), graph=True)}}), flush=True)
    del store, xu, got_u
    # K5 where the stage-1 step runs it: on K6's planes under the retired
    # ids (S = 16,384), bitwise against its plain version
    planes, sid2 = got[0], got[2]
    kv, krow = seg_max_fwd(planes.t(), sid2, S)
    pv, prow = segment_max_plain(planes.t(), sid2, S)
    torch.cuda.synchronize()
    check(torch.equal(krow, prow) and torch.equal(kv.view(torch.int32),
                                                  pv.view(torch.int32)),
          "K5 on K6's planes differs from its plain version")
    n_k5 = int((sid2 < S).sum())
    k6_planes_row = (f"seg_max_fwd@K6's planes, nseg {NSEG_LARGE}",
                     (kv - pv).abs().max().item(),
                     time_ms(lambda: seg_max_fwd(planes.t(), sid2, S),
                             graph=True),
                     time_ms(lambda: segment_max_plain(planes.t(), sid2, S)),
                     bound(P * 4 + n_k5 * row_bytes + S * C * 8, n_k5 * C),
                     None)
    print(f"K5 on K6's planes: bitwise; {n_k5} of {P} pixels valid under the "
          f"retired ids", flush=True)
    del got, want, probs, planes, sid2, kv, krow, pv, prow
    # K4 on the pre-reduced term's outputs, the backward of this path
    target = torch.as_tensor(batch["target"]).to(dev)
    _, k4_err = check_k4(xc, sid3, pre_vals, pre_pix,
                         group_cotangent(pre_vals, pre_pix, target, P), temp,
                         "K4 on the pre-reduced term")
    print(f"K4 on the pre-reduced term (nseg {NSEG_LARGE}): max abs err "
          f"{k4_err}", flush=True)
    rows.append(("prereduce_nchw", err,
                 time_ms(lambda: segment.prereduce_softmax_nchw(
                     xc, sid3, S, temp), graph=True),
                 time_ms(lambda: segment.prereduce_plain(xc, sid2d, S,
                                                         temp)),
                 bound(pre_bytes(B * -(-HW // 4)), 12 * P * C), None))
    rows.append(k6_planes_row)

    # the logits as (P, C) rows, the row-major ops' layout
    x2d = logits.permute(0, 2, 3, 1).reshape(P, C).contiguous()
    scaled = x2d / temp
    bits = bits3.reshape(P)

    # the rows one float into a larger storage: K7's and K10's 4-byte
    # instances
    store = torch.empty(2 * P * C + 2, device=dev)
    store[1:P * C + 1] = x2d.reshape(-1)
    store[P * C + 2:] = scaled.reshape(-1)
    x2d_u = store[1:P * C + 1].view(P, C)
    scaled_u = store[P * C + 2:].view(P, C)
    check(segment.rows_instance(scaled) == (C, True)
          and segment.rows_instance(scaled_u) == (C, False)
          and pixel_loss.rows_instance(x2d, bits) == (C, True)
          and pixel_loss.rows_instance(x2d_u, bits) == (C, False),
          "K7/K10 instances: want the C = 20 ones, 16-byte units on the "
          "rows, 4-byte units on the shifted copies")
    four_byte = {}

    # K7: against its plain version, bitwise against the class-order
    # reference, and the same bits on both instances
    vals, pix = segment.ssm_rows_fwd(scaled, sid, S)
    pvals, ppix = segment.ssm_rows_fwd_plain(scaled, sid, S)
    uvals, upix = segment.ssm_rows_fwd(scaled_u, sid, S)
    torch.cuda.synchronize()
    absent = pix == P
    check(bool((pix < P).any() and absent.any()), "K7: no present or no "
          "absent entry")
    check(torch.equal(absent, ppix == P), "K7 absent sets differ")
    check(bool((vals[absent] == 0).all()), "K7 absent value is not 0.0")
    err = (vals - pvals).abs().max().item()
    check(err <= 1e-6, f"K7 max values differ by {err}")
    probs = torch.softmax(segment._round_bf16(scaled), dim=1)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    tie_err = (probs[q, cls] - pvals[~absent]).abs().max().item()
    check(tie_err <= 1e-6, f"K7 argmax pixel off the max by {tie_err}")
    check(bool((sid[q] == torch.arange(S, device=dev)[:, None]
                .expand(S, C)[~absent]).all()), "K7 argmax outside segment")
    del probs
    cvals, cpix = segment.segment_max_plain(class_order_softmax(scaled),
                                            sid, S)
    check(torch.equal(pix, cpix) and torch.equal(vals.view(torch.int32),
                                                 cvals.view(torch.int32)),
          "K7 differs bitwise from the class-order reference")
    check(torch.equal(pix, upix) and torch.equal(vals.view(torch.int32),
                                                 uvals.view(torch.int32)),
          "K7 differs between its 16-byte and 4-byte instances")
    del cvals, cpix
    four_byte["K7_ms"] = time_ms(
        lambda: segment.ssm_rows_fwd(scaled_u, sid, S), graph=True)
    del uvals, upix
    rows.append(("ssm_rows_fwd", err,
                 time_ms(lambda: segment.ssm_rows_fwd(scaled, sid, S),
                         graph=True),
                 time_ms(lambda: segment.ssm_rows_fwd_plain(scaled, sid, S)),
                 bound(P * 4 + n_valid * row_bytes + S * C * 8,
                       8 * n_valid * C),
                 None))

    # K8, then the row op's pre-reduced branch (K8, K5, map back)
    got = segment.prereduce_softmax_rows(scaled, sid, S)
    want = segment.prereduce_plain(scaled.t()[None], sid[None], S, 1.0)
    probs = torch.softmax(scaled, dim=1).t()
    torch.cuda.synchronize()
    err, *counts = check_prereduce(got, want, probs, sid, 1, P, "K8")
    with torch.no_grad():
        out = segment.segment_softmax_max(scaled, sid, S, prereduce=True)
    term = check_prereduced_term(got, want, out, probs, sid, 1, P, counts,
                                 "K8")
    print(f"K8: values within one bf16 ulp of the plain version; "
          f"{counts[0]} of {want[0].numel()} values and {counts[1]} of "
          f"{want[1].numel()} choices differ (each a near-tie). K8 -> K5 -> "
          f"map back: K5 bitwise; against the plain chain {term[0]} maxima "
          f"and {term[1]} argmax pixels of {S * C} differ (near-ties)",
          flush=True)
    del got, want, probs, out
    rows.append(("prereduce_rows", err,
                 time_ms(lambda: segment.prereduce_softmax_rows(
                     scaled, sid, S), graph=True),
                 time_ms(lambda: segment.prereduce_plain(
                     scaled.t()[None], sid[None], S, 1.0)),
                 bound(pre_bytes(-(-P // 4)), 12 * P * C), None))

    # K9
    got = pixel_loss.pixel_ce_rows_fwd(x2d, bits, temp)
    want = pixel_loss.pixel_ce_fwd_plain(x2d.t()[None], bits[None, None],
                                         temp)
    torch.cuda.synchronize()
    check(torch.equal(got[1::2], want[1::2]),
          f"K9 counts differ: {got.tolist()} vs {want.tolist()}")
    check(torch.allclose(got[0::2], want[0::2], rtol=1e-5, atol=0),
          f"K9 sums differ: {got.tolist()} vs {want.tolist()}")
    rows.append(("pixel_ce_rows_fwd", (got - want).abs().max().item(),
                 time_ms(lambda: pixel_loss.pixel_ce_rows_fwd(x2d, bits,
                                                              temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd_plain(
                     x2d.t()[None], bits[None, None], temp)),
                 bound(P * 4 + n_live * row_bytes + 16, 8 * n_live * C),
                 None))

    # K10, with the cotangents the loss gives (coeff / (1 + count))
    g = torch.stack([16.0 / (1.0 + want[1]), 8.0 / (1.0 + want[3])]
                    ).float().contiguous()
    got = pixel_loss.pixel_ce_rows_bwd(x2d, bits, g, temp)
    want_dl = pixel_loss.pixel_ce_bwd_plain(x2d.t()[None], bits[None, None],
                                            g, temp)[0].t()
    got_u = pixel_loss.pixel_ce_rows_bwd(x2d_u, bits, g, temp)
    torch.cuda.synchronize()
    err = (got - want_dl).abs().max().item()
    scale = want_dl.abs().max().item()
    check(scale > 0 and err <= 1e-6 * scale,
          f"K10 dl differs: max abs err {err} vs max |dl| {scale}")
    check(torch.equal(got.view(torch.int32), got_u.view(torch.int32)),
          "K10 differs between its 16-byte and 4-byte instances")
    del got, want_dl, got_u
    four_byte["K10_ms"] = time_ms(
        lambda: pixel_loss.pixel_ce_rows_bwd(x2d_u, bits, g, temp),
        graph=True)
    print(json.dumps({"rows_4byte_path": four_byte}), flush=True)
    del store, x2d_u, scaled_u
    rows.append(("pixel_ce_rows_bwd", err,
                 time_ms(lambda: pixel_loss.pixel_ce_rows_bwd(x2d, bits, g,
                                                              temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_bwd_plain(
                     x2d.t()[None], bits[None, None], g, temp)),
                 bound(P * 4 + n_live * row_bytes + P * row_bytes + 8,
                       12 * n_live * C),
                 None))
    return rows, (x2d, scaled, sid, bits), k4_err


def row_op_pass(x2d, scaled, sid, bits):
    """One autograd pass through each row-major op with every counter at 0
    just before: segment_softmax_max (K7), the same with prereduce=True (K8
    then K5) and pixel_partial_ce (K9, K10). Each loss must equal the one
    its plain versions give on the same rows (rtol 1e-5; the pre-reduced
    values may round a near-tie the other way, which moves a mean over
    ~10^5 entries far less), and each gradient must be finite and
    non-zero. Returns the launch counts and the losses."""
    from mulactseg_tpu_torch.ops import _build, pixel_loss, segment
    from mulactseg_tpu_torch.ops.segment_max import segment_max_plain

    P, S = x2d.shape[0], B * NSEG_LARGE

    def group_loss(mx, pix):
        present = pix < P
        return -(torch.log(mx + 1e-8) * present).sum() / (1.0 + present.sum())

    def ce_loss(sums):
        return 16.0 * sums[0] / (1.0 + sums[1]) + 8.0 * sums[2] / (
            1.0 + sums[3])

    torch.cuda.synchronize()
    _build.reset_launches()
    out = {}
    for name, prereduce in (("segment_softmax_max", False),
                            ("segment_softmax_max prereduce", True)):
        u = scaled.detach().requires_grad_(True)
        loss = group_loss(*segment.segment_softmax_max(
            u, sid, S, prereduce=prereduce))
        loss.backward()
        out[name] = (loss.detach(), u.grad)
    x = x2d.detach().requires_grad_(True)
    loss = ce_loss(pixel_loss.pixel_partial_ce(x, bits, 0.1))
    loss.backward()
    out["pixel_partial_ce"] = (loss.detach(), x.grad)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches == {k: 1 for k in ROW_OP_KERNELS},
          f"row-op launches {launches}, want one each of {ROW_OP_KERNELS}")

    planes, choice, sid2 = segment.prereduce_plain(scaled.t()[None],
                                                   sid[None], S, 1.0)
    v8, r8 = segment_max_plain(planes.t(), sid2, S)
    want = {"segment_softmax_max": group_loss(*segment.ssm_rows_fwd_plain(
                scaled, sid, S)),
            "segment_softmax_max prereduce": group_loss(v8, r8),
            "pixel_partial_ce": ce_loss(pixel_loss.pixel_ce_fwd_plain(
                x2d.t()[None], bits[None, None], 0.1))}
    losses = {}
    for name, (loss, grad) in out.items():
        losses[name] = float(loss)
        check(math.isclose(losses[name], float(want[name]), rel_tol=1e-5)
              and losses[name] > 0,
              f"{name}: loss {losses[name]} vs plain {float(want[name])}")
        check(bool(torch.isfinite(grad).all()) and grad.abs().max() > 0,
              f"{name}: bad gradient")
    return launches, losses


def small_reference_check(dev, h=96, w=80, nseg=24):
    """lossdecomp_fused on the card against the CPU on one small input:
    loss and parts within rtol 1e-5, every gradient entry within 1e-5 of
    the largest. Past the K3 guard (2 * nseg + 1 > 9216) the group term is
    pre-reduced: the card must launch K6 and no K3. A K6 value next to a
    bf16 rounding boundary may round the other way on the card than on the
    CPU; that may move the gradient of its own segment only, so an entry
    outside the tolerance must lie in a segment that holds such a value
    (with none, every entry must be inside it). Returns (entries outside
    the tolerance, K6 values that round differently)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.fused import (
        _popcount,
        lossdecomp_fused,
        pixel_target_bits,
    )
    from mulactseg_tpu_torch.ops import _build, segment

    rng = np.random.RandomState(5)
    b, c = 2, NUM_CLASSES
    prereduced = b * nseg + 1 > segment.SCATTER_MAX_SEGMENTS
    spx = np.stack([irregular_superpixels(h, w, nseg, rng)
                    for _ in range(b)]).astype(np.int32)
    target = (rng.rand(b, nseg, c) < 0.15).astype(np.float32)
    spmask = np.take_along_axis(rng.rand(b, nseg) < 0.6, spx.reshape(b, -1),
                                axis=1).reshape(b, h, w)
    bits = np.stack([pixel_target_bits(target[i], spx[i], spmask[i])
                     for i in range(b)])
    logits = (rng.randn(b, c, h, w) * 3).astype(np.float32)
    out = {}
    _build.reset_launches()
    for d in ("cpu", dev):
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        total, aux = lossdecomp_fused(
            x, torch.from_numpy(bits).to(d), torch.from_numpy(target).to(d),
            torch.from_numpy(spx).to(d), nseg=nseg)
        total.backward()
        out[str(d)] = ({k: float(v.detach()) for k, v in aux.items()},
                       x.grad.cpu())
    torch.cuda.synchronize()
    want = STAGE1_LARGE_KERNELS if prereduced else STAGE1_KERNELS
    check(dict(_build.LAUNCHES) == {k: 1 for k in want},
          f"small lossdecomp launches {dict(_build.LAUNCHES)}, want {want}")
    (ref, gref), (got, ggot) = out["cpu"], out[str(dev)]
    for k in ref:
        check(math.isclose(ref[k], got[k], rel_tol=1e-5) and ref[k] > 0,
              f"small lossdecomp {k}: card {got[k]} vs cpu {ref[k]}")
    bad = (ggot - gref).abs() > 1e-5 * gref.abs().max()
    hw, S = h * w, b * nseg
    may_differ = torch.zeros(b * hw, dtype=torch.bool)
    flips = 0
    if prereduced:
        # the group term's ids as lossdecomp_fused makes them
        bt = torch.from_numpy(bits).reshape(b * hw).long()
        sid = torch.where(_popcount(bt & ((1 << c) - 1)) > 1,
                          torch.from_numpy(spx).reshape(-1).long()
                          + torch.arange(b).repeat_interleave(hw) * nseg, S)
        xc = torch.from_numpy(logits).reshape(b, c, hw)
        sid3 = sid.int().reshape(b, 1, hw)
        cpu_planes, _, sid2 = segment.prereduce_softmax_nchw(xc, sid3, S,
                                                             0.1)
        card_planes = segment.prereduce_softmax_nchw(
            xc.to(dev), sid3.to(dev), S, 0.1)[0].cpu()
        flipped = (card_planes != cpu_planes) & (sid2 < S)
        flips = int(flipped.sum())
        touched = torch.zeros(S + 1, dtype=torch.bool)
        touched[sid[flipped.any(dim=0)]] = True
        may_differ = touched[sid]
    bad_pix = bad.permute(0, 2, 3, 1).reshape(b * hw, c).any(dim=1)
    check(not bool((bad_pix & ~may_differ).any()),
          f"small lossdecomp gradient: {int(bad.sum())} entries differ, "
          f"{int((bad_pix & ~may_differ).sum())} pixels outside the "
          f"segments of the {flips} values that round differently")
    return int(bad.sum()), flips


def run_steps(step, batches, warmup, timed):
    """warmup steps, then `timed` ones in windows of WINDOW steps (the
    last window shorter), each timed to a synchronise at its end.
    Returns (the last step's losses as floats, window seconds, steps
    per window)."""
    for i in range(warmup):
        aux = step(batches[i % len(batches)])
    torch.cuda.synchronize()
    window_s, sizes, done = [], [], 0
    while done < timed:
        n = min(WINDOW, timed - done)
        ts = time.perf_counter()
        for i in range(n):
            aux = step(batches[i % len(batches)])
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - ts)
        sizes.append(n)
        done += n
    return {k: float(v) for k, v in aux.items()}, window_s, sizes


def zoo_eval_check(name, model, variables, dev):
    """Eval logits of `model` (seeded weights `variables`) on the card
    against the same model on the CPU, one ZOO_EVAL_HW image, float32 with
    TF32 off: max abs error over the largest |logit|."""
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model

    cpu = get_model(name, NUM_CLASSES, 16, separable_conv=True,
                    device="cpu")
    convert.load_variables(cpu, variables)
    x = torch.from_numpy(np.random.RandomState(21).randn(
        1, 3, *ZOO_EVAL_HW).astype(np.float32))
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            model.eval()
            got = model(x.to(dev)).cpu()
            want = cpu.eval()(x)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = flags
        model.train()
    check(got.shape == (1, NUM_CLASSES, *ZOO_EVAL_HW)
          and bool(torch.isfinite(got).all()), f"{name}: bad eval logits")
    return (got - want).abs().max().item() / want.abs().max().item()


def zoo_slice(dev, smi, batches):
    """The six models the port added last (ZOO_NAMES), each at full width
    from its own seeded weights: eval logits on the card against the CPU,
    then ZOO_WARMUP + ZOO_TIMED stage-1 steps of the recipe's fused
    lossdecomp at batch B, HxW, nseg NSEG, bf16, counted (K1-K4 once a
    step). Returns (the zoo line, launches)."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build

    out, launches = {}, Counter()
    steps = ZOO_WARMUP + ZOO_TIMED
    for i, name in enumerate(ZOO_NAMES):
        cfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG,
                     crop_size=(H, W), train_batch_size=B, dtype="bfloat16",
                     separable_conv=True, model=name,
                     method="active_joint_multi_predignore_lossdecomp")
        model = get_model(name, cfg.num_model_classes, cfg.output_stride,
                          separable_conv=cfg.separable_conv, device=dev)
        variables = convert.random_variables(model, seed=100 + i)
        convert.load_variables(model, variables)
        err = zoo_eval_check(name, model, variables, dev)
        step = make_train_step(model, cfg, device=dev,
                               generator=torch.Generator(dev).manual_seed(0))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        losses, window_s, sizes = run_steps(step, batches, ZOO_WARMUP,
                                            ZOO_TIMED)
        got = dict(_build.LAUNCHES)
        want = {**{k: steps for k in STAGE1_KERNELS},
                **bn_launches(model, steps)}
        check(got == want, f"{name}: launches {got}, want {want} (K1-K4 "
              "once a step, each BN kernel once a BN and step)")
        check(all(math.isfinite(v) for v in losses.values()),
              f"{name}: non-finite loss {losses}")
        check(err <= ZOO_EVAL_RTOL,
              f"{name}: card eval logits off the CPU's by {err} of the "
              "largest")
        launches += Counter(got)
        dt = sum(window_s)
        out[name] = {
            "params": sum(p.numel() for p in model.parameters()),
            "step_ms": dt / ZOO_TIMED * 1e3, "img_per_s": B * ZOO_TIMED / dt,
            "window_step_ms": [t / n * 1e3 for t, n in zip(window_s, sizes)],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "eval_rel_err_vs_cpu": err, **losses}
        print(f"zoo {name}: {json.dumps(out[name])}", flush=True)
        del step, model
        torch.cuda.empty_cache()
    return {"zoo": out, "card": smi, "batch": B, "crop": [H, W],
            "nseg": NSEG, "steps": steps, "timed_steps": ZOO_TIMED}, launches


# criteria beside the recipe's: (case, method, Config overrides, K5
# launches per image and step); the ablation's rand_multi_ce samples
CRITERIA_CASES = (
    ("joint_predignore", "active_joint_multi_predignore", {}, 1),
    ("joint", "active_joint_multi", {}, 1),
    ("mclossablation2", "active_joint_multi_predignore_mclossablation2", {},
     1),
    ("precise", "active_joint_multi_predignore_precise", {}, 1),
    ("multice_precise", "active_joint_multi_predignore_multice_precise", {},
     0),
    ("multient", "active_joint_multi_predignore_multient", {}, 1),
    ("exclusivece", "active_joint_multi_predignore_exclusivece", {}, 1),
    ("lossdecomp_rc", "active_joint_multi_lossdecomp_rc", {}, 1),
    ("lossdecomp_topone", "active_joint_multi_lossdecomp_topone", {}, 1),
    ("pwce", "active_pwce_multi_predignore", {}, 1),
    ("top1plbl", "active_joint_multi_predignore_top1plbl", {}, 1),
    ("mclossablation", "active_joint_multi_predignore_mclossablation", {},
     1),
    ("lscale", "active_joint_multi_predignore_lscale", {}, 1),
    ("wgroup", "active_joint_multi_predignore_wgroup", {}, 2),
    ("ablation", "active_joint_multi_ablation",
     {"loss_type": "rand_multi_ce"}, 1),
    ("sequence", "active_joint_multi_predignore_sequence", {}, 1),
    ("logprecision", "active_joint_multi_predignore_logprecision", {}, 1),
    ("lossdecomp_unfused", "active_joint_multi_predignore_lossdecomp", {},
     1),
)
# the criteria that read more than a region batch (more_regions' keys)
MORE_CRITERIA_CASES = (
    ("onlineplbl", "active_onlineplbl_multi_predignore", {"dorampup": True},
     1),
    ("onlinewplbl", "active_onlinewplbl_multi_predignore", {}, 1),
    ("onlinesimwplbl", "active_onlinesimwplbl_multi_predignore", {}, 1),
    ("onlinewplblonly", "active_onlinewplblonly_multi_predignore", {}, 1),
    ("onlineplbl_domc", "active_onlineplbl_multi_predignore_domc", {}, 2),
    ("onlinesimwplbl_domc", "active_onlinesimwplbl_multi_predignore_domc", {},
     2),
    ("hier", "active_joint_hier_multi", {}, 1),
    ("hier_async", "active_joint_hier_multi_async", {}, 1),
    ("hier_async_weight", "active_joint_hier_multi_async_weight", {}, 2),
    ("mseg", "active_joint_multi_predignore_mseg",
     {"nseg_list": MSEG_LEVELS}, len(MSEG_LEVELS)),
)
SLICED = ("active_joint_multi", "active_joint_multi_ablation",
          "active_joint_hier_multi", "active_joint_hier_multi_async",
          "active_joint_hier_multi_async_weight")


def criteria_batch(batch, method, case):
    """A stage-1 batch for `case`: spmask and labels added; the targets
    given the extra (undefined) channel where the criterion slices it
    off; no target bits for the unfused fallback."""
    out = dict(batch)
    if method in SLICED:
        t = out["target"]
        out["target"] = np.concatenate(
            [t, np.zeros(t.shape[:-1] + (1,), t.dtype)], axis=-1)
    if case == "lossdecomp_unfused":
        del out["target_bits"]
    return out


def with_regions(batches, seed):
    """make_batches' batches with a selection mask and labels (random
    classes, 10% 255). The mask is the pixels whose target bits are set:
    the 50% selection of superpixels, less the ~4% of them with no
    candidate (make_batches keeps no other record of the selection)."""
    rng = np.random.RandomState(seed)
    out = []
    for b in batches:
        labels = rng.randint(0, NUM_CLASSES, b["spx"].shape).astype(np.int32)
        labels[rng.rand(*labels.shape) < 0.1] = 255
        out.append({**b, "spmask": b["target_bits"] != 0, "labels": labels})
    return out


def more_regions(batches, seed):
    """with_regions' batches with what the criteria of
    MORE_CRITERIA_CASES read: spx_small, the finer map (SMALL_NSEG
    irregular superpixels); the weak view of each image uncut at WEAK_HW (uint8 images_weak, its own
    spx_weak and spx_small_weak maps, spmask_weak over the superpixels the
    strong view selects); and the mixed-scale levels MSEG_LEVELS stacked
    (mseg_spx, mseg_spmask, mseg_target_<i>: the batch's own at nseg NSEG,
    50% selected and 15% candidates at the coarser levels)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels

    rng = np.random.RandomState(seed)
    maps = lambda h, w, n: np.stack([irregular_superpixels(h, w, n, rng)
                                     for _ in range(B)]).astype(np.int32)
    out = []
    for b in batches:
        sel = np.zeros((B, NSEG + 1), bool)
        for i in range(B):
            sel[i, np.unique(b["spx"][i][b["spmask"][i]])] = True
        spx_weak = maps(*WEAK_HW, NSEG)
        extra = {"spx_small": maps(H, W, SMALL_NSEG),
                 "images_weak": rng.randint(0, 256, (B, 3) + WEAK_HW).astype(
                     np.uint8),
                 "spx_weak": spx_weak,
                 "spmask_weak": np.take_along_axis(
                     sel, spx_weak.reshape(B, -1), 1).reshape(B, *WEAK_HW),
                 "spx_small_weak": maps(*WEAK_HW, SMALL_NSEG)}
        spx_levels, mask_levels = [], []
        for i, n in enumerate(MSEG_LEVELS):
            if n == NSEG:
                spx, mask, target = b["spx"], b["spmask"], b["target"]
            else:
                spx = maps(H, W, n)
                mask = np.take_along_axis(rng.rand(B, n) < 0.5,
                                          spx.reshape(B, -1),
                                          1).reshape(B, H, W)
                target = (rng.rand(B, n, NUM_CLASSES) < 0.15).astype(
                    np.float32)
            spx_levels.append(spx)
            mask_levels.append(mask)
            extra[f"mseg_target_{i}"] = target
        extra["mseg_spx"] = np.stack(spx_levels, axis=1)
        extra["mseg_spmask"] = np.stack(mask_levels, axis=1)
        out.append({**b, **extra})
    return out


def k5_row(label, planes, ids, mask, nseg, dev):
    """K5 at one instance: (P, C) planes under the host ids `ids` where
    `mask`, nseg elsewhere; held bitwise against its plain version
    (check_k5) and timed, with its bytes bound over the valid pixels.
    Returns the kernels-line row."""
    from mulactseg_tpu_torch.ops import segment_max

    sid = torch.from_numpy(np.where(mask, ids, nseg).astype(
        np.int32)).to(dev)
    err = check_k5(planes, sid, label.partition("@")[2], nseg)
    P, C = planes.shape
    n_valid = int((sid < nseg).sum())
    out = (label, err,
           time_ms(lambda: segment_max.seg_max_fwd(planes, sid, nseg),
                   graph=True),
           time_ms(lambda: segment_max.segment_max_plain(planes, sid, nseg)),
           bound(P * 4 + n_valid * C * 4 + nseg * C * 8, n_valid * C),
           None)
    print(f"K5 at {label.partition('@')[2]} bitwise equal to its plain "
          f"version; {n_valid} of {P} pixels valid; {out[2]:.4f} ms "
          f"(bound {out[4][0]:.4f})", flush=True)
    return out


def k5_instances(model, variables, dev, b0):
    """K5 held bitwise against its plain version and timed at the three
    instances of the criteria phase, on the first batch from the seeded
    weights: the group term's (one image's softmax planes at T = 0.1 under
    the ids of its selected superpixels, about half); the async
    criteria's weak view (one uncut 1024x2048 image's planes under its
    2,048 superpixels' ids) and the weight's max over its fine map (the
    same planes under SMALL_NSEG ids), which no other path runs. Returns
    their kernels-line rows."""
    from mulactseg_tpu_torch.engine.train import _device_normalize
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.ops import segment_max

    C = NUM_CLASSES
    convert.load_variables(model, variables)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(_device_normalize(
            torch.as_tensor(b0["images"]).to(dev)))
    planes = torch.softmax(logits[0].float().reshape(C, H * W) / 0.1,
                           dim=0).t()
    del logits
    check(segment_max.layout(planes) == segment_max.PLANES,
          "the group term's planes do not take K5's PLANES path")
    rows = [k5_row("seg_max_fwd@group term, 768x768 image", planes,
                   b0["spx"][0].reshape(-1), b0["spmask"][0].reshape(-1),
                   NSEG, dev)]
    convert.load_variables(model, variables)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model.eval()
        logits = model(_device_normalize(torch.as_tensor(
            b0["images_weak"][:1]).to(dev)))
        model.train()
    planes = torch.softmax(logits.float().reshape(C, -1) / 0.1, dim=0).t()
    del logits
    check(segment_max.layout(planes) == segment_max.PLANES,
          "the weak view's planes do not take K5's PLANES path")
    mask_w = b0["spmask_weak"][0].reshape(-1)
    rows += [k5_row("seg_max_fwd@async weak view, 1024x2048", planes,
                    b0["spx_weak"][0].reshape(-1), mask_w, NSEG, dev),
             k5_row("seg_max_fwd@fine map, 8192 segments", planes,
                    b0["spx_small_weak"][0].reshape(-1), mask_w,
                    SMALL_NSEG, dev)]
    return rows


def prototype_counts(model, dev, b0):
    """The online criteria's (superpixel, class) prototype candidates per
    image of the first batch, from its eval forward, and how many the
    256-slot cap drops (it keeps the first)."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import _device_normalize
    from mulactseg_tpu_torch.losses import online

    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        model.eval()
        feat, plbl_logits = model(_device_normalize(torch.as_tensor(
            b0["images"]).to(dev)), return_feat=True)
        model.train()
    probs = torch.softmax(plbl_logits.float().reshape(B, NUM_CLASSES, -1)
                          / Config().group_ce_temp, dim=1)
    candidates = [int(online.prototypes(
        feat[i].reshape(feat.shape[1], -1).t(), probs[i].t(),
        torch.as_tensor(b0["target"][i]).to(dev),
        torch.as_tensor(b0["spx"][i]).to(dev),
        torch.as_tensor(b0["spmask"][i]).to(dev), nseg=NSEG).candidates)
        for i in range(B)]
    protos = {"candidates": candidates,
              "dropped_by_cap": [max(0, n - 256) for n in candidates]}
    print(f"online prototypes per image: {protos}", flush=True)
    return protos


def criteria_slice(model, variables, dev, smi, batches):
    """Every criterion beside the recipe's (CRITERIA_CASES and
    MORE_CRITERIA_CASES) on the recipe model at the stage-1 shape, on
    more_regions' batches (a criterion
    moves to the card only the keys it reads), from the seeded weights
    each time: K5 held and timed at its three instances first
    (k5_instances), the online criteria's prototypes counted
    (prototype_counts), then each criterion's steps with every launch
    counter set to 0 just before and read just after (K5 its count per
    image and step, K1-K4 never), SGD with the constant schedule once.
    Returns (the criteria line, launches, K5's kernels-line rows)."""
    from mulactseg_tpu_torch.models import convert

    batches = more_regions(with_regions(batches, 13), 17)
    rows = k5_instances(model, variables, dev, batches[0])
    protos = prototype_counts(model, dev, batches[0])

    out, launches = {}, Counter()
    runs = list(CRITERIA_CASES + MORE_CRITERIA_CASES) + [
        ("joint_predignore_sgd_constant", "active_joint_multi_predignore",
         {"optimizer": "sgd", "scheduler": "constant"}, 1)]
    for case, method, over, k5 in runs:
        warmup, timed = ((WARMUP, TIMED) if case == "joint_predignore"
                         else (CRIT_WARMUP, CRIT_TIMED))
        out[case], got, step = run_criterion(
            model, variables, dev, case, method, over, k5, batches, warmup,
            timed)
        if over.get("scheduler") == "constant":
            cfg = step.cfg
            lrs = [g["lr"] for g in step.optimizer.param_groups]
            check(lrs == [cfg.train_lr, cfg.train_lr * cfg.cls_lr_scale]
                  and isinstance(step.optimizer, torch.optim.SGD),
                  f"SGD with the constant schedule: lrs {lrs}")
        launches += Counter(got)
        del step
    convert.load_variables(model, variables)
    torch.cuda.empty_cache()
    return {"criteria": out, "online_prototypes": protos, "card": smi,
            "batch": B, "crop": [H, W], "nseg": NSEG}, launches, rows


def run_criterion(model, variables, dev, case, method, over, k5, batches,
                  warmup, timed):
    """One criterion on the recipe model from the seeded weights:
    warmup + timed steps on criteria_batch's batches, every launch counter
    set to 0 just before and read just after (K5 k5 times an image and
    step, no other kernel), finite losses. Returns (its line, launches,
    the step, with its Config as step.cfg)."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.ops import _build

    cfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                 train_batch_size=B, dtype="bfloat16", separable_conv=True,
                 method=method, small_nseg=SMALL_NSEG, **over)
    bs = [criteria_batch(b, method, case) for b in batches]
    convert.load_variables(model, variables)
    step = make_train_step(model, cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    step.cfg = cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, window_s, sizes = run_steps(step, bs, warmup, timed)
    got = dict(_build.LAUNCHES)
    steps = warmup + timed
    want = {**({"seg_max_fwd": k5 * B * steps} if k5 else {}),
            **bn_launches(model, steps)}
    check(got == want, f"criterion {case}: launches {got}, want {want}")
    check(all(math.isfinite(v) for v in losses.values()),
          f"criterion {case}: non-finite loss {losses}")
    dt = sum(window_s)
    line = {"method": method, "step_ms": dt / timed * 1e3,
            "img_per_s": B * timed / dt,
            "window_step_ms": [t / n * 1e3 for t, n in zip(window_s, sizes)],
            "k5_per_step": got.get("seg_max_fwd", 0) / steps, "steps": steps,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            **losses}
    print(f"criterion {case}: {json.dumps(line)}", flush=True)
    return line, got, step


def near_tie_pixels(probs, sid, nseg, rel=1e-6):
    """(B, P) bool: the pixels of a segment where, for some class, two
    pixels' probabilities (probs (B, C, P), compared in float64) lie
    within `rel` of the larger. sid (B, P), ids == nseg invalid. The one
    definition of a near-tie that this script and the port's tests
    exempt from argmax comparisons: two float32 softmaxes that differ in
    the last bits may pick either pixel."""
    p = torch.as_tensor(probs).double()
    B, C, P = p.shape
    sid = torch.as_tensor(sid, device=p.device).long().reshape(B, P)
    idx = sid[:, None].expand(B, C, P)
    top = p.new_zeros(B, C, nseg + 1).scatter_reduce(2, idx, p, "amax")
    near = (p >= top.gather(2, idx) * (1.0 - rel)).double()
    n = p.new_zeros(B, C, nseg + 1).scatter_add(2, idx, near)
    tie = (n[..., :nseg] >= 2).any(dim=1)
    tie = torch.cat([tie, tie.new_zeros(B, 1)], dim=1)
    return tie.gather(1, sid)


def group_term_float64(logits, target, spx, spmask, nseg, temp=0.1,
                       only_multi=False):
    """A plain float64 group_multi_label_ce (mulactseg_tpu/losses/
    partial.py:64-107, all target channels, no slicing) on numpy inputs
    (logits (B, C, H, W), target (B, S, C), spx and spmask (B, H, W)):
    (loss, d loss / d logits, unit), the witness that float32 runs of the
    group term are held against where their own rounding is the
    question. unit (B, C, H, W) is one float32 rounding unit of each
    gradient entry's operands: the softmax backward p_k (u_k - sum_j u_j
    p_j) / T, with u = d loss / d p, cancels, and each p_k carries the
    rounding of its exponent, up to max_j |x_j| / T units, so
    unit_k = 2^-24 p_k (|u_k| + sum_j |u_j| p_j) (1 + max_j |x_j| / T) / T
    (p_k at least the smallest normal float32)."""
    x = torch.from_numpy(logits).double().requires_grad_(True)
    B, C = x.shape[:2]
    p = torch.softmax(x.reshape(B, C, -1) / temp, dim=1)
    p.retain_grad()
    P = p.shape[-1]
    spx = torch.from_numpy(spx).reshape(B, P).long()
    mask = torch.from_numpy(spmask).reshape(B, P).bool()
    trg = torch.from_numpy(target).double()
    if only_multi:
        mask = mask & (trg.sum(dim=-1) > 1).gather(1, spx.clamp(0, nseg - 1))
    sid = torch.where(mask, spx, nseg)[:, None].expand(B, C, P)
    pd = p.detach()
    top = pd.new_full((B, C, nseg + 1), -1.0).scatter_reduce(2, sid, pd,
                                                             "amax")
    at = torch.where(pd == top.gather(2, sid), torch.arange(P), P)
    first = torch.full((B, C, nseg + 1), P).scatter_reduce(
        2, sid, at, "amin")[..., :nseg]
    entry = (trg.transpose(1, 2) > 0.5) & (first < P)
    nll = -torch.log(p.gather(2, first.clamp(max=P - 1)) + 1e-8)
    loss = torch.where(entry, nll, 0.0).sum() / (1.0 + entry.sum())
    loss.backward()
    u = p.grad.abs()
    z = x.detach().reshape(B, C, P).abs().amax(dim=1, keepdim=True) / temp
    unit = 2.0 ** -24 * pd.clamp(min=2.0 ** -126) * (
        u + (u * pd).sum(dim=1, keepdim=True)) * (1.0 + z) / temp
    return float(loss.detach()), x.grad, unit.reshape(x.shape)


def small_criteria_check(dev, h=96, w=80, nseg=24):
    """Every criterion of CRITERIA_CASES (those that read a region batch;
    tests/test_torch_port_cuda.py holds MORE_CRITERIA_CASES') on the card
    against the CPU on one small input (B 2, N(0, 0.2^2) logits, which leave the T = 0.1
    softmax unsaturated: at N(0, 1) each float32 group term, the card's,
    the CPU's and JAX's, strays from float64 past 1e-5 of its largest
    gradient entry, see saturated_group_check; for the needs_feat
    criteria random
    features and eval logits; one-hot targets for the sampling ablation,
    whose pick is then forced): loss and parts within rtol 1e-5,
    the gradient finite where the CPU's is and within 1e-5 of its largest
    entry outside segments with a near-tie (two probabilities of a class
    within 1e-6), as the CPU tests hold the port against JAX. Returns the
    number of gradient entries inside near-ties that differ."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.engine.train import CRITERIA

    rng = np.random.RandomState(15)
    b, ct = 2, NUM_CLASSES
    spx = np.stack([irregular_superpixels(h, w, nseg, rng)
                    for _ in range(b)]).astype(np.int32)
    kinds = rng.choice(3, (b, nseg), p=[0.15, 0.45, 0.4])
    target = np.zeros((b, nseg, ct + 1), np.float32)
    for i in range(b):
        for s in range(nseg):
            n = (0, 1, rng.randint(2, 4))[kinds[i, s]]
            target[i, s, rng.choice(ct, n, replace=False)] = 1.0
    one_hot = np.zeros_like(target)
    one_hot[np.arange(b)[:, None], np.arange(nseg)[None],
            rng.randint(0, ct, (b, nseg))] = 1.0
    spmask = np.take_along_axis(rng.rand(b, nseg) < 0.6, spx.reshape(b, -1),
                                1).reshape(b, h, w)
    labels = rng.randint(0, ct, (b, h, w)).astype(np.int32)
    labels[rng.rand(b, h, w) < 0.2] = 255
    feat = rng.randn(b, 16, h, w).astype(np.float32)
    plbl = rng.randn(b, ct, h, w).astype(np.float32)
    sid = torch.from_numpy(np.where(spmask, spx, nseg).reshape(b, -1))
    tie_entries = 0
    for case, method, over, _ in CRITERIA_CASES:
        # 20 outputs; the sliced criteria read 21 target channels
        tgt = one_hot if case == "ablation" else target
        batch = {"target": tgt if method in SLICED else tgt[..., :ct],
                 "spx": spx, "spmask": spmask, "labels": labels}
        logits = (rng.randn(b, ct, h, w) * 0.2).astype(np.float32)
        cfg = Config(num_classes=ct - 1, nseg=nseg, method=method,
                     finetune_itrs=10, **over)
        res = {}
        for d in ("cpu", dev):
            crit = CRITERIA[method](cfg)
            x = torch.from_numpy(logits).to(d).requires_grad_(True)
            tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            if getattr(crit, "needs_feat", False):
                total, aux = crit(x, tb, {
                    "feat": torch.from_numpy(feat).to(d),
                    "plbl_logits": torch.from_numpy(plbl).to(d),
                    "frac": 0.25})
            elif getattr(crit, "needs_rng", False):
                total, aux = crit(x, tb, {"generator": torch.Generator(d)})
            else:
                total, aux = crit(x, tb)
            total.backward()
            res[str(d)] = ({k: float(v.detach()) for k, v in aux.items()},
                           x.grad.cpu())
        (ref, gref), (got, ggot) = res["cpu"], res[str(dev)]
        for k in ref:
            check(math.isclose(ref[k], got[k], rel_tol=1e-5, abs_tol=1e-7),
                  f"small criterion {case} {k}: card {got[k]} vs cpu "
                  f"{ref[k]}")
        fin = torch.isfinite(gref)
        check(torch.equal(fin, torch.isfinite(ggot)),
              f"small criterion {case}: gradients finite in other places")
        bad = fin & ((ggot - gref).abs() > 1e-5 * gref[fin].abs().max())
        bad_pix = bad.any(dim=1).reshape(b, -1)
        if bool(bad_pix.any()):
            probs = torch.softmax(torch.from_numpy(logits).reshape(
                b, ct, -1) / 0.1, dim=1)
            ties = near_tie_pixels(probs, sid, nseg)
            check(not bool((bad_pix & ~ties).any()),
                  f"small criterion {case}: {int(bad.sum())} gradient "
                  "entries differ outside near-ties")
            tie_entries += int(bad.sum())
    return tie_entries


def saturated_group_check(dev, h=96, w=80, nseg=24, seed=16):
    """The group term (active_joint_multi_predignore's, all 21 channels)
    on N(0, 1) logits, which saturate the T = 0.1 softmax, on the card and
    on the CPU against a float64 run (group_term_float64): the loss within
    8 * 2^-24 * (1 + loss) and, outside near-ties, every gradient entry
    within 8 float32 rounding units of its operands, on both. Returns the
    readings: each side's largest error in units and as a share of the
    largest gradient entry, and the share of pixels in near-ties."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.partial import group_multi_label_ce

    rng = np.random.RandomState(seed)
    b, c = 2, NUM_CLASSES + 1
    spx = np.stack([irregular_superpixels(h, w, nseg, rng)
                    for _ in range(b)]).astype(np.int32)
    target = np.zeros((b, nseg, c), np.float32)
    for i in range(b):
        for s in range(nseg):
            n = rng.choice([0, 1, 2, 3], p=[0.15, 0.45, 0.25, 0.15])
            target[i, s, rng.choice(c, n, replace=False)] = 1.0
    spmask = np.take_along_axis(rng.rand(b, nseg) < 0.6, spx.reshape(b, -1),
                                1).reshape(b, h, w)
    logits = rng.randn(b, c, h, w).astype(np.float32)
    l64, g64, unit = group_term_float64(logits, target, spx, spmask, nseg)
    probs = torch.softmax(torch.from_numpy(logits).reshape(b, c, -1) / 0.1,
                          dim=1)
    sid = np.where(spmask, spx, nseg).reshape(b, -1)
    ties = near_tie_pixels(probs, sid, nseg).reshape(b, 1, h, w)
    out = {"tie_share": float(ties.double().mean())}
    for d in ("cpu", dev):
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        loss = group_multi_label_ce(
            x, *(torch.from_numpy(a).to(d) for a in (target, spx, spmask)),
            nseg=nseg, temp=0.1, slice_last=False)
        loss.backward()
        err = torch.where(ties, 0.0, (x.grad.cpu().double() - g64).abs())
        side = "card" if d == dev else "cpu"
        lerr = abs(float(loss.detach()) - l64)
        check(lerr <= 8 * 2.0 ** -24 * (1 + l64),
              f"saturated group term, {side}: loss {float(loss.detach())} vs "
              f"float64 "
              f"{l64}")
        check(bool((err <= 8 * unit).all()),
              f"saturated group term, {side}: a gradient entry past 8 "
              "float32 units of float64")
        out[f"{side}_units"] = float((err / unit).nan_to_num(0.0).max())
        out[f"{side}_of_max"] = float(err.max() / g64.abs().max())
    return out


def device_spans(prof):
    """(kernel spans sorted by start, busy us, window us) of a profile:
    busy is the union of the spans (one stream), the window runs from the
    first span's start to the last one's end. Device-side spans of
    record_function ranges enclose kernels already counted and are left
    out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    check(spans, "the profiler saw no device activity")
    return (spans, *busy_window(spans))


def busy_window(spans):
    """(busy, window) of (start, end, ...) spans sorted by start: busy is
    their union (one stream), the window runs from the first start to the
    last end."""
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, *_ in spans:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def profile_steps(step, batches, label, n=3, top=25):
    """torch.profiler over n train steps, after one warm-up step: device time
    by kernel name, the kernels' share by kind, and the device's idle share
    between the first kernel's start and the last one's end (one stream, so
    busy time is the union of kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
    spans, busy, window = device_spans(prof)
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    kinds = {"loss kernels (K1-K10)": ("pixel_ce", "ssm_", "prereduce",
                                       "seg_max"),
             "convolutions and matmuls": ("conv", "gemm", "xmma", "cutlass",
                                          "cudnn", "wgrad", "dgrad", "sm90"),
             "optimizer": ("multi_tensor", "adam", "Adam"),
             "reductions": ("reduce",),
             "elementwise and copies": ("elementwise", "copy", "Memcpy",
                                        "Memset", "fill")}
    by_kind = {}
    for name, t in by_name.items():
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    loss_keys = kinds["loss kernels (K1-K10)"]
    print(json.dumps({"profile": {
        "slice": label, "steps": n, "device_spans_per_step": len(spans) / n,
        "window_ms_per_step": window / n / 1e3,
        "device_busy_ms_per_step": busy / n / 1e3,
        "idle_share": 1.0 - busy / window,
        "kind_ms_per_step": {k: v / n / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        "loss_kernel_ms_per_step": {
            name[:110]: t / n / 1e3 for name, t in by_name.items()
            if any(key in name for key in loss_keys)}}}))
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {t / n / 1e3:9.3f} ms/step  {name[:110]}")


# the distinct BN input shapes of the recipe's network in city_stage1
# (batch 4, 768^2) and voc_stage1 (batch 12, 513^2), and how many of a
# step's 64 BNs take each (forward hooks on models/factory.get_model)
BN_CELLS = {
    "city": (((4, 48, 192, 192), 1), ((4, 64, 384, 384), 2),
             ((4, 64, 192, 192), 6), ((4, 128, 384, 384), 1),
             ((4, 128, 192, 192), 1), ((4, 128, 96, 96), 7),
             ((4, 256, 192, 192), 6), ((4, 256, 96, 96), 1),
             ((4, 256, 48, 48), 16), ((4, 256, 1, 1), 1),
             ((4, 512, 96, 96), 5), ((4, 512, 48, 48), 6),
             ((4, 1024, 48, 48), 7), ((4, 2048, 48, 48), 4)),
    "voc": (((12, 48, 129, 129), 1), ((12, 64, 257, 257), 2),
            ((12, 64, 129, 129), 6), ((12, 128, 257, 257), 1),
            ((12, 128, 129, 129), 1), ((12, 128, 65, 65), 7),
            ((12, 256, 129, 129), 6), ((12, 256, 65, 65), 1),
            ((12, 256, 33, 33), 16), ((12, 256, 1, 1), 1),
            ((12, 512, 65, 65), 5), ((12, 512, 33, 33), 6),
            ((12, 1024, 33, 33), 7), ((12, 2048, 33, 33), 4)),
    # city_segformer_b5_stage1's one BN, channels-last as the decoder
    # hands it over
    "segformer": (((4, 768, 256, 256), 1),)}
BN_CHANNELS_LAST = ("segformer",)
# bytes a bf16 element costs each full-tensor BN kernel, its inputs read
# and its outputs written once: x; x and y; x and dy; x, dy and dx
BN_BYTES = {"bn_stats": 2, "bn_apply": 4, "bn_bwd_stats": 4, "bn_dx": 6}
# the outputs of the training pass that each BN kernel writes or alone
# feeds: its error in the kernels line is theirs
BN_OUTPUTS = {"bn_stats": ("rm", "rv"), "bn_finalize": ("rm", "rv"),
              "bn_apply": ("y",), "bn_bwd_stats": ("dw", "db"),
              "bn_bwd_finalize": ("dw", "db"), "bn_dx": ("dx",)}


def n_bn(model):
    """The FastBatchNorms of `model`: a module, or a name of
    models/factory (built on the CPU with separable convolutions, as
    every model here is)."""
    from mulactseg_tpu_torch.models.layers import FastBatchNorm

    if isinstance(model, str):
        return _n_bn_named(model)
    return sum(isinstance(m, FastBatchNorm) for m in model.modules())


@functools.lru_cache(maxsize=None)
def _n_bn_named(name):
    from mulactseg_tpu_torch.models.factory import get_model

    return n_bn(get_model(name, NUM_CLASSES, 16, separable_conv=True,
                          device="cpu"))


def bn_launches(model, fwd, bwd=None):
    """The BN kernels' launches (ops/batch_norm.KERNELS, three forward and
    three backward) on the card of `fwd` train-mode forwards and `bwd`
    (default `fwd`) backwards of `model` (n_bn's argument): each kernel
    once a FastBatchNorm and pass, none where that makes 0. Eval-mode
    forwards launch none."""
    from mulactseg_tpu_torch.ops import batch_norm

    n = n_bn(model)
    bwd = fwd if bwd is None else bwd
    counts = zip(batch_norm.KERNELS, [n * fwd] * 3 + [n * bwd] * 3)
    return {k: v for k, v in counts if v}


def bn_inputs(dev, shape, dtype, seed, offset=0, rows=False):
    """x ~ N(mu_c, s_c^2) with mu_c in [-1, 1], s_c in [0.5, 2] and channel
    0 constant 1.5 (v = 0 exactly in float32: its sums are exact), a
    N(0, 1) cotangent, scale, bias and running statistics; with `offset`
    x is a contiguous view that many elements into a larger storage (not
    16-byte aligned, the kernels' scalar path); with `rows` x and the
    cotangent are channels-last."""
    g = torch.Generator(dev).manual_seed(seed)
    N, C, H, W = shape
    scale = torch.rand(1, C, 1, 1, generator=g, device=dev) * 1.5 + 0.5
    mean = torch.rand(1, C, 1, 1, generator=g, device=dev) * 2.0 - 1.0
    x = torch.randn(shape, generator=g, device=dev) * scale + mean
    x[:, 0] = 1.5
    big = torch.empty(x.numel() + offset, device=dev, dtype=dtype)
    big[offset:] = x.reshape(-1)
    x = big[offset:].view(shape)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    if rows:
        x = x.contiguous(memory_format=torch.channels_last)
        dy = dy.contiguous(memory_format=torch.channels_last)
    return (x, dy, torch.rand(C, generator=g, device=dev) + 0.5,
            torch.rand(C, generator=g, device=dev) * 0.4 - 0.2,
            torch.rand(C, generator=g, device=dev) - 0.5,
            torch.rand(C, generator=g, device=dev) * 1.5 + 0.5)


def bn_run(fn, x, dy, w, b, rm, rv):
    """fn's output, gradients and running statistics, from copies."""
    xs = x.detach().requires_grad_(True)
    ws, bs = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    rms, rvs = rm.clone(), rv.clone()
    y = fn(xs, ws, bs, rms, rvs, 0.1, 1e-5)
    y.backward(dy)
    return {"y": y.detach(), "dx": xs.grad, "dw": ws.grad, "db": bs.grad,
            "rm": rms, "rv": rvs}


def bn_exact(x, dy, w, b, rm, rv):
    """The training pass in float64 on the same inputs (a and b not
    rounded), and each output's operand magnitude: |x a| + |beta| + |m a|
    for y (b = beta - m a); |dy a| + (|a dB| + 2 |m dv|) / n + |k2 x| for
    dx (dx = dy a + k1 + k2 x, k1 = (-a dB - 2 m dv) / n and k2 = 2 dv / n
    from the clamped variance's gradient dv); the sums of |dy x| and
    |m dy| times r for dw, of |dy| for db; the update's terms for the
    running statistics."""
    x, dy, w, b = x.double(), dy.double(), w.double(), b.double()
    d, n = (0, 2, 3), x[:, 0].numel()
    m = x.sum(d) / n
    vr = (x * x).sum(d) / n - m * m
    r = 1.0 / torch.sqrt(vr.clamp(min=0.0) + 1e-5)
    a = w * r
    bb = b - m * a
    dB, dA = dy.sum(d), (dy * x).sum(d)
    dv = torch.where(vr >= 0, -0.5 * (dA - m * dB) * w * r ** 3,
                     torch.zeros_like(r))
    k1, k2 = (-a * dB - 2.0 * m * dv) / n, 2.0 * dv / n

    def c(t):
        return t[None, :, None, None]

    exact = {"y": x * c(a) + c(bb), "dx": dy * c(a) + c(k1) + c(k2) * x,
             "dw": (dA - m * dB) * r, "db": dB,
             "rm": 0.9 * rm.double() + 0.1 * m,
             "rv": 0.9 * rv.double() + 0.1 * vr.clamp(min=0.0)}
    mag = {"y": x.abs() * c(a.abs()) + c(b.abs() + (m * a).abs()),
           "dx": dy.abs() * c(a.abs()) + c(k2.abs()) * x.abs()
           + c(((a * dB).abs() + 2.0 * (m * dv).abs()) / n),
           "dw": ((dy * x).abs().sum(d) + m.abs() * dy.abs().sum(d)) * r,
           "db": dy.abs().sum(d),
           "rm": 0.9 * rm.double().abs() + 0.1 * x.abs().sum(d) / n,
           "rv": 0.9 * rv.double().abs() + 0.1 * (x * x).sum(d) / n}
    return exact, mag


def rel_err(got, want, mag):
    """The largest error relative to its operands' magnitude."""
    return float(((got.double() - want.double()).abs() / mag).max())


# float32 sums of up to 2.4M terms in another order: each within ~1e-5
# of the sum of its terms' magnitudes (both sides add runs of hundreds of
# terms in a thread before a tree), and v = E[x^2] - m^2 amplifies that
# by (E[x^2] + 2 |m| E|x|) / v, at most ~10 on these inputs (|mean| <= 1,
# std >= 0.5): 1e-4 of the operands, three times the largest reading on
# an H100 (3.1e-5)
BN_F32_TOL = 1e-4
# bf16, against the exact function: the kernels round a and b to bf16 and
# the result once, half a bf16 ulp (2^-8) each, so y and dx lie within
# 2^-7 (1 + 2^-8) of their operands' magnitude, plus the float32 sums'
# BN_F32_TOL; dw, db and the statistics are float32 sums of the bf16
# inputs. Against the plain version, which also rounds the product apart
# from the sum (within 4 half ulps of the exact y): y within 6 half ulps;
# dw within 2^-7 and db within 2^-8 (its gradient rounds each dy x and
# both sums to bf16); the statistics as in float32. The plain version's dx
# is not compared: its bf16 sums feed the variance's gradient, which
# amplifies them (7% of the operands on these inputs).
BN_BF16_EXACT = {"y": 2.0 ** -7 * (1 + 2.0 ** -8) + BN_F32_TOL,
                 "dx": 2.0 ** -7 * (1 + 2.0 ** -8) + BN_F32_TOL,
                 "dw": BN_F32_TOL, "db": BN_F32_TOL, "rm": BN_F32_TOL,
                 "rv": BN_F32_TOL}
BN_BF16_PLAIN = {"y": 6 * 2.0 ** -8 * (1 + 2.0 ** -8) + BN_F32_TOL,
                 "dw": 2.0 ** -7 * (1 + 2.0 ** -8) + BN_F32_TOL,
                 "db": 2.0 ** -8 + BN_F32_TOL, "rm": BN_F32_TOL,
                 "rv": BN_F32_TOL}


def bn_slice(dev):
    """FastBatchNorm's training pass at each BN shape of city_stage1,
    voc_stage1 and city_segformer_b5_stage1 (BN_CELLS) in bf16, on
    bn_inputs' tensors. Held: the six kernels
    (ops/batch_norm.batch_norm_train, one launch each) give y, the
    running statistics and dx, dw, db of one backward (bn_run) within
    BN_BF16_EXACT of the float64 function (bn_exact) and within
    BN_BF16_PLAIN of the plain version (batch_norm_plain, fed copies of
    the same running statistics), relative to their operands' magnitude
    (rel_err). Timed, forward and backward (torch.autograd.grad, so no
    accumulation), each as CUDA graph replays (time_ms): the kernels
    (their split by torch.profiler over replays), the plain version and,
    as a yardstick the port never calls, F.batch_norm (cuDNN). Summed
    over a step's BNs (64, SegFormer's one): ms per kernel beside its
    bound (BN_BYTES; the two finalize kernels at their partials and
    per-channel values), and the whole pass's ms, bound, plain and cuDNN
    ms; the largest errors. Returns (the bn line, the kernels line's rows:
    each kernel in each cell, its error the largest of the outputs of
    BN_OUTPUTS)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from mulactseg_tpu_torch.ops import _build, batch_norm

    def grads(fn, x, w, b, rm, rv, dy):
        y = fn(x, w, b, rm, rv)
        return torch.autograd.grad(y, (x, w, b), dy)

    paths = {
        "kernels": lambda x, w, b, rm, rv: batch_norm.batch_norm_train(
            x, w, b, rm, rv, 0.1, 1e-5),
        "plain": lambda x, w, b, rm, rv: batch_norm.batch_norm_plain(
            x, w, b, rm, rv, 0.1, 1e-5),
        "cudnn": lambda x, w, b, rm, rv: F.batch_norm(
            x, rm, rv, w, b, True, 0.1, 1e-5)}
    out, rows = {}, []
    for cell, shapes in BN_CELLS.items():
        ms = {k: 0.0 for k in paths}
        per_kernel = {k: 0.0 for k in batch_norm.KERNELS}
        bound = {k: 0.0 for k in batch_norm.KERNELS}
        err = {"exact": {}, "plain": {}}
        elements = 0
        for i, (shape, count) in enumerate(shapes):
            N, C, H, W = shape
            rows_layout = cell in BN_CHANNELS_LAST
            args = bn_inputs(dev, shape, torch.bfloat16, 26 + i,
                             rows=rows_layout)
            _build.reset_launches()
            got = bn_run(batch_norm.batch_norm_train, *args)
            torch.cuda.synchronize()
            check(dict(_build.LAUNCHES) == {k: 1 for k in batch_norm.KERNELS},
                  f"bn {shape}: launches {dict(_build.LAUNCHES)}")
            plain = bn_run(batch_norm.batch_norm_plain, *args)
            exact, mag = bn_exact(*args)
            for k, t in got.items():
                e = rel_err(t, exact[k], mag[k])
                check(bool(torch.isfinite(t).all()) and e <= BN_BF16_EXACT[k],
                      f"bn {cell} {shape}: {k} off the float64 function by "
                      f"{e} of its operands (at most {BN_BF16_EXACT[k]})")
                err["exact"][k] = max(err["exact"].get(k, 0.0), e)
                if k in BN_BF16_PLAIN:
                    e = rel_err(t, plain[k], mag[k])
                    check(e <= BN_BF16_PLAIN[k],
                          f"bn {cell} {shape}: {k} off the plain version by "
                          f"{e} of its operands (at most {BN_BF16_PLAIN[k]})")
                    err["plain"][k] = max(err["plain"].get(k, 0.0), e)
            del got, plain, exact, mag
            x, dy, w, b, rm, rv = args
            x = x.detach().requires_grad_(True)
            w, b = w.requires_grad_(True), b.requires_grad_(True)
            for name, fn in paths.items():
                ms[name] += count * time_ms(
                    lambda fn=fn: grads(fn, x, w, b, rm, rv, dy), graph=True)
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                graph.capture_begin()
                grads(paths["kernels"], x, w, b, rm, rv, dy)
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPEATS):
                    graph.replay()
                torch.cuda.synchronize()
            for s0, e0, name in device_spans(prof)[0]:
                k = re.search(r"(bn_\w+?)_kernel", name)
                if k and k.group(1) in per_kernel:
                    per_kernel[k.group(1)] += count * (e0 - s0) / 1e3 / REPEATS
            splits = batch_norm._reduction(
                x, rows_layout, torch.cuda.get_device_properties(
                    dev).multi_processor_count)[0]
            small = {"bn_finalize": (2 * splits * C + 6 * C + 6 * C) * 4,
                     "bn_bwd_finalize": (4 * splits * C + 9 * C) * 4}
            for k in batch_norm.KERNELS:
                nbytes = BN_BYTES[k] * x.numel() if k in BN_BYTES \
                    else small[k]
                bound[k] += count * nbytes / HBM_BYTES_PER_S * 1e3
            elements += count * x.numel()
            del x, dy, args, graph
        whole = 16 * elements / HBM_BYTES_PER_S * 1e3
        out[cell] = {
            "elements_per_step": elements,
            "kernels_ms_per_step": per_kernel,
            "kernels_bound_ms_per_step": bound,
            "pass_ms_per_step": ms["kernels"], "pass_bound_ms": whole,
            "pass_roofline_pct": 100.0 * whole / ms["kernels"],
            "plain_ms_per_step": ms["plain"],
            "cudnn_ms_per_step": ms["cudnn"], "max_rel_err": err}
        for k in batch_norm.KERNELS:
            rows.append((k if cell == "city" else f"{k}@{cell}",
                         max(err["exact"][o] for o in BN_OUTPUTS[k]),
                         per_kernel[k], None, (bound[k], "bytes"), None))
    torch.cuda.empty_cache()
    return {"bn": out}, rows


def host_self_ms(events, top=10):
    """The `top` host ops of a Chrome trace by self time (an op's span less
    its child ops' on the same thread), in ms summed over the trace."""
    threads = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X":
            threads.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], -e["dur"], e["name"]))
    self_us = Counter()
    for ops in threads.values():
        ops.sort()
        stack = []  # [end, name, span, children's spans]

        def pop():
            end, name, span, child = stack.pop()
            self_us[name] += span - child
            if stack:
                stack[-1][3] += span

        for ts, neg, name in ops:
            while stack and stack[-1][0] <= ts:
                pop()
            stack.append([ts - neg, name, -neg, 0.0])
        while stack:
            pop()
    return [[name, t / 1e3] for name, t in self_us.most_common(top)]


def profile_slice(variables, dev, smi, workdir):
    """The profiler switch (docstring, item 14): ALTrainer at cfg.profile
    trains PROF_ITRS recipe steps, the launch counters set to 0 just
    before and read just after; its trace is read back and held. Returns
    (the profile line, the path's launches)."""
    from torch.profiler import profile

    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine.rounds import ALTrainer
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build

    cfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                 train_batch_size=B, dtype="bfloat16", separable_conv=True,
                 method="active_joint_multi_predignore_lossdecomp",
                 finetune_itrs=PROF_ITRS, profile=True, num_workers=4,
                 model_save_dir=workdir)
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=dev)
    convert.load_variables(model, variables)
    trainer = ALTrainer(cfg, 1, model=model, device=dev)
    trainset = SyntheticRegionDataset(n_images=PROF_IMAGES, H=H, W=W,
                                      num_classes=NUM_CLASSES - 1, nseg=NSEG,
                                      split="active-label", seed=7)
    # the steps' losses, read after the loop (no sync inside it)
    auxes, real_step = [], trainer.train_step

    def recorded(batch):
        auxes.append(real_step(batch))
        return auxes[-1]
    recorded.__dict__ = real_step.__dict__  # step count and optimizer
    trainer.train_step = recorded
    spent = {}

    def timed(fn, key):
        def wrapper(*a, **k):
            t1 = time.perf_counter()
            out = fn(*a, **k)
            spent[key] = time.perf_counter() - t1
            return out
        return wrapper

    with mock.patch.object(profile, "stop", timed(profile.stop, "stop_s")), \
            mock.patch.object(profile, "export_chrome_trace", timed(
                profile.export_chrome_trace, "export_s")):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        rate = trainer.train(type("Active", (), {
            "get_trainset": lambda _: trainset})())
        train_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
    losses = [{k: float(v) for k, v in aux.items()} for aux in auxes]
    check(len(losses) == PROF_ITRS and all(
        math.isfinite(x) for aux in losses for x in aux.values()),
        f"profile phase: losses {losses}")
    want = {**{k: PROF_ITRS for k in STAGE1_KERNELS},
            **bn_launches(model, PROF_ITRS)}
    check(launches == want, f"profile phase launches {launches}, want "
          f"{want} (K1-K4 and each BN kernel once a step, BN)")

    path = trainer.trace_file
    check(os.path.basename(path) == "rank0.round01.pt.trace.json"
          and os.path.dirname(path) == os.path.join(workdir, "profile")
          and os.listdir(os.path.dirname(path)) == [os.path.basename(path)],
          f"profile phase: trace {path}, "
          f"{os.listdir(os.path.join(workdir, 'profile'))}")
    trace_mb = os.path.getsize(path) / 2 ** 20
    t0 = time.perf_counter()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    read_s = time.perf_counter() - t0
    device = sorted((e["ts"], e["ts"] + e["dur"], e["cat"], e["name"])
                    for e in events if e.get("cat") in (
                        "kernel", "gpu_memcpy", "gpu_memset")
                    and e.get("dur", 0) > 0)
    kernels = [name for _, _, cat, name in device if cat == "kernel"]
    check(kernels, "profile phase: the trace holds no device kernel (the "
          "CUDA activity was not recorded)")
    busy, window = busy_window(device)
    # every kernel that K1-K4 launch, once a step, and the BN kernels,
    # once a BN and step
    spans = {}
    for counter, n in launches.items():
        for g in COUNTER_KERNELS[counter]:
            pat = re.compile(rf"(?<![A-Za-z0-9_]){g}(?![A-Za-z0-9_])")
            spans[g] = sum(1 for name in kernels if pat.search(name))
            check(spans[g] == n, f"profile phase: {g} ({counter}) has "
                  f"{spans[g]} kernel spans in the trace, want {n}")
    line = {"profile_phase": {
        "slice": "ALTrainer.train at cfg.profile", "card": smi,
        "steps": PROF_ITRS, "trace": os.path.relpath(path, workdir),
        "trace_mb": trace_mb, "events": len(events),
        "export_s": spent["export_s"], "stop_s": spent["stop_s"],
        "read_s": read_s, "train_s": train_s, "img_per_s": rate,
        "device_spans_per_step": len(device) / PROF_ITRS,
        "kernel_spans_per_step": len(kernels) / PROF_ITRS,
        "device_busy_ms_per_step": busy / PROF_ITRS / 1e3,
        "window_ms_per_step": window / PROF_ITRS / 1e3,
        "idle_share": 1.0 - busy / window, "counted_kernel_spans": spans,
        "top_host_self_ms": host_self_ms(events),
        "losses": losses, "launches": launches}}
    return line, launches


def plbl_fixture(n, seed):
    """tools_dev/bench_round.py:135-157's pseudo-label fixture at
    1024x2048 in the port's layout: two base superpixel maps, 30% of
    superpixels selected, 1-3 candidate classes per superpixel (of C+1),
    uint8 NCHW images and GT; the first 600 superpixel ids count as
    labelled (suppix)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels

    rng = np.random.RandomState(seed)
    base = [irregular_superpixels(PH, PW, NSEG, rng) for _ in range(2)]
    batches, suppix = [], {}
    for i in range(n):
        spx = base[i % 2]
        sel = np.nonzero(rng.rand(NSEG) < 0.3)[0]
        tgt = (rng.rand(NSEG, NUM_CLASSES) < 0.1).astype(np.float32)
        tgt[np.arange(NSEG), rng.randint(0, NUM_CLASSES, NSEG)] = 1.0
        batches.append({
            "images": rng.randint(0, 256, (1, 3, PH, PW)).astype(np.uint8),
            "labels": rng.randint(0, NUM_CLASSES - 1,
                                  (1, PH, PW)).astype(np.uint8),
            "target": tgt[None], "spx": spx[None],
            "spmask": np.isin(spx, sel)[None],
            "fnames": [["img", f"lbl_{i}.png", f"spx_{i}"]]})
        suppix[f"spx_{i}"] = np.unique(spx).tolist()[:600]
    return batches, suppix


def check_k5(values, sid, name, nseg=NSEG):
    """K5 on (P, C) values under (P,) ids against its plain version: the
    argmax pixels and the max values bitwise, with present and absent
    segments among the nseg. Returns the max abs error."""
    from mulactseg_tpu_torch.ops import segment_max

    vals, pix = segment_max.seg_max_fwd(values, sid, nseg)
    pvals, ppix = segment_max.segment_max_plain(values, sid, nseg)
    torch.cuda.synchronize()
    P = values.shape[0]
    check(torch.equal(pix, ppix), f"K5 argmax pixels differ ({name})")
    check(torch.equal(vals.view(torch.int32), pvals.view(torch.int32)),
          f"K5 max values differ bitwise ({name})")
    check(bool((pix < P).any()) and bool((pix == P).any()),
          f"K5 case {name} lacks present or absent segments")
    return (vals - pvals).abs().max().item()


def k5_checks(model, dev):
    """K5 against its plain version at the pseudo-labeller's shapes:
    the softmax planes of a full-resolution eval forward with ~30% of
    superpixels selected, then signed values rounded to 1/8. Both outputs
    must be bitwise equal. Returns the kernels-line row."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.engine.evaluate import eval_forward
    from mulactseg_tpu_torch.ops import segment_max

    rng = np.random.RandomState(11)
    C, P = NUM_CLASSES, PH * PW
    image = rng.randint(0, 256, (1, 3, PH, PW)).astype(np.uint8)
    logits = eval_forward(model, image, dev, True)
    planes = torch.softmax(logits[0].float(), dim=0).reshape(C, P).t()
    del logits
    spx = irregular_superpixels(PH, PW, NSEG, rng)
    sel = rng.rand(NSEG) < 0.3
    sid = torch.from_numpy(np.where(sel[spx], spx, NSEG).reshape(-1).astype(
        np.int32)).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    signed = torch.round(torch.randn(P, C, device=dev, generator=gen) * 8) / 8
    err = max(check_k5(planes, sid, "softmax planes"),
              check_k5(signed, sid, "signed/8"))
    del signed
    n_valid = int((sid < NSEG).sum())
    print(f"K5 bitwise equal to its plain version on both inputs; "
          f"{n_valid} of {P} pixels valid", flush=True)
    return ("seg_max_fwd", err,
            time_ms(lambda: segment_max.seg_max_fwd(planes, sid, NSEG),
                    graph=True),
            time_ms(lambda: segment_max.segment_max_plain(planes, sid, NSEG)),
            bound(P * 4 + n_valid * C * 4 + NSEG * C * 8, n_valid * C),
            None)


def eval_slice(model, cfg, dev):
    """Evaluator.run with predignore on EVAL_IMAGES uint8 1024x2048 images
    (1 warm-up image first)."""
    from mulactseg_tpu_torch.engine.evaluate import Evaluator

    rng = np.random.RandomState(12)
    batches = []
    for _ in range(EVAL_IMAGES):
        labels = rng.randint(0, NUM_CLASSES - 1, (1, PH, PW)).astype(np.uint8)
        labels[rng.rand(1, PH, PW) < 0.1] = 255
        batches.append({"images": rng.randint(0, 256, (1, 3, PH, PW)).astype(
            np.uint8), "labels": labels})
    ev = Evaluator(model, cfg, device=dev)
    ev.run(None, batches[:1], predignore=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    miou, table = ev.run(None, batches, predignore=True)
    dt = time.perf_counter() - t0
    check(math.isfinite(miou) and len(table.split(",")) == NUM_CLASSES + 1,
          f"bad eval result {miou} {table}")
    return {"slice": "evaluation, predignore, 1024x2048", "images":
            EVAL_IMAGES, "img_per_s": EVAL_IMAGES / dt,
            "ms_per_image": dt / EVAL_IMAGES * 1e3, "miou": miou}


def plbl_slice(model, cfg, dev):
    """The recipe's pseudo-labelling step on the fixture: the main path's
    run (counted), the PNG check, and a profiled pass for the breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator
    from mulactseg_tpu_torch.utils.png import read_gray8

    batches, suppix = plbl_fixture(PLBL_IMAGES + 1, seed=3)
    warm, timed = batches[:1], batches[1:]
    gen = PseudoLabelGenerator(model, cfg, "cosprop_includeonehot",
                               device=dev)
    check(gen.sim_bf16, "the recipe's plbl runs with bf16 similarities")
    with tempfile.TemporaryDirectory() as tmp:
        gen.generate(None, warm, save_dir=os.path.join(tmp, "warm"),
                     suppix=suppix)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        miou, iou, prec, rec = gen.generate(
            None, timed, save_dir=os.path.join(tmp, "run"), suppix=suppix)
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches == {"seg_max_fwd": PLBL_IMAGES},
              f"plbl launches {launches}, want seg_max_fwd once per image")
        check(math.isfinite(miou) and all(
            math.isfinite(float(v)) for t in (iou, prec, rec)
            for v in t.split(",")), f"bad plbl scores {miou} {iou}")
        labelled = []
        for b in timed:
            path = os.path.join(tmp, "run", b["fnames"][0][1])
            check(os.path.exists(path), f"missing {path}")
            want = gen.plbl_for_batch(b, suppix).to(torch.uint8).cpu().numpy()
            check(np.array_equal(read_gray8(path), want),
                  f"{path} does not decode to the generator's map")
            labelled.append(float((want != 255).mean()))

        host_prep_s = []
        for b in timed:
            t1 = time.perf_counter()
            gen.host_prep(b, suppix)
            host_prep_s.append(time.perf_counter() - t1)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gen.generate(None, timed, save_dir=os.path.join(tmp, "prof"),
                         suppix=suppix)
            torch.cuda.synchronize()
    _, busy, window = device_spans(prof)
    parts = {}
    for name in PLBL_PARTS:
        dev_us = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.name == name and e.device_type == DeviceType.CUDA]
        host_us = [e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.name == name and e.device_type == DeviceType.CPU]
        parts[name] = {
            "device_ms": (sum(dev_us) / PLBL_IMAGES / 1e3 if dev_us
                          else None),
            "host_ms": sum(host_us) / PLBL_IMAGES / 1e3 if host_us else None}
    return {"slice": "plbl cosprop_includeonehot, 1024x2048, nseg 2048, "
            "bf16 features", "images": PLBL_IMAGES,
            "img_per_s": PLBL_IMAGES / dt,
            "ms_per_image": dt / PLBL_IMAGES * 1e3, "peak_mem_gib": peak_gib,
            "miou": miou, "labelled_share": statistics.mean(labelled),
            "host_prep_ms": statistics.mean(host_prep_s) * 1e3,
            "parts_per_image": parts,
            "profiled_window_ms_per_image": window / PLBL_IMAGES / 1e3,
            "profiled_device_busy_ms_per_image": busy / PLBL_IMAGES / 1e3,
            "profiled_idle_share": 1.0 - busy / window}, launches


def small_plbl_check(dev):
    """cosine_prototype_plbl on the card against the CPU on one small
    input with sim_bf16 off: K5's outputs equal, and the maps agree on
    >= 99.5% of pixels (the similarity matmuls sum in another order)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd
    from mulactseg_tpu_torch.plbl.cosine_prop import (
        cosine_prototype_plbl,
        selected_spx_adjacency,
    )

    rng = np.random.RandomState(13)
    h, w, nseg, C, Ch = 96, 80, 24, NUM_CLASSES, 256
    P = h * w
    spx = irregular_superpixels(h, w, nseg, rng)
    feats = rng.randn(Ch, P).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=0, keepdims=True)
    logits = rng.randn(C, P).astype(np.float32) * 3
    probs = np.exp(logits - logits.max(0))
    probs = (probs / probs.sum(0)).astype(np.float32)
    targets = np.zeros((nseg, C), np.float32)
    for s in range(nseg):
        targets[s, rng.choice(C, rng.randint(1, 4), replace=False)] = 1
    selected = np.nonzero(rng.rand(nseg) < 0.6)[0].tolist()
    proto = selected_spx_adjacency(spx, selected, nseg, targets, 256, True)
    valid = np.isin(spx, selected).reshape(-1)
    sid = np.where(valid, spx.reshape(-1), nseg).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(d)

        k5 = seg_max_fwd(t(probs).t(), t(sid), nseg)
        m = cosine_prototype_plbl(
            t(feats).t(), t(probs).t(), t(spx.reshape(-1)), t(valid),
            *(t(a) for a in proto), nseg=nseg, chunk=2048)
        out[str(d)] = (k5[0].cpu(), k5[1].cpu(), m.cpu())
    (cv, ci, cm), (gv, gi, gm) = out["cpu"], out[str(dev)]
    check(torch.equal(ci, gi) and torch.equal(cv, gv),
          "small plbl: K5 on the card differs from the CPU")
    differ = int((cm != gm).sum())
    print(f"small plbl: {differ} of {P} pixels differ between card and CPU",
          flush=True)
    check(differ <= 0.005 * P and bool((gm != 255).any()),
          f"small plbl: {differ} of {P} pixels differ")
    return differ


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _state_equal(payload, model, optimizer, step):
    """The checkpoint payload holds bitwise the model's and optimizer's
    state and the step."""
    if payload["step"] != step:
        return False
    sd = model.state_dict()
    if payload["model_state_dict"].keys() != sd.keys() or not all(
            torch.equal(payload["model_state_dict"][k], v.cpu())
            for k, v in sd.items()):
        return False
    want, got = optimizer.state_dict(), payload["optimizer_state_dict"]
    if want["param_groups"] != got["param_groups"] or \
            want["state"].keys() != got["state"].keys():
        return False
    return all(torch.equal(got["state"][i][k], v.cpu())
               for i, st in want["state"].items() for k, v in st.items())


def al_rounds_slice(variables, dev, smi, workdir):
    """The active-learning main path (docstring, item 8a): 2 rounds, the
    pseudo-labelling of the label set and stage 2, timed per part with
    wrappers around the trainer's and the selectors' methods, the launch
    counters read around each part. Returns (the al_rounds line, the
    path's launches)."""
    from mulactseg_tpu_torch.acquisition import selectors
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.datasets import RegionDatasetPlbl
    from mulactseg_tpu_torch.data.loader import DataProvider, start_workers
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine import rounds
    from mulactseg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from mulactseg_tpu_torch.engine.evaluate import eval_forward
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import (
        PseudoLabelGenerator,
        plbl_save_dir,
    )
    from mulactseg_tpu_torch.utils.png import read_gray8, write_rgb8

    sel2 = "my_bvsb_predclsbal_pwr_banignore"
    common = dict(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                  train_batch_size=B, dtype="bfloat16", separable_conv=True,
                  finetune_itrs=AL_ITRS, val_period=AL_VAL_PERIOD,
                  val_start=0, log_period=AL_ITRS // 3, val_batch_size=B,
                  num_workers=4, val_num_workers=4)
    cfg = Config(method="active_joint_multi_predignore_lossdecomp",
                 max_iterations=2, active_selection_size=AL_BUDGET,
                 init_active_method="my_random", active_method=sel2,
                 model_save_dir=os.path.join(workdir, "run"), **common)
    t0 = time.perf_counter()
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=dev)
    convert.load_variables(model, variables)
    init = os.path.join(workdir, "deeplab_resnet50deepstem_imagenet_"
                        "pretrained_seed0.pth")
    save_checkpoint(init, model)
    del model

    def dataset(split, n, seed):
        return SyntheticRegionDataset(n_images=n, H=H, W=W,
                                      num_classes=NUM_CLASSES - 1, nseg=NSEG,
                                      split=split, seed=seed)

    pool = dataset("active-ulabel", AL_POOL, 7)
    label = dataset("active-label", AL_POOL, 7)
    label.suppix, label.im_idx = {}, []
    val, evalset = dataset("val", AL_VAL, 8), dataset("val", AL_VAL, 9)
    active = RegionActiveSet(cfg, pool, label)
    setup_s = time.perf_counter() - t0

    per_round = {r: {"select_s": [], "train_s": [], "train_img_per_s": [],
                     "validations": 0, "save_s": [], "load_s": []}
                 for r in (1, 2)}
    losses, checked = [], []
    real = {"train": rounds.ALTrainer.train, "save": rounds.ALTrainer.save,
            "load": rounds.ALTrainer.load,
            "validate": rounds.ALTrainer.validate,
            "select": selectors.RegionSelector.select_next_batch}

    def timed(fn, key):
        def wrapper(self, *a, **k):
            _sync(dev)
            t1 = time.perf_counter()
            out = fn(self, *a, **k)
            _sync(dev)
            per_round[self.selection_iter][key].append(
                time.perf_counter() - t1)
            return out
        return wrapper

    def train(self, *a, **k):
        t1 = time.perf_counter()
        rate = real["train"](self, *a, **k)
        per_round[self.selection_iter]["train_s"].append(
            time.perf_counter() - t1)
        per_round[self.selection_iter]["train_img_per_s"].append(rate)
        return rate

    def save(self, path=None):
        timed(real["save"], "save_s")(self, path)
        if not checked:  # the first checkpoint, loaded back
            checked.append(_state_equal(
                load_checkpoint(path or self.checkpoint_file), self.model,
                self.optimizer, self.step))

    def validate(self, trainiter):
        per_round[self.selection_iter]["validations"] += 1
        return real["validate"](self, trainiter)

    def select(self, trainer, active_set, n):
        _sync(dev)
        t1 = time.perf_counter()
        out = real["select"](self, trainer, active_set, n)
        per_round[active_set.selection_iter]["select_s"].append(
            time.perf_counter() - t1)
        return out

    rounds.ALTrainer.train, rounds.ALTrainer.save = train, save
    rounds.ALTrainer.load = timed(real["load"], "load_s")
    rounds.ALTrainer.validate = validate
    selectors.RegionSelector.select_next_batch = select
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        results = rounds.run_al_rounds(
            cfg, active, val_dataset=val, eval_dataset=evalset,
            init_checkpoint=init, device=dev,
            metrics_cb=lambda it, aux: losses.append(aux))
        _sync(dev)
        rounds_s = time.perf_counter() - t0
        round_launches = dict(_build.LAUNCHES)
    finally:
        rounds.ALTrainer.train, rounds.ALTrainer.save = (real["train"],
                                                         real["save"])
        rounds.ALTrainer.load = real["load"]
        rounds.ALTrainer.validate = real["validate"]
        selectors.RegionSelector.select_next_batch = real["select"]
    steps = 2 * AL_ITRS
    want = {**{k: steps for k in STAGE1_KERNELS},
            **bn_launches(cfg.model, steps)}
    check(round_launches == want, f"al rounds launches {round_launches}, "
          f"want {want} (K1-K4 once per stage-1 step, {steps}, each BN "
          "kernel once a BN and step, and no other)")
    check(checked == [True], "a checkpoint loaded back differs from the "
          "state that was saved")
    check(len(losses) == 6 and all(math.isfinite(v) for aux in losses
                                   for v in aux.values()),
          f"bad round losses {losses}")
    check(sorted(results) == [1, 2] and all(
        math.isfinite(m) for m in results.values()), f"bad mIoU {results}")
    run = cfg.model_save_dir
    for f in ("datalist_01.json", "datalist_02.json",
              "my_random_selection_01.json", f"{sel2}_selection_02.json",
              "checkpoint01", "checkpoint02"):
        check(os.path.exists(os.path.join(run, f)), f"missing {f}")
    for r in (1, 2):
        check(per_round[r]["validations"] == AL_ITRS // AL_VAL_PERIOD,
              f"round {r}: {per_round[r]['validations']} validations")
    with open(os.path.join(run, f"{sel2}_selection_02.json")) as f:
        chosen = json.load(f)
    clicks = [int(label.multi_hot_cls[label.id_to_index[p.split(",")[1]
                                                        .split(".")[0]],
                                      i].sum()) for _, p, i in chosen]
    check(sum(clicks[:-1]) <= AL_BUDGET < sum(clicks),
          f"round 2 selected {sum(clicks)} clicks in {len(chosen)} regions "
          f"for a budget of {AL_BUDGET}")

    # pseudo-labelling of the label set with round 2's best checkpoint
    pcfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, dtype="bfloat16",
                  method=cfg.method)
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=dev)
    ckpt2 = os.path.join(run, "checkpoint02")
    model.load_state_dict(load_checkpoint(ckpt2)["model_state_dict"])
    gen = PseudoLabelGenerator(model, pcfg, "cosprop_includeonehot",
                               device=dev)
    plbl_dir = plbl_save_dir(ckpt2, "cosprop_includeonehot", "02")
    loader = DataProvider(label, 1, shuffle=False, drop_last=False,
                          infinite=False, num_workers=2)
    _sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    plbl_miou = gen.generate(None, loader, save_dir=plbl_dir,
                             suppix=label.suppix)[0]
    _sync(dev)
    plbl_s = time.perf_counter() - t0
    plbl_launches = dict(_build.LAUNCHES)
    loader.close()
    n_lbl = len(label)
    check(n_lbl == AL_POOL and plbl_launches == {"seg_max_fwd": n_lbl},
          f"plbl of {n_lbl} images launched {plbl_launches}, want "
          "seg_max_fwd once per image")
    check(math.isfinite(plbl_miou), f"bad plbl mIoU {plbl_miou}")
    for i in range(n_lbl):
        b = {k: (v[None] if isinstance(v, np.ndarray) else [v])
             for k, v in label[i].items()}
        want = gen.plbl_for_batch(b, label.suppix).to(torch.uint8).cpu()
        path = os.path.join(plbl_dir, b["fnames"][0][1])
        check(np.array_equal(read_gray8(path), want.numpy()),
              f"{path} does not decode to the generator's map")
    # K5 at this path's shapes, outside the counted windows: one label-set
    # image's softmax planes and ids, built as plbl_for_batch builds them
    b = {k: (v[None] if isinstance(v, np.ndarray) else [v])
         for k, v in label[0].items()}
    pixel_valid = gen.host_prep(b, label.suppix)[-1]
    _, logits = eval_forward(model, b["images"], gen.dev, gen.autocast,
                             return_feat=True, feat_bf16=gen.sim_bf16)
    planes = torch.softmax(logits[0].float(), dim=0).reshape(
        NUM_CLASSES, H * W).t()
    sid = torch.from_numpy(np.where(pixel_valid, b["spx"][0].reshape(-1),
                                    NSEG).astype(np.int32)).to(dev)
    k5_err = check_k5(planes, sid, f"al_rounds label image, {H}x{W}")
    print(f"K5 bitwise equal to its plain version on a label-set image "
          f"({H}x{W}, {int((sid < NSEG).sum())} of {H * W} pixels valid)",
          flush=True)
    del gen, model, logits, planes

    # stage 2 on the pseudo-labels, the images read back from RGB PNGs
    im_idx = []
    for key in label.im_idx:
        img = os.path.join(workdir, "images", key[0])
        os.makedirs(os.path.dirname(img), exist_ok=True)
        write_rgb8(img, label.images[label.id_to_index[key[1].split(".")[0]]])
        im_idx.append([img, key[1], key[2]])
    s2cfg = Config(method="active_predignore", stage2=True,
                   model_save_dir=run, **common)
    stage2 = RegionDatasetPlbl(s2cfg, im_idx, plbl_dir)
    # its items are built in worker processes: start them before the clock
    start_workers(s2cfg.num_workers)

    class Stage2Set:
        def get_trainset(self):
            return stage2

    s2losses = []
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer = rounds.ALTrainer(s2cfg, 2, val_dataset=val,
                               eval_dataset=evalset, device=dev)
    trainer.load(init)
    check(torch.equal(trainer.model.classifier.proxy.detach().cpu(),
                      get_model(cfg.model, cfg.num_model_classes,
                                cfg.output_stride, separable_conv=True,
                                device="cpu").classifier.proxy.detach()),
          "stage 2: the init file's classifier was not stripped")
    trainer.checkpoint_file = os.path.join(run, "stage2_checkpoint02")
    s2_rate = trainer.train(Stage2Set(), metrics_cb=lambda it, aux:
                            s2losses.append(aux))
    if trainer.best_iou == 0.0:
        trainer.save()
    s2_miou, _ = trainer.eval()
    _sync(dev)
    s2_s = time.perf_counter() - t0
    s2_launches = dict(_build.LAUNCHES)
    want = bn_launches(s2cfg.model, s2cfg.finetune_itrs)
    check(s2_launches == want, f"stage 2 launched kernels {s2_launches}, "
          f"want {want} (each BN kernel once a BN and step)")
    check(len(s2losses) == 3 and all(math.isfinite(a["train_loss"])
                                     for a in s2losses),
          f"bad stage-2 losses {s2losses}")
    check(os.path.exists(trainer.checkpoint_file) and math.isfinite(s2_miou),
          f"stage 2: no checkpoint or bad mIoU {s2_miou}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer
    torch.cuda.empty_cache()

    line = {"al_rounds": {
        "card": smi, "config": f"{cfg.model} separable, {NUM_CLASSES} "
        f"outputs, bf16, batch {B}, {H}x{W}, nseg {NSEG}, pool {AL_POOL}, "
        f"val/eval {AL_VAL}, {AL_ITRS} steps a round, budget {AL_BUDGET} "
        "clicks", "setup_s": setup_s, "rounds_s": rounds_s,
        "rounds": {r: {"select_s": sum(v["select_s"]),
                       "train_img_per_s": v["train_img_per_s"][0],
                       "train_s": v["train_s"][0],
                       "validations": v["validations"],
                       "eval_miou": results[r],
                       "checkpoint_save_s": v["save_s"],
                       "checkpoint_load_s": v["load_s"]}
                   for r, v in per_round.items()},
        "round2_regions": len(chosen), "round2_clicks": sum(clicks),
        "plbl_img_per_s": n_lbl / plbl_s, "plbl_miou": plbl_miou,
        "stage2_img_per_s": s2_rate, "stage2_s": s2_s,
        "stage2_miou": s2_miou, "stage2_loss": s2losses[-1]["train_loss"],
        "k5_max_abs_err": k5_err, "peak_mem_gib": peak_gib}}
    launches = Counter(round_launches) + Counter(plbl_launches)
    return line, dict(launches)


# -- the round loop's parity fixture (round_parity) ----------------------------
def rp_model(variables=None, device="cpu"):
    """The fixture's model: the CPU tests' small DeepLabV3+ twin (ResNet
    (2, 2, 2, 2) with a deep stem of 16, planes 16-128, the separable
    weight-normalised head with 12 low-level and 64 mid channels,
    RP_CLASSES outputs), dropout off, with `variables` (the JAX package's
    layout) carried in when given."""
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
    from mulactseg_tpu_torch.models.layers import Dropout
    from mulactseg_tpu_torch.models.resnet import ResNet

    model = DeepLabV3(
        ResNet(layers=(2, 2, 2, 2), deep_stem=True, stem_width=16,
               stage_planes=(16, 32, 64, 128)),
        DeepLabHeadV3Plus(512, 64, RP_CLASSES, (6, 12, 18), variant="wn",
                          separable=True, low_channels=12, mid_channels=64))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    if variables is not None:
        convert.load_variables(model, variables)
    return model.to(device)


def rp_init(seed=RP_SEED):
    """The fixture's seeded init, in the JAX package's layout."""
    from mulactseg_tpu_torch.models import convert

    return convert.random_variables(rp_model(), seed)


def rp_config_kw(fx, workdir, rounds=RP_ROUNDS):
    """The fixture's configuration as keywords both packages' Config take:
    the recipe's criterion and selectors, float32, SGD (momentum 0.9)."""
    return dict(
        num_classes=RP_CLASSES - 1, nseg=fx["nseg"],
        crop_size=(fx["hh"], fx["hh"]), train_batch_size=fx["batch"],
        finetune_itrs=fx["steps"],
        val_period=fx["val_period"] or fx["steps"], val_start=0,
        max_iterations=rounds, active_selection_size=fx["budget"],
        val_batch_size=fx["batch"], num_workers=2, val_num_workers=2,
        model_save_dir=str(workdir), dtype="float32", optimizer="sgd",
        train_lr=fx["lr"], cls_lr_scale=10.0, n_devices=1, log_period=1,
        method="active_joint_multi_predignore_lossdecomp")


def rp_datasets(cls, fx, seed=1):
    """Pool, empty label set and val set of the fixture, made by `cls`
    (either package's SyntheticRegionDataset)."""
    def make(split, n):
        return cls(n_images=n, H=fx["hh"], W=fx["hh"],
                   num_classes=RP_CLASSES - 1, nseg=fx["nseg"], split=split,
                   seed=seed)

    pool, label = make("active-ulabel", fx["pool"]), make("active-label",
                                                          fx["pool"])
    label.suppix, label.im_idx = {}, []
    return pool, label, make("val", fx["val"])


def rp_selection_file(r):
    return (f"{'my_random' if r == 1 else 'my_bvsb_predclsbal_pwr_banignore'}"
            f"_selection_{r:02d}.json")


def rp_selected(workdir, r):
    """Round r's selected regions, {(label file, superpixel)}."""
    with open(os.path.join(workdir, rp_selection_file(r))) as f:
        return {(p, i) for _, p, i in json.load(f)}


def jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def rp_label_set(cls, fx, workdir, r):
    """The label set as round r left it (its datalist), made by `cls`."""
    label = rp_datasets(cls, fx)[1]
    with open(os.path.join(workdir, f"datalist_{r:02d}.json")) as f:
        data = json.load(f)
    label.im_idx = [list(k) for k in data["trg_label_im_idx"]]
    label.suppix = {k: list(v) for k, v in data["trg_label_suppix"].items()}
    return label


def rp_rounds(fx, variables, workdir, device, rounds=RP_ROUNDS):
    """The port's run_al_rounds on the fixture from `variables` (saved as
    the init checkpoint in `workdir`): round 1 my_random, then the
    paper's selector from the previous round's checkpoint, start_over,
    validation every fx["val_period"] steps (None: off, each round keeps
    its last step). Returns {"miou": {round: eval mIoU}, "step0": [each
    round's step-0 loss]}; the files are in `workdir`."""
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine import rounds as port_rounds
    from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint

    cfg = Config(**rp_config_kw(fx, workdir, rounds))
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, "init")
    save_checkpoint(init, rp_model(variables))
    step0 = []
    pool, label, val = rp_datasets(SyntheticRegionDataset, fx)
    with mock.patch.object(port_rounds, "get_model",
                           lambda *a, **k: rp_model(variables)):
        miou = port_rounds.run_al_rounds(
            cfg, RegionActiveSet(cfg, pool, label),
            val_dataset=val if fx["val_period"] else None, eval_dataset=val,
            init_checkpoint=init, device=device,
            metrics_cb=lambda it, aux: it or step0.append(
                float(aux["train_loss"])))
    return {"miou": miou, "step0": step0}


def rp_generator(fx, state_dict, device):
    """The recipe's pseudo-labeller (eval_save_cosplbl_prop_includeonehot)
    of the fixture's model with the weights `state_dict`, float32, on
    `device`."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.plbl import METHOD_TO_PLBL, PseudoLabelGenerator

    model = rp_model(device=device)
    model.load_state_dict(state_dict)
    cfg = Config(**{**rp_config_kw(fx, "unused"),
                    "method": "eval_save_cosplbl_prop_includeonehot"})
    return PseudoLabelGenerator(model, cfg, METHOD_TO_PLBL[cfg.method],
                                device=device)


def rp_batches(label):
    """The label set's items as single-image batches, in order."""
    from mulactseg_tpu_torch.data.loader import DataProvider

    return DataProvider(label, 1, shuffle=False, drop_last=False,
                        infinite=False, num_workers=0)


def rp_plbl(gen, label):
    """gen's pseudo-labels of `label`: {label file: (H, W) uint8 map}."""
    with torch.no_grad():
        return {b["fnames"][0][1]: gen.plbl_for_batch(b, label.suppix).to(
            torch.uint8).cpu().numpy() for b in rp_batches(label)}


def plbl_margins(gen, batch, suppix):
    """How far each pixel's cosine pseudo-label decision is from flipping,
    in float64 from gen's float32 forward of one image, for the recipe's
    type (cosprop_includeonehot: propagation, median thresholds, no
    filters; plbl/cosine_prop.py): for a pixel with prototypes of its own
    superpixel, its best similarity less the best of another class; for
    a propagated pixel, the least distance of a candidate's similarity to
    that prototype's threshold, and the best similarity among the
    winning superpixel's prototypes less the best of another class.
    (P,) numpy, inf where no decision could flip."""
    from mulactseg_tpu_torch.engine.evaluate import eval_forward

    feat, logits = eval_forward(gen.model, batch["images"], gen.dev, False,
                                return_feat=True)
    return decision_margins(
        feat[0].flatten(1).t(), torch.softmax(logits[0].float(), dim=0),
        batch["spx"][0], gen.host_prep(batch, suppix), gen.cfg.nseg)


def decision_margins(feat, probs, spx, prep, nseg):
    """plbl_margins' float64 part: feat (P, Ch) of one image, probs its
    (C, H, W) softmax, spx its (H, W) superpixel map and prep the
    generator's host_prep of it. (P,) numpy."""
    from mulactseg_tpu_torch.ops.segment_max import segment_max_plain

    _, _, psid, pcls, pok, adj, valid = (
        torch.from_numpy(np.asarray(a)) for a in prep)
    psid, pcls, valid = psid.long(), pcls.long(), valid.bool()
    f = torch.as_tensor(feat).double().cpu()
    probs = torch.as_tensor(probs).float().flatten(1).t().cpu()
    spx = torch.from_numpy(np.asarray(spx).reshape(-1)).long()
    P, S, inf = f.shape[0], nseg, float("inf")
    _, argpix = segment_max_plain(probs, torch.where(valid, spx, S).int(), S)
    src = argpix[psid.clamp(0, S - 1), pcls].long()
    pok = pok.bool() & (src < P) & (psid < S)
    sim = f @ torch.where(pok[:, None], f[src.clamp(0, P - 1)], 0.0).t()

    def gap(mask):
        s = torch.where(mask, sim, -inf)
        best = pcls[s.argmax(-1)]
        other = mask & (pcls[None, :] != best[:, None])
        g = s.amax(-1) - torch.where(other, sim, -inf).amax(-1)
        return torch.nan_to_num(g, nan=inf)

    own = (psid[None, :] == spx[:, None]) & pok[None, :]
    s_own = torch.where(own, sim, -inf)
    assigned = valid & own.any(-1)
    key = torch.where(assigned, s_own.argmax(-1), -1)
    thr = torch.ones(psid.shape[0], dtype=torch.float64)
    for k in key[key >= 0].unique().tolist():
        v = s_own.amax(-1)[key == k].sort().values
        thr[k] = v[(v.numel() - 1) // 2]  # the lower median
    cand = adj.t()[spx] & pok[None, :]
    to_thr = torch.where(cand, (sim - thr[None, :]).abs(), inf).amin(-1)
    top = torch.where(cand & (sim > thr[None, :]), psid[None, :], -1).amax(-1)
    within_top = gap(cand & (psid[None, :] == top[:, None]))
    return torch.where(assigned, gap(own),
                       torch.minimum(to_thr, within_top)).numpy()


def round_parity_slice(dev, smi, workdir):
    """The round loop held against itself across devices (docstring, item
    8h): RP_ROUNDS free-running rounds of the fixture on the card, then
    on the CPU through the plain versions, and the pseudo-labels of the
    card's last checkpoint on both. Returns (its line, the path's
    launches)."""
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine.checkpoint import load_checkpoint
    from mulactseg_tpu_torch.ops import _build

    fx = RP_FIXTURE
    variables = rp_init()
    t0 = time.perf_counter()
    _sync(dev)
    _build.reset_launches()
    card = rp_rounds(fx, variables, os.path.join(workdir, "card"), dev)
    _sync(dev)
    round_launches = dict(_build.LAUNCHES)
    card_s = time.perf_counter() - t0
    steps = RP_ROUNDS * fx["steps"]
    want = {**{k: steps for k in STAGE1_KERNELS},
            **bn_launches(rp_model(), steps)}
    check(round_launches == want, f"round parity: launches "
          f"{round_launches}, want {want} (K1-K4 once per stage-1 step, "
          f"{steps}, each BN kernel once a BN and step, and no other)")
    t1 = time.perf_counter()
    cpu = rp_rounds(fx, variables, os.path.join(workdir, "cpu"), "cpu")
    cpu_s = time.perf_counter() - t1
    rows = []
    for r in range(1, RP_ROUNDS + 1):
        a, b = (rp_selected(os.path.join(workdir, side), r)
                for side in ("card", "cpu"))
        gap = abs(card["step0"][r - 1] - cpu["step0"][r - 1]) / max(
            abs(cpu["step0"][r - 1]), 1e-6)
        rows.append({"round": r, "jaccard": jaccard(a, b),
                     "regions": len(b), "step0_rel_gap": gap,
                     "miou": [card["miou"][r], cpu["miou"][r]]})
        print(f"round parity, round {r}: card against CPU selection "
              f"Jaccard {rows[-1]['jaccard']} ({len(a)}/{len(b)} regions), "
              f"step-0 loss gap {gap:.3e} relative", flush=True)
    # the pseudo-labels of the card's last checkpoint, on the card and on
    # the CPU, and of each side's own last checkpoint
    last = f"checkpoint{RP_ROUNDS:02d}"
    label = rp_label_set(SyntheticRegionDataset, fx,
                         os.path.join(workdir, "card"), RP_ROUNDS)
    weights = load_checkpoint(os.path.join(workdir, "card", last))[
        "model_state_dict"]
    card_gen = rp_generator(fx, weights, dev)
    _sync(dev)
    _build.reset_launches()
    on_card = rp_plbl(card_gen, label)
    _sync(dev)
    plbl_launches = dict(_build.LAUNCHES)
    cpu_gen = rp_generator(fx, weights, "cpu")
    on_cpu = rp_plbl(cpu_gen, label)
    own_cpu = rp_plbl(rp_generator(fx, load_checkpoint(os.path.join(
        workdir, "cpu", last))["model_state_dict"], "cpu"), label)
    # each pixel where the card's map differs: its decision's margin on
    # the CPU
    margins = []
    for b in rp_batches(label):
        k = b["fnames"][0][1]
        d = np.flatnonzero(on_card[k] != on_cpu[k])
        if d.size:
            margins += plbl_margins(cpu_gen, b, label.suppix)[d].tolist()
    wall_s = time.perf_counter() - t0
    n_lbl = len(label)
    check(plbl_launches == {"seg_max_fwd": n_lbl},
          f"round parity plbl of {n_lbl} images launched {plbl_launches}, "
          "want seg_max_fwd once per image")
    differ = len(margins)
    free = sum(int((on_card[k] != own_cpu[k]).sum()) for k in on_cpu)
    pixels = sum(m.size for m in on_cpu.values())
    widest = max(margins, default=None)
    print(f"round parity plbl at the card's round-{RP_ROUNDS} checkpoint: "
          f"{differ} of {pixels} pixels differ between card and CPU, their "
          f"decision margins at most {widest} ({free} against the CPU's own "
          "checkpoint)", flush=True)
    print(f"round parity: {wall_s:.1f} s ({card_s:.1f} s the card's rounds, "
          f"{cpu_s:.1f} s the CPU's) on {smi}", flush=True)
    check(all(r["jaccard"] == 1.0 and r["regions"] > 0 for r in rows),
          f"round parity: the card's selections part from the CPU's {rows}")
    check(on_cpu.keys() == on_card.keys() and any(
        bool((m != 255).any()) for m in on_cpu.values()),
          "round parity: no pseudo-labels")
    check(differ <= RP_PLBL_TIES * pixels and all(
        m <= RP_TIE_MARGIN for m in margins),
          f"round parity: {differ} plbl pixels differ between card and CPU, "
          f"their decision margins at most {widest}")
    check(all(math.isfinite(v) for v in card["step0"] + cpu["step0"]),
          "round parity: non-finite step-0 loss")
    line = {"round_parity": {
        "card": smi, "fixture": fx, "rounds": rows, "wall_s": wall_s,
        "card_rounds_s": card_s, "cpu_rounds_s": cpu_s,
        "plbl_images": n_lbl, "plbl_pixels": pixels,
        "plbl_pixels_differ_synced": differ,
        "plbl_differ_margin_max": widest,
        "plbl_pixels_differ_free": free}}
    return line, dict(Counter(round_launches) + Counter(plbl_launches))


# -- the bf16 recipe path against the JAX package's bf16 model (bf16_parity) --
def tree_leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, the keys joined by '/', sorted."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out += tree_leaves(tree[k], path)
        else:
            out.append((path, tree[k]))
    return out


def variables_digest(variables):
    """sha256 of a variable tree: each leaf's path, shape and float32
    bytes, in sorted order."""
    h = hashlib.sha256()
    for path, a in tree_leaves(variables):
        a = np.ascontiguousarray(np.asarray(a, np.float32))
        h.update(f"{path}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def bf16_recipe(name):
    """The fixture's entry of BF16_RECIPES."""
    return BF16_RECIPES[BF16_FIXTURES[name]["recipe"]]


def bf16_num_classes(name):
    """The fixture's real classes: its outputs less the predignore class
    where the recipe's model has one."""
    return BF16_FIXTURES[name]["classes"] - bf16_recipe(name)["predignore"]


def bf16_config_kw(name, stage=None):
    """The fixture's configuration as keywords both packages' Config take:
    the recipe's model, criterion and optimizer (AdamW, poly), bf16;
    stage "plbl" or "stage2" for its pseudo-labeller's or stage 2's."""
    fx = BF16_FIXTURES[name]
    recipe = bf16_recipe(name)
    kw = dict(num_classes=bf16_num_classes(name), nseg=fx["nseg"],
              crop_size=(fx["hw"], fx["hw"]), train_batch_size=fx["batch"],
              val_batch_size=2, num_workers=0, val_num_workers=0,
              dtype="bfloat16", separable_conv=True, n_devices=1,
              **recipe["config"])
    if stage == "plbl":
        kw["method"] = recipe["plbl_method"]
    elif stage == "stage2":
        kw.update(recipe["stage2"])
    return kw


def bf16_reference_of(name):
    """The fixture's entry of its reference file (BF16_FILES)."""
    return bf16_reference(BF16_FILES[name])[name]


def bf16_model(name, variables=None, device="cpu"):
    """The fixture's model on `device`, dropout off (its noise is
    framework-specific): the recipe's at full width, or rp_model's twin;
    `variables` (the JAX package's layout) carried in when given."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.models.layers import Dropout

    if name == "twin":
        return rp_model(variables, device)
    cfg = Config(**bf16_config_kw(name))
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=device)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    if variables is not None:
        convert.load_variables(model, variables)
    return model


def bf16_variables(name):
    """The fixture's weights in the JAX package's layout, from seeds alone:
    models/convert.random_variables from the fixture's seed, then (as
    tests/test_torch_port_model.py's perturb) every BN scale and variance
    scaled by U(0.8, 1.2) and every BN bias and mean shifted by U(-0.1,
    0.1), drawn in sorted leaf order from the seed + 1, so that every
    leaf shows in the outputs; the scale of each residual block's last
    BN (bn3) then times BF16_RESIDUAL_SCALE."""
    from mulactseg_tpu_torch.models import convert

    seed = BF16_FIXTURES[name]["seed"]
    variables = convert.random_variables(bf16_model(name), seed)
    rng = np.random.RandomState(seed + 1)
    for path, a in tree_leaves(variables):
        leaf = path.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            a *= rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        elif leaf in ("bias", "mean"):
            a += rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
        if path.endswith("/bn3/scale"):
            a *= np.float32(BF16_RESIDUAL_SCALE)
    return variables


def bf16_inputs(name):
    """The fixture's inputs, numpy from its seed + 2: BF16_STEPS train
    batches (images (B, 3, H, W) float32 at per-image scales and offsets;
    labels, a ground truth of 3 x 3 cells of the n real classes or
    ignore; irregular superpixels; target, the multi-hot of the labels in
    each superpixel, (B, S, C), whose last channel is ignore's where the
    model has the predignore class (C = n + 1) and is dropped where it has
    not (C = n, as VOC's loader drops it); spmask over a 60% selection,
    with its ids in 'selected'; target_bits), the first of which the eval,
    the train-mode forward and the pseudo-labeller read; and the
    selector's pool: uint8 (N, H, W, 3) images, their ground truth and one
    superpixel map."""
    from mulactseg_tpu_torch.data.synthetic import (
        irregular_superpixels,
        multi_hot_from_gt,
    )
    from mulactseg_tpu_torch.losses.fused import pixel_target_bits

    fx = BF16_FIXTURES[name]
    B, hw, S, C = fx["batch"], fx["hw"], fx["nseg"], fx["classes"]
    n = bf16_num_classes(name)
    rng = np.random.RandomState(fx["seed"] + 2)

    def ground_truth(k):
        # 3 x 3 cells of a class each, class n standing for ignore, so
        # that some superpixels hold one class (the CE term's pixels)
        cells = rng.randint(0, n + 1, (k, 3, 3))
        idx = np.arange(hw) * 3 // hw
        gt = cells[:, idx[:, None], idx[None, :]]
        return np.where(gt == n, 255, gt).astype(np.int32)

    batches = []
    for _ in range(BF16_STEPS):
        spx = np.stack([irregular_superpixels(hw, hw, S, rng)
                        for _ in range(B)]).astype(np.int32)
        labels = ground_truth(B)
        target = np.stack([multi_hot_from_gt(labels[b], spx[b], S, n)[:, :C]
                           for b in range(B)])
        sel = rng.rand(B, S) < 0.6
        spmask = np.take_along_axis(sel, spx.reshape(B, -1), 1).reshape(
            B, hw, hw)
        images = (rng.randn(B, 3, hw, hw)
                  * np.linspace(0.5, 2.0, B)[:, None, None, None]
                  + np.linspace(-2.0, 2.0, B)[:, None, None, None]
                  ).astype(np.float32)
        batches.append({
            "images": images, "labels": labels, "target": target,
            "spx": spx, "spmask": spmask,
            "target_bits": np.stack([pixel_target_bits(target[b], spx[b],
                                                       spmask[b])
                                     for b in range(B)]),
            "selected": [np.flatnonzero(s).tolist() for s in sel]})
    pool = {"images": rng.randint(0, 256, (fx["pool"], hw, hw, 3)).astype(
                np.uint8),
            "labels": ground_truth(fx["pool"]),
            "spx": irregular_superpixels(hw, hw, S, rng).astype(np.int32)}
    return batches, pool


def bf16_pixels(name, n):
    """A seeded sample of n of the fixture's B * H * W pixels, sorted: the
    pixels of the float maps that the reference keeps."""
    fx = BF16_FIXTURES[name]
    rng = np.random.RandomState(fx["seed"] + 3)
    return np.sort(rng.choice(fx["batch"] * fx["hw"] ** 2, n, replace=False))


def bf16_sample(name, key, x, n):
    """A seeded sample of n of the values of x (flat, C order; seeded by
    the fixture and the output's key), in order; all of them where x has
    no more."""
    x = np.asarray(x).reshape(-1)
    if x.size <= n:
        return x.copy()
    rng = np.random.RandomState(zlib.crc32(f"{name}/{key}".encode()))
    return x[np.sort(rng.choice(x.size, n, replace=False))]


def bf16_grad_outputs(name, grads):
    """A step-0 gradient as the reference keeps it, from either package's
    tree in the JAX layout: a sample of BF16_GRAD_VALUES values of its
    leaves in sorted order, and its norm per leaf."""
    leaves = tree_leaves(grads)
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for _, a in leaves])
    return {"grad0": bf16_sample(name, "grad0", flat, BF16_GRAD_VALUES),
            "grad0_norm": {k: np.float64(np.linalg.norm(a))
                           for k, a in leaves}}


def bf16_step_outputs(name, grads, before, after):
    """The train step's outputs that the reference keeps, from either
    package's trees in the JAX layout: the step-0 gradient
    (bf16_grad_outputs); the norm per leaf of the parameters' update over
    the steps."""
    before = dict(tree_leaves(before))
    return {**bf16_grad_outputs(name, grads),
            "update_norm": {k: np.float64(np.linalg.norm(
                np.float64(a) - before[k])) for k, a in tree_leaves(after)}}


def bf16_pool_sets(cls, name, pool):
    """Pool and empty label set of the selector over `pool`, made by `cls`
    (either package's SyntheticRegionDataset) with its images, ground
    truth and superpixel map put in."""
    from mulactseg_tpu_torch.data.synthetic import multi_hot_from_gt

    fx = BF16_FIXTURES[name]
    n = bf16_num_classes(name)
    out = []
    for split in ("active-ulabel", "active-label"):
        ds = cls(n_images=fx["pool"], H=fx["hw"], W=fx["hw"],
                 num_classes=n, nseg=fx["nseg"], split=split)
        ds.images = list(pool["images"])
        ds.gts = list(pool["labels"])
        ds.spx_map = pool["spx"]
        # the training targets' channels (bf16_inputs): fair counting
        # counts them
        ds.multi_hot_cls = np.stack([
            multi_hot_from_gt(g, pool["spx"], fx["nseg"], n)[:, :fx["classes"]]
            for g in ds.gts])
        ds.isselected = np.zeros(ds.multi_hot_cls.shape[:-1], np.float32)
        ds.suppix = {k[2]: np.unique(pool["spx"]).tolist() for k in ds.im_idx}
        out.append(ds)
    out[1].suppix, out[1].im_idx = {}, []
    return out


def bf16_plbl_items(batch, layout="nchw"):
    """The first train batch as the pseudo-labeller's single-image items
    (the eval_region_*_all contract) and its suppix: each image's selected
    superpixels. layout "nhwc" for the JAX package."""
    items, suppix = [], {}
    for b in range(batch["images"].shape[0]):
        img = batch["images"][b:b + 1]
        key = [f"img_{b}.png", f"lbl_{b}.png", f"spx_{b}.pkl"]
        items.append({
            "images": img.transpose(0, 2, 3, 1) if layout == "nhwc" else img,
            "labels": batch["labels"][b:b + 1],
            "target": batch["target"][b:b + 1],
            "spx": batch["spx"][b:b + 1], "spmask": batch["spmask"][b:b + 1],
            "fnames": [key]})
        suppix[key[2]] = batch["selected"][b]
    return items, suppix


def eval_confusion(pred, labels, n):
    """(n, n) confusion matrix of a predicted map against the ground truth
    (255 ignored), rows the truth."""
    ok = labels != 255
    return np.bincount(labels[ok].astype(np.int64) * n + pred[ok],
                       minlength=n * n).reshape(n, n)


def bf16_outputs_common(name, eval_logits, eval_feat, labels):
    """The eval outputs both packages derive alike: the logits and features
    at the kept pixels (rows of (pixels, channels)), the argmax over the n
    real classes (predignore's where the model has that class), and its
    confusion matrix."""
    n = bf16_num_classes(name)
    pred = eval_logits[:, :n].argmax(1).astype(np.uint8)

    def rows(x, n):
        return np.ascontiguousarray(x.transpose(0, 2, 3, 1).reshape(
            -1, x.shape[1])[bf16_pixels(name, n)])

    return {"eval_logits": rows(eval_logits, BF16_LOGIT_PIXELS),
            "eval_feat": rows(eval_feat, BF16_FEAT_PIXELS),
            "eval_pred": pred,
            "eval_confusion": eval_confusion(pred, labels, n)}


def bf16_tta_views():
    """The TTA forward's views: 2 x len(TTA_SCALES), read at call time."""
    from mulactseg_tpu_torch.engine.tta import TTA_SCALES

    return 2 * len(TTA_SCALES)


def bf16_tta_key(i, stage):
    """The reference's key of a stage output of the TTA forward's view i
    (engine/tta.py's order: the scales unflipped, then flipped), e.g.
    'stage_tta/1.25f/stem'."""
    from mulactseg_tpu_torch.engine.tta import TTA_SCALES

    flip, k = divmod(i, len(TTA_SCALES))
    return f"stage_tta/{TTA_SCALES[k]}{'f' if flip else ''}/{stage}"


def bf16_stage2_outputs(loss, grads):
    """Stage 2's step-0 outputs that the reference keeps, from either
    package's gradient tree in the JAX layout: the loss and the norm per
    leaf."""
    return {"s2_loss0": np.array([loss]),
            "s2_grad0_norm": {k: np.float64(np.linalg.norm(np.asarray(
                a, np.float32))) for k, a in tree_leaves(grads)}}


def bf16_port_outputs(name, variables, inputs, device, cpu_autocast=False,
                      parts=BF16_OUTPUT_PARTS, s2_labels=None):
    """The port's bf16 path on `device` through its entry points, from the
    fixture's weights, in the parts of BF16_OUTPUT_PARTS asked for: "eval",
    make_eval_step and eval_forward (features) with each stage's output;
    "train", a train-mode forward (logits, BN statistics, each stage's
    output) and BF16_STEPS make_train_step steps (the step-0 loss and
    parts, the step-0 gradient, each step's loss, the update of the
    parameters); "plbl", the recipe's PseudoLabelGenerator.generate (its
    PNGs read back), with TTA also the BF16_TTA_STAGES outputs of the
    first image's views; "select", the recipe's selector (scores and
    selected regions); "stage2", where the recipe holds it, stage 2's
    make_train_step at step 0 on s2_labels (the reference's pseudo-labels;
    by default this run's), its loss and gradient. cpu_autocast runs the
    CPU under bfloat16 autocast where the card would. Returns {key:
    array, or {leaf path: array}}, as the reference stores them."""
    from types import SimpleNamespace

    from mulactseg_tpu_torch import device as port_device
    from mulactseg_tpu_torch.acquisition import get_selector
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine import train as port_train
    from mulactseg_tpu_torch.engine.evaluate import eval_forward
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.plbl import generator as port_generator
    from mulactseg_tpu_torch.utils.png import read_gray8

    dev = torch.device(device)
    cfg = Config(**bf16_config_kw(name))
    recipe = bf16_recipe(name)
    batches, pool = inputs
    b0 = batches[0]
    model = bf16_model(name, variables, dev)
    autocast = cpu_autocast or port_device.bf16_autocast(dev, cfg)
    out = {}
    with contextlib.ExitStack() as stack:
        if cpu_autocast:
            for mod in (port_train, port_generator):
                stack.enter_context(mock.patch.object(
                    mod, "bf16_autocast", lambda d, c: True))
        stages = {}
        hooks = [model.get_submodule(path).register_forward_hook(
            lambda m, i, o, s=stage: stages.__setitem__(s, o))
            for stage, path in BF16_STAGE_MODULES.items()]

        def stage_outputs(mode):
            return {f"stage_{mode}/{k}": bf16_sample(
                name, f"stage_{mode}/{k}", v.float().cpu().numpy(),
                BF16_STAGE_VALUES) for k, v in stages.items()}

        predict = port_train.make_eval_step(model, cfg, device=dev)
        if "eval" in parts:
            logits = predict(b0["images"]).cpu().numpy()
            out.update(stage_outputs("eval"))
            feat, _ = eval_forward(model, b0["images"], dev, autocast,
                                   return_feat=True)
            out.update(bf16_outputs_common(
                name, logits, feat.float().cpu().numpy(), b0["labels"]))
        if "train" in parts:
            model.train()
            with torch.no_grad(), torch.autocast(
                    dev.type, dtype=torch.bfloat16, enabled=autocast):
                train_logits = model(torch.as_tensor(b0["images"]).to(dev))
            out.update(stage_outputs("train"))
        for h in hooks:
            h.remove()
        if "train" in parts:
            out["train_logits"] = np.ascontiguousarray(
                train_logits.cpu().numpy().transpose(0, 2, 3, 1).reshape(
                    -1, train_logits.shape[1])[bf16_pixels(
                        name, BF16_LOGIT_PIXELS)])
            stats = dict(tree_leaves(variables["batch_stats"]))
            out["bn_delta"] = {k: a - stats[k] for k, a in tree_leaves(
                convert.state_dict_to_variables(model.state_dict())[
                    "batch_stats"])}
            convert.load_variables(model, variables)
            step = port_train.make_train_step(model, cfg, device=dev)
            losses = []
            for i, batch in enumerate(batches):
                aux = step(batch)
                if i == 0:
                    out["loss0"] = np.array([float(aux[k])
                                             for k in BF16_PARTS])
                    grads = convert.state_dict_to_variables(
                        {n: p.grad for n, p in model.named_parameters()})
                losses.append(float(aux["train_loss"]))
            out["losses"] = np.array(losses)
            out.update(bf16_step_outputs(
                name, grads, {"params": variables["params"]},
                convert.state_dict_to_variables(
                    dict(model.named_parameters()))))
            convert.load_variables(model, variables)
        if "plbl" in parts:
            items, suppix = bf16_plbl_items(b0)
            gen = port_generator.PseudoLabelGenerator(
                model, Config(**bf16_config_kw(name, "plbl")),
                "cosprop_includeonehot", use_tta=recipe["tta"], device=dev)
            # the first image's TTA views, by stage, in the forward's order
            views = {stage: [] for stage in BF16_TTA_STAGES}
            n_views = bf16_tta_views()

            def keep(stage, out):
                if len(views[stage]) < n_views:
                    views[stage].append(out.float().cpu().numpy())

            hooks = [model.get_submodule(BF16_STAGE_MODULES[stage])
                     .register_forward_hook(
                         lambda m, i, o, s=stage: keep(s, o))
                     for stage in BF16_TTA_STAGES] if recipe["tta"] else []
            with tempfile.TemporaryDirectory() as tmp:
                gen.generate(None, items, save_dir=tmp, suppix=suppix)
                out["plbl"] = np.stack([read_gray8(os.path.join(
                    tmp, f"lbl_{b}.png")) for b in range(len(items))])
            for h in hooks:
                h.remove()
            for stage, arrays in views.items():
                for i, a in enumerate(arrays):
                    key = bf16_tta_key(i, stage)
                    out[key] = bf16_sample(name, key, a, BF16_STAGE_VALUES)
        if "select" in parts:
            out.update(bf16_selection(
                name, get_selector(cfg.active_method, cfg),
                SimpleNamespace(predict_logits=predict), RegionActiveSet,
                cfg, *bf16_pool_sets(SyntheticRegionDataset, name, pool)))
        if "stage2" in parts and recipe["stage2"]:
            labels = out["plbl"] if s2_labels is None else s2_labels
            step = port_train.make_train_step(
                model, Config(**bf16_config_kw(name, "stage2")), device=dev)
            aux = step({"images": b0["images"],
                        "labels": np.asarray(labels, np.int32)})
            out.update(bf16_stage2_outputs(
                float(aux["train_loss"]), convert.state_dict_to_variables(
                    {n: p.grad for n, p in model.named_parameters()})))
            convert.load_variables(model, variables)
    return out


def bf16_selection(name, selector, trainer, active_set_cls, cfg, pool,
                   label):
    """The selector's region scores (pool images, nseg) and its selected
    regions at the fixture's budget, as a bool (pool images, nseg) array;
    either package's selector, trainer and active set."""
    fx = BF16_FIXTURES[name]
    scores = np.full((fx["pool"], fx["nseg"]), np.nan, np.float32)
    for score, path, i in selector.calculate_scores(trainer, pool):
        scores[int(path.split(",")[2][4:-4]), i] = score
    selector.select_next_batch(trainer, active_set_cls(cfg, pool, label),
                               fx["budget"])
    selected = np.zeros(scores.shape, bool)
    for spx_path, ids in label.suppix.items():
        selected[int(spx_path[4:-4]), ids] = True
    return {"scores": scores, "selected": selected}


def bf16_flatten(tree):
    """{fixture: {key: array or {leaf: array}}} -> the .npz's flat
    {"fixture/key": array, "fixture/key::leaf": array}."""
    flat = {}
    for name, outputs in tree.items():
        for key, v in outputs.items():
            if isinstance(v, dict):
                for leaf, a in v.items():
                    flat[f"{name}/{key}::{leaf}"] = np.asarray(a)
            else:
                flat[f"{name}/{key}"] = np.asarray(v)
    return flat


def bf16_reference(path=BF16_REFERENCE):
    """The reference file, unflattened: {fixture: {key: array or {leaf:
    array}}}. Its keys beside the outputs: 'digest' (variables_digest of
    the fixture's weights), 'spread_input/<key>' and 'spread_weights/
    <key>' (how far the JAX package moves from itself under one bf16 ulp
    on 1% of its input pixels, and under its weights scaled by 1 + 1e-3
    N(0, 1)), 'flips/<key>' (the pixels or regions of an exact output
    that flip under either), 'novel/<key>' (the most of those one
    perturbed run flips alone), 'plbl_margin' (each pseudo-label
    pixel's decision margin, decision_margins) and, where the recipe
    holds world 2, 'world2/<key>' (the JAX package's step on a 2-device
    mesh: grad0, grad0_norm, loss0, and its cosine and rel_l2 to the
    1-device gradient)."""
    ref = {}
    with np.load(path) as z:
        for k in z.files:
            name, rest = k.split("/", 1)
            key, _, leaf = rest.partition("::")
            node = ref.setdefault(name, {})
            if leaf:
                node.setdefault(key, {})[leaf] = z[k]
            else:
                node[key] = z[k]
    return ref


def bf16_distance(key, got, want):
    """How far a float output lies from the reference's: the step losses
    and parts (stage 2's too) relative to each; the step-0 gradient's
    sample, its norms per leaf (stage 2's too), the update's norms per
    leaf and the change of the BN running statistics in relative L2 over
    every value (a zero gradient or update, or statistics left as they
    were, lie at 1); an eval-mode stage output (a TTA view's too) by the
    share of its values that differ bitwise from the
    reference's (both are bf16 values where the casts agree); a
    train-mode one, whose values the rounding of the batch statistics
    moves, by the max abs error relative to its largest value; the rest
    (logits, features, scores) by the max abs error."""
    if key in ("loss0", "losses", "s2_loss0"):
        return float(np.max(np.abs(got - want) / np.abs(want)))
    if isinstance(want, dict):
        check(set(got) == set(want), f"{key}: leaves differ")
        got, want = (np.concatenate([np.asarray(t[k], np.float64).reshape(-1)
                                     for k in sorted(want)])
                     for t in (got, want))
    if key.startswith(("stage_eval/", "stage_tta/")):
        return float(np.mean(np.asarray(got, np.float32)
                             != np.asarray(want, np.float32)))
    if key.startswith("stage_train/"):
        return float(np.abs(got - want).max() / np.abs(want).max())
    if key in ("grad0", "grad0_norm", "update_norm", "bn_delta",
               "s2_grad0_norm"):
        got, want = np.float64(got), np.float64(want)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))
    return float(np.abs(got - want).max())


# the eval outputs, on one of which the CPU's float32 run must fall
# outside: the control that the check tells a bf16 path from float32
BF16_EVAL_KEYS = ("eval_logits", "eval_feat", "scores", "stage_eval/",
                  "stage_tta/")


def bf16_output_keys(ref):
    """The keys of a fixture's reference entry that the port's outputs
    (bf16_port_outputs with every part) hold."""
    return {k for k in ref if k not in ("digest", "plbl_margin")
            and not k.startswith(("spread_", "flips/", "novel/",
                                  "world2/"))}


def bf16_compare(name, ref, runs, labels):
    """Each output of the runs ({run: port outputs}) against the
    reference: rows {key: {run: distance, "tol": tolerance}} for the float
    outputs, and for the exact ones {run: [positions that differ, those
    outside the JAX package's flip set]}, "flips" (the set's size) and
    "novel" (the most positions one run of the reference flips that no
    other does), for the pseudo-labels with the largest reference
    decision margin of a pixel that differs outside the set; for the
    confusion matrix over the pixels outside the flip set {run: pixels
    counted in another cell} (labels: the eval images' ground truth).
    An exact output holds where no more positions differ outside the
    flip set than "novel": as many as one more run of the reference's
    own noise would add. Only the outputs every run holds are compared
    (bf16_port_outputs' parts). Returns (rows, {run: the outputs that
    lie outside})."""
    tols = BF16_TOL[name]
    rows, bad = {}, {run: [] for run in runs}
    check(set(tols) == bf16_output_keys(ref) - set(BF16_EXACT)
          - {"eval_confusion"},
          f"{name}: the tolerances do not name every float output")
    # the outputs the runs hold (bf16_port_outputs' parts)
    held = set.intersection(*(set(out) for out in runs.values()))
    check(held <= bf16_output_keys(ref),
          f"{name}: outputs the reference lacks: "
          f"{held - bf16_output_keys(ref)}")
    for key, tol in tols.items():
        if key not in held:
            continue
        rows[key] = {run: bf16_distance(key, out[key], ref[key])
                     for run, out in runs.items()}
        rows[key]["tol"] = tol
        for run in runs:
            if not rows[key][run] <= tol:
                bad[run].append(f"{name} {key}: {rows[key][run]:.3g} > {tol}")
    for key in BF16_EXACT:
        if key not in held:
            continue
        flips, novel = ref[f"flips/{key}"], int(ref[f"novel/{key}"])
        rows[key] = {"flips": int(flips.sum()), "novel": novel}
        for run, out in runs.items():
            d = out[key] != ref[key]
            rows[key][run] = [int(d.sum()), int((d & ~flips).sum())]
            if key == "plbl" and (d & ~flips).any():
                # the reference's decision margins there (decision_margins)
                rows[key][f"{run}_margin_max"] = float(
                    ref["plbl_margin"][d & ~flips].max())
            if rows[key][run][1] > novel:
                bad[run].append(
                    f"{name} {key}: {rows[key][run][1]} positions differ "
                    f"outside the flip set, one run of the reference flips "
                    f"{novel} alone")
    if "eval_pred" not in held:
        return rows, bad
    # the confusion matrix outside the flip set: the pixels it counts in
    # another cell than the reference's
    keep = ~ref["flips/eval_pred"]
    n = ref["eval_confusion"].shape[0]
    want = eval_confusion(ref["eval_pred"][keep], labels[keep], n)
    rows["eval_confusion"] = {run: int(np.abs(eval_confusion(
        out["eval_pred"][keep], labels[keep], n) - want).sum() // 2)
        for run, out in runs.items()}
    for run in runs:
        if rows["eval_confusion"][run] > int(ref["novel/eval_pred"]):
            bad[run].append(f"{name} eval_confusion moves "
                            f"{rows['eval_confusion'][run]} pixels outside "
                            "the flip set")
    return rows, bad


def bf16_control_outside(bad):
    """The messages of a run's outputs outside (bf16_compare) that name an
    eval output (BF16_EVAL_KEYS)."""
    return [m for m in bad
            if m.split(" ")[1].startswith(BF16_EVAL_KEYS)]


@contextlib.contextmanager
def kernel_instances():
    """Records the instance each stage-1 kernel and K5 take on the card
    while the block runs: {"pixel_ce": {(C, nc, 16-byte path)} for K1 and
    K2 (pixel_loss.instance), "ssm": {(C, nc)} for K3 and K4 (whose
    sources take C == 20 compiled, else C at run time, and have no
    16-byte path), "seg_max_fwd": {(C, nc, load path)} for K5
    (segment_max.layout)}; nc 0 is C at run time. CPU tensors take the
    plain versions and record nothing."""
    from mulactseg_tpu_torch.ops import pixel_loss, segment, segment_max

    seen = {"pixel_ce": set(), "ssm": set(), "seg_max_fwd": set()}
    nc = pixel_loss.compiled_classes
    instance, layout = pixel_loss.instance, segment_max.layout
    ssm_fwd, ssm_bwd = segment.ssm_fwd, segment.ssm_bwd

    def rec_instance(xc, bits3):
        got = instance(xc, bits3)
        seen["pixel_ce"].add((xc.shape[1], *got))
        return got

    def rec_layout(values):
        got = layout(values)
        seen["seg_max_fwd"].add((values.shape[1], nc(values.shape[1]), got))
        return got

    def rec_fwd(xc, *args):
        if xc.device.type == "cuda":
            seen["ssm"].add((xc.shape[1], nc(xc.shape[1])))
        return ssm_fwd(xc, *args)

    def rec_bwd(xc, *args):
        if xc.device.type == "cuda":
            seen["ssm"].add((xc.shape[1], nc(xc.shape[1])))
        return ssm_bwd(xc, *args)

    with mock.patch.object(pixel_loss, "instance", rec_instance), \
            mock.patch.object(segment_max, "layout", rec_layout), \
            mock.patch.object(segment, "ssm_fwd", rec_fwd), \
            mock.patch.object(segment, "ssm_bwd", rec_bwd):
        yield seen


def bf16_parity_slice(dev, smi):
    """The port's bf16 path on the card against the JAX package's
    dtype=bfloat16 model (docstring, item 8i): each fixture's outputs,
    card, CPU float32 and CPU autocast, against its reference file
    (BF16_FILES). Returns (its line, the path's launches, the card's
    outputs by fixture)."""
    from mulactseg_tpu_torch.ops import _build, segment_max

    t0 = time.perf_counter()
    line, launches, bad, card = {}, Counter(), [], {}
    for name, fx in BF16_FIXTURES.items():
        ref = bf16_reference_of(name)
        variables = bf16_variables(name)
        check(variables_digest(variables) == str(ref["digest"]),
              f"bf16 parity {name}: the weights made from seeds are not "
              "the reference's")
        inputs = bf16_inputs(name)
        # stage 2 trains on the reference's pseudo-labels
        s2 = ref["plbl"] if bf16_recipe(name)["stage2"] else None
        t1 = time.perf_counter()
        _sync(dev)
        _build.reset_launches()
        with kernel_instances() as instances:
            runs = {"card": bf16_port_outputs(name, variables, inputs, dev,
                                              s2_labels=s2)}
        _sync(dev)
        card_s = time.perf_counter() - t1
        got = dict(_build.LAUNCHES)
        # the BN kernels: the no-grad train-mode forward, each step's and
        # stage 2's forward, and the steps' backwards
        steps = BF16_STEPS + (1 if s2 is not None else 0)
        want = {**{k: BF16_STEPS for k in STAGE1_KERNELS},
                "seg_max_fwd": fx["batch"],
                **bn_launches(bf16_model(name), 1 + steps, steps)}
        check(got == want, f"bf16 parity {name}: launches {got}, want "
              f"{want} (K1-K4 once a step, K5 once a pseudo-labelled "
              "image, each BN kernel once a BN and train-mode pass)")
        check(set(runs["card"]) == bf16_output_keys(ref),
              f"bf16 parity {name}: the card's outputs are not the "
              "reference's")
        launches += Counter(got)
        instances = {k: sorted(v) for k, v in instances.items()}
        print(f"bf16 parity {name}: kernel instances (C, nc, path) "
              f"{instances}", flush=True)
        C = fx["classes"]
        if C != 20 and (fx["hw"] ** 2) % 4:
            # VOC's: C at run time, no 16-byte path (HW odd)
            check(instances == {"pixel_ce": [(C, 0, False)],
                                "ssm": [(C, 0)],
                                "seg_max_fwd": [(C, 0, segment_max.ANY)]},
                  f"bf16 parity {name}: kernel instances {instances}, "
                  f"want C = {C} at run time without the 16-byte path")
        card[name] = runs["card"]
        t1 = time.perf_counter()
        runs["cpu_f32"] = bf16_port_outputs(name, variables, inputs, "cpu",
                                            s2_labels=s2)
        runs["cpu_autocast"] = bf16_port_outputs(
            name, variables, inputs, "cpu", cpu_autocast=True, s2_labels=s2)
        cpu_s = time.perf_counter() - t1
        rows, outside = bf16_compare(name, ref, runs,
                                     inputs[0][0]["labels"])
        for key, r in rows.items():
            print(f"bf16 parity {name} {key}: {r}", flush=True)
        bad += outside["card"]
        control = bf16_control_outside(outside["cpu_f32"])
        print(f"bf16 parity {name}: the float32 control falls outside on "
              f"{control}", flush=True)
        if not control:
            bad.append(f"{name}: the CPU's float32 run holds every eval "
                       "output, so the check cannot tell a bf16 path from "
                       "a float32 one")
        line[name] = {"outputs": rows, "card_s": card_s, "cpu_s": cpu_s,
                      "control": control, "instances": instances}
    wall_s = time.perf_counter() - t0
    print(f"bf16 parity: {wall_s:.1f} s on {smi}", flush=True)
    check(not bad, f"bf16 parity: outside the tolerances: {bad}")
    return ({"bf16_parity": {"card": smi, "fixtures": line,
                             "wall_s": wall_s}}, dict(launches), card)


def bf16_world2_rank(name, device, cpu_autocast=False):
    """One rank of bf16_world2: the port's make_train_step, from the
    fixture's seeded weights, on this rank's rows of its first batch, in
    bf16 (on the CPU under CPU bfloat16 autocast with cpu_autocast).
    Returns the step's loss and parts (the global batch's), the step-0
    gradient summed over the ranks as the reference keeps one
    (bf16_grad_outputs) and the launches of the step."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine import train as port_train
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.parallel import mesh

    dev = torch.device(device)
    variables = bf16_variables(name)
    model = bf16_model(name, variables, dev)
    b0 = bf16_inputs(name)[0][0]
    rows = mesh.local_rows(len(b0["images"]))
    batch = {k: v[rows] for k, v in b0.items() if isinstance(v, np.ndarray)}
    with contextlib.ExitStack() as stack:
        if cpu_autocast:
            stack.enter_context(mock.patch.object(
                port_train, "bf16_autocast", lambda d, c: True))
        step = port_train.make_train_step(
            model, Config(**bf16_config_kw(name)), device=dev)
        _sync(dev)
        _build.reset_launches()
        aux = step(batch)
        _sync(dev)
        launches = dict(_build.LAUNCHES)
    want = {**{k: 1 for k in STAGE1_KERNELS}, **bn_launches(model, 1)}
    grads = convert.state_dict_to_variables(
        {n: p.grad for n, p in model.named_parameters()})
    return {"loss0": np.array([float(aux[k]) for k in BF16_PARTS]),
            **bf16_grad_outputs(name, grads), "launches": launches,
            "want": want}


def bf16_world2_slice(dev, smi, card_world1=None, cpu_autocast=False):
    """The port's bf16 step at world 2 against the JAX package's 2-device
    step (docstring, item 8j): for each fixture whose recipe holds it,
    two ranks sharing `dev` under gloo (each on dev explicitly), each on
    half of the first batch, against the reference's 'world2/' entries:
    the summed step-0 gradient's sample and its norms per leaf within
    the fixture's grad0 and grad0_norm tolerances, the loss and its parts
    within loss0's; K1-K4 once on each rank. card_world1: the card's
    world-1 outputs by fixture (bf16_parity_slice's), against which world
    2 is reported, not held. Returns (its line, the path's launches)."""
    from mulactseg_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    line, launches, bad = {}, Counter(), []
    for name in BF16_FIXTURES:
        if not bf16_recipe(name)["world2"]:
            continue
        ref, tol = bf16_reference_of(name), BF16_TOL[name]
        t1 = time.perf_counter()
        ranks = mesh.spawn(bf16_world2_rank, 2, "gloo", str(dev), name,
                           str(dev), cpu_autocast, timeout=600)
        rank_s = time.perf_counter() - t1
        for r, res in enumerate(ranks):
            check(res["launches"] == res["want"],
                  f"bf16 world 2 {name}: rank {r} launched "
                  f"{res['launches']}, want {res['want']} (K1-K4 once, "
                  "each BN kernel once a BN)")
            launches += Counter(res["launches"])
        got = ranks[0]
        if not np.array_equal(got["grad0"], ranks[1]["grad0"]):
            bad.append(f"{name} world 2: the ranks hold different "
                       "gradients")
        rows = {}
        for key, want, t in (("grad0", "world2/grad0", tol["grad0"]),
                             ("grad0_norm", "world2/grad0_norm",
                              tol["grad0_norm"]),
                             ("loss0", "world2/loss0", tol["loss0"])):
            d = bf16_distance(key, got[key], ref[want])
            rows[key] = {"card": d, "tol": t}
            if not d <= t:
                bad.append(f"{name} world 2 {key}: {d:.3g} > {t}")
        if card_world1 is not None:
            # reported, not held: the card's world 2 against its world 1
            w1 = card_world1[name]
            rows["card_world1"] = {k: bf16_distance(k, got[k], w1[k])
                                   for k in ("grad0", "grad0_norm")}
            rows["card_world1"]["loss0"] = bf16_distance(
                "loss0", got["loss0"], w1["loss0"])
        rows["jax_world1"] = {"cosine": float(ref["world2/cosine"]),
                              "rel_l2": float(ref["world2/rel_l2"])}
        for key, r in rows.items():
            print(f"bf16 world 2 {name} {key}: {r}", flush=True)
        line[name] = {"outputs": rows, "ranks_s": rank_s,
                      "loss0": got["loss0"].tolist()}
    wall_s = time.perf_counter() - t0
    print(f"bf16 world 2: {wall_s:.1f} s on {smi}", flush=True)
    check(line, "bf16 world 2: no fixture holds the step at world 2")
    check(not bad, f"bf16 world 2: outside the tolerances: {bad}")
    return ({"bf16_world2": {"card": smi, "fixtures": line,
                             "wall_s": wall_s}}, dict(launches))


def recipe_commands(script, workdir, data_root):
    """The commands the port's recipe script issues, in order, recorded by
    a stub `python` on PATH (bash runs the script; nothing else runs)."""
    rec = os.path.join(workdir, "argv.jsonl")
    stub = os.path.join(workdir, "bin", "python")
    os.makedirs(os.path.dirname(stub), exist_ok=True)
    with open(stub, "w") as f:
        f.write("#!/bin/bash\npython3 - \"$@\" <<'EOF'\nimport json, sys\n"
                f"open({rec!r}, 'a').write(json.dumps(sys.argv[1:]) + "
                "'\\n')\nEOF\n")
    os.chmod(stub, 0o755)
    env = dict(os.environ, PATH=f"{os.path.dirname(stub)}:{os.environ['PATH']}",
               DATA_ROOT=data_root)
    subprocess.run(["bash", str(HERE / "mulactseg_tpu_torch" / "scripts" /
                                script)], check=True, env=env,
                   capture_output=True)
    with open(rec) as f:
        return [json.loads(line) for line in f]


def recipe_cut(argv, workdir, dl_dir, cuts):
    """The recipe's command (`-m module` dropped) with the phase's cuts:
    the flag values in `cuts` replaced, the checkpoint paths moved under
    workdir, and the datalist directory of the generated tree."""
    out = list(argv[2:])
    for i, a in enumerate(out):
        if a in cuts and i + 1 < len(out):
            out[i + 1] = str(cuts[a])
        elif a.startswith("checkpoint/"):
            out[i] = os.path.join(workdir, a)
    return out + ["--datalist_dir", dl_dir]


class _Stamped:
    """A train step that synchronises after each call and stamps its end;
    every other attribute (the step count, the optimizer) is the step's.
    Each batch with superpixels also has its crop padding counted (pixels
    whose id is the pad id nseg) into `pads`, after the stamp."""

    def __init__(self, fn, dev, stamps, losses, pads, nseg):
        self.__dict__.update(fn=fn, dev=dev, stamps=stamps, losses=losses,
                             pads=pads, nseg=nseg)

    def __call__(self, batch):
        aux = self.fn(batch)
        self.losses.append(float(aux["train_loss"]))
        _sync(self.dev)
        self.stamps.append(time.perf_counter())
        if "spx" in batch:
            self.pads.append(int((np.asarray(batch["spx"])
                                  >= self.nseg).sum()))
        return aux

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


def _epoch_rates(rec, batch):
    """Train img/s over the first epoch (cold decode cache) and over the
    rest (warm), validation time taken out of each window."""
    stamps, vals = rec["stamps"], rec["validations"]
    steps = len(stamps) - 1
    epoch = min(max(rec["images"] // batch, 1), steps)

    def rate(a, b):
        t = stamps[b] - stamps[a] - sum(t1 - t0 for t0, t1 in vals
                                         if stamps[a] <= t0 < stamps[b])
        return batch * (b - a) / t if b > a else None

    return rate(0, epoch), rate(epoch, steps)


def _loader_rate(ds, processes, workers):
    """Items per second of one pass of a DataProvider over ds (batch B)."""
    from mulactseg_tpu_torch.data.loader import DataProvider

    t0 = time.perf_counter()
    loader = DataProvider(ds, B, shuffle=False, drop_last=False,
                          infinite=False, num_workers=workers,
                          processes=processes)
    n = sum(len(b["fnames"]) for b in loader)
    loader.close()
    return n / (time.perf_counter() - t0)


def _fresh_copy(ds, root, dst):
    """ds over copies of its files under dst (paths below root kept), so
    no decode cache holds them."""
    out = copy.copy(ds)
    out.im_idx = [[os.path.join(dst, os.path.relpath(p, root)) for p in k]
                  for k in ds.im_idx]
    for old, new in zip(ds.im_idx, out.im_idx):
        for a, b in zip(old, new):
            os.makedirs(os.path.dirname(b), exist_ok=True)
            shutil.copyfile(a, b)
    out.suppix = {new[2]: ds.suppix[old[2]]
                  for old, new in zip(ds.im_idx, out.im_idx)}
    return out


def run_commands(dev, commands):
    """Runs the (name, main, argv) commands in order on dev, each through
    its CLI's main(argv, device=dev), with every launch counter set to 0
    just before it and read just after; each training's steps are
    stamped (a synchronise after each) with its validations, and each
    pseudo-labelling is timed. Each training's record also counts each
    batch's padded pixels ('pads') and says whether the weights are finite
    after it ('weights_finite'). Returns (wall s, launches, results by
    command; the trainings' records and the pseudo-labellings' seconds in
    order; peak GiB)."""
    from mulactseg_tpu_torch.engine import rounds
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl import generator

    trains, real_train = [], rounds.ALTrainer.train
    real_validate = rounds.ALTrainer.validate
    plbl_s, real_generate = [], generator.PseudoLabelGenerator.generate

    def train(self, active_set, *a, **k):
        rec = {"stamps": [time.perf_counter()], "validations": [],
               "losses": [], "pads": [],
               "images": len(active_set.get_trainset())}
        trains.append(rec)
        step = self.train_step
        self.train_step = _Stamped(step, dev, rec["stamps"], rec["losses"],
                                   rec["pads"], self.cfg.nseg)
        try:
            rec["img_per_s"] = real_train(self, active_set, *a, **k)
        finally:
            self.train_step = step
        rec["weights_finite"] = all(bool(torch.isfinite(p).all())
                                    for p in self.model.parameters())
        return rec["img_per_s"]

    def validate(self, trainiter):
        t1 = time.perf_counter()
        out = real_validate(self, trainiter)
        _sync(dev)
        trains[-1]["validations"].append((t1, time.perf_counter()))
        return out

    def generate(self, *a, **k):
        t1 = time.perf_counter()
        out = real_generate(self, *a, **k)
        _sync(dev)
        plbl_s.append(time.perf_counter() - t1)
        return out

    rounds.ALTrainer.train, rounds.ALTrainer.validate = train, validate
    generator.PseudoLabelGenerator.generate = generate
    wall, launches, results = {}, {}, {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, fn, argv in commands:
            _sync(dev)
            _build.reset_launches()
            t1 = time.perf_counter()
            results[name] = fn(argv, device=dev)
            _sync(dev)
            wall[name] = time.perf_counter() - t1
            launches[name] = dict(_build.LAUNCHES)
    finally:
        rounds.ALTrainer.train, rounds.ALTrainer.validate = (real_train,
                                                             real_validate)
        generator.PseudoLabelGenerator.generate = real_generate
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    return wall, launches, results, trains, plbl_s, peak_gib


def cli_recipe_slice(variables, dev, smi, workdir):
    """The recipe's three commands over files (docstring, item 8b): a
    generated Cityscapes-format tree, the port recipe's command lines cut
    to CLI_ROUNDS rounds, each run through its CLI's main(argv). Returns
    (the cli_recipe line, the path's launches)."""
    from mulactseg_tpu_torch.cli import eval_al, train_al, train_stage2
    from mulactseg_tpu_torch.config import parse_config
    from mulactseg_tpu_torch.data import datasets
    from mulactseg_tpu_torch.data.loader import collate
    from mulactseg_tpu_torch.data.transforms import get_train_transform
    from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.plbl import generator
    from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
    from mulactseg_tpu_torch.utils.png import read_gray8, read_rgb8

    t0 = time.perf_counter()
    root = os.path.join(workdir, "data")
    dl_dir = write_tree(root, CLI_TRAIN, CLI_VAL, PH, PW, NSEG, seed=0,
                        encoding="adaptive", processes=os.cpu_count() or 1)
    tree_s = time.perf_counter() - t0
    cmds = recipe_commands("train_city_mul_res50.sh", workdir, root)
    modules = ["train_al"] + ["eval_al", "train_stage2"] * 5
    check([c[:2] for c in cmds] == [["-m", f"mulactseg_tpu_torch.cli.{m}"]
                                    for m in modules],
          f"the recipe issued {[c[:2] for c in cmds]}")
    budget = round(CLI_TRAIN * 100_000 / 2_975)  # the recipe's clicks/image
    cuts = {"--finetune_itrs": CLI_ITRS, "--val_period": CLI_VAL_PERIOD,
            "--max_iterations": CLI_ROUNDS}
    stage1 = recipe_cut(cmds[0], workdir, dl_dir,
                        {**cuts, "--active_selection_size": budget})
    init = stage1[stage1.index("--init_checkpoint") + 1]
    check("imagenet_pretrained" in init, f"init {init}")
    model = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES, 16,
                      separable_conv=True, device="cpu")
    convert.load_variables(model, variables)
    save_checkpoint(init, model)  # the seeded stand-in of the ImageNet init
    del model
    run = stage1[stage1.index("-p") + 1]
    commands = [("train_al", train_al.main, stage1)]
    for r in range(1, CLI_ROUNDS + 1):
        commands += [
            (f"eval_al_{r:02d}", eval_al.main,
             recipe_cut(cmds[2 * r - 1], workdir, dl_dir, cuts)),
            (f"train_stage2_{r:02d}", train_stage2.main,
             recipe_cut(cmds[2 * r], workdir, dl_dir, cuts))]
    wall, launches, results, trains, plbl_s, peak_gib = run_commands(
        dev, commands)

    steps = CLI_ROUNDS * CLI_ITRS
    recipe_model = "deeplabv3pluswn_resnet50deepstem"
    want = {**{k: steps for k in STAGE1_KERNELS},
            **bn_launches(recipe_model, steps)}
    check(launches["train_al"] == want, f"train_al launched "
          f"{launches['train_al']}, want {want} (K1-K4 once per stage-1 "
          f"step, {steps}, each BN kernel once a BN and step, and no "
          "other)")
    check(sorted(results["train_al"]) == list(range(1, CLI_ROUNDS + 1)) and
          all(math.isfinite(m) for m in results["train_al"].values()),
          f"bad train_al mIoU {results['train_al']}")
    check(len(trains) == 2 * CLI_ROUNDS and all(
        len(t["losses"]) == CLI_ITRS and all(map(math.isfinite, t["losses"]))
        and len(t["validations"]) == CLI_ITRS // CLI_VAL_PERIOD
        for t in trains), "a training ran other steps or validations, or a "
          "loss is not finite: " + str([(t["losses"], len(t["validations"]))
                                        for t in trains]))
    line_rounds = {}
    for r in range(1, CLI_ROUNDS + 1):
        with open(os.path.join(run, f"datalist_{r:02d}.json")) as f:
            labelled = json.load(f)["trg_label_im_idx"]
        plbl_dir = generator.plbl_save_dir(
            os.path.join(run, f"checkpoint{r:02d}"), "cosprop_includeonehot",
            f"{r:02d}")
        pngs = sorted(os.listdir(plbl_dir))
        check(len(pngs) == len(labelled) and pngs == sorted(
            os.path.basename(l).split(".")[0] + ".png" for _, l, _ in
            labelled), f"round {r}: {len(pngs)} pseudo-label PNGs for "
              f"{len(labelled)} labelled images")
        for p in pngs:  # every PNG decodes to a map of the image's size
            check(read_gray8(os.path.join(plbl_dir, p)).shape == (PH, PW),
                  f"{p}: bad pseudo-label map")
        check(launches[f"eval_al_{r:02d}"] == {"seg_max_fwd": len(labelled)},
              f"eval_al round {r} launched {launches[f'eval_al_{r:02d}']}, "
              f"want seg_max_fwd once per labelled image ({len(labelled)})")
        want = bn_launches(recipe_model, CLI_ITRS)
        check(launches[f"train_stage2_{r:02d}"] == want,
              f"stage 2 launched {launches[f'train_stage2_{r:02d}']}, want "
              f"{want} (each BN kernel once a BN and step)")
        s2_miou = results[f"train_stage2_{r:02d}"]
        check(math.isfinite(results[f"eval_al_{r:02d}"]) and
              math.isfinite(s2_miou) and os.path.exists(os.path.join(
                  run, f"stage2_checkpoint{r:02d}")),
              f"round {r}: bad plbl or stage-2 result")
        s1, s2 = trains[r - 1], trains[CLI_ROUNDS + r - 1]
        cold, warm = _epoch_rates(s1, B)
        s2_cold, s2_warm = _epoch_rates(s2, B)
        line_rounds[r] = {
            "labelled_images": len(labelled), "plbl_pngs": len(pngs),
            "train_img_per_s": s1["img_per_s"], "train_cold_img_per_s": cold,
            "train_warm_img_per_s": warm, "eval_miou": results["train_al"][r],
            "plbl_img_per_s": len(labelled) / plbl_s[r - 1],
            "plbl_miou": results[f"eval_al_{r:02d}"],
            "stage2_img_per_s": s2["img_per_s"],
            "stage2_cold_img_per_s": s2_cold,
            "stage2_warm_img_per_s": s2_warm, "stage2_miou": s2_miou}

    # the loader alone: one pass over fresh copies of the training files
    # (cold caches) on worker processes and on threads, as many as cores
    cfg = parse_config(stage1)
    label = datasets.RegionDatasetOr(
        cfg, cfg.trg_datalist, cfg.region_dict, "active-label",
        transform=get_train_transform(cfg.train_transform, cfg,
                                      seed=cfg.seed))
    workers = min(8, os.cpu_count() or 1)
    rates = {}
    for mode in ("processes", "threads"):
        ds = _fresh_copy(label, root, os.path.join(workdir, mode))
        rates[mode] = _loader_rate(ds, mode == "processes", workers)
    # a file-backed item by part, in this process: decoding (the image PNG,
    # the superpixel pickle), the rest of the item (crop, resample,
    # normalise, bits) over decoded files, the batch's copy to the card
    img_p, _, spx_p = label.im_idx[0]
    t1 = time.perf_counter()
    read_rgb8(img_p)
    t2 = time.perf_counter()
    datasets._open_spx_impl(spx_p)
    t3 = time.perf_counter()
    for i in range(B):  # fills this process's decode cache
        label[i]
    t4 = time.perf_counter()
    batch = collate([label[i] for i in range(B)])
    t5 = time.perf_counter()
    _sync(dev)
    t6 = time.perf_counter()
    for k in ("images", "target_bits", "target", "spx"):
        torch.as_tensor(batch[k]).to(dev)
    _sync(dev)
    t7 = time.perf_counter()
    datasets._decode_cache.clear()

    line = {"cli_recipe": {
        "card": smi, "config": f"{cfg.model} separable, {NUM_CLASSES} "
        f"outputs, {cfg.dtype}, batch {cfg.train_batch_size}, crop "
        f"{cfg.crop_size[0]}x{cfg.crop_size[1]}, nseg {cfg.nseg}, the "
        f"recipe's flags; tree: {CLI_TRAIN} train and {CLI_VAL} val images "
        f"at {PH}x{PW}, adaptive-filtered RGB PNGs, .pkl superpixels",
        "cuts": {"finetune_itrs": CLI_ITRS, "val_period": CLI_VAL_PERIOD,
                 "max_iterations": CLI_ROUNDS,
                 "active_selection_size": budget,
                 "init": "seeded stand-in of the ImageNet init",
                 "stage-2 rounds": CLI_ROUNDS},
        "tree_s": tree_s, "command_s": wall, "rounds": line_rounds,
        "loader_files_per_s": {**rates, "workers": workers},
        "item_ms": {"decode_image_png": (t2 - t1) * 1e3,
                    "decode_superpixel_pkl": (t3 - t2) * 1e3,
                    "transform_and_bits": (t5 - t4) / B * 1e3,
                    "batch_to_card": (t7 - t6) * 1e3},
        "launches": {k: v for k, v in launches.items() if v},
        "peak_mem_gib": peak_gib}}
    total = Counter()
    for v in launches.values():
        total.update(v)
    return line, dict(total)


def with_flags(argv, flags):
    """argv with each flag of `flags` set to its value: the value after
    the flag replaced, a value given to a bare flag, or the flag added."""
    out = list(argv)
    for flag, value in flags.items():
        if flag not in out:
            out += [flag, str(value)]
            continue
        i = out.index(flag) + 1
        if i < len(out) and not out[i].startswith("-"):
            out[i] = str(value)
        else:
            out.insert(i, str(value))
    return out


def _finite_steps(losses, pads, nan_after_padding):
    """Whether the losses are finite where they must be: at every step,
    or, for a criterion whose MC term gathers a NaN target row at a padded
    pixel (nan_after_padding), up to the first step whose batch holds crop
    padding. That step's gradient is NaN there, as the JAX package's is
    (ROADMAP.md, open question 4 for the reference's owners), so every
    later loss may be NaN. Either way at least one step must be finite
    and free of padding, so that one step shows a finite model."""
    first = next((i for i, n in enumerate(pads) if n), None)
    upto = len(losses) if first is None or not nan_after_padding \
        else first + 1
    clean = any(math.isfinite(v) and not n for v, n in zip(losses, pads))
    return clean and all(map(math.isfinite, losses[:upto]))


def _arm_record(losses, pads, weights_finite, miou=None):
    """The loader_arms line's record of an arm's steps: its losses, each
    batch's padded pixels, how many losses were finite, whether the
    weights were finite after the steps, and its eval mIoU (null where
    the weights went NaN, and then under eval_miou_nan_weights)."""
    out = {"losses": losses, "padded_pixels": pads,
           "finite_steps": sum(map(math.isfinite, losses)),
           "weights_finite": weights_finite}
    if miou is not None:
        out["eval_miou"] = miou if weights_finite else None
        if not weights_finite:
            out["eval_miou_nan_weights"] = miou
    return out


def loader_arms_slice(variables, dev, smi, workdir):
    """The loader arms over files (docstring, item 8d): a generated tree
    with the extra granularities and the dominant labels; the dominant,
    async hierarchy and research-rewrite arms each through train_al.main
    with the recipe's stage-1 flags cut to 1 round of LA_ITRS steps; the
    mixed-scale arm as its loaders, MsegRegionActiveSet's
    expand_training_set with given rows and LA_ITRS steps. Every launch
    counter is set to 0 just before each arm and read just after: the
    dominant arm (plain CE) launches nothing, the async arm K5 twice an
    image and step, the rewrite arm (the recipe's fused criterion) K1-K4
    once a step, the mixed-scale arm K5 once an image, level and step.
    Returns (the loader_arms line, the path's launches)."""
    from mulactseg_tpu_torch.cli import train_al
    from mulactseg_tpu_torch.cli.common import build_active_datasets
    from mulactseg_tpu_torch.config import parse_config
    from mulactseg_tpu_torch.data.loader import DataProvider
    from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree

    t0 = time.perf_counter()
    root = os.path.join(workdir, "data")
    coarse = tuple(n for n in MSEG_LEVELS if n != NSEG)
    dl_dir = write_tree(root, LA_TRAIN, LA_VAL, PH, PW, NSEG, seed=1,
                        encoding="adaptive", processes=os.cpu_count() or 1,
                        extra_nseg=coarse + (SMALL_NSEG,), dominant=True)
    tree_s = time.perf_counter() - t0
    cmds = recipe_commands("train_city_mul_res50.sh", workdir, root)
    budget = round(LA_TRAIN * 100_000 / 2_975)
    base = recipe_cut(cmds[0], workdir, dl_dir, {
        "--finetune_itrs": LA_ITRS, "--val_period": LA_ITRS,
        "--max_iterations": 1, "--active_selection_size": budget})
    init = base[base.index("--init_checkpoint") + 1]
    model = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES, 16,
                      separable_conv=True, device="cpu")
    convert.load_variables(model, variables)
    save_checkpoint(init, model)  # the seeded stand-in of the ImageNet init
    arms = {
        "dominant": ({"--or_labeling": "false", "--dominant_labeling": "true",
                      "--method": "active_predignore",
                      "--loader": "region_cityscapes_predignore",
                      "--trg_datalist": os.path.join(
                          dl_dir, f"train_seed{NSEG}_dominant_labels.txt")},
                     {}),
        "async_hier": ({"--loader": "region_cityscapes_or_tensor_ignore_async",
                        "--method": "active_joint_hier_multi_async_weight",
                        "--small_nseg": SMALL_NSEG},
                       {"seg_max_fwd": 2 * B * LA_ITRS}),
        "ratiosample": ({"--loader":
                         "region_cityscapes_or_tensor_ratiosample_gt",
                         "--multihot_filter_ratio": 0.1},
                        {k: LA_ITRS for k in STAGE1_KERNELS}),
    }
    commands = [(name, train_al.main, with_flags(base, {
        "-p": os.path.join(workdir, name), **flags}))
        for name, (flags, _) in arms.items()]
    wall, launches, results, trains, _, peak_gib = run_commands(
        dev, commands)
    workers = min(8, os.cpu_count() or 1)
    out = {}
    for (name, _, argv), rec in zip(commands, trains):
        want = {**arms[name][1], **bn_launches(
            "deeplabv3pluswn_resnet50deepstem", LA_ITRS)}
        check(launches[name] == want,
              f"loader arm {name}: launches {launches[name]}, want {want}")
        finite = _finite_steps(rec["losses"], rec["pads"],
                               name == "async_hier")
        check(len(rec["losses"]) == LA_ITRS and finite
              and all(map(math.isfinite, results[name].values())),
              f"loader arm {name}: losses {rec['losses']} (padded pixels "
              f"{rec['pads']}), mIoU {results[name]}")
        # the loader alone over the round's labelled set, its workers warm
        cfg = parse_config(argv)
        label = build_active_datasets(cfg)[0].trg_label_dataset
        with open(os.path.join(cfg.model_save_dir, "datalist_01.json")) as f:
            saved = json.load(f)
        label.im_idx = saved["trg_label_im_idx"]
        label.suppix = saved["trg_label_suppix"]
        item = label[0]
        if name == "async_hier":
            check(item["images_weak"].shape == (3,) + WEAK_HW
                  and item["spx_small_weak"].shape == WEAK_HW
                  and item["spx_small"].shape == (H, W),
                  "the async arm's weak view is not 1024x2048: "
                  f"{item['images_weak'].shape}")
        out[name] = {"method": cfg.method, "loader": cfg.loader,
                     "command_s": wall[name], "train_img_per_s":
                     rec["img_per_s"], "labelled_images": len(label),
                     "loader_items_per_s": _loader_rate(label, True, workers),
                     "k5_per_step": launches[name].get("seg_max_fwd", 0)
                     / LA_ITRS, **_arm_record(
                         rec["losses"], rec["pads"], rec["weights_finite"],
                         results[name][1])}
        print(f"loader arm {name}: {json.dumps(out[name])}", flush=True)

    # the mixed-scale arm: its loaders, selection rows given, LA_ITRS steps
    t1 = time.perf_counter()
    cfg = parse_config(with_flags(base, {
        "-p": os.path.join(workdir, "mseg"),
        "--loader": "mseg_region_cityscapes_or_tensor",
        "--method": "active_joint_multi_predignore_mseg",
        "--region_dict": os.path.join(dl_dir, f"train_seed{NSEG}.dict")})
        + ["--nseg_list"] + [str(n) for n in MSEG_LEVELS])
    active, _ = build_active_datasets(cfg)
    active.lbl_tpl = "gtFine/train/synth/{1}_gtFine_labelIds.png"
    active.spx_tpl = "superpixels/seeds_{}/train/synth/{}.pkl"
    pool = active.trg_pool_dataset
    rng = np.random.RandomState(3)
    rows = []
    for img, levels in pool.im_idx:
        fid = os.path.basename(img)[:-len("_leftImg8bit.png")]
        for n in MSEG_LEVELS[rng.randint(0, 2):]:  # 2 or 3 levels
            ids = rng.choice(pool.suppix[levels[str(n)][1]], n // 4,
                             replace=False)
            rows += [(1.0, f"{n}/{fid}", int(i)) for i in ids]
    active.expand_training_set(rows, len(rows), "given")
    active.dump_datalist()
    label = active.get_trainset()
    check(len(label) == LA_TRAIN and all(len(e[1]) >= 2
                                         for e in label.im_idx),
          "the mixed-scale selection left an image without two levels")
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=dev)
    convert.load_variables(model, variables)
    step = make_train_step(model, cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    loader = DataProvider(label, B, num_workers=workers, seed=cfg.seed)
    setup_s = time.perf_counter() - t1
    _sync(dev)
    _build.reset_launches()
    t2 = time.perf_counter()
    losses, fed = [], []
    for _ in range(LA_ITRS):
        fed.append(next(loader))
        losses.append(float(step(fed[-1])["train_loss"]))
    _sync(dev)
    mseg_s = time.perf_counter() - t2
    loader.close()
    # each level's crop padding carries that level's nseg
    pads = [int(sum((b["mseg_spx"][:, i] >= n).sum()
                    for i, n in enumerate(MSEG_LEVELS))) for b in fed]
    del fed
    launches["mseg"] = dict(_build.LAUNCHES)
    want = {"seg_max_fwd": len(MSEG_LEVELS) * B * LA_ITRS,
            **bn_launches(model, LA_ITRS)}
    check(launches["mseg"] == want,
          f"loader arm mseg: launches {launches['mseg']}, want {want}")
    check(_finite_steps(losses, pads, True),
          f"mseg losses {losses} (padded pixels {pads})")
    out["mseg"] = {"method": cfg.method, "loader": cfg.loader,
                   "setup_s": setup_s, "steps_s": mseg_s,
                   "train_img_per_s": B * LA_ITRS / mseg_s,
                   "labelled_images": len(label), "selected_rows": len(rows),
                   "loader_items_per_s": _loader_rate(label, True, workers),
                   "k5_per_step": want["seg_max_fwd"] / LA_ITRS,
                   **_arm_record(losses, pads, all(
                       bool(torch.isfinite(p).all())
                       for p in model.parameters()))}
    print(f"loader arm mseg: {json.dumps(out['mseg'])}", flush=True)
    del step, model
    torch.cuda.empty_cache()
    line = {"loader_arms": {
        "card": smi, "config": f"deeplabv3pluswn_resnet50deepstem "
        f"separable, bf16, batch {B}, crop {H}x{W}, nseg {NSEG}, the "
        f"recipe's flags; tree: {LA_TRAIN} train and {LA_VAL} val images "
        f"at {PH}x{PW}, superpixels at {coarse + (NSEG, SMALL_NSEG)}, "
        "dominant labels",
        "cuts": {"finetune_itrs": LA_ITRS, "max_iterations": 1,
                 "active_selection_size": budget,
                 "init": "seeded stand-in of the ImageNet init"},
        "tree_s": tree_s, "arms": out, "peak_mem_gib": peak_gib,
        "launches": {k: v for k, v in launches.items() if v}}}
    total = Counter()
    for v in launches.values():
        total.update(v)
    return line, dict(total)


def voc_recipe_slice(dev, smi, workdir):
    """The VOC recipe's commands over files (docstring, item 8c): a
    generated VOC-format tree, the kernel instances of VOC stage 1 held
    against their plain versions, the port's VOC script cut to VOC_ROUNDS
    rounds and run through the CLIs' main(argv), and K5 held on a TTA
    pseudo-labelling image. Returns (the voc_recipe line, the path's
    launches, the kernels-line rows of the VOC instances)."""
    from mulactseg_tpu_torch.cli import eval_al, train_al, train_stage2
    from mulactseg_tpu_torch.cli.common import build_active_datasets
    from mulactseg_tpu_torch.config import parse_config
    from mulactseg_tpu_torch.data import datasets
    from mulactseg_tpu_torch.data.loader import collate
    from mulactseg_tpu_torch.data.transforms import get_train_transform
    from mulactseg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from mulactseg_tpu_torch.engine.tta import tta_feat_forward
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import segment_max
    from mulactseg_tpu_torch.plbl import generator
    from mulactseg_tpu_torch.tools.voc_tree import write_tree
    from mulactseg_tpu_torch.utils import jpeg
    from mulactseg_tpu_torch.utils.png import read_gray8

    t0 = time.perf_counter()
    root = os.path.join(workdir, "data")
    dl_dir = write_tree(root, VOC_TRAIN, VOC_VAL, VOC_NSEG, seed=0)
    tree_s = time.perf_counter() - t0
    cmds = recipe_commands("train_voc_mul_res50.sh", workdir, root)
    modules = ["train_al"] + ["eval_al", "train_stage2"] * 5
    check([c[:2] for c in cmds] == [["-m", f"mulactseg_tpu_torch.cli.{m}"]
                                    for m in modules],
          f"the VOC recipe issued {[c[:2] for c in cmds]}")
    budget = round(VOC_TRAIN * 10_000 / 1_464)  # the recipe's clicks/image
    stage1 = recipe_cut(cmds[0], workdir, dl_dir, {
        "--finetune_itrs": VOC_ITRS, "--val_period": VOC_VAL_PERIOD,
        "--max_iterations": VOC_ROUNDS, "--active_selection_size": budget})
    cfg = parse_config(stage1)
    check((cfg.dataset, cfg.num_classes, cfg.train_batch_size,
           cfg.crop_size, cfg.nseg, cfg.dtype) == (
              "voc", VOC_CLASSES, VOC_B, (VOC_CROP, VOC_CROP), VOC_NSEG,
              "bfloat16"), f"the VOC stage-1 command parsed to {cfg}")
    init = stage1[stage1.index("--init_checkpoint") + 1]
    check("imagenet_pretrained" in init, f"init {init}")
    model = get_model(cfg.model, VOC_CLASSES, 16, separable_conv=True,
                      device="cpu")
    convert.load_variables(model, convert.random_variables(model, seed=0))
    save_checkpoint(init, model)  # the seeded stand-in of the ImageNet init
    model.to(dev).eval()

    # the VOC instances of K1-K4 (C = 21 at run time; HW = 513 * 513 is
    # odd, so the 4-byte path): a stage-1 batch of the tree's files, half
    # of each image's superpixels selected, through the seeded model
    label = datasets.RegionDatasetOr(
        cfg, cfg.trg_datalist, cfg.region_dict, "active-label",
        transform=get_train_transform(cfg.train_transform, cfg,
                                      seed=cfg.seed),
        encode_fn=datasets.encode_identity)
    rng = np.random.RandomState(0)
    for k, ids in label.suppix.items():
        label.suppix[k] = sorted(rng.choice(ids, len(ids) // 2,
                                            replace=False).tolist())
    batch = collate([label[i % len(label)] for i in range(VOC_B)])
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(torch.as_tensor(batch["images"]).to(dev))
    check(logits.shape == (VOC_B, VOC_CLASSES, VOC_CROP, VOC_CROP)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad VOC model logits")
    shape = f"voc ({VOC_B}, {VOC_CLASSES}, {VOC_CROP * VOC_CROP})"
    rows = kernel_checks(logits, batch, dev, nseg=VOC_NSEG,
                         label=f"@{shape}")
    del logits, batch, label
    model.cpu()
    torch.cuda.empty_cache()

    run = stage1[stage1.index("-p") + 1]
    s2_cuts = {"--finetune_itrs": VOC_S2_ITRS,
               "--val_period": VOC_S2_VAL_PERIOD}
    commands = [("train_al", train_al.main, stage1)]
    for r in range(1, VOC_ROUNDS + 1):
        commands += [
            (f"eval_al_{r:02d}", eval_al.main,
             recipe_cut(cmds[2 * r - 1], workdir, dl_dir, {})),
            (f"train_stage2_{r:02d}", train_stage2.main,
             recipe_cut(cmds[2 * r], workdir, dl_dir, s2_cuts))]
    wall, launches, results, trains, plbl_s, peak_gib = run_commands(
        dev, commands)

    steps = VOC_ROUNDS * VOC_ITRS
    want = {**{k: steps for k in STAGE1_KERNELS},
            **bn_launches(model, steps)}
    check(launches["train_al"] == want, f"VOC train_al launched "
          f"{launches['train_al']}, want {want} (K1-K4 once per stage-1 "
          f"step, {steps}, each BN kernel once a BN and step, and no "
          "other)")
    check(sorted(results["train_al"]) == list(range(1, VOC_ROUNDS + 1)) and
          all(math.isfinite(m) for m in results["train_al"].values()),
          f"bad VOC train_al mIoU {results['train_al']}")
    want = ([(VOC_ITRS, VOC_ITRS // VOC_VAL_PERIOD)] * VOC_ROUNDS
            + [(VOC_S2_ITRS, VOC_S2_ITRS // VOC_S2_VAL_PERIOD)] * VOC_ROUNDS)
    check([(len(t["losses"]), len(t["validations"])) for t in trains] == want
          and all(math.isfinite(x) for t in trains for x in t["losses"]),
          "a VOC training ran other steps or validations, or a loss is not "
          "finite: " + str([(t["losses"], len(t["validations"]))
                            for t in trains]))
    line_rounds, last = {}, None
    for r in range(1, VOC_ROUNDS + 1):
        with open(os.path.join(run, f"datalist_{r:02d}.json")) as f:
            labelled = json.load(f)["trg_label_im_idx"]
        plbl_dir = generator.plbl_save_dir(
            os.path.join(run, f"checkpoint{r:02d}"), "cosprop_includeonehot",
            f"{r:02d}")
        pngs = sorted(os.listdir(plbl_dir))
        check(len(pngs) == len(labelled) and pngs == sorted(
            os.path.basename(l).split(".")[0] + ".png" for _, l, _ in
            labelled), f"VOC round {r}: {len(pngs)} pseudo-label PNGs for "
              f"{len(labelled)} labelled images")
        for img, lbl, _ in labelled:  # each the size of its image
            p = os.path.join(plbl_dir,
                             os.path.basename(lbl).split(".")[0] + ".png")
            check(read_gray8(p).shape == jpeg.jpeg_size(img),
                  f"{p}: not a map of its image's size")
        check(launches[f"eval_al_{r:02d}"] == {"seg_max_fwd": len(labelled)},
              f"VOC eval_al round {r} launched "
              f"{launches[f'eval_al_{r:02d}']}, want seg_max_fwd once per "
              f"labelled image ({len(labelled)})")
        want = bn_launches(model, VOC_S2_ITRS)
        check(launches[f"train_stage2_{r:02d}"] == want,
              f"VOC stage 2 launched {launches[f'train_stage2_{r:02d}']}, "
              f"want {want} (each BN kernel once a BN and step)")
        s2_miou = results[f"train_stage2_{r:02d}"]
        check(math.isfinite(results[f"eval_al_{r:02d}"]) and
              math.isfinite(s2_miou) and os.path.exists(os.path.join(
                  run, f"stage2_checkpoint{r:02d}")),
              f"VOC round {r}: bad plbl or stage-2 result")
        s1, s2 = trains[r - 1], trains[VOC_ROUNDS + r - 1]
        cold, warm = _epoch_rates(s1, VOC_B)
        s2_batch = parse_config(commands[2 * r][2]).train_batch_size
        s2_cold, s2_warm = _epoch_rates(s2, s2_batch)
        line_rounds[r] = {
            "labelled_images": len(labelled), "plbl_pngs": len(pngs),
            "train_img_per_s": s1["img_per_s"], "train_cold_img_per_s": cold,
            "train_warm_img_per_s": warm, "eval_miou": results["train_al"][r],
            "plbl_img_per_s": len(labelled) / plbl_s[r - 1],
            "plbl_miou": results[f"eval_al_{r:02d}"],
            "stage2_batch": s2_batch, "stage2_img_per_s": s2["img_per_s"],
            "stage2_cold_img_per_s": s2_cold,
            "stage2_warm_img_per_s": s2_warm, "stage2_miou": s2_miou}
        last = commands[2 * r - 1][2]

    # K5 on one pseudo-labelling image of the last round, its planes as the
    # generator builds them: the TTA softmax of the round's checkpoint
    # under the image's selected superpixels
    ecfg = parse_config(last)
    active, _ = build_active_datasets(ecfg)
    active.selection_iter = ecfg.init_iteration
    active.load_datalist(ecfg.datalist_path)
    lds = active.trg_label_dataset
    item = datasets.EvalRegionDatasetAll(ecfg, lds, lds.suppix,
                                         emit_u8=True)[0]
    model.load_state_dict(load_checkpoint(ecfg.resume_checkpoint)[
        "model_state_dict"])
    model.to(dev)
    _, logits = tta_feat_forward(model, item["images"][None], dev, True)
    h, w = item["spx"].shape
    P = h * w
    planes = torch.softmax(logits[0].float(), dim=0).reshape(
        VOC_CLASSES, P).t()
    sid = torch.from_numpy(np.where(item["spmask"], item["spx"], VOC_NSEG)
                           .reshape(-1).astype(np.int32)).to(dev)
    k5_err = check_k5(planes, sid, f"VOC plbl image, {h}x{w}",
                      nseg=VOC_NSEG)
    n_valid = int((sid < VOC_NSEG).sum())
    rows.append((
        f"seg_max_fwd@voc plbl ({P}, {VOC_CLASSES}), {VOC_NSEG} segments",
        k5_err,
        time_ms(lambda: segment_max.seg_max_fwd(planes, sid, VOC_NSEG),
                graph=True),
        time_ms(lambda: segment_max.segment_max_plain(planes, sid,
                                                      VOC_NSEG)),
        bound(P * 4 + n_valid * VOC_CLASSES * 4 + VOC_NSEG * VOC_CLASSES * 8,
              n_valid * VOC_CLASSES), None))
    del model, logits, planes
    torch.cuda.empty_cache()

    # JPEG decoding, a file of the tree at a time, in this process
    decode_ms = []
    for img, _, _ in datasets.RegionDatasetOr(
            cfg, cfg.trg_datalist, cfg.region_dict, "active-ulabel",
            encode_fn=datasets.encode_identity).im_idx:
        t1 = time.perf_counter()
        jpeg.read_rgb8(img)
        decode_ms.append((time.perf_counter() - t1) * 1e3)

    line = {"voc_recipe": {
        "card": smi, "config": f"{cfg.model} separable, {VOC_CLASSES} "
        f"outputs, {cfg.dtype}, batch {VOC_B}, crop {VOC_CROP}x{VOC_CROP}, "
        f"nseg {VOC_NSEG}, the VOC recipe's flags (10-view TTA plbl); tree: "
        f"{VOC_TRAIN} train and {VOC_VAL} val images at VOC's sizes, "
        "baseline 4:2:0 JPEGs (quality 75), palette label PNGs, .pkl "
        "superpixels",
        "cuts": {"finetune_itrs": VOC_ITRS, "val_period": VOC_VAL_PERIOD,
                 "max_iterations": VOC_ROUNDS,
                 "active_selection_size": budget,
                 "stage-2 finetune_itrs": VOC_S2_ITRS,
                 "stage-2 val_period": VOC_S2_VAL_PERIOD,
                 "init": "seeded stand-in of the ImageNet init",
                 "stage-2 rounds": VOC_ROUNDS},
        "tree_s": tree_s, "command_s": wall, "rounds": line_rounds,
        "jpeg_decode_ms_per_file": statistics.median(decode_ms),
        "jpeg_decode_ms_range": [min(decode_ms), max(decode_ms)],
        "k5_plbl_image": {"pixels": P, "valid": n_valid,
                          "max_abs_err": k5_err},
        "launches": {k: v for k, v in launches.items() if v},
        "peak_mem_gib": peak_gib}}
    total = Counter()
    for v in launches.values():
        total.update(v)
    return line, dict(total), rows


class _Timed:
    """Wraps methods of classes to append (name, seconds) to `log` per
    call, the device synchronised before the stamp; restores them on
    exit."""

    def __init__(self, dev, log, *targets):
        self.dev, self.log, self.targets = dev, log, targets
        self.saved = []

    def __enter__(self):
        for cls, name in self.targets:
            real = getattr(cls, name)
            self.saved.append((cls, name, real))

            def timed(*a, _real=real, _label=f"{cls.__name__}.{name}", **k):
                t1 = time.perf_counter()
                out = _real(*a, **k)
                _sync(self.dev)
                self.log.append((_label, time.perf_counter() - t1))
                return out

            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, real in self.saved:
            setattr(cls, name, real)


def small_evals_check(model, dev):
    """The evals' device code on the card against the CPU at small shapes:
    SlidingEval at crop EV_CROP on an EV_HW image (2 x 4 windows) with the
    seeded model in float32, TF32 off, the summed logits within 1e-4 of
    the largest; the four simple pseudo-labels, boundary_mask and
    top1_selection_counts on the same logits (at 20 and 19 classes):
    exactly equal. Returns the
    sliding logits' largest difference over the largest logit."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.engine.analysis import top1_selection_counts
    from mulactseg_tpu_torch.engine.sliding import SlidingEval
    from mulactseg_tpu_torch.ops.morphology import boundary_mask
    from mulactseg_tpu_torch.plbl import simple

    rng = np.random.RandomState(31)
    h, w = EV_HW
    image = rng.randint(0, 256, (1, 3, h, w)).astype(np.uint8)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for d in ("cpu", dev):
            model.to(d)
            se = SlidingEval(model, NUM_CLASSES - 1, crop_size=EV_CROP,
                             stride_rate=0.6667, device=d)
            out[str(d)] = se(image).cpu()
            check(se.windows == 8, f"{se.windows} windows at {EV_HW}")
    finally:
        model.to(dev)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    c, g = out["cpu"], out[str(dev)]
    rel = ((c - g).abs().max() / c.abs().max()).item()
    check(rel <= 1e-4, f"sliding eval: card and CPU differ by {rel} of the "
          "largest logit")

    C, S, B2 = NUM_CLASSES, 24, 2
    logits = rng.randn(B2, C, h, w).astype(np.float32) * 3
    spx = np.stack([irregular_superpixels(h, w, S, rng) for _ in range(B2)])
    spmask = rng.rand(B2, h, w) < 0.6
    targets = (rng.rand(B2, S, C) < 0.3).astype(np.float32)
    gt = np.where(rng.rand(B2, h, w) < 0.1, 255,
                  rng.randint(0, C - 1, (B2, h, w))).astype(np.int32)
    plbl = np.where(spmask, rng.randint(0, C, (B2, h, w)), 255).astype(
        np.int32)
    res = {}
    for d in ("cpu", dev):
        t = [torch.from_numpy(a).to(d) for a in
             (logits, targets, spx, spmask, gt, plbl)]
        lg, tg, sx, sm, gtt, pl = t
        res[str(d)] = [x.cpu() for x in (
            simple.within_multihot_plbl(lg, tg, sx, sm),
            simple.naive_argmax_plbl(lg, sm, num_real_classes=C - 1),
            simple.naive_threshold_plbl(lg, sm, plbl_th=0.5),
            simple.naive_threshold_fill(pl[0], lg[0], sm[0], temp=0.1,
                                        plbl_th=0.9),
            boundary_mask(sx[0]),
            *top1_selection_counts(lg, tg, sx, sm, gtt, nseg=S,
                                   num_classes=C),
            # the probe's model has 19 outputs: K5's run-time-C instance
            *top1_selection_counts(lg[:, :C - 1], tg, sx, sm, gtt, nseg=S,
                                   num_classes=C - 1))]
    names = ("within_multihot_plbl", "naive_argmax_plbl",
             "naive_threshold_plbl", "naive_threshold_fill", "boundary_mask",
             *(f"top1 ({c} classes) {n}" for c in (C, C - 1)
               for n in ("ncorr_cls", "n_cls", "ncorr", "n")))
    for name, a, b in zip(names, res["cpu"], res[str(dev)]):
        check(torch.equal(a, b), f"small evals: {name} differs between the "
              "card and the CPU")
    print(f"small evals: sliding logits within {rel:.2e} of the largest; "
          "simple pseudo-labels, boundary_mask and the probe's counts "
          "equal on the card and the CPU", flush=True)
    return rel


def evals_slice(variables, dev, smi, workdir):
    """The remaining evals over files (docstring, item 8e): a tree with
    dominant labels, a checkpoint of the seeded recipe model and one of a
    seeded 19-class model, round-1 and round-2 datalists of the labelled
    set; K5 held and timed at the sliding pseudo-labeller's and the
    probe's instances; then the commands through eval_al.main and
    train_al.main, every launch counter set to 0 just before each and read
    just after. Returns (the evals line, the path's launches, the kernels
    rows, the tree: the commands' common arguments, the two checkpoints
    and the number of labelled images)."""
    from mulactseg_tpu_torch.cli import eval_al, train_al
    from mulactseg_tpu_torch.cli.common import build_active_datasets
    from mulactseg_tpu_torch.config import parse_config
    from mulactseg_tpu_torch.data import datasets
    from mulactseg_tpu_torch.data.loader import DataProvider, collate
    from mulactseg_tpu_torch.engine.analysis import (
        ANALYSIS_METHODS,
        AnalysisEvaluator,
        SelectionAccuracyEvaluator,
    )
    from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
    from mulactseg_tpu_torch.engine.evaluate import Evaluator, eval_forward
    from mulactseg_tpu_torch.engine.sliding import SlidingEval, _window_grid
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import (
        PseudoLabelGenerator,
        plbl_save_dir,
    )
    from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
    from mulactseg_tpu_torch.utils.png import read_gray8, read_rgb8

    t0 = time.perf_counter()
    root = os.path.join(workdir, "data")
    dl_dir = write_tree(root, EV_TRAIN, EV_VAL, PH, PW, NSEG, seed=5,
                        encoding="adaptive", processes=os.cpu_count() or 1,
                        dominant=True)
    tree_s = time.perf_counter() - t0
    run = os.path.join(workdir, "evals")
    os.makedirs(run)
    ck, ck19 = (os.path.join(run, n) for n in ("checkpoint02",
                                               "checkpoint02_c19"))
    model = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES, 16,
                      separable_conv=True, device="cpu")
    convert.load_variables(model, variables)
    save_checkpoint(ck, model)
    # the probe and the _voc methods build num_classes outputs
    m19 = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES - 1, 16,
                    separable_conv=True, device="cpu")
    convert.load_variables(m19, convert.random_variables(m19, seed=0))
    save_checkpoint(ck19, m19)
    del model
    with open(os.path.join(dl_dir, f"train_seed{NSEG}.txt")) as f:
        rows = [[os.path.join(root, p) for p in line.split("\t")]
                for line in f.read().splitlines()]
    rng = np.random.RandomState(6)
    sel = {r[2]: sorted(rng.choice(NSEG, int(EV_SELECT * NSEG),
                                   replace=False).tolist()) for r in rows}
    for rnd, suppix in ((1, {k: v[:len(v) // 3] for k, v in sel.items()}),
                        (2, sel)):
        with open(os.path.join(run, f"datalist_{rnd:02d}.json"), "w") as f:
            json.dump({"trg_label_im_idx": rows, "trg_pool_im_idx": [],
                       "trg_label_suppix": suppix, "trg_pool_suppix": {}}, f)
    workers = min(8, os.cpu_count() or 1)
    common = ["-p", run, "--data_root", root, "--datalist_dir", dl_dir,
              "--dataset", "cityscapes", "--num_classes",
              str(NUM_CLASSES - 1), "--nseg", str(NSEG), "--separable_conv",
              "--dtype", "bfloat16", "--num_workers", str(workers),
              "--val_num_workers", str(workers), "--init_iteration", "2",
              "--datalist_path", os.path.join(run, "datalist_02.json"),
              "--stage2", "--or_labeling", "--loader",
              "eval_region_cityscapes_all",
              "--trim_multihot_boundary", "--trim_kernel_size", "5",
              "--dontlog"]

    def argv(method, *extra, ckpt=ck):
        return common + ["--init_checkpoint", ckpt, "--resume_checkpoint",
                         ckpt, "--method", method, *extra]

    cfg = parse_config(argv("eval_save_cosplbl_prop"))
    label = build_active_datasets(cfg)[0]
    label.load_datalist(cfg.datalist_path)
    label = label.trg_label_dataset
    eval_all = datasets.EvalRegionDatasetAll(cfg, label, label.suppix,
                                             emit_u8=True)
    n_img = len(eval_all)
    model = get_model(cfg.model, NUM_CLASSES, 16, separable_conv=True,
                      device=dev)
    convert.load_variables(model, variables)

    # K5 at the sliding pseudo-labeller's instance: one image's softmax of
    # the window-summed logits under its labelled superpixels' ids
    item = eval_all[0]
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    feat, logits = SlidingEval(model, NUM_CLASSES - 1, return_feat=True,
                               device=dev, autocast=True)(
        item["images"][None])
    _sync(dev)
    slide_feat_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    planes = torch.softmax(logits[0], dim=0).reshape(NUM_CLASSES, -1).t()
    del feat, logits
    rows_k5 = [k5_row("seg_max_fwd@slide_plbl, 1024x2048 sliding sums",
                      planes, item["spx"].reshape(-1),
                      item["spmask"].reshape(-1), NSEG, dev)]
    # ... and at the probe's: one 768x768 crop's softmax (T = 1) over the
    # 19 outputs of the model it evaluates (K5's run-time-C instance)
    # under its spmask ids (the labelled set's train items)
    label.load_gt = True
    crop = label[0]
    m19.to(dev)
    logits = eval_forward(m19, crop["images"][None], dev, True)
    planes = torch.softmax(logits[0].float(), dim=0).reshape(
        NUM_CLASSES - 1, -1).t()
    del logits, m19
    rows_k5.append(k5_row("seg_max_fwd@probe, 768x768 crop, 19 classes",
                          planes,
                          crop["spx"].reshape(-1), crop["spmask"].reshape(-1),
                          NSEG, dev))
    del planes
    label.load_gt = False

    # the commands: (name, main, argv, K5 launches)
    cos_plbl = {"cosprop_includeonehot_slide":
                ("eval_save_cosplbl_prop_includeonehot_slide",),
                "cosprop_plusonehot": ("eval_save_cosplbl_prop_plusonehot",
                                       "--save_vis"),
                "cos_naiveprop": ("eval_save_cosplbl_naiveprop",
                                  "--plbl_th", "0.5")}
    simple_plbl = {"naive_argmax": ("eval_save_naiveplbl", "--plbl_type",
                                    "naive_argmax"),
                   "naive": ("eval_save_naiveplbl",),
                   "within_multihot": ("eval_save_candidateplbl",
                                       "--plbl_type", "within_multihot"),
                   "candidate": ("eval_save_candidateplbl",),
                   "candidate_prop": ("eval_save_candidateplbl_prop",
                                      "--plbl_th", "0.5")}
    windows = len(_window_grid(PH, PW, cfg.slide_crop,
                               cfg.slide_stride_rate)[2])
    check(windows == EV_WINDOWS, f"{windows} sliding windows an image")
    commands = [("eval_naive_sliding", eval_al.main,
                 argv("eval_naive", "--sliding_eval"), 0)]
    commands += [(t, eval_al.main, argv(*a), n_img)
                 for t, a in cos_plbl.items()]
    commands += [(t, eval_al.main, argv(*a), 0)
                 for t, a in simple_plbl.items()]
    # the JAX CLI runs neither of these on a Cityscapes tree: its loader
    # gives eval_all_dominant the multi-hot 'target' (ROADMAP.md, question
    # 7) and a _voc method a 19-output model, whose candidate mask has 20
    # columns; both run at the evaluator level below
    at_evaluator = ("eval_all_dominant", "eval_within_multihot_voc")
    analysis = [m for m in ANALYSIS_METHODS if m not in at_evaluator]
    for m in analysis:
        plbl = ANALYSIS_METHODS[m].get("plbl", "")
        n = EV_VAL if ANALYSIS_METHODS[m].get("pred") == "argmax" \
            else n_img
        commands.append((m, eval_al.main, argv(m),
                         n if plbl.startswith("cos") else 0))
    commands.append(("active_joint_multi_analysis", eval_al.main,
                     argv("active_joint_multi_analysis", ckpt=ck19),
                     n_img))
    log = []
    with _Timed(dev, log, (Evaluator, "run"), (AnalysisEvaluator, "run"),
                (SelectionAccuracyEvaluator, "run")):
        wall, launches, results, _, plbl_s, peak_gib = run_commands(
            dev, [c[:3] for c in commands])
    for name, _, _, k5 in commands:
        want = {"seg_max_fwd": k5} if k5 else {}
        check(launches[name] == want, f"evals: {name} launched "
              f"{launches[name]}, want {want}")
        check(math.isfinite(results[name]), f"evals: {name} gave "
              f"{results[name]}")
    check(len(log) == len(commands) - len(cos_plbl) - len(simple_plbl),
          f"evals: evaluator runs {log}")
    run_s = iter(s for _, s in log)
    out = {}
    for name, _, a, _ in commands:
        rec = {"command_s": wall[name], "result": results[name],
               "k5_launches": launches[name].get("seg_max_fwd", 0)}
        if name in cos_plbl or name in simple_plbl:
            s = plbl_s.pop(0)
            d = plbl_save_dir(ck, name, "02")
            pngs = sorted(os.listdir(d))
            check(len(pngs) == n_img and all(
                read_gray8(os.path.join(d, p)).shape == (PH, PW)
                for p in pngs), f"evals: {name} wrote {pngs}")
            rec.update(s=s, img_per_s=n_img / s, pngs_decoded=len(pngs))
            if "--save_vis" in a:
                vis = sorted(os.listdir(d + "_vis"))
                for p in vis:
                    rgb = read_rgb8(os.path.join(d + "_vis", p))
                    check(rgb.shape == (PH, PW, 3) and
                          bool((rgb == (255, 255, 0)).all(-1).any()),
                          f"evals: bad overlay {p}")
                check(len(vis) == n_img, f"evals: {name} overlays {vis}")
                rec["overlays_decoded"] = len(vis)
        else:
            s = next(run_s)
            n = (EV_VAL if name in ("eval_naive_sliding", "eval_naive_vis")
                 else n_img)
            rec.update(s=s, img_per_s=n / s)
            vis_dir = os.path.join(run, f"vis_{name}_02")
            if os.path.isdir(vis_dir):
                vis = sorted(os.listdir(vis_dir))
                # eval_naive_vis's are the validation transform's size
                check(len(vis) == n and all(
                    read_rgb8(os.path.join(vis_dir, p)).shape[2] == 3
                    for p in vis), f"evals: {name} overlays {vis}")
                rec["overlays_decoded"] = len(vis)
        if name == "eval_naive_sliding":
            rec["windows_per_image"] = windows
        out[name] = rec
        print(f"evals {name}: {json.dumps(rec)}", flush=True)

    # the sliding forward warm beside the direct one, on the validation
    # images in memory, batched as the command's loader batches them (the
    # command's run above includes the workers' start and the first
    # shapes; other window batches would round the bf16 forward
    # otherwise)
    val_ds = build_active_datasets(cfg)[1]
    items = [val_ds[i] for i in range(len(val_ds))]
    bs = cfg.val_batch_size
    vb = [collate(items[i:i + bs]) for i in range(0, len(items), bs)]
    del items
    warm = {}
    for arm, flags in (("sliding", ("--sliding_eval",)), ("direct", ())):
        ev = Evaluator(model, parse_config(argv("eval_naive", *flags)),
                       device=dev)
        ev.run(None, vb)
        _sync(dev)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        miou, _ = ev.run(None, vb)
        _sync(dev)
        warm[arm] = {"img_per_s": EV_VAL / (time.perf_counter() - t1),
                     "miou": miou, "peak_mem_gib":
                     torch.cuda.max_memory_allocated() / 2 ** 30}
    check(abs(warm["sliding"]["miou"] - results["eval_naive_sliding"])
          < 1e-9, f"evals: warm sliding mIoU {warm['sliding']['miou']}, "
          f"the command's {results['eval_naive_sliding']}")
    out["eval_naive_sliding"]["warm"] = warm
    del vb

    # the dominant-map readers at the generator and evaluator level, on
    # the label set's items with 'target' the dominant labels of the
    # selected superpixels (255 elsewhere), and the _voc method
    batches = []
    for i in range(n_img):
        it = eval_all[i]
        dom = datasets.open_label(os.path.join(
            root, f"superpixel_seed/cityscapes/seeds_{NSEG}/train/"
            "gtFine_dominant", os.path.basename(it["fnames"][1]).replace(
                "_gtFine_labelIds", "")))
        batches.append({**{k: (v[None] if k != "fnames" else [v])
                           for k, v in it.items()},
                        "dominant": np.where(it["spmask"], dom, 255)[None]})
    for ptype in ("cosprop_onehot", "cosprop_onehotignore"):
        gen = PseudoLabelGenerator(model, cfg, ptype, device=dev)
        _sync(dev)
        _build.reset_launches()
        t1 = time.perf_counter()
        res = gen.generate(None, [{**b, "target": b["dominant"]}
                                  for b in batches],
                           save_dir=os.path.join(run, ptype),
                           suppix=label.suppix)
        _sync(dev)
        s = time.perf_counter() - t1
        got = dict(_build.LAUNCHES)
        check(got == {"seg_max_fwd": n_img} and math.isfinite(res[0]),
              f"evals: {ptype} launched {got}, mIoU {res[0]}")
        launches[ptype] = got
        out[ptype] = {"level": "generator", "s": s, "img_per_s": n_img / s,
                      "result": res[0], "k5_launches": n_img,
                      "pngs_decoded": sum(
                          read_gray8(os.path.join(run, ptype, p)).shape ==
                          (PH, PW) for p in os.listdir(
                              os.path.join(run, ptype)))}
    for m in at_evaluator:
        cfg_m = parse_config(argv(m))
        ev = AnalysisEvaluator(model, cfg_m, m, device=dev)
        _sync(dev)
        _build.reset_launches()
        t1 = time.perf_counter()
        res = ev.run(None, [{**b, "target": b["dominant"]} if
                            m == "eval_all_dominant" else b
                            for b in batches], suppix=label.suppix)
        _sync(dev)
        s = time.perf_counter() - t1
        got = dict(_build.LAUNCHES)
        check(got == {} and math.isfinite(res["miou"]),
              f"evals: {m} launched {got}, mIoU {res['miou']}")
        launches[m] = got
        out[m] = {"level": "evaluator", "s": s, "img_per_s": n_img / s,
                  "result": res["miou"], "k5_launches": 0}
    del batches, model
    torch.cuda.empty_cache()

    # the statistics loaders: items/s over the labelled set, one pass on
    # worker processes, each item's keys checked
    stats = {}
    want_keys = {
        "count_all": {"sup_size_bin": np.int64, "num_class_bin": np.int64},
        "visualize_minor": {"superpixel": np.int32, "target": np.int32},
        "dom_w_gt": {"images": np.float32, "target": np.int32,
                     "labels": np.int32, "spx": np.int32, "spmask": bool},
        "dominant_sample": {"images": np.float32, "labels": np.int32,
                            "spx": np.int32}}
    for loader, mode in (("count_all", "count_all"),
                         ("visualize_minor", "visualize_minor"),
                         ("dom_w_gt", "dom_w_gt"),
                         ("dominant_all_sample", "dominant_sample")):
        c = parse_config(common + ["--loader",
                                   f"region_cityscapes_or_tensor_{loader}",
                                   "--method", "active_predignore"])
        active = build_active_datasets(c)[0]
        active.load_datalist(c.datalist_path)
        ds = active.trg_label_dataset
        check(type(ds).__name__ == "RegionStatsDataset" and ds.mode == mode,
              f"evals: loader {loader} built {type(ds).__name__}")
        item = ds[0]
        for k, dt in want_keys[mode].items():
            check(np.asarray(item[k]).dtype == dt, f"evals: {loader} item "
                  f"{k} is {np.asarray(item[k]).dtype}, want {dt}")
        shape = (c.nseg, c.num_classes + 1)
        if mode == "visualize_minor":
            check(item["superpixel_info"][0].shape == shape and
                  item["superpixel"].shape == (PH, PW), f"evals: {loader}")
        elif mode == "count_all":
            check(item["num_class_bin"].shape == (c.nseg,), "count_all")
        else:
            check(item["images"].shape == (3,) + tuple(c.crop_size),
                  f"evals: {loader} crop {item['images'].shape}")
        t1 = time.perf_counter()
        loader_ = DataProvider(ds, 1, shuffle=False, drop_last=False,
                               infinite=False, num_workers=workers)
        n = sum(1 for _ in loader_)
        loader_.close()
        stats[loader] = {"mode": mode,
                         "items_per_s": n / (time.perf_counter() - t1)}

    # training through the statistics loaders and active_slide: the
    # recipe's stage-1 command cut to 1 round of EV_ITRS steps
    cmds = recipe_commands("train_city_mul_res50.sh", workdir, root)
    base = recipe_cut(cmds[0], workdir, dl_dir, {
        "--finetune_itrs": EV_ITRS, "--val_period": EV_ITRS,
        "--max_iterations": 1,
        "--active_selection_size": round(EV_TRAIN * 100_000 / 2_975)})
    init = base[base.index("--init_checkpoint") + 1]
    m = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES, 16,
                  separable_conv=True, device="cpu")
    convert.load_variables(m, variables)
    save_checkpoint(init, m)  # the seeded stand-in of the ImageNet init
    del m
    dominant = {"--or_labeling": "false", "--dominant_labeling": "true",
                "--trg_datalist": os.path.join(
                    dl_dir, f"train_seed{NSEG}_dominant_labels.txt")}
    trains_cmds = [
        ("train_dom_w_gt", {**dominant, "--method": "active_predignore",
                            "--loader": "region_cityscapes_dom_w_gt"}),
        # named with or_labeling unset, as the reference's Dominant
        # scripts do (the Or arm's selection reads multi-hot counts the
        # statistics loaders do not carry, in JAX as here); the precise
        # GT's datalist, each drawn label from its counts
        ("train_dominant_all_sample", {
            "--or_labeling": "false", "--method": "active_predignore",
            "--loader": "region_cityscapes_dominant_all_sample"}),
        ("train_active_slide", {**dominant, "--method": "active_slide",
                                "--loader": "region_cityscapes",
                                "--sliding_eval": "true"})]
    tcommands = [(name, train_al.main, with_flags(base, {
        "-p": os.path.join(workdir, name), **flags}))
        for name, flags in trains_cmds]
    log.clear()
    with _Timed(dev, log, (Evaluator, "run")):
        twall, tlaunches, tresults, trains, _, tpeak = run_commands(
            dev, tcommands)
    want = bn_launches("deeplabv3pluswn_resnet50deepstem", EV_ITRS)
    for (name, _, _), rec in zip(tcommands, trains):
        check(tlaunches[name] == want and len(rec["losses"]) == EV_ITRS and
              all(map(math.isfinite, rec["losses"])) and
              len(rec["validations"]) == 1 and
              all(map(math.isfinite, tresults[name].values())),
              f"evals: {name} launched {tlaunches[name]} (want {want}), "
              f"losses {rec['losses']}, validations {rec['validations']}, "
              f"mIoU {tresults[name]}")
        out[name] = {"command_s": twall[name], "train_img_per_s":
                     rec["img_per_s"], "losses": rec["losses"],
                     "eval_miou": tresults[name][1]}
    sl = [s for n, s in log]
    out["train_active_slide"]["sliding_validation_s"] = sl[-1]
    launches.update(tlaunches)

    line = {"evals": {
        "card": smi, "config": f"deeplabv3pluswn_resnet50deepstem "
        f"separable, {NUM_CLASSES} outputs (19 for the probe and the _voc "
        f"method), bf16, nseg {NSEG}; tree: {EV_TRAIN} train and {EV_VAL} "
        f"val images at {PH}x{PW}, dominant labels, {EV_SELECT:.0%} of each "
        f"image's superpixels labelled; sliding crop {cfg.slide_crop}, "
        f"stride {cfg.slide_stride_rate}",
        "tree_s": tree_s, "methods": out, "stats_loaders": stats,
        "sliding_feature_sum_peak_gib": slide_feat_peak_gib,
        "peak_mem_gib": max(peak_gib, tpeak),
        "launches": {k: v for k, v in launches.items() if v}}}
    total = Counter()
    for v in launches.values():
        total.update(v)
    tree = {"common": common, "ck": ck, "ck19": ck19, "images": n_img}
    return line, dict(total), rows_k5, tree


def small_selector_check(dev, variables):
    """The paper's selector on the card against the CPU: the full-width
    model with the seeded weights in float32 (TF32 off) on two 96x80
    images, nseg 24; scores within 1e-4, the same selected regions."""
    from mulactseg_tpu_torch.acquisition import get_selector
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine.rounds import ALTrainer
    from mulactseg_tpu_torch.models import convert

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in ("cpu", dev):
            cfg = Config(num_classes=NUM_CLASSES - 1, nseg=24,
                         dtype="float32", separable_conv=True,
                         val_batch_size=2, val_num_workers=1,
                         model_save_dir=os.path.join(tmp, str(d)))
            kw = dict(n_images=2, H=96, W=80, num_classes=NUM_CLASSES - 1,
                      nseg=24, seed=5)
            pool = SyntheticRegionDataset(split="active-ulabel", **kw)
            label = SyntheticRegionDataset(**kw)
            label.suppix, label.im_idx = {}, []
            trainer = ALTrainer(cfg, 2, device=d)
            convert.load_variables(trainer.model, variables)
            sel = get_selector("my_bvsb_predclsbal_pwr_banignore", cfg)
            scores = sel.calculate_scores(trainer, pool)
            sel.select_next_batch(trainer, RegionActiveSet(cfg, pool, label),
                                  12)
            out[str(d)] = (scores, label.suppix)
    (cs, cl), (gs, gl) = out["cpu"], out[str(dev)]
    err = max(abs(a[0] - b[0]) for a, b in zip(cs, gs))
    check([s[1:] for s in cs] == [s[1:] for s in gs] and err <= 1e-4,
          f"small selector: card scores differ from the CPU by {err}")
    check(cl == gl and sum(len(v) for v in cl.values()) > 0,
          f"small selector: card selected {gl}, CPU {cl}")
    print(f"small selector (96x80, nseg 24, float32): scores within {err} "
          f"of the CPU, the same {sum(len(v) for v in cl.values())} regions",
          flush=True)
    return err


# -- the data-parallel phase (dp) ---------------------------------------------
def _dp_model(variables, dev):
    """The recipe model on `dev` with the seeded `variables`."""
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model

    model = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES,
                      16, separable_conv=True, device=dev)
    convert.load_variables(model, variables)
    return model


def _flat_grads(model):
    return torch.cat([p.grad.reshape(-1).float() for p in model.parameters()
                      if p.grad is not None]).cpu()


def dp_steps(variables, cfg, batches, device, identity_check=False):
    """cfg's stage-1 steps from `variables` on this rank's rows of each
    global batch (every rank of a group, or the process alone): the
    logged losses (global), the step-0 gradient (summed over the ranks;
    rank 0 only), the weights after the steps, the kernels' launches, ms
    a step after the first, the gradient bytes all-reduced a step and
    the peak GiB of this process. identity_check: every collective of
    the step must give back its input bitwise (a group of one rank)."""
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.parallel import mesh

    dev = torch.device(device)
    model = _dp_model(variables, dev)
    step = make_train_step(model, cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    rows = mesh.local_rows(cfg.train_batch_size)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    losses, grad0, times = [], None, []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        aux = step({k: v[rows] for k, v in batch.items()})
        _sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in aux.items()})
        if i == 0 and mesh.is_main():
            grad0 = _flat_grads(model)
    launches = dict(_build.LAUNCHES)
    out = {"losses": losses, "grad0": grad0, "launches": launches,
           "step_ms": statistics.mean(times[1:] or times) * 1e3,
           "grad_bytes": 4 * sum(p.numel() for p in model.parameters()
                                 if p.grad is not None),
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                        if dev.type == "cuda" else None),
           "state": ({k: v.detach().cpu()
                      for k, v in model.state_dict().items()}
                     if mesh.world() == 1 else None)}
    if identity_check:
        grads = [p.grad.clone() for p in model.parameters()
                 if p.grad is not None]
        mesh.all_reduce_grads(model)
        sums = torch.randn(2, 64, device=dev)
        out["identity"] = all(torch.equal(g, p.grad) for g, p in zip(
            grads, (p for p in model.parameters() if p.grad is not None))) \
            and torch.equal(mesh.all_reduce_sum(sums), sums)
    return out


def dp_world1(variables, adamw, sgds, batches, sgd_batches, device):
    """World 1 (one rank): the recipe's AdamW steps, then from the
    seeded weights again the SGD trajectory under each config of sgds."""
    a = dp_steps(variables, adamw, batches, device, identity_check=True)
    return a, [dp_steps(variables, c, sgd_batches, device) for c in sgds]


def dp_world2(variables, sgds, batches, device):
    """World 2: the SGD trajectory under each config of sgds."""
    return [dp_steps(variables, c, batches, device) for c in sgds]


def _trajectory_dev(got, want):
    return max(abs(a["train_loss"] - b["train_loss"])
               / max(abs(b["train_loss"]), 1e-6) for a, b in zip(got, want))


def _grad_stats(got, want):
    """(loss-free) cosine and relative norm deviation of two flat
    gradients, in float64."""
    g, w = got.double(), want.double()
    cos = float(g @ w / (g.norm() * w.norm() + 1e-30))
    return cos, float(abs(g.norm() - w.norm()) / max(float(w.norm()), 1e-30))


def _dp_sets(cfg, n_pool, n_val):
    """The synthetic active-learning sets of the round (al_rounds'
    seeds): pool and label sets of n_pool images, a val set of n_val."""
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset

    def dataset(split, n, seed):
        return SyntheticRegionDataset(n_images=n, H=cfg.crop_size[0],
                                      W=cfg.crop_size[1],
                                      num_classes=cfg.num_classes,
                                      nseg=cfg.nseg, split=split, seed=seed)

    pool, label = dataset("active-ulabel", n_pool, 7), \
        dataset("active-label", n_pool, 7)
    label.suppix, label.im_idx = {}, []
    return pool, label, dataset("val", n_val, 8)


def _regions(suppix):
    return {(k, int(i)) for k, ids in suppix.items() for i in ids}


def dp_round(cfg, s2cfg, init, images_dir, sizes, device):
    """One active-learning round on every rank of the group (docstring,
    item 8f): the paper's selector from the init file, training with
    validation, the best checkpoint back, eval, pseudo-labelling (rank 0)
    and stage 2; launches counted around training, plbl and stage 2."""
    from mulactseg_tpu_torch.acquisition import get_selector
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.data.datasets import RegionDatasetPlbl
    from mulactseg_tpu_torch.data.loader import DataProvider
    from mulactseg_tpu_torch.engine.rounds import ALTrainer
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import (
        PseudoLabelGenerator,
        plbl_save_dir,
    )

    dev = torch.device(device)
    pool, label, val = _dp_sets(cfg, *sizes)
    active = RegionActiveSet(cfg, pool, label)
    active.selection_iter = 1
    trainer = ALTrainer(cfg, 1, val_dataset=val, eval_dataset=val,
                        device=dev)
    trainer.load(init)
    t0 = time.perf_counter()
    get_selector("my_bvsb_predclsbal_pwr_banignore", cfg).select_next_batch(
        trainer, active, cfg.active_selection_size)
    active.dump_datalist()
    select_s = time.perf_counter() - t0
    losses, validations = [], []
    real = trainer.validate
    trainer.validate = lambda it: validations.append(real(it))
    _build.reset_launches()
    t0 = time.perf_counter()
    rate = trainer.train(active, metrics_cb=lambda it, aux:
                         losses.append(aux["train_loss"]))
    train_s = time.perf_counter() - t0
    train_launches = dict(_build.LAUNCHES)
    if trainer.best_iou == 0.0:
        trainer.save()
    else:
        trainer.load(trainer.checkpoint_file, strip_classifier=False)
    miou, _ = trainer.eval()
    confusion = trainer.evaluator.confusion

    # pseudo-labels of the label set with the round's checkpoint: rank 0
    # generates, the others wait for its PNGs
    gen = PseudoLabelGenerator(trainer.model, cfg, "cosprop_includeonehot",
                               device=dev)
    plbl_dir = plbl_save_dir(trainer.checkpoint_file,
                             "cosprop_includeonehot", "01")
    loader = DataProvider(label, 1, shuffle=False, drop_last=False,
                          infinite=False, num_workers=0)
    _sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    plbl_miou = gen.generate(None, loader, save_dir=plbl_dir,
                             suppix=label.suppix)[0]
    _sync(dev)
    plbl_s = time.perf_counter() - t0
    plbl_launches = dict(_build.LAUNCHES)
    loader.close()
    del gen, trainer

    # stage 2 on the pseudo-labels and the images as RGB PNGs
    stage2 = RegionDatasetPlbl(s2cfg, [
        [os.path.join(images_dir, k[0]), k[1], k[2]] for k in label.im_idx],
        plbl_dir)

    class Stage2Set:
        def get_trainset(self):
            return stage2

    s2 = ALTrainer(s2cfg, 1, device=dev)
    s2.load(init)
    s2losses = []
    _build.reset_launches()
    s2_rate = s2.train(Stage2Set(), metrics_cb=lambda it, aux:
                       s2losses.append(aux["train_loss"]))
    return {"regions": _regions(label.suppix), "n_label": len(label),
            "select_s": select_s, "train_s": train_s, "train_img_per_s": rate,
            "losses": losses, "validations": validations, "miou": miou,
            "confusion": confusion, "train_launches": train_launches,
            "plbl_s": plbl_s, "plbl_miou": plbl_miou,
            "plbl_launches": plbl_launches,
            "stage2_img_per_s": s2_rate, "stage2_losses": s2losses,
            "stage2_launches": dict(_build.LAUNCHES),
            "files": sorted(os.listdir(cfg.model_save_dir)),
            "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None)}


def dp_slice(variables, dev, smi, workdir, backend1="nccl",
             backend2="gloo"):
    """The data-parallel main path (docstring, item 8f): world 1 under
    backend1 against the step without a group, world 2 (two processes
    sharing the card, each with device `dev`) under backend2 against
    world 1, and one active-learning round at world 2. Returns (the dp
    line, the path's launches summed over the ranks)."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.loader import DataProvider
    from mulactseg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from mulactseg_tpu_torch.engine.evaluate import Evaluator
    from mulactseg_tpu_torch.engine.rounds import ALTrainer
    from mulactseg_tpu_torch.acquisition import get_selector
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.parallel import mesh
    from mulactseg_tpu_torch.utils.png import write_rgb8

    device = str(dev)
    common = dict(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                  train_batch_size=B, dtype="bfloat16", separable_conv=True,
                  method="active_joint_multi_predignore_lossdecomp")
    adamw = Config(finetune_itrs=DP_STEPS, **common)
    # the JAX dryrun holds float32 runs to its bounds; the recipe's bf16
    # convolutions round differently at 2 images a rank (other cuDNN
    # algorithms), and the step-0 gradient of the seeded model is chaotic
    # in its input (the group term's argmax), so bf16 is held to the
    # loss and trajectory bounds and its gradient agreement is reported
    sgd16 = Config(optimizer="sgd", finetune_itrs=DP_SGD_STEPS, **common)
    sgds = (dataclasses.replace(sgd16, dtype="float32"), sgd16)
    batches = make_batches(DP_STEPS, seed=5)
    sgd_batches = batches[:DP_SGD_STEPS]

    # world 1: the group of one rank against the process alone, twice
    # (the card's step is not bitwise reproducible: atomic adds in the
    # backward); then the SGD trajectory of world 1
    t0 = time.perf_counter()
    refs = [dp_steps(variables, adamw, batches, device) for _ in range(2)]
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w1, w1_sgd = mesh.spawn(dp_world1, 1, backend1, device, variables, adamw,
                            sgds, batches, sgd_batches, device,
                            timeout=DP_TIMEOUT)[0]
    w1_s = time.perf_counter() - t0
    check(w1["identity"], "world 1: a collective changed its input")
    check(w1["losses"][0] == refs[0]["losses"][0],
          f"world 1 step 0 {w1['losses'][0]} is not the step without a "
          f"group's {refs[0]['losses'][0]} bitwise")
    repeat_dev = _trajectory_dev(refs[1]["losses"], refs[0]["losses"])
    w1_dev = _trajectory_dev(w1["losses"], refs[0]["losses"])
    check(w1_dev < 0.05, f"world 1's {DP_STEPS} steps stray {w1_dev} from "
          "the step without a group")
    differing = sum(not torch.equal(w1["state"][k], v)
                    for k, v in refs[0]["state"].items())
    repeat_differing = sum(not torch.equal(refs[1]["state"][k], v)
                           for k, v in refs[0]["state"].items())
    dp_model = "deeplabv3pluswn_resnet50deepstem"  # _dp_model's
    for r in (w1, *w1_sgd, *refs):
        steps = len(r["losses"])
        check(r["launches"] == {**{k: steps for k in STAGE1_KERNELS},
                                **bn_launches(dp_model, steps)},
              f"world 1 launches {r['launches']}")

    # world 2: two processes on the one card, step 0 and the SGD
    # trajectory against world 1's, in float32 and in bf16
    t0 = time.perf_counter()
    w2 = mesh.spawn(dp_world2, 2, backend2, device, variables, sgds,
                    sgd_batches, device, timeout=DP_TIMEOUT)
    w2_s = time.perf_counter() - t0
    agree = {}
    for i, c in enumerate(sgds):
        mine, want = w2[0][i], w1_sgd[i]
        l2, l1 = (mine["losses"][0]["train_loss"],
                  want["losses"][0]["train_loss"])
        cos, norm_dev = _grad_stats(mine["grad0"], want["grad0"])
        agree[c.dtype] = {
            "step0_loss_dev": abs(l2 - l1) / abs(l1), "grad_cos": cos,
            "grad_norm_dev": norm_dev,
            "sgd_traj_dev": _trajectory_dev(mine["losses"], want["losses"]),
            "step_ms": [w2[r][i]["step_ms"] for r in range(2)],
            "world1_step_ms": want["step_ms"],
            "peak_gib": [w2[r][i]["peak_gib"] for r in range(2)]}
        a = agree[c.dtype]
        print(f"dp world 2 ({backend2}, two ranks on one card) against world "
              f"1, {c.dtype}: step-0 loss dev {a['step0_loss_dev']:.3e}, "
              f"gradient cosine {cos:.6f}, norm dev {norm_dev:.3e}, "
              f"{DP_SGD_STEPS}-step SGD loss dev {a['sgd_traj_dev']:.3e}",
              flush=True)
        check(a["step0_loss_dev"] < 1e-3 and a["sgd_traj_dev"] < 0.05,
              f"world 2 {c.dtype}: loss or trajectory outside the JAX "
              "dryrun's bounds")
        for r in range(2):
            res = w2[r][i]
            check(res["launches"] == {
                **{k: DP_SGD_STEPS for k in STAGE1_KERNELS},
                **bn_launches(dp_model, DP_SGD_STEPS)},
                f"world 2 rank {r} launches {res['launches']}")
            check(res["losses"] == mine["losses"],
                  f"world 2 rank {r} logged other losses")
    f32 = agree["float32"]
    check(f32["grad_cos"] >= 0.99 and f32["grad_norm_dev"] < 1e-2,
          "world 2 float32 step-0 gradient outside the JAX dryrun's bounds")

    # one active-learning round at world 2, its world-1 references here
    run = os.path.join(workdir, "run")
    rcfg = Config(model_save_dir=run, finetune_itrs=DP_ITRS,
                  val_period=DP_ITRS // 2, val_start=0,
                  log_period=1, val_batch_size=1, num_workers=0,
                  val_num_workers=0, active_selection_size=AL_BUDGET,
                  **common)
    s2cfg = dataclasses.replace(rcfg, method="active_predignore",
                                stage2=True)
    init = os.path.join(workdir, "deeplab_resnet50deepstem_imagenet_"
                        "pretrained_seed0.pth")
    save_checkpoint(init, _dp_model(variables, dev))
    pool, label, val = _dp_sets(rcfg, AL_POOL, AL_VAL)
    images_dir = os.path.join(workdir, "images")
    for i, key in enumerate(pool.im_idx):
        os.makedirs(images_dir, exist_ok=True)
        write_rgb8(os.path.join(images_dir, key[0]), pool.images[i])
    ref = ALTrainer(dataclasses.replace(rcfg, model_save_dir=os.path.join(
        workdir, "ref")), 1, device=dev)
    ref.load(init)
    active = RegionActiveSet(ref.cfg, pool, label)
    active.selection_iter = 1
    get_selector("my_bvsb_predclsbal_pwr_banignore", ref.cfg
                 ).select_next_batch(ref, active, rcfg.active_selection_size)
    want = _regions(label.suppix)
    del ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rnd = mesh.spawn(dp_round, 2, backend2, device, rcfg, s2cfg, init,
                     images_dir, (AL_POOL, AL_VAL), device,
                     timeout=DP_TIMEOUT)
    round_s = time.perf_counter() - t0
    got = rnd[0]["regions"]
    jaccard = len(got & want) / max(len(got | want), 1)
    print(f"dp round at world 2: selection Jaccard {jaccard:.6f} against "
          f"world 1 ({len(want)} regions)", flush=True)
    check(jaccard >= 0.99, f"world 2 selection Jaccard {jaccard}")
    n_label = rnd[0]["n_label"]
    for r, res in enumerate(rnd):
        check(res["regions"] == got, f"rank {r} selected other regions")
        check(res["train_launches"] == {
            **{k: DP_ITRS for k in STAGE1_KERNELS},
            **bn_launches(dp_model, DP_ITRS)},
            f"round rank {r} training launches {res['train_launches']}")
        want_k5 = {"seg_max_fwd": n_label} if r == 0 else {}
        check(res["plbl_launches"] == want_k5,
              f"round rank {r} plbl launches {res['plbl_launches']}")
        check(res["stage2_launches"] == bn_launches(
            dp_model, s2cfg.finetune_itrs),
            f"round rank {r} stage-2 launches {res['stage2_launches']}")
        check(len(res["validations"]) == 2 and all(
            math.isfinite(v) for v in res["losses"] + res["stage2_losses"]
            + res["validations"]), f"round rank {r}: bad losses or "
              "validations")
        check(np.array_equal(res["confusion"], rnd[0]["confusion"]),
              f"round rank {r} counted another confusion matrix")
    check(rnd[0]["files"] == ["checkpoint01", "datalist_01.json",
                              "my_bvsb_predclsbal_pwr_banignore_"
                              "selection_01.json", "plbl_gen_"
                              "cosprop_includeonehot"],
          f"round files {rnd[0]['files']}")
    # world 1's eval of the checkpoint world 2 wrote, at batch 1
    model = _dp_model(variables, dev)
    model.load_state_dict(load_checkpoint(os.path.join(
        run, "checkpoint01"))["model_state_dict"])
    loader = DataProvider(val, 1, shuffle=False, drop_last=False,
                          infinite=False, num_workers=0)
    ev = Evaluator(model, rcfg, device=dev)
    ev.run(None, loader)
    loader.close()
    check(np.array_equal(ev.confusion, rnd[0]["confusion"]),
          "world 2's eval confusion matrix is not world 1's")
    del model

    launches = Counter()
    for res in (w1, *w1_sgd, *w2[0], *w2[1]):
        launches += Counter(res["launches"])
    for res in rnd:
        launches += Counter(res["train_launches"]) + Counter(
            res["plbl_launches"])
    line = {"dp": {
        "card": smi, "config": f"deeplabv3pluswn_resnet50deepstem "
        f"separable, {NUM_CLASSES} outputs, bf16, global batch {B}, "
        f"{H}x{W}, nseg {NSEG}",
        "world1": {"backend": backend1, "steps": DP_STEPS,
                   "step_ms": w1["step_ms"],
                   "img_per_s": B / w1["step_ms"] * 1e3,
                   "grad_bytes": w1["grad_bytes"], "peak_gib": w1["peak_gib"],
                   "no_group_step_ms": refs[0]["step_ms"],
                   "step0_loss_bitwise": True, "identity": w1["identity"],
                   "traj_dev": w1_dev, "no_group_repeat_dev": repeat_dev,
                   "tensors_differing": differing,
                   "no_group_repeat_tensors_differing": repeat_differing,
                   "tensors": len(refs[0]["state"]), "spawn_s": w1_s,
                   "no_group_s": ref_s},
        "world2": {"backend": backend2, "ranks_share_one_card": True,
                   "sgd_steps": DP_SGD_STEPS,
                   "img_per_s": B / max(agree["bfloat16"]["step_ms"]) * 1e3,
                   "grad_bytes": w2[0][1]["grad_bytes"],
                   "launches_per_rank": [r[1]["launches"] for r in w2],
                   "spawn_s": w2_s, **agree},
        "round": {"world": 2, "jaccard": jaccard, "regions": len(want),
                  "label_images": n_label,
                  "select_s": [r["select_s"] for r in rnd],
                  "train_s": [r["train_s"] for r in rnd],
                  "train_img_per_s": rnd[0]["train_img_per_s"],
                  "validations": rnd[0]["validations"],
                  "eval_miou": rnd[0]["miou"],
                  "confusion_equal_world1": True,
                  "plbl_s": rnd[0]["plbl_s"], "plbl_miou": rnd[0]["plbl_miou"],
                  "plbl_launches": [r["plbl_launches"] for r in rnd],
                  "stage2_img_per_s": rnd[0]["stage2_img_per_s"],
                  "stage2_loss": rnd[0]["stage2_losses"][-1],
                  "peak_gib": [r["peak_gib"] for r in rnd],
                  "spawn_s": round_s}}}
    return line, dict(launches)


# -- the criteria's data-parallel phase (dp_criteria) -------------------------
def dpc_steps(variables, cases, batch, common, device, grad_dir=None):
    """Step 0 of each (case, method, over, k5) of cases on the recipe model
    from the seeded `variables`, float32 with TF32 off, on this rank's rows
    of the global `batch` (as criteria_batch gives it to the case), Config
    keywords `common`, after one warm-up step of the first case. Per case
    the logged (global) losses, the step's ms and this rank's launches,
    every counter set to 0 just before the step and read just after. The
    step-0 gradient (summed over the ranks) as a flat float32 CPU tensor:
    returned without a group; in a group rank 0 writes it to
    grad_dir/<case>.pt as soon as it has it (the gradients of all cases
    would not fit one pickle)."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    model = _dp_model(variables, dev)
    rows = mesh.local_rows(len(batch["images"]))
    out = {}
    for i, (case, method, over, _) in enumerate([cases[0]] + list(cases)):
        cfg = Config(num_classes=NUM_CLASSES - 1, dtype="float32",
                     separable_conv=True, method=method, **common, **over)
        b = {k: v[rows] for k, v in criteria_batch(batch, method,
                                                   case).items()}
        convert.load_variables(model, variables)
        step = make_train_step(model, cfg, device=dev,
                               generator=torch.Generator(dev).manual_seed(0))
        _sync(dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        aux = step(b)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.LAUNCHES)
        del step
        if i == 0:  # the warm-up step
            continue
        rec = {"losses": {k: float(v) for k, v in aux.items()}, "ms": ms,
               "launches": launches}
        grad = _flat_grads(model)
        if not mesh.active():
            rec["grad0"] = grad
        elif mesh.is_main():
            tmp = os.path.join(grad_dir, f".{case}.pt")
            torch.save(grad, tmp)
            os.replace(tmp, os.path.join(grad_dir, f"{case}.pt"))
        out[case] = rec
    return out


def dpc_evals(argvs, device):
    """cli.eval_al.main(argv, device) for each argv on this rank (of a
    group, or the process alone), every launch counter set to 0 just
    before and read just after: per run the evaluator's result
    (AnalysisEvaluator's with its confusion matrix, or the probe's
    counts), the overlay files this rank wrote, its launches."""
    from mulactseg_tpu_torch.cli import eval_al
    from mulactseg_tpu_torch.engine import analysis
    from mulactseg_tpu_torch.ops import _build

    out = []
    for argv in argvs:
        results, written = [], []

        def capture(cls):
            real = cls.run

            def run(self, *a, **k):
                res = real(self, *a, **k)
                results.append({**res, "confusion": getattr(
                    self, "confusion", None)})
                return res
            return mock.patch.object(cls, "run", run)

        def overlay(cfg, labels, spx_map, path, dev,
                    _real=analysis.save_overlay):
            written.append(os.path.basename(path))
            return _real(cfg, labels, spx_map, path, dev)

        with capture(analysis.AnalysisEvaluator), \
                capture(analysis.SelectionAccuracyEvaluator), \
                mock.patch.object(analysis, "save_overlay", overlay):
            _sync(device)
            _build.reset_launches()
            t0 = time.perf_counter()
            eval_al.main(argv, device=device)
            _sync(device)
        out.append({"result": results[0], "overlays": written,
                    "s": time.perf_counter() - t0,
                    "launches": dict(_build.LAUNCHES)})
    return out


def dp_criteria_slice(variables, dev, smi, workdir, tree, backend="gloo"):
    """The criteria's data-parallel main path (docstring, item 8g): step 0
    of every criterion of CRITERIA_CASES and MORE_CRITERIA_CASES at world
    2 (two processes sharing the card, each with device `dev`, under
    `backend`) against world 1 (this process without a group), float32
    with TF32 off; then DPC_ANALYSIS and the probe through eval_al.main at
    world 2 against world 1 on the evals phase's tree (`tree`: its
    command's common arguments and checkpoints). Returns (the dp_criteria
    line, the path's launches over both worlds and the ranks)."""
    from concurrent.futures import ThreadPoolExecutor

    from mulactseg_tpu_torch.parallel import mesh

    device = str(dev)
    batch = more_regions(with_regions(make_batches(1, seed=9), 13), 17)[0]
    cases = list(CRITERIA_CASES + MORE_CRITERIA_CASES)
    common = {"nseg": NSEG, "crop_size": (H, W), "train_batch_size": B,
              "small_nseg": SMALL_NSEG}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    t0 = time.perf_counter()
    try:
        w1 = dpc_steps(variables, cases, batch, common, device)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    w1_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # world 2; rank 0's gradients are held against world 1's as they come
    grad_dir = os.path.join(workdir, "dp_criteria_grads")
    os.makedirs(grad_dir)
    grads = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(mesh.spawn, dpc_steps, 2, backend, device,
                          variables, cases, batch, common, device, grad_dir,
                          timeout=DP_TIMEOUT)
        for case, *_ in cases:
            path = os.path.join(grad_dir, f"{case}.pt")
            while not os.path.exists(path):
                if fut.done():
                    fut.result()  # raises the ranks' failure
                    check(False, f"dp_criteria: no world-2 gradient of {case}")
                time.sleep(0.05)
            grads[case] = _grad_stats(torch.load(path),
                                      w1[case].pop("grad0"))
            os.remove(path)
        w2 = fut.result()
    w2_s = time.perf_counter() - t0

    out, launches = {}, Counter()
    for case, method, _, k5 in cases:
        one, mine = w1[case], [w2[r][case] for r in range(2)]
        bn = bn_launches("deeplabv3pluswn_resnet50deepstem", 1)
        want1 = {**({"seg_max_fwd": k5 * B} if k5 else {}), **bn}
        want2 = {**({"seg_max_fwd": k5 * B // 2} if k5 else {}), **bn}
        check(one["launches"] == want1, f"dp_criteria {case}: world 1 "
              f"launches {one['launches']}, want {want1}")
        for r, res in enumerate(mine):
            check(res["launches"] == want2, f"dp_criteria {case}: rank {r} "
                  f"launches {res['launches']}, want {want2}")
            check(res["losses"] == mine[0]["losses"],
                  f"dp_criteria {case}: rank {r} logged other losses")
            launches += Counter(res["launches"])
        launches += Counter(one["launches"])
        l2, l1 = mine[0]["losses"], one["losses"]
        check(l2.keys() == l1.keys() and all(
            math.isfinite(v) for v in list(l1.values()) + list(l2.values())),
            f"dp_criteria {case}: losses {l2} against {l1}")
        cos, norm_dev = grads[case]
        rec = {"method": method,
               "loss_dev": abs(l2["train_loss"] - l1["train_loss"])
               / abs(l1["train_loss"]),
               "part_devs": {k: abs(l2[k] - v) / max(abs(v), 1e-12)
                             for k, v in l1.items()},
               "grad_cos": cos, "grad_norm_dev": norm_dev,
               "world2_step_ms": [r["ms"] for r in mine],
               "world1_step_ms": one["ms"],
               "k5_per_rank": [r["launches"].get("seg_max_fwd", 0)
                               for r in mine],
               "k5_world1": one["launches"].get("seg_max_fwd", 0),
               "train_loss": l1["train_loss"]}
        print(f"dp criterion {case}: {json.dumps(rec)}", flush=True)
        check(rec["loss_dev"] < 1e-3 and cos >= 0.99 and norm_dev < 1e-2,
              f"dp_criteria {case}: world 2 outside the JAX dryrun's "
              f"bounds: {rec}")
        out[case] = rec

    # the analysis evals and the probe through eval_al at both widths
    def argvs(run):
        base = list(tree["common"])
        base[base.index("-p") + 1] = run
        cut = ["--num_workers", "0", "--val_num_workers", "0"]
        return [base + cut + ["--init_checkpoint", tree["ck"],
                              "--resume_checkpoint", tree["ck"],
                              "--method", m] for m in DPC_ANALYSIS] + [
            base + cut + ["--init_checkpoint", tree["ck19"],
                          "--resume_checkpoint", tree["ck19"],
                          "--train_batch_size", "2",
                          "--method", "active_joint_multi_analysis"]]

    runs = [os.path.join(workdir, f"dpc_w{w}") for w in (1, 2)]
    t0 = time.perf_counter()
    e1 = dpc_evals(argvs(runs[0]), device)
    e1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e2 = mesh.spawn(dpc_evals, 2, backend, device, argvs(runs[1]), device,
                    timeout=DP_TIMEOUT)
    e2_s = time.perf_counter() - t0
    evals = {}
    names = list(DPC_ANALYSIS) + ["active_joint_multi_analysis"]
    n_img = tree["images"]
    for i, name in enumerate(names):
        one, mine = e1[i], [e2[r][i] for r in range(2)]
        check(one["launches"] == {"seg_max_fwd": n_img},
              f"dp_criteria {name}: world 1 launches {one['launches']}")
        launches += Counter(one["launches"])
        probe = name == "active_joint_multi_analysis"
        keys = (("ncorr_cls", "n_cls", "ncorr_total", "n_total", "acc_total")
                if probe else ("confusion", "miou"))
        for r, res in enumerate(mine):
            check(res["launches"] == {"seg_max_fwd": n_img // 2},
                  f"dp_criteria {name}: rank {r} launches {res['launches']}")
            launches += Counter(res["launches"])
            for k in keys:
                check(np.array_equal(res["result"][k], one["result"][k]),
                      f"dp_criteria {name}: rank {r} {k} "
                      f"{res['result'][k]}, world 1 {one['result'][k]}")
        rec = {"world1_s": one["s"], "world2_s": [r["s"] for r in mine],
               "k5_per_rank": [r["launches"].get("seg_max_fwd", 0)
                               for r in mine],
               "result": float(one["result"]["acc_total" if probe
                                             else "miou"])}
        vis = f"vis_{name}_02"
        if os.path.isdir(os.path.join(runs[0], vis)):
            files = sorted(os.listdir(os.path.join(runs[0], vis)))
            written = sorted(p for r in mine for p in r["overlays"])
            check(len(files) == n_img and written == files and sorted(
                os.listdir(os.path.join(runs[1], vis))) == files,
                f"dp_criteria {name}: overlays {written}, world 1 {files}")
            for f in files:
                with open(os.path.join(runs[0], vis, f), "rb") as a, \
                        open(os.path.join(runs[1], vis, f), "rb") as b:
                    check(a.read() == b.read(),
                          f"dp_criteria {name}: overlay {f} differs")
            rec["overlays_equal"] = len(files)
        print(f"dp eval {name}: {json.dumps(rec)}", flush=True)
        evals[name] = rec
    line = {"dp_criteria": {
        "card": smi, "config": f"deeplabv3pluswn_resnet50deepstem "
        f"separable, {NUM_CLASSES} outputs, float32 (TF32 off), global "
        f"batch {B}, {H}x{W}, nseg {NSEG}, weak view {WEAK_HW[0]}x"
        f"{WEAK_HW[1]}; world 2: two processes on one card under "
        f"{backend}; evals: the evals phase's tree ({n_img} labelled "
        f"images at {PH}x{PW}), bf16",
        "criteria": out, "evals": evals, "world1_s": w1_s,
        "world2_s": w2_s, "evals_world1_s": e1_s, "evals_world2_s": e2_s}}
    return line, dict(launches)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available()"
                 " is False")
    import mulactseg_tpu_torch

    check(Path(mulactseg_tpu_torch.__file__).resolve().parents[1] == HERE,
          "mulactseg_tpu_torch must come from this checkout")
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.loader import shutdown_workers
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    # pixel_loss, segment and segment_max set their sources' -D constants
    # before the build
    from mulactseg_tpu_torch.ops import _build, pixel_loss, segment  # noqa: F401

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    reports = _build.build_all(_build.SOURCES)
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (parallel nvcc, sm_90a)", flush=True)
    for name, log in reports.items():
        for line in ptxas_summary(log):
            print(f"  {name}: {line}")

    cfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                 train_batch_size=B, dtype="bfloat16", separable_conv=True,
                 method="active_joint_multi_predignore_lossdecomp")
    t0 = time.perf_counter()
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=cfg.separable_conv, device=dev)
    variables = convert.random_variables(model, seed=0)
    convert.load_variables(model, variables)
    batches = make_batches(2, seed=0)
    print(f"model {cfg.model} ({sum(p.numel() for p in model.parameters())}"
          f" params) and batches: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # realistic logits (upsampled cosine logits, with their near-ties) for
    # the kernel checks
    from mulactseg_tpu_torch.engine.train import _device_normalize

    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(_device_normalize(
            torch.as_tensor(batches[0]["images"]).to(dev)))
    check(logits.shape == (B, NUM_CLASSES, H, W)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad model logits")
    rows = kernel_checks(logits, batches[0], dev)
    batches_large = make_batches(2, seed=1, nseg=NSEG_LARGE)
    large_rows, row_inputs, k4_pre_err = large_kernel_checks(
        logits, batches_large[0], dev)
    # K4's row gives its larger error of the two forward branches
    rows = [(n, max(e, k4_pre_err) if n == "ssm_bwd" else e, *rest)
            for n, e, *rest in rows]
    del logits
    torch.cuda.synchronize()

    step = make_train_step(model, cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    losses, window_s, _ = run_steps(step, batches, WARMUP, TIMED)
    dt = sum(window_s)
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = WARMUP + TIMED
    want = {**{k: steps for k in STAGE1_KERNELS},
            **bn_launches(model, steps)}
    check(launches == want, f"stage-1 launches {launches}, want {want} "
          f"(K1-K4 and each BN kernel once a BN and step, {steps} steps)")
    check(all(math.isfinite(v) for v in losses.values()),
          f"non-finite loss {losses}")

    stage1_launches = launches
    bn_line, bn_rows = bn_slice(dev)
    print(json.dumps(bn_line, separators=(",", ":")), flush=True)

    # past the K3 guard: nseg 4096, from the seeded weights again. Every
    # timed run comes before the first torch.profiler pass, whose tracing
    # may stay armed and slow the host for the rest of the process.
    del step
    torch.cuda.empty_cache()
    convert.load_variables(model, variables)
    lcfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG_LARGE,
                  crop_size=(H, W), train_batch_size=B, dtype="bfloat16",
                  separable_conv=True, method=cfg.method)
    lstep = make_train_step(model, lcfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    large_losses, large_window_s, _ = run_steps(lstep, batches_large,
                                                WARMUP_LARGE, TIMED_LARGE)
    large_launches = dict(_build.LAUNCHES)
    large_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    large_steps = WARMUP_LARGE + TIMED_LARGE
    want = {**{k: large_steps for k in STAGE1_LARGE_KERNELS},
            **bn_launches(model, large_steps)}
    check(large_launches == want,
          f"nseg {NSEG_LARGE} launches {large_launches}, want {want}: "
          f"{STAGE1_LARGE_KERNELS} and each BN kernel once a BN and step, "
          "and no ssm_fwd (K3)")
    check(all(math.isfinite(v) for v in large_losses.values()),
          f"non-finite loss at nseg {NSEG_LARGE}: {large_losses}")
    del lstep

    row_launches, row_losses = row_op_pass(*row_inputs)
    del row_inputs
    print(json.dumps({"row_ops": row_losses}), flush=True)
    small_reference_check(dev)
    bad, flips = small_reference_check(dev, h=192, w=192, nseg=4608)
    print(f"small lossdecomp past the guard (192x192, nseg 4608): {flips} "
          f"K6 values round differently on the card, {bad} gradient entries "
          "outside 1e-5 (all in their segments)", flush=True)

    # the rest of the model zoo, then the criteria beside the recipe's at
    # the stage-1 shape; before the first profiler pass too
    torch.cuda.empty_cache()
    zoo_line, zoo_launches = zoo_slice(dev, smi, batches)
    crit_line, crit_launches, crit_rows = criteria_slice(
        model, variables, dev, smi, batches)
    crit_line["small_check_tie_entries"] = small_criteria_check(dev)
    crit_line["saturated_group_vs_float64"] = saturated_group_check(dev)
    print(f"saturated group term against float64: "
          f"{crit_line['saturated_group_vs_float64']}", flush=True)

    # the active-learning main path (rounds, plbl, stage 2), from a file of
    # the seeded weights; it comes before the first profiler pass too
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        al_line, al_launches = al_rounds_slice(variables, dev, smi, tmp)
    small_selector_check(dev, variables)
    # the round loop's 5 free-running rounds on the card against the CPU
    with tempfile.TemporaryDirectory() as tmp:
        rp_line, rp_launches = round_parity_slice(dev, smi, tmp)
    # the bf16 path against the JAX package's dtype=bfloat16 model, from
    # the reference file
    torch.cuda.empty_cache()
    bf16_line, bf16_launches, bf16_card = bf16_parity_slice(dev, smi)
    # its step at world 2: two ranks sharing the card under gloo
    torch.cuda.empty_cache()
    w2_line, w2_launches = bf16_world2_slice(
        torch.device("cuda", torch.cuda.current_device()), smi, bf16_card)
    del bf16_card
    # data parallelism: a group of one rank under NCCL, then two ranks
    # sharing the card under gloo (NCCL refuses two ranks on one card),
    # each on cuda:<this card> explicitly
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        dp_line, dp_launches = dp_slice(
            variables, torch.device("cuda", torch.cuda.current_device()),
            smi, tmp)
    # the recipe's three commands over files on disk, after the rounds
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cli_line, cli_launches = cli_recipe_slice(variables, dev, smi, tmp)
    # the loader arms over a tree with more granularities and dominant
    # labels
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        arms_line, arms_launches = loader_arms_slice(variables, dev, smi, tmp)
    shutdown_workers()  # the loader's worker processes
    # the VOC recipe's commands over a VOC-format tree, its kernel
    # instances held first
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        voc_line, voc_launches, voc_rows = voc_recipe_slice(dev, smi, tmp)
    shutdown_workers()
    # the remaining evals over a tree with dominant labels, their K5
    # instances held first, then the small card-against-CPU checks
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        evals_line, evals_launches, evals_rows, ev_tree = evals_slice(
            variables, dev, smi, tmp)
        shutdown_workers()
        # every criterion and the analysis evals at world 2 (two ranks
        # sharing the card under gloo), the evals on the evals' tree
        torch.cuda.empty_cache()
        dpc_line, dpc_launches = dp_criteria_slice(
            variables, torch.device("cuda", torch.cuda.current_device()),
            smi, tmp, ev_tree)
    convert.load_variables(model, variables)
    evals_line["evals"]["small_sliding_rel_err"] = small_evals_check(model,
                                                                     dev)

    # evaluation and pseudo-labelling at 1024x2048, from the seeded weights
    # again (BN in eval mode reads the running statistics)
    torch.cuda.empty_cache()
    convert.load_variables(model, variables)
    name, err, *rest = k5_checks(model, dev)  # K5 also held at al_rounds'
    rows.append((name, max(err, al_line["al_rounds"]["k5_max_abs_err"]),
                 *rest))
    pcfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, dtype="bfloat16",
                  method=cfg.method)
    eval_stats = eval_slice(model, pcfg, dev)
    plbl_stats, plbl_launches = plbl_slice(model, pcfg, dev)
    small_plbl_check(dev)
    for c, b in ((cfg, batches), (lcfg, batches_large)):
        gen = torch.Generator(dev).manual_seed(0)
        profile_steps(make_train_step(model, c, device=dev, generator=gen), b,
                      f"stage-1, nseg {c.nseg}")
    # the profiler switch through ALTrainer, last: a profiler pass slows
    # what follows
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        prof_line, prof_launches = profile_slice(variables, dev, smi, tmp)
    rows += large_rows + voc_rows + crit_rows + evals_rows + bn_rows
    # each kernel's launches on each main path that runs it, and their sum
    by_path = {f"stage1_nseg{NSEG}": stage1_launches,
               f"stage1_nseg{NSEG_LARGE}": large_launches,
               "plbl": plbl_launches, "row_ops": row_launches,
               "al_rounds": al_launches, "cli_recipe": cli_launches,
               "voc": voc_launches, "zoo": zoo_launches,
               "criteria": crit_launches, "loader_arms": arms_launches,
               "evals": evals_launches, "dp": dp_launches,
               "dp_criteria": dpc_launches, "profile": prof_launches,
               "round_parity": rp_launches, "bf16_parity": bf16_launches,
               "bf16_world2": w2_launches}
    launches = sum((Counter(n) for n in by_path.values()), Counter())
    check(all(launches[name] > 0 for name in KERNELS),
          f"a kernel was never launched on a main path: {dict(launches)}")

    # every slice's line at the end, the kernels line and the card last
    compact = {"separators": (",", ":")}
    for line in (zoo_line, crit_line, cli_line, arms_line, voc_line,
                 evals_line, dp_line, dpc_line, prof_line, rp_line,
                 bf16_line, w2_line, eval_stats):
        print(json.dumps(line, **compact))
    print(json.dumps({
        "slice": "cityscapes stage-1 train step", "card": smi,
        "img_per_s": B * TIMED / dt, "step_ms": dt / TIMED * 1e3,
        "window_step_ms": [t / WINDOW * 1e3 for t in window_s],
        "timed_steps": TIMED,
        "steps": steps, "peak_mem_gib": peak_gib,
        "ce_loss": losses["ce_loss"], "mc_loss": losses["mc_loss"],
        "group_loss": losses["group_loss"],
        "train_loss": losses["train_loss"]}, **compact))
    large_dt = sum(large_window_s)
    print(json.dumps({
        "slice": f"cityscapes stage-1 train step, nseg {NSEG_LARGE} "
                 "(pre-reduced group term)", "card": smi,
        "img_per_s": B * TIMED_LARGE / large_dt,
        "step_ms": large_dt / TIMED_LARGE * 1e3,
        "window_step_ms": [t / WINDOW * 1e3 for t in large_window_s],
        "timed_steps": TIMED_LARGE, "steps": large_steps,
        "peak_mem_gib": large_peak_gib, **large_losses}, **compact))
    print(json.dumps(plbl_stats, **compact))
    print(json.dumps(al_line, **compact))
    kernels = []
    for label, err, ms, plain_ms, (bound_ms, bound_by), lib_ms in rows:
        # a kernel timed at a second shape is labelled name@shape
        name, _, shape = label.partition("@")
        tag, source, replaces = KERNELS[name]
        kernels.append({
            "name": f"{tag} {name}" + (f" ({shape})" if shape else ""),
            "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {path: n[name] for path, n in by_path.items()
                                 if n.get(name)},
            "max_abs_err": err, "max_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    print(smi)
    print(json.dumps({"kernels": kernels, "card": smi}, **compact))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
