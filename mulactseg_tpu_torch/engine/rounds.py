"""Active-learning trainer shell and round orchestration: the port of
mulactseg_tpu/engine/rounds.py (ALTrainer, run_al_rounds), on one card or
on several, one rank each (parallel/mesh.py).

ALTrainer holds one round's model, optimizer and step count: a fresh
model every round (train_AL.py:44-46), the resume scenarios, the train
loop with periodic validation and the best-checkpoint policy
(trainer/base.py:222-244), selection logits and eval. It takes one
optimizer step per call: the JAX package's steps_per_dispatch amortises
TPU dispatch over a lax.scan of K steps and has no counterpart here, so
the option is ignored. cfg.profile traces each train() call with
torch.profiler (ALTrainer.train).

Data parallelism, the JAX package's mesh over cfg.n_devices: every rank
of a process group (torchrun, one rank per card) runs the same
run_al_rounds. Training steps on each rank's rows of the global batch
(engine/train.py), pool scoring forwards each rank's rows of every pool
batch and gathers the logits, so selection runs identically on every
rank; validation and eval give whole batches to the ranks and sum their
confusion matrices (engine/evaluate.py), so every rank takes the same
best-checkpoint decision. Rank 0 writes the checkpoints and the JSON
files; every rank reads them.

The model and the optimizer change in place here (load_state_dict,
optimizer.step), where the JAX package's train state is an immutable
value. So run_al_rounds keeps an explicit copy of the initial weights and
optimizer state for start_over, and the trainer flags a checkpoint load
itself (`loaded`) instead of comparing state identities.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile

from mulactseg_tpu_torch.acquisition import get_selector
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.checkpoint import (
    load_checkpoint,
    merge_pretrained,
    optimizer_state,
    save_checkpoint,
)
from mulactseg_tpu_torch.engine.evaluate import Evaluator
from mulactseg_tpu_torch.engine.state import make_optimizer
from mulactseg_tpu_torch.engine.train import (
    CRITERIA,
    make_eval_step,
    make_train_step,
)
from mulactseg_tpu_torch.models.factory import get_model
from mulactseg_tpu_torch.parallel import mesh

log = logging.getLogger("mulactseg_tpu_torch")


class ALTrainer:
    """One AL round's trainer (trainer/active.py:10-104). `model` injects
    a network (the tests' small twin); by default cfg.model is built with
    weights drawn from cfg.seed, the same init every round.

    The data-parallel width is the process group's (1 without one).
    cfg.n_devices=None takes it; another n_devices than the ranks that
    run raises ValueError, and so does a train_batch_size that the width
    does not divide. Unlike the JAX package's n_devices=None, which
    shrinks its mesh to the largest width that divides the batch, a
    launched group cannot shrink: start as many ranks as divide it."""

    def __init__(self, cfg, selection_iter: int, val_dataset=None,
                 eval_dataset=None, model: Optional[torch.nn.Module] = None,
                 device="cuda"):
        width = mesh.world()
        if cfg.n_devices not in (None, width):
            raise ValueError(
                f"n_devices={cfg.n_devices}, but {width} rank(s) run: start "
                "one rank per card (torchrun --nproc_per_node "
                f"{cfg.n_devices}), or leave n_devices unset")
        if cfg.train_batch_size % width:
            raise ValueError(
                f"train_batch_size {cfg.train_batch_size} not divisible "
                f"by data-parallel width {width}")
        self.cfg = cfg
        self.selection_iter = selection_iter
        self.best_iou = 0.0
        self.dev = resolve_device(device)
        self.model = (model if model is not None else get_model(
            cfg.model, num_classes=cfg.num_model_classes,
            output_stride=cfg.output_stride,
            separable_conv=cfg.separable_conv, device=self.dev,
            generator=torch.Generator().manual_seed(cfg.seed))).to(self.dev)
        self.optimizer = make_optimizer(
            self.model, cfg, total_itrs=cfg.finetune_itrs,
            lr_mult=float(selection_iter) if cfg.adaptive_train_lr else 1.0)
        # eval-only methods (eval_save_* and the analysis evals) have no
        # training criterion; the trainer still serves model, eval, plbl
        self.train_step = (make_train_step(
            self.model, cfg, self.dev,
            generator=torch.Generator(self.dev).manual_seed(cfg.seed),
            optimizer=self.optimizer)
            if cfg.method in CRITERIA else None)
        self._step = 0
        self.eval_step = make_eval_step(self.model, cfg, self.dev)
        self.evaluator = Evaluator(self.model, cfg, device=self.dev)
        self.val_dataset = val_dataset
        self.eval_dataset = eval_dataset
        self.checkpoint_file = os.path.join(
            cfg.model_save_dir, f"checkpoint{selection_iter:02d}")
        self.loaded = False  # set by every load()

    @property
    def step(self) -> int:
        """Optimizer steps taken (the poly LR's position); a checkpoint
        carries it."""
        return self.train_step.step if self.train_step else self._step

    @step.setter
    def step(self, value: int) -> None:
        if self.train_step:
            self.train_step.step = int(value)
        self._step = int(value)

    # -- inference ------------------------------------------------------------
    def predict_logits(self, images) -> torch.Tensor:
        """Eval-mode float32 NCHW logits on the trainer's device. Under
        data parallelism the batch is padded to a multiple of the ranks
        (the last image repeated), each rank forwards its rows, and the
        rows are gathered and cut back (the JAX package's rounds.py:
        116-125): every rank gets the whole batch's logits."""
        if mesh.world() == 1:
            return self.eval_step(images)
        padded, n = mesh.pad_to_multiple(images, mesh.world())
        rows = mesh.local_rows(padded.shape[0])
        return mesh.all_gather_rows(self.eval_step(padded[rows]))[:n]

    # -- state ----------------------------------------------------------------
    def snapshot(self):
        """A copy of the weights, the optimizer state and the step."""
        return ({k: v.detach().clone()
                 for k, v in self.model.state_dict().items()},
                copy.deepcopy(self.optimizer.state_dict()), self.step)

    def restore(self, snap) -> None:
        weights, opt_state, step = snap
        self.model.load_state_dict(weights)
        self._load_optimizer(opt_state)
        self.step = step

    def _load_optimizer(self, opt_state) -> None:
        """Load an optimizer state but keep this round's schedule (base LR
        and length), which the JAX package keeps in its transform, not in
        the saved state, and this device's LR holder (engine/state.py: a
        device tensor on a card, a float on the CPU), whichever device
        wrote the state."""
        keys = ("base_lr", "total_itrs", "lr", "capturable")
        own = [{k: g[k] for k in keys if k in g}
               for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict({
            **opt_state, "param_groups": [
                {**saved, **kept} for saved, kept in
                zip(opt_state["param_groups"], own)]})

    # -- checkpointing --------------------------------------------------------
    def save(self, path: Optional[str] = None):
        save_checkpoint(path or self.checkpoint_file, self.model,
                        self.optimizer, self.step)

    def load(self, path: str, strip_classifier: Optional[bool] = None,
             load_optim: bool = True):
        """The resume scenarios of train_AL.py:47-57 funnel here. For
        'imagenet_pretrained' inits the final classifier weights are
        stripped (trainer/active_joint_multi_predignore.py:146-168), and
        nothing else changes. Otherwise the weights load, and with
        load_optim also the optimizer state and the step; without it the
        optimizer and the step stay as they are
        (load_checkpoint(load_optimizer=False), trainer/base.py:288-295)."""
        if strip_classifier is None:
            strip_classifier = "imagenet_pretrained" in path
        payload = load_checkpoint(path)
        weights = payload["model_state_dict"]
        if strip_classifier:
            self.model.load_state_dict(merge_pretrained(
                self.model.state_dict(), weights))
        else:
            self.model.load_state_dict(weights)
            opt_state = optimizer_state(payload)
            if load_optim and opt_state:
                self._load_optimizer(opt_state)
                # the reference's files hold no step count
                self.step = payload.get("step", self.step)
        self.loaded = True

    # -- training -------------------------------------------------------------
    def train(self, active_set,
              metrics_cb: Optional[Callable[[int, Dict], None]] = None):
        """cfg.finetune_itrs steps on active_set.get_trainset(), validating
        on the reference's gate; returns images per second.

        With cfg.profile, torch.profiler traces the loop (every step and
        validation, CPU ops, and the card's kernels where the trainer runs
        on one) and writes one Chrome trace per rank and call to
        <model_save_dir>/profile/rank<r>.round<ii>.pt.trace.json, which
        TensorBoard's profiler plugin reads. The trace holds every event
        in host memory until the loop ends, as jax.profiler's does, so it
        is meant for short runs; the returned rate includes its cost."""
        cfg = self.cfg
        if self.train_step is None:
            raise RuntimeError(
                f"method {cfg.method!r} is eval-only (no training criterion)")
        loader = DataProvider(active_set.get_trainset(), cfg.train_batch_size,
                              shuffle=True, drop_last=True, infinite=True,
                              num_workers=cfg.num_workers, seed=cfg.seed,
                              split="rows")
        t0 = time.time()
        it = n_img = 0
        prof = None
        try:
            if cfg.profile:
                prof = self._start_profiler()
            while it < cfg.finetune_itrs:
                aux = self.train_step(next(loader))
                it += 1
                n_img = it * cfg.train_batch_size
                if metrics_cb is not None and it % cfg.log_period == 0:
                    aux_host = {k: float(v) for k, v in aux.items()}
                    aux_host["images_per_sec"] = n_img / (time.time() - t0)
                    metrics_cb(it - 1, aux_host)
                # reference gate: `iteration % val_period == val_period-1
                # and iteration > val_start` (trainer/active.py:54); `it`
                # is 1-based past the step
                if (self.val_dataset is not None and it % cfg.val_period == 0
                        and it - 1 > cfg.val_start):
                    self.validate(it - 1)
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
        finally:
            if prof is not None:
                prof.stop()
            loader.close()
        if prof is not None:
            prof.export_chrome_trace(self.trace_file)
        return n_img / (time.time() - t0)

    @property
    def trace_file(self) -> str:
        """Where train() writes this rank's trace of this round."""
        return os.path.join(
            self.cfg.model_save_dir, "profile",
            f"rank{mesh.rank()}.round{self.selection_iter:02d}.pt.trace.json")

    def _start_profiler(self):
        os.makedirs(os.path.dirname(self.trace_file), exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _run_evaluator(self, dataset):
        loader = DataProvider(dataset, self.cfg.val_batch_size,
                              shuffle=False, drop_last=False, infinite=False,
                              num_workers=self.cfg.val_num_workers,
                              split="batches")
        try:
            return self.evaluator.run(None, loader)
        finally:
            loader.close()

    def validate(self, trainiter: int):
        miou, table = self._run_evaluator(self.val_dataset)
        log.info("[val @%d] %s", trainiter, table)
        if miou > self.best_iou:  # best-val overwrite (trainer/base.py:229-233)
            self.best_iou = miou
            self.save()
        return miou

    def eval(self):
        miou, table = self._run_evaluator(self.eval_dataset)
        log.info("[AL %d-round eval] %s", self.selection_iter, table)
        return miou, table


def run_al_rounds(cfg, active_set, *, val_dataset=None, eval_dataset=None,
                  init_checkpoint: Optional[str] = None, metrics_cb=None,
                  device="cuda") -> Dict[int, float]:
    """The stage-1 AL loop (train_AL.py:18-100): for each round select ->
    train -> eval, with the JAX package's weight policy:
      - round 1 == init_iteration selects with the init weights;
      - round r > 1, r != init_iteration, selects with the previous
        round's best-val checkpoint;
      - round r > 1 == init_iteration selects with resume_checkpoint;
      - start_over: training restarts from the init weights (and a fresh
        optimizer) every round, else it continues from the selection-time
        weights;
      - after training the round's best-val checkpoint is loaded back
        before eval, so the reported mIoU and the next round's selection
        use the best model.
    Returns {round: eval mIoU}."""
    results = {}
    for selection_iter in range(cfg.init_iteration, cfg.max_iterations + 1):
        active_set.selection_iter = selection_iter
        trainer = ALTrainer(cfg, selection_iter, val_dataset=val_dataset,
                            eval_dataset=eval_dataset, device=device)
        if init_checkpoint:
            trainer.load(init_checkpoint)
        # the fresh-init state, which start_over restores before training
        init_state = trainer.snapshot() if cfg.start_over else None
        trainer.loaded = False
        if (selection_iter == cfg.init_iteration and selection_iter != 1
                and cfg.resume_checkpoint):
            trainer.load(cfg.resume_checkpoint, load_optim=cfg.load_optim)
        elif selection_iter != 1 and selection_iter != cfg.init_iteration:
            prev_ckpt = os.path.join(
                cfg.model_save_dir, f"checkpoint{selection_iter - 1:02d}")
            trainer.load(prev_ckpt, strip_classifier=False,
                         load_optim=cfg.load_optim)
        elif cfg.resume_checkpoint and selection_iter == 1:
            log.warning(
                "--resume-checkpoint is not loaded at round 1 "
                "(reference semantics); training from %s",
                init_checkpoint or "scratch")
        if (not cfg.skip_first_eval and eval_dataset is not None
                and selection_iter == cfg.init_iteration):
            # sanity-check eval of the loaded weights before sampling, not
            # part of the results (train_AL.py:59-60)
            trainer.eval()
        sel_name = (cfg.init_active_method if selection_iter == 1
                    else cfg.active_method)
        selector = get_selector(sel_name, cfg)
        selector.select_next_batch(trainer, active_set,
                                   cfg.active_selection_size)
        active_set.dump_datalist()
        if cfg.start_over and trainer.loaded:
            trainer.restore(init_state)
        trainer.train(active_set, metrics_cb=metrics_cb)
        if trainer.val_dataset is None or trainer.best_iou == 0.0:
            trainer.save()
        else:
            trainer.load(trainer.checkpoint_file, strip_classifier=False)
        if eval_dataset is not None:
            miou, _ = trainer.eval()
            results[selection_iter] = miou
    return results
