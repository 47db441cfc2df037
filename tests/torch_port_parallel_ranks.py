"""What each rank runs in tests/test_torch_port_parallel.py and in the
card test of data parallelism (tests/test_torch_port_cuda.py), under
mulactseg_tpu_torch.parallel.spawn. The spawned processes import this
module, so it imports only numpy, torch and the port, never JAX. Every
function also runs in the test process without a group, where it is the
one-rank reference (every collective an identity).
"""

import json
import os
import time
from unittest import mock

import numpy as np
import torch

from mulactseg_tpu_torch.active import RegionActiveSet
from mulactseg_tpu_torch.acquisition import get_selector
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.loader import DataProvider
from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
from mulactseg_tpu_torch.engine.rounds import ALTrainer
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
from mulactseg_tpu_torch.models.layers import Dropout, FastBatchNorm
from mulactseg_tpu_torch.models.resnet import ResNet
from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.parallel import mesh

NC = 7


def port_twin(separable):
    """The port half of tests/test_torch_port_model.twin_pair: ResNet
    layers (2, 2, 2, 2), stem 16, low 12, mid 64, NC outputs."""
    return DeepLabV3(
        ResNet(layers=(2, 2, 2, 2), deep_stem=True, stem_width=16,
               stage_planes=(16, 32, 64, 128)),
        DeepLabHeadV3Plus(512, 64, NC, (6, 12, 18), variant="wn",
                          separable=separable, low_channels=12,
                          mid_channels=64))


def _rows(batch):
    """This rank's rows of every array of a global batch."""
    out = {}
    for k, v in batch.items():
        out[k] = v[mesh.local_rows(len(v))] if isinstance(v, np.ndarray) \
            else v
    return out


def _np(t):
    return t.detach().cpu().numpy()


def bn_and_dropout(x, cot, weight, bias, drop_shape, device="cpu"):
    """FastBatchNorm in train mode on this rank's rows of x (B, C, H, W)
    with the loss sum(y * cot); its parameter gradients summed over the
    ranks. Returns this rank's output rows, input gradient rows, the
    parameter gradients, the running statistics, and this rank's rows of
    a p = 0.5 dropout mask of the global shape drop_shape."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    rows = mesh.local_rows(x.shape[0])
    bn = FastBatchNorm(x.shape[1]).to(dev)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xr = torch.from_numpy(x[rows]).to(dev).requires_grad_(True)
    y = bn(xr)
    (y * torch.from_numpy(cot[rows]).to(dev)).sum().backward()
    mesh.all_reduce_grads(bn)
    drop = Dropout(0.5)
    drop.generator = torch.Generator(dev).manual_seed(3)
    local = (drop_shape[0] // mesh.world(),) + tuple(drop_shape[1:])
    mask = drop(torch.ones(local, device=dev)) != 0
    return {"y": _np(y), "dx": _np(xr.grad), "dw": _np(bn.weight.grad),
            "db": _np(bn.bias.grad), "mean": _np(bn.running_mean),
            "var": _np(bn.running_var), "mask": _np(mask)}


def train_steps(model, cfg, batches, device="cpu", ckpt=None):
    """make_train_step on this rank's rows of each global batch. Returns
    the logged losses of each step, the step-0 gradients (summed over the
    ranks) by parameter name, the final state_dict and the K1-K4 launches
    of the steps; with ckpt, also saves a checkpoint there (rank 0
    writes)."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    model = model.to(dev)
    step = make_train_step(model, cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(5))
    losses, grads = [], None
    _build.reset_launches()
    for i, batch in enumerate(batches):
        aux = step(_rows(batch))
        losses.append({k: float(v) for k, v in aux.items()})
        if i == 0:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None}
    launches = dict(_build.LAUNCHES)
    if ckpt is not None:
        save_checkpoint(ckpt, model, step.optimizer, step.step)
    return {"losses": losses, "grads": grads, "launches": launches,
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def trainer_round(cfg, model, sets, images, device="cpu"):
    """ALTrainer on `model` (the recipe's stage-1 criterion): the uneven
    pool batch `images` scored, the paper's selector over the pool (JSON
    writes counted), the init weights evaluated on the val set, then
    cfg.finetune_itrs steps with validation, a save and the eval.
    sets = (pool, label, val) datasets."""
    torch.set_num_threads(1)
    pool, label, val = sets
    trainer = ALTrainer(cfg, 1, val_dataset=val, eval_dataset=val,
                        model=model, device=device)
    logits = _np(trainer.predict_logits(images))
    active = RegionActiveSet(cfg, pool, label)
    active.selection_iter = 1
    with mock.patch.object(json, "dump", wraps=json.dump) as dump:
        get_selector("my_bvsb_predclsbal_pwr_banignore",
                     cfg).select_next_batch(trainer, active,
                                            cfg.active_selection_size)
        active.dump_datalist()
    init_miou, _ = trainer.eval()
    init_confusion = trainer.evaluator.confusion
    validations = []
    real = trainer.validate
    trainer.validate = lambda it: validations.append(real(it))
    trainer.train(active)
    trainer.save()
    miou, _ = trainer.eval()
    return {"logits": logits, "suppix": label.suppix,
            "json_dumps": dump.call_count, "init_miou": init_miou,
            "init_confusion": init_confusion, "validations": validations,
            "miou": miou, "confusion": trainer.evaluator.confusion,
            "files": sorted(os.listdir(cfg.model_save_dir))}


def loader_batches(dataset, batch_size, n, seed):
    """The first n batches of a shuffled, infinite DataProvider split by
    rows over the ranks (thread workers)."""
    loader = DataProvider(dataset, batch_size, shuffle=True, drop_last=True,
                          infinite=True, num_workers=2, seed=seed,
                          processes=False, split="rows")
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def guards(cfg_kw, model):
    """The messages of what a group of several ranks refuses: a batch the
    width does not divide, another n_devices than the width, and a
    criterion that normalises per rank."""
    out = {}
    for name, kw in (("batch", {"train_batch_size": 3}),
                     ("n_devices", {"n_devices": mesh.world() + 1})):
        try:
            ALTrainer(Config(**{**cfg_kw, **kw}), 1, model=model,
                      device="cpu")
        except ValueError as e:
            out[name] = str(e)
    try:
        make_train_step(model, Config(**{
            **cfg_kw, "method": "active_joint_multi_predignore"}), "cpu")
    except NotImplementedError as e:
        out["criterion"] = str(e)
    return out


def cli_round(argv, variables):
    """cli.train_al.main(argv) on the CPU with the small twin of
    `variables` as every round's model; its results."""
    from mulactseg_tpu_torch.cli import train_al
    from mulactseg_tpu_torch.engine import rounds
    from mulactseg_tpu_torch.models import convert

    torch.set_num_threads(1)

    def twin(*args, **kwargs):
        model = port_twin(separable=True)
        convert.load_variables(model, variables)
        return model

    with mock.patch.object(rounds, "get_model", twin):
        return train_al.main(argv, device="cpu")


def run_all(jobs):
    """Each (name, function name, args) of jobs, in order, on this rank:
    {name: result}."""
    return {name: globals()[fn](*args) for name, fn, args in jobs}


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits at a barrier it never leaves."""
    if mesh.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.barrier()


def hang():
    """Rank 0 waits at a barrier that rank 1 never reaches."""
    if mesh.rank() == 1:
        time.sleep(600)
    mesh.barrier()
