"""What each rank runs in tests/test_torch_port_parallel.py and in the
card test of data parallelism (tests/test_torch_port_cuda.py), under
mulactseg_tpu_torch.parallel.spawn. The spawned processes import this
module, so it imports only numpy, torch and the port, never JAX. Every
function also runs in the test process without a group, where it is the
one-rank reference (every collective an identity).
"""

import contextlib
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
from mulactseg_tpu_torch.data.synthetic import (
    SyntheticRegionDataset,
    irregular_superpixels,
)
from mulactseg_tpu_torch.engine import train
from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
from mulactseg_tpu_torch.engine.rounds import ALTrainer
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.models.deeplab import DeepLabHeadV3Plus, DeepLabV3
from mulactseg_tpu_torch.models.layers import Conv2d, Dropout, FastBatchNorm
from mulactseg_tpu_torch.models.resnet import ResNet
from mulactseg_tpu_torch.ops import _build, segment_max
from mulactseg_tpu_torch.parallel import mesh

NC = 7
# the criteria jobs' inputs (full_batch)
B, HH, NSEG = 4, 33, 12
SMALL, WEAK, LEVELS = 40, (40, 36), (6, 12)
# the criteria whose targets carry the extra (undefined) channel that
# they slice off
SLICED = ("active_joint_multi", "active_joint_multi_ablation",
          "active_joint_hier_multi", "active_joint_hier_multi_async",
          "active_joint_hier_multi_async_weight")


def port_twin(separable):
    """The port half of tests/test_torch_port_model.twin_pair: ResNet
    layers (2, 2, 2, 2), stem 16, low 12, mid 64, NC outputs."""
    return DeepLabV3(
        ResNet(layers=(2, 2, 2, 2), deep_stem=True, stem_width=16,
               stage_planes=(16, 32, 64, 128)),
        DeepLabHeadV3Plus(512, 64, NC, (6, 12, 18), variant="wn",
                          separable=separable, low_channels=12,
                          mid_channels=64))


def cfg_kw(method, over, **kw):
    """The configuration of a case, as keywords both packages' Config
    take."""
    return dict(num_classes=NC - 1, nseg=NSEG, crop_size=(HH, HH),
                train_batch_size=B, method=method, dtype="float32",
                finetune_itrs=10, small_nseg=SMALL, nseg_list=LEVELS,
                **{**over, **kw})


def cfg_for(method, over, **kw):
    return Config(**cfg_kw(method, over, **kw))


def _maps(rng, h, w, n, count=B):
    return np.stack([irregular_superpixels(h, w, n, rng)
                     for _ in range(count)]).astype(np.int32)


def full_batch(rng, weak_small=(SMALL, SMALL)):
    """A global batch with every key a criterion reads: images with a
    per-image scale and offset (test_torch_port_train.make_batch's);
    'target' (B, NSEG, NC + 1), each superpixel's row empty, one-hot or
    multi-hot, 60% of superpixels selected; labels with 20% 255; the
    finer map (SMALL ids); the weak view (40x36) with its own maps, the
    small one of weak_small[0] ids on rank 0's images and weak_small[1]
    on rank 1's; the two mseg levels."""
    images = (rng.randn(B, 3, HH, HH)
              * np.linspace(0.5, 2.0, B)[:, None, None, None]
              + np.linspace(-2.0, 2.0, B)[:, None, None, None]
              ).astype(np.float32)
    spx = _maps(rng, HH, HH, NSEG)
    target = np.zeros((B, NSEG, NC + 1), np.float32)
    for b in range(B):
        for s in range(NSEG):
            n = (0, 1, rng.randint(2, 4))[rng.choice(3, p=[0.15, 0.45, 0.4])]
            target[b, s, rng.choice(NC + 1, n, replace=False)] = 1.0
    sel = rng.rand(B, NSEG) < 0.6
    spmask = np.take_along_axis(sel, spx.reshape(B, -1), 1).reshape(
        B, HH, HH)
    labels = rng.randint(0, NC, (B, HH, HH)).astype(np.int32)
    labels[rng.rand(B, HH, HH) < 0.2] = 255
    spx_weak = _maps(rng, *WEAK, NSEG)
    half = B // 2
    batch = {
        "images": images, "target": target, "spx": spx, "spmask": spmask,
        "labels": labels, "spx_small": _maps(rng, HH, HH, SMALL),
        "images_weak": rng.randn(B, 3, *WEAK).astype(np.float32),
        "spx_weak": spx_weak,
        "spmask_weak": np.take_along_axis(
            sel, spx_weak.reshape(B, -1), 1).reshape(B, *WEAK),
        "spx_small_weak": np.concatenate(
            [_maps(rng, *WEAK, weak_small[0], half),
             _maps(rng, *WEAK, weak_small[1], B - half)])}
    mspx = np.stack([_maps(rng, HH, HH, n) for n in LEVELS], 1)
    batch["mseg_spx"] = mspx
    batch["mseg_spmask"] = np.stack(
        [np.take_along_axis(rng.rand(B, n) < 0.6, mspx[:, s].reshape(B, -1),
                            1).reshape(B, HH, HH)
         for s, n in enumerate(LEVELS)], 1)
    for s, n in enumerate(LEVELS):
        t = np.zeros((B, n, NC), np.float32)
        for b in range(B):
            for i in range(n):
                t[b, i, rng.choice(NC, rng.randint(1, 4), replace=False)] = 1
        batch[f"mseg_target_{s}"] = t
    return batch


def for_method(batch, method):
    """The batch as `method` reads it: the targets' extra channel only
    where the criterion slices it off."""
    out = dict(batch)
    if method not in SLICED:
        out["target"] = batch["target"][..., :NC]
    return out


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


class FilesLike:
    """`dataset` as a loader sees a dataset of files: DataProvider builds
    its items in worker processes (which import this module), each item
    the dataset's own."""

    reads_files = True

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def draw(self, index):
        return None

    def load(self, index, params):
        return self.dataset[index]


def profiled_train(spec, cfg_kw_, dataset_kw):
    """ALTrainer at cfg.profile on build_model(spec): cfg.finetune_itrs
    steps on this rank's rows of a synthetic label set (every superpixel
    labelled). Returns the trace file this rank wrote."""
    torch.set_num_threads(1)
    cfg = Config(**cfg_kw_)
    trainer = ALTrainer(cfg, 1, model=build_model(spec), device="cpu")
    trainset = SyntheticRegionDataset(**dataset_kw)
    trainer.train(type("Active", (), {"get_trainset": lambda _: trainset})())
    return trainer.trace_file


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
    width does not divide, another n_devices than the width, and an
    unknown method (KeyError on every rank, before any collective)."""
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
            **cfg_kw, "method": "no_such_method"}), "cpu")
    except KeyError as e:
        out["method"] = str(e)
    mesh.barrier()  # every rank got past the guards
    return out


@contextlib.contextmanager
def count_k5():
    """K5's calls in the block (its plain version, which the CPU takes),
    one entry a call."""
    calls = []
    real = segment_max.segment_max_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with mock.patch.object(segment_max, "segment_max_plain", counted):
        yield calls


class _TinyBackbone(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 8, 3)
        self.bn = FastBatchNorm(8)
        self.drop = Dropout(0.0)

    def forward(self, x):
        return {"out": self.drop(torch.relu(self.bn(self.conv(x))))}


class _TinyHead(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.final = Conv2d(8, c, 1, bias=True, fan_mode="fan_in")

    def forward(self, feats, return_feat=False):
        y = feats["out"]
        return (y, self.final(y)) if return_feat else self.final(y)


def build_model(spec):
    """("twin", flax variables): the separable twin with them, dropout
    off; ("tiny", state_dict of numpy arrays): the tiny model of
    tests/test_torch_port_criteria_step.py (a 3x3 conv, BN and ReLU, a
    biased 1x1 final: full-resolution logits) with that state."""
    from mulactseg_tpu_torch.models import convert

    kind, arg = spec
    if kind == "tiny":
        model = DeepLabV3(_TinyBackbone(),
                          _TinyHead(arg["classifier.final.bias"].shape[0]))
        model.load_state_dict({k: torch.from_numpy(a)
                               for k, a in arg.items()}, strict=True)
        return model
    model = port_twin(separable=True)
    convert.load_variables(model, arg)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return model


@contextlib.contextmanager
def record_totals():
    """The loss each criterion returns to the step's backward (after its
    NaN guards; this rank's share under a group), one entry a step."""
    real = train.get_criterion
    totals = []

    def get(cfg):
        fn = real(cfg)

        def recorded(*args):
            total, aux = fn(*args)
            totals.append(float(total.detach()))
            return total, aux
        recorded.__dict__.update(fn.__dict__)  # keys, needs_feat, ...
        return recorded

    with mock.patch.object(train, "get_criterion", get):
        yield totals


def criteria_steps(spec, cases, device="cpu"):
    """For each (name, cfg, global batches) of cases, make_train_step on
    build_model(spec), one step on this rank's rows of each batch: {name: {"losses": each step's logged (global) losses,
    "totals": each step's loss as the criterion returned it on this rank,
    "grads": the step-0 gradients summed over the ranks, by parameter
    name (rank 0 only, None elsewhere), "grad_sq": their float64 sum of
    squares, "finite": for each parameter whether its step-0 gradient is
    finite, "k5": K5's plain calls on this rank (the CPU's), "launches":
    the kernels launched on this rank (the card's)}}. On the card TF32
    is off, so that float32 means float32."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, cfg, batches in cases:
        model = build_model(spec).to(dev)
        losses, grads = [], None
        _build.reset_launches()
        with count_k5() as calls, record_totals() as totals:
            step = make_train_step(model, cfg, device=dev)
            for i, batch in enumerate(batches):
                aux = step(_rows(batch))
                losses.append({k: float(v) for k, v in aux.items()})
                if i == 0:
                    grads = {n: _np(p.grad) for n, p in
                             model.named_parameters() if p.grad is not None}
        out[name] = {
            "losses": losses, "totals": totals, "k5": len(calls),
            "launches": dict(_build.LAUNCHES),
            "grads": grads if mesh.is_main() else None,
            "grad_sq": sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in grads.values()),
            "finite": {n: bool(np.isfinite(g).all())
                       for n, g in grads.items()}}
    return out


def eval_al_runs(argvs):
    """cli.eval_al.main(argv, device="cpu") for each argv on this rank,
    with the non-separable small twin as the model (the checkpoint's
    weights): per run the evaluator's result (AnalysisEvaluator's with
    its confusion matrix, or the probe's counts), the overlay files this
    rank wrote and its K5 calls."""
    from mulactseg_tpu_torch.cli import eval_al
    from mulactseg_tpu_torch.engine import analysis, rounds

    torch.set_num_threads(1)
    out = []
    for argv in argvs:
        results = []

        def capture(cls):
            real = cls.run

            def run(self, *a, **k):
                res = real(self, *a, **k)
                results.append({**res,
                                "confusion": getattr(self, "confusion",
                                                     None)})
                return res
            return mock.patch.object(cls, "run", run)

        with capture(analysis.AnalysisEvaluator), \
                capture(analysis.SelectionAccuracyEvaluator), \
                mock.patch.object(rounds, "get_model",
                                  lambda *a, **k: port_twin(False)), \
                mock.patch.object(analysis, "save_overlay",
                                  wraps=analysis.save_overlay) as vis, \
                count_k5() as calls:
            eval_al.main(argv, device="cpu")
        out.append({"result": results[0], "k5": len(calls),
                    "overlays": [c.args[3] for c in vis.call_args_list]})
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
