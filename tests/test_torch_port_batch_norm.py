"""FastBatchNorm's training pass (ops/batch_norm.py, csrc/batch_norm.cu)
on the CPU, where no kernel runs:

- batch_norm_train on a CPU tensor returns the bits of the port's
  FastBatchNorm as it was written in PyTorch ops (copied below as
  `_written`): output, running statistics and the gradients of x, the
  scale and the bias, in bf16 and float32; eval mode and frozen BN keep
  that formula too;
- the module imports, and the CPU path runs, without nvcc;
- every kernel symbol of csrc/batch_norm.cu starts with bn_ and falls in
  the benchmark's norm_eltwise kind, and every C entry point has its
  argument types;
- the statistics passes' plan covers each channel once at every BN shape
  of the two DeepLab cells and puts several blocks on each SM;
- the kernels' per-channel arithmetic (bn_finalize_kernel,
  bn_bwd_finalize_kernel and the dx formula), written out in float64,
  gives autograd's float64 gradient of the written version, a constant
  channel (v = 0, where torch's clamp passes the gradient) included.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import yardstick
from mulactseg_tpu_torch.models.layers import FastBatchNorm
from mulactseg_tpu_torch.ops import _build, batch_norm

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "mulactseg_tpu_torch" / "csrc" / "batch_norm.cu"

# the distinct BN input shapes of city_stage1 (batch 4, 768^2) and
# voc_stage1 (batch 12, 513^2) on deeplabv3pluswn_resnet50deepstem, OS16,
# separable, as forward hooks read them: 14 of each, 64 BNs a step
CITY_SHAPES = [(4, 48, 192, 192), (4, 64, 384, 384), (4, 64, 192, 192),
               (4, 128, 384, 384), (4, 128, 192, 192), (4, 128, 96, 96),
               (4, 256, 192, 192), (4, 256, 96, 96), (4, 256, 48, 48),
               (4, 256, 1, 1), (4, 512, 96, 96), (4, 512, 48, 48),
               (4, 1024, 48, 48), (4, 2048, 48, 48)]
VOC_SHAPES = [(12, c, {192: 129, 384: 257, 96: 65, 48: 33, 1: 1}[h],
               {192: 129, 384: 257, 96: 65, 48: 33, 1: 1}[h])
              for _, c, h, _ in CITY_SHAPES]


def _written(x, weight, bias, running_mean, running_var, momentum=0.1,
             eps=1e-5, acc=torch.float32):
    """models/layers.FastBatchNorm's train-mode forward as the port wrote
    it in PyTorch ops (no process group), its sums in `acc`."""
    n = x.numel() // x.shape[1]
    xf = x.to(acc)
    sums = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
    m = sums[0] / n
    v = torch.clamp(sums[1] / n - m * m, min=0.0)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * m.detach())
        running_var.mul_(1.0 - momentum).add_(momentum * v.detach())
    a = weight * torch.rsqrt(v + eps)
    b = bias - m * a
    dt = x.dtype
    return x * a.to(dt)[None, :, None, None] + b.to(dt)[None, :, None, None]


def _inputs(seed, shape, dtype):
    rng = np.random.RandomState(seed)
    N, C, H, W = shape
    x = (rng.randn(*shape) * rng.uniform(0.5, 2.0, (1, C, 1, 1))
         + rng.uniform(-1.0, 1.0, (1, C, 1, 1)))
    x[:, 0] = 1.5  # a constant channel: v = 0 exactly
    return (torch.tensor(x, dtype=dtype),
            torch.tensor(rng.randn(*shape), dtype=dtype),
            torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32),
            torch.tensor(rng.uniform(-0.2, 0.2, C), dtype=torch.float32),
            torch.tensor(rng.uniform(-0.5, 0.5, C), dtype=torch.float32),
            torch.tensor(rng.uniform(0.5, 2.0, C), dtype=torch.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 5, 7, 9), (3, 4, 1, 1)])
def test_cpu_wrapper_is_the_written_batch_norm(dtype, shape):
    """batch_norm_train and FastBatchNorm's train-mode forward on the CPU:
    the written version's output, running statistics and gradients,
    bitwise."""
    x, dy, w, b, rm, rv = _inputs(3, shape, dtype)
    runs = {}
    for side in ("written", "wrapper", "module"):
        xs = x.clone().requires_grad_(True)
        ws, bs = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        rms, rvs = rm.clone(), rv.clone()
        if side == "written":
            y = _written(xs, ws, bs, rms, rvs)
        elif side == "wrapper":
            y = batch_norm.batch_norm_train(xs, ws, bs, rms, rvs, 0.1, 1e-5)
        else:
            bn = FastBatchNorm(shape[1])
            with torch.no_grad():
                bn.weight.copy_(w)
                bn.bias.copy_(b)
                bn.running_mean.copy_(rm)
                bn.running_var.copy_(rv)
            y = bn.train()(xs)
            ws, bs, rms, rvs = bn.weight, bn.bias, bn.running_mean, \
                bn.running_var
        y.backward(dy)
        runs[side] = (y, rms, rvs, xs.grad, ws.grad, bs.grad)
    for side in ("wrapper", "module"):
        for got, want in zip(runs[side], runs["written"]):
            assert got.dtype == want.dtype and torch.equal(got, want), side


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("frozen", [False, True])
def test_running_statistics_path_is_unchanged(dtype, frozen):
    """Eval mode, and a frozen BN in train mode, normalise with the running
    statistics by the written formula and leave them as they are."""
    x, _, w, b, rm, rv = _inputs(4, (2, 6, 5, 3), dtype)
    bn = FastBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(rm)
        bn.running_var.copy_(rv)
    bn.frozen = frozen
    bn.train(frozen)
    y = bn(x)
    a = w * torch.rsqrt(rv + 1e-5)
    want = x * a.to(dtype)[None, :, None, None] \
        + (b - rm * a).to(dtype)[None, :, None, None]
    assert torch.equal(y, want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var,
                                                            rv)


def test_imports_and_runs_on_the_cpu_without_nvcc(monkeypatch):
    """A fresh interpreter with no nvcc on its PATH imports the module and
    the model layers; the CPU path never asks for the library."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    code = ("import shutil, torch; "
            "from mulactseg_tpu_torch.ops import batch_norm, _build; "
            "from mulactseg_tpu_torch.models import layers; "
            "assert shutil.which('nvcc') is None; "
            "y = layers.FastBatchNorm(3).train()(torch.randn(2, 3, 4, 4)); "
            "assert not _build._LIBS; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

    def refuse(*_):
        raise AssertionError("the CPU path loaded a CUDA library")

    monkeypatch.setattr(_build, "load", refuse)
    x, _, w, b, rm, rv = _inputs(5, (2, 3, 4, 4), torch.bfloat16)
    batch_norm.batch_norm_train(x, w, b, rm, rv, 0.1, 1e-5)
    assert not any(k.startswith("bn_") for k in _build.LAUNCHES)


def test_kernel_symbols_are_norm_eltwise():
    """Every __global__ of csrc/batch_norm.cu starts with bn_ and, as the
    profiler names its instances, falls in yardstick.KINDS' norm_eltwise
    kind (so its time stays in model.norm_eltwise_ms_per_step); every C
    entry point is typed in _ARGTYPES and counted under its name."""
    src = SOURCE.read_text()
    kernels = re.findall(r"__global__ void(?: __launch_bounds__\(\w+\))?"
                         r"\s+(\w+)\(", src)
    assert sorted(kernels) == sorted(f"{k}_kernel"
                                     for k in batch_norm.KERNELS)
    for k in kernels:
        for t in ("float", "__nv_bfloat16"):
            name = (f"void {k}<{t}>({t} const*, {t} const*, {t}*, float "
                    f"const*, int, long long, long long, long long, int)")
            assert yardstick.kind_of(name) == "norm_eltwise", name
        assert yardstick.kind_of(k) == "norm_eltwise", k
    entries = re.findall(r'extern "C" int (\w+)\(', src)
    assert sorted(entries) == sorted(batch_norm.KERNELS) \
        == sorted(batch_norm._ARGTYPES)


@pytest.mark.parametrize("shape", CITY_SHAPES + VOC_SHAPES + [
    (2, 256, 48, 48), (6, 64, 257, 257), (1, 3, 5, 7), (4, 768, 256, 256)])
@pytest.mark.parametrize("per", [1, 32 * 8])
def test_statistics_plan_covers_each_channel(shape, per):
    """plan(C, N*H*W, 132 SMs, per), a block taking one channel (NCHW) or
    32 packs of 8 (channels-last bf16): the splits cover the positions
    exactly once (the last split not empty), chunks of 64, and at least
    1.5 blocks an SM wherever the positions allow that many chunks of 64
    and of MIN_SPLIT elements."""
    N, C, H, W = shape
    L = N * H * W
    splits, chunk = batch_norm.plan(C, L, 132, per)
    assert 1 <= splits <= 65535 and chunk % 64 == 0
    assert (splits - 1) * chunk < L <= splits * chunk
    tiles = -(-C // per)
    most = L // max(64, -(-batch_norm.MIN_SPLIT // per))
    assert splits * tiles >= min(1.5 * 132, tiles * most)


def _finalize64(x, dy, w, b, eps=1e-5):
    """The kernels' arithmetic in float64: bn_finalize_kernel's (m, vr, r,
    a), bn_bwd_finalize_kernel's dw, db and (k1, k2), and bn_dx_kernel's
    dx = dy * a + k1 + k2 * x."""
    n = x[:, 0].numel()
    s1, s2 = x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))
    m = s1 / n
    vr = s2 / n - m * m
    r = 1.0 / torch.sqrt(torch.clamp(vr, min=0.0) + eps)
    a = w * r
    y = x * a[None, :, None, None] + (b - m * a)[None, :, None, None]
    dB, dA = dy.sum(dim=(0, 2, 3)), (dy * x).sum(dim=(0, 2, 3))
    dw, db = (dA - m * dB) * r, dB
    dr = (dA - m * dB) * w
    dv = torch.where(vr >= 0, -0.5 * dr * r ** 3, torch.zeros_like(dr))
    dm = -a * dB - 2.0 * m * dv
    k1, k2 = dm / n, 2.0 * dv / n
    dx = dy * a[None, :, None, None] + k1[None, :, None, None] \
        + k2[None, :, None, None] * x
    return y, dx, dw, db


@pytest.mark.parametrize("shape", [(2, 5, 7, 9), (4, 3, 1, 1)])
def test_kernel_arithmetic_is_the_plain_gradient(shape):
    """In float64 the kernels' formulas give the written version's output
    and autograd's gradients (its sums in float64 too) within 1e-12 of
    each output's largest entry, a constant channel (v = 0, the clamp's
    boundary) included."""
    x, dy, w, b, rm, rv = (t.double() for t in _inputs(6, shape,
                                                       torch.float64))
    xs = x.clone().requires_grad_(True)
    ws, bs = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y = _written(xs, ws, bs, rm, rv, acc=torch.float64)
    y.backward(dy)
    got = _finalize64(x, dy, w, b)
    for g, want in zip(got, (y.detach(), xs.grad, ws.grad, bs.grad)):
        scale = want.abs().max().item()
        assert (g - want).abs().max().item() <= 1e-12 * scale
