"""SegFormer-B5's configuration through the benchmark on the CPU: the
training loop at the CPU size (bench_tiny.cut: batch 2, 64 x 64 crops,
nseg 16) and the published widths, driven as run.py drives it, comes out
`correct` under the cell's limits, and the float8 control does not; the
reference's recomputed blocks give the gradients of its plain ones; the
configuration's FLOPs a step."""

import time

import torch

import bench_tiny
from benchmark import calibrate, common
from benchmark.loops import train

torch.set_num_threads(2)
CELL = "city_segformer_b5_stage1"


def test_a_tiny_segformer_cell_is_correct():
    w, cfg, mix, limits = bench_tiny.cell(CELL)
    out = train.run(w, cfg, mix, limits, 2 ** 31 + 251, 0.5, False,
                    bench_tiny.CPU, time.perf_counter())
    ok, checks = common.judge(out["values"], limits)
    assert ok and out["values"]["rows_not_in_pool"] == 0, checks
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_float8_control_is_not_correct():
    """The reference in float8 in the program's place, under the cell's
    limits."""
    w, cfg, mix, limits = bench_tiny.cell(CELL)
    got = calibrate.train_readings(cfg, mix, 2 ** 31 + 101, bench_tiny.CPU,
                                   control=True, fault=False)
    ok, checks = common.judge(got["control"], limits)
    assert not ok, checks


def test_recomputed_blocks_give_the_plain_gradients():
    """The reference checkpoints its blocks on a card; on the CPU, forced,
    the same loss and gradients, drop-path masks included."""
    _, cfg, _, _ = bench_tiny.cell(CELL)
    cfg["widths"].update(embed_dims=[16, 32, 48, 64], depths=[1, 1, 2, 1],
                         num_heads=[1, 2, 2, 1], decoder_channels=32,
                         drop_path=0.5)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    grads = []
    for recompute in (False, True):
        ref, net, _ = common.reference_net(cfg, 7, bench_tiny.CPU)
        net.train()
        net.backbone.recompute = recompute
        g = torch.Generator().manual_seed(3)
        for d in ref.dropouts(net):
            d.generator = g
        loss = net(x).square().mean()
        loss.backward()
        grads.append([float(loss.detach())]
                     + [p.grad for p in net.parameters()])
    assert grads[0][0] == grads[1][0]
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1:], grads[1][1:]))


def test_step_flops_of_the_configuration():
    """4 x 1024 x 1024, forward and backward: 13.46 TFLOP, 3.92 of them
    the attention's batched products (q k^T, p v)."""
    cfg = bench_tiny.load("configs", "city_segformer_b5")
    assert train.step_flops(cfg) == 13461450915840.0
