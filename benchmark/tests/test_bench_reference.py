"""The plain reference is the port's semantics: on the CPU at a small crop,
in float32, its forward, lossdecomp, gradient and one
AdamW/poly update agree with the port's, and its cosine-prototype map
equals the port's.

Tolerances: float32 with different summation orders, relative 1e-5 on
logits and losses (the port's kernels' plain versions sum in another order;
a float32 ulp is 6e-8, the sums run over ~1e5 terms), 1e-4 on per-leaf
gradient norms (the backward sums over the whole batch), 1e-6 on an
AdamW update given the same gradient. Train-mode BN is left out of the
gradient test: the port's BN normalises with the single-pass variance
E[x^2] - m^2 and the reference with the two-pass one, the same function
whose float32 roundings differ, and a seeded network at a tiny batch
amplifies that difference (the pooling branch's BN sees 2 values a
channel); eval mode reads the same running statistics on both sides.
"""

import numpy as np
import pytest
import torch

import bench_tiny
from benchmark import gen, rules
from benchmark.loops import train
from benchmark.reference import plbl as ref_plbl
from benchmark.reference import train as ref_train

torch.set_num_threads(2)


def _batch(name, seed=3):
    from mulactseg_tpu_torch.data.loader import collate

    _, cfg, mix, _ = bench_tiny.cell(name)
    return cfg, mix, collate(gen.make_items(seed, cfg, mix)[:2])


@pytest.mark.parametrize("name", ["city_stage1", "voc_stage1"])
def test_forward_and_lossdecomp_match_the_port(name):
    from mulactseg_tpu_torch.engine.train import get_criterion

    cfg, mix, batch = _batch(name)
    port, ref = bench_tiny.pair(cfg)
    port.eval(), ref.eval()
    x = torch.as_tensor(batch["images"])
    with torch.no_grad():
        a, b = port(x), ref(x)
    scale = b.abs().max()
    assert (a - b).abs().max() <= 1e-5 * scale
    crit = get_criterion(train.port_config(cfg, cfg["stage1"], 0))
    keys = {k: torch.as_tensor(batch[k])
            for k in ("target_bits", "target", "spx", "spmask")}
    lp, _ = crit(b, keys)
    lr = ref_train.lossdecomp(b, keys["target_bits"], keys["target"],
                              keys["spx"], cfg["stage1"])
    assert abs(float(lp) - float(lr)) <= 1e-5 * abs(float(lr))


def test_gradient_matches_the_port():
    """Eval-mode BN (the same running statistics on both sides), the
    stage-1 loss through the whole network, each leaf's gradient."""
    from mulactseg_tpu_torch.engine.train import get_criterion

    cfg, mix, batch = _batch("city_stage1")
    port, ref = bench_tiny.pair(cfg)
    port.eval(), ref.eval()
    x = torch.as_tensor(batch["images"])
    keys = {k: torch.as_tensor(batch[k])
            for k in ("target_bits", "target", "spx", "spmask")}
    crit = get_criterion(train.port_config(cfg, cfg["stage1"], 0))
    crit(port(x), keys)[0].backward()
    ref_train.lossdecomp(ref(x), keys["target_bits"], keys["target"],
                         keys["spx"], cfg["stage1"]).backward()
    gp = dict(port.named_parameters())
    for n, p in ref.named_parameters():
        want = p.grad.norm()
        assert (gp[n].grad - p.grad).norm() <= 1e-4 * max(want, 1e-12), n


@pytest.mark.parametrize("step", [0, 40000])
def test_adamw_poly_update_matches_the_port(step):
    from mulactseg_tpu_torch.engine.state import make_optimizer, set_lr

    cfg, _, _ = _batch("city_stage1")
    port, ref = bench_tiny.pair(cfg)
    s = cfg["stage1"]
    opt = make_optimizer(port, train.port_config(cfg, s, 0))
    mine = ref_train.AdamW(ref.named_parameters(), s, start=step)
    g = torch.Generator().manual_seed(1)
    for k in range(2):  # two updates: the moments carry over
        for (n, p), (_, q) in zip(port.named_parameters(),
                                  ref.named_parameters()):
            grad = torch.randn(p.shape, generator=g)
            p.grad, q.grad = grad.clone(), grad.clone()
        set_lr(opt, train.port_config(cfg, s, 0), step + k)
        opt.step()
        mine.step()
    for (n, p), (_, q) in zip(port.named_parameters(),
                              ref.named_parameters()):
        d, q = (p - q).detach(), q.detach()
        assert d.abs().max() <= 1e-6 * max(float(q.abs().max()), 1e-6)


def test_poly_schedule():
    s = {"finetune_itrs": 100, "power": 0.9, "min_lr": 1e-6}
    assert ref_train.poly_lr(1e-3, 0, s) == 1e-3
    assert ref_train.poly_lr(1e-3, 50, s) == pytest.approx(1e-3 * 0.5 ** 0.9)
    assert ref_train.poly_lr(1e-3, 100, s) == 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cosine_prototype_map_equals_the_port(seed):
    from mulactseg_tpu_torch.plbl.cosine_prop import (
        cosine_prototype_plbl, selected_spx_adjacency)

    rng = np.random.RandomState(seed)
    H, W, S, C, Ch = 48, 64, 24, 5, 8
    spx = rules.irregular_superpixels(H, W, S, rng)
    gt = rules.blobby_labels(rng, H, W, C - 1, 3, 4, 0.1)
    target = rules.multi_hot_from_gt(gt, spx, S, C - 1)
    selected = np.nonzero(rng.rand(S) < 0.4)[0]
    g = torch.Generator().manual_seed(seed)
    feat = torch.nn.functional.normalize(torch.randn(Ch, H, W, generator=g),
                                         dim=0)
    probs = torch.softmax(torch.randn(C, H, W, generator=g) * 3, dim=0)
    want = ref_plbl.pseudo_labels(feat, probs, spx, selected, target, 1024)
    sid, cls, ok, adj = selected_spx_adjacency(spx, selected, S, target,
                                               1024, True)
    valid = np.isin(spx, selected).reshape(-1)
    t = torch.as_tensor
    got = cosine_prototype_plbl(
        feat.reshape(Ch, -1).t(), probs.reshape(C, -1).t(),
        t(spx.reshape(-1)), t(valid), t(sid), t(cls), t(ok), t(adj),
        nseg=S).view(H, W)
    assert (want != 255).any() and (want == 255).any()
    assert torch.equal(got.long(), want)
