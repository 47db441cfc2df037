"""Free-running active-learning parity of the PyTorch port against the
JAX package over 5 rounds, on a fixture where neither package is chaotic.

tools_dev/round_parity_port.py runs the same protocol at the tiny sizes
of tests/test_torch_port_rounds.py (33x33, nseg 16, 4 steps validating
every 2, learning rate 1e-4), where each package against itself, from
an init 1e-7 apart, selects other regions from round 2 or 3 on. This
harness first measures a fixture on each package alone and only then
holds the port against the JAX package on it.

Both sides run their own run_al_rounds through the recipe's loop: round
1 my_random, rounds 2.. the paper's selector
my_bvsb_predclsbal_pwr_banignore from the previous round's checkpoint,
start_over from one init (chip_smoke.rp_init: models/convert's seeded
init of the CPU tests' small separable twin, 7 outputs), SGD with
momentum 0.9, float32, dropout off. A fixture (chip_smoke.RP_FIXTURE
and CANDIDATES below) sets the image side, the superpixels, the pool,
val and budget sizes, the batch, the steps a round, the learning rate,
and whether the rounds validate (val_period None: no val set, so each
round keeps its last step, mulactseg_tpu/engine/rounds.py:391).

Two modes:
  --sides port port (or jax jax): self-stability. One run from the
    init, then one for each --perturb eps and --seeds seed from the init
    with every parameter scaled by 1 + eps * N(0, 1); per round the
    selection Jaccard of each perturbed run against the first. A fixture
    is stable when every Jaccard is 1.0.
  --sides port jax: parity, each side from the same init. Per round:
    the selection Jaccard; the step-0 stage-1 loss gap, relative; the
    pseudo-labels at synced weights (the port's round-r checkpoint
    carried into the JAX package by models/convert.state_dict_to_variables,
    both packages' eval_save_cosplbl_prop_includeonehot on the port's
    round-r label set: the pixels that differ, each one's decision
    margin (chip_smoke.plbl_margins: how far its cosine similarity lies
    from the rival or threshold it was compared with), and then how many
    pixels the JAX package's own maps change by when the carried weights
    are scaled by 1 + 1e-7 N(0, 1)); the free-running
    pseudo-labels (each side's own checkpoint on its own label set: the
    share of equal pixels) and each side's eval mIoU. Round 1's selection
    JSON and datalist must be byte-identical (my_random from one seed).
    Last, stage 2 (active_predignore, the fixture's steps) from the init
    on each side's own round-N pseudo-labels, and each side's eval mIoU.

Run: python tools_dev/round_parity_port_fixture.py [--fixture NAME]
[--sides port jax] [--perturb EPS ...] [--out FILE] (with equal sides,
seeds 0-2 of each eps, 1e-7 and 1e-6 by default; minutes on one core,
the JAX side's XLA compiles most of it). XLA runs at the test
suite's optimisation level 0 (tests/conftest.py) unless XLA_FLAGS says
otherwise. tests/test_torch_port_round_parity_fixture.py asserts it.
"""

import argparse
import json
import os
import sys
import tempfile
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the port's side of the fixture)
from tools_dev.round_parity_port import _perturbed as perturbed  # noqa: E402

# the fixtures of the search (PERF.md), by name; the chosen one,
# b4_val, is chip_smoke.RP_FIXTURE
CANDIDATES = {
    # tests/test_torch_port_rounds.py's sizes with SGD
    "rounds33": dict(hh=33, nseg=16, pool=6, val=6, budget=24, batch=4,
                     steps=4, lr=1e-4, val_period=2),
    # round_parity_multi.py's sizes (commit fbc153b), validating
    "multi64_val": dict(hh=64, nseg=16, pool=6, val=3, budget=24, batch=2,
                        steps=8, lr=3e-3, val_period=4),
    # round_parity_multi.py's sizes, no validation (its own protocol)
    "multi64": dict(hh=64, nseg=16, pool=6, val=3, budget=24, batch=2,
                    steps=8, lr=3e-3, val_period=None),
    # the two above at batch 4
    "b4": dict(hh=64, nseg=16, pool=6, val=3, budget=24, batch=4, steps=8,
               lr=3e-3, val_period=None),
    "b4_val": cs.RP_FIXTURE,
}


def jax_model():
    """The JAX half of the twin (tests/test_torch_port_model.twin_pair)."""
    from tests.test_torch_port_model import NC, twin_pair

    assert NC == cs.RP_CLASSES
    return twin_pair(separable=True)[1]


def _no_dropout():
    import flax.linen as fnn

    return mock.patch.object(fnn.Dropout, "__call__", lambda self, x, **k: x)


def _jax_init(ref, cfg, fx, variables, path):
    """An Orbax checkpoint of `variables` with a fresh optimizer state."""
    import jax

    from mulactseg_tpu.engine import checkpoint
    from mulactseg_tpu.engine.state import create_train_state

    state = create_train_state(ref, cfg, jax.random.PRNGKey(0),
                               (fx["batch"], fx["hh"], fx["hh"], 3),
                               total_itrs=cfg.finetune_itrs)
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=state.tx.init(variables["params"]))
    checkpoint.save_checkpoint(path, state)


def jax_rounds(fx, variables, workdir, rounds=cs.RP_ROUNDS):
    """The JAX package's run_al_rounds on the fixture: chip_smoke.rp_rounds'
    twin (same return value)."""
    from mulactseg_tpu.active import RegionActiveSet
    from mulactseg_tpu.config import Config
    from mulactseg_tpu.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu.engine import rounds as jr

    ref = jax_model()
    cfg = Config(**cs.rp_config_kw(fx, workdir, rounds))
    os.makedirs(workdir, exist_ok=True)
    init = os.path.join(workdir, "init")
    _jax_init(ref, cfg, fx, variables, init)
    # the trainer builds fresh jitted steps every round; the first round's
    # serve every round (same model, same configuration)
    memo = {}
    patches = [_no_dropout(),
               mock.patch.object(jr, "get_model", lambda *a, **k: ref)]
    for name in ("make_train_step", "make_eval_step"):
        real = getattr(jr, name)
        patches.append(mock.patch.object(
            jr, name, lambda *a, _r=real, _n=name, **k:
            memo.setdefault(_n, _r(*a, **k))))
    evaluator = jr.Evaluator(ref, cfg)
    patches.append(mock.patch.object(jr, "Evaluator",
                                     lambda *a, **k: evaluator))
    step0 = []
    pool, label, val = cs.rp_datasets(SyntheticRegionDataset, fx)
    for p in patches:
        p.start()
    try:
        miou = jr.run_al_rounds(
            cfg, RegionActiveSet(cfg, pool, label),
            val_dataset=val if fx["val_period"] else None, eval_dataset=val,
            init_checkpoint=init,
            metrics_cb=lambda it, aux: it or step0.append(
                float(aux["train_loss"])))
    finally:
        for p in reversed(patches):
            p.stop()
    return {"miou": miou, "step0": step0}


def run_side(side, fx, variables, workdir, rounds=cs.RP_ROUNDS):
    if side == "jax":
        return jax_rounds(fx, variables, workdir, rounds)
    return cs.rp_rounds(fx, variables, workdir, "cpu", rounds)


def jax_plbl(fx, params, batch_stats, label):
    """chip_smoke.rp_plbl's twin: the JAX package's pseudo-labels of
    `label` from (params, batch_stats)."""
    from mulactseg_tpu.config import Config
    from mulactseg_tpu.data.loader import DataProvider
    from mulactseg_tpu.plbl.generator import (
        METHOD_TO_PLBL,
        PseudoLabelGenerator,
    )

    cfg = Config(**{**cs.rp_config_kw(fx, "unused"),
                    "method": "eval_save_cosplbl_prop_includeonehot"})
    gen = PseudoLabelGenerator(jax_model(), cfg,
                               plbl_type=METHOD_TO_PLBL[cfg.method])
    maps = {}
    for b in DataProvider(label, 1, shuffle=False, drop_last=False,
                          infinite=False, num_workers=0):
        plbl, _ = gen.plbl_for_batch(params, batch_stats, b,
                                     suppix=label.suppix)
        maps[b["fnames"][0][1]] = np.asarray(plbl).astype(np.uint8)
    return maps


class PlblSet:
    """Stage 2's training set: the label set's images with pseudo-label
    maps as their labels."""

    def __init__(self, label, maps):
        self.label, self.maps = label, maps
        self.im_idx = label.im_idx

    def __len__(self):
        return len(self.label)

    def __getitem__(self, i):
        item = self.label[i]
        return {"images": item["images"], "fnames": item["fnames"],
                "labels": self.maps[item["fnames"][1]].astype(np.int32)}

    def get_trainset(self):
        return self


def stage2(side, fx, workdir, label, maps):
    """active_predignore for the fixture's steps from `workdir`'s init on
    (label, maps); the eval mIoU on the val set."""
    d = os.path.join(workdir, "stage2")
    kw = {**cs.rp_config_kw(fx, d), "method": "active_predignore"}
    if side == "jax":
        from mulactseg_tpu.config import Config
        from mulactseg_tpu.data.synthetic import SyntheticRegionDataset
        from mulactseg_tpu.engine import rounds as jr

        ref = jax_model()
        with _no_dropout(), mock.patch.object(jr, "get_model",
                                              lambda *a, **k: ref):
            trainer = jr.ALTrainer(
                Config(**kw), 1, eval_dataset=cs.rp_datasets(
                    SyntheticRegionDataset, fx)[2])
            trainer.load(os.path.join(workdir, "init"))
            trainer.train(PlblSet(label, maps))
            return trainer.eval()[0]
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine import rounds as pr

    variables = cs.rp_init()
    with mock.patch.object(pr, "get_model",
                           lambda *a, **k: cs.rp_model(variables)):
        trainer = pr.ALTrainer(
            Config(**kw), 1, eval_dataset=cs.rp_datasets(
                SyntheticRegionDataset, fx)[2], device="cpu")
        trainer.load(os.path.join(workdir, "init"))
        trainer.train(PlblSet(label, maps))
        return trainer.eval()[0]


def self_check(side, fx, eps=(1e-7, 1e-6), seeds=(0, 1, 2),
               rounds=cs.RP_ROUNDS, workdir=None, verbose=True):
    """One package against itself: per perturbed run, the selection
    Jaccard of each round against the unperturbed run."""
    workdir = workdir or tempfile.mkdtemp(prefix="round_parity_fixture_")
    v = cs.rp_init()
    base = os.path.join(workdir, f"{side}_base")
    step0 = run_side(side, fx, v, base, rounds)["step0"]
    rows = []
    for e in eps:
        for seed in seeds:
            d = os.path.join(workdir, f"{side}_eps{e:g}_seed{seed}")
            got = run_side(side, fx, perturbed(v, e, seed), d, rounds)
            rows.append({"side": side, "perturb": e, "seed": seed,
                         "jaccard": [cs.jaccard(cs.rp_selected(base, r),
                                                cs.rp_selected(d, r))
                                     for r in range(1, rounds + 1)],
                         "regions": [len(cs.rp_selected(base, r))
                                     for r in range(1, rounds + 1)],
                         "step0_rel": [abs(a - b) / max(abs(a), 1e-6)
                                       for a, b in zip(step0, got["step0"])]})
            if verbose:
                print(json.dumps(rows[-1]), flush=True)
    return rows


def parity(fx, rounds=cs.RP_ROUNDS, workdir=None, with_stage2=True,
           verbose=True):
    """The port against the JAX package (module docstring). Returns
    {"round1_identical", "rounds": [per-round dicts], "stage2_miou":
    [port, jax] or None}."""
    from mulactseg_tpu.data.synthetic import SyntheticRegionDataset as JaxDS
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine.checkpoint import load_checkpoint
    from mulactseg_tpu_torch.models.convert import state_dict_to_variables

    from mulactseg_tpu.engine.checkpoint import load_checkpoint as jax_load

    workdir = workdir or tempfile.mkdtemp(prefix="round_parity_fixture_")
    v = cs.rp_init()
    pd, jd = os.path.join(workdir, "port"), os.path.join(workdir, "jax")
    port = cs.rp_rounds(fx, v, pd, "cpu", rounds)
    with _no_dropout():
        jx = jax_rounds(fx, v, jd, rounds)

    def read(d, f):
        with open(os.path.join(d, f), "rb") as fh:
            return fh.read()

    report = {"fixture": fx, "round1_identical": all(
        read(pd, f) == read(jd, f)
        for f in (cs.rp_selection_file(1), "datalist_01.json")),
        "rounds": []}
    for r in range(1, rounds + 1):
        a, b = cs.rp_selected(pd, r), cs.rp_selected(jd, r)
        weights = load_checkpoint(os.path.join(pd, f"checkpoint{r:02d}"))[
            "model_state_dict"]
        carried = state_dict_to_variables(weights)
        label = cs.rp_label_set(SyntheticRegionDataset, fx, pd, r)
        gen = cs.rp_generator(fx, weights, "cpu")
        port_maps = cs.rp_plbl(gen, label)
        synced_label = cs.rp_label_set(JaxDS, fx, pd, r)
        synced = jax_plbl(fx, carried["params"], carried["batch_stats"],
                          synced_label)
        # where the synced maps differ: each pixel's decision margin
        # (chip_smoke.plbl_margins, from the port's forward), and how many
        # pixels the JAX package's own maps change by when the carried
        # weights are scaled by 1 + 1e-7 N(0, 1)
        margins, self_flips = [], None
        for bt in cs.rp_batches(label):
            k = bt["fnames"][0][1]
            d = np.flatnonzero(port_maps[k] != synced[k]) if k in synced \
                else ()
            if len(d):
                margins += cs.plbl_margins(gen, bt, label.suppix)[d].tolist()
        if margins:
            vp = perturbed(carried, 1e-7, 0)
            again = jax_plbl(fx, vp["params"], vp["batch_stats"],
                             synced_label)
            self_flips = int(sum((again[k] != synced[k]).sum()
                                 for k in synced))
        jpay = jax_load(os.path.join(jd, f"checkpoint{r:02d}"))
        jlabel = cs.rp_label_set(JaxDS, fx, jd, r)
        free = jax_plbl(fx, jpay["params"], jpay["batch_stats"], jlabel)
        common = sorted(port_maps.keys() & free.keys())
        row = {"round": r, "selection_jaccard": cs.jaccard(a, b),
               "n_selected": [len(a), len(b)],
               "step0_loss": [port["step0"][r - 1], jx["step0"][r - 1]],
               "step0_rel": abs(port["step0"][r - 1] - jx["step0"][r - 1])
               / max(abs(jx["step0"][r - 1]), 1e-6),
               "plbl_images": len(port_maps),
               "plbl_pixels": int(sum(m.size for m in port_maps.values())),
               "plbl_same_images_synced": port_maps.keys() == synced.keys(),
               "plbl_pixels_differ_synced": int(sum(
                   (port_maps[k] != synced[k]).sum()
                   for k in port_maps.keys() & synced.keys())),
               "plbl_differ_margins": margins,
               "plbl_jax_self_flips": self_flips,
               "plbl_agreement_free": float(
                   sum((port_maps[k] == free[k]).sum() for k in common)
                   / max(sum(free[k].size for k in common), 1)),
               "miou": [port["miou"][r], jx["miou"][r]]}
        report["rounds"].append(row)
        if verbose:
            print(json.dumps(row), flush=True)
    report["stage2_miou"] = None
    if with_stage2:
        # the last round's maps: each side's own checkpoint on its own
        # label set
        report["stage2_miou"] = [
            stage2("port", fx, pd, label, port_maps),
            stage2("jax", fx, jd, jlabel, free)]
        if verbose:
            print(json.dumps({"stage2_miou": report["stage2_miou"]}),
                  flush=True)
    return report


def main(argv=None):
    os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0")
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixture", default="b4_val", choices=sorted(CANDIDATES))
    ap.add_argument("--sides", nargs=2, choices=("port", "jax"),
                    default=("port", "jax"))
    ap.add_argument("--perturb", nargs="*", type=float, default=(1e-7, 1e-6),
                    help="with equal sides: the init's scalings to run")
    ap.add_argument("--out", help="write the report here as JSON")
    args = ap.parse_args(argv)
    fx = CANDIDATES[args.fixture]
    print(json.dumps({"fixture": fx, "sides": args.sides}), flush=True)
    if args.sides[0] == args.sides[1]:
        rep = {"fixture": fx,
               "self": self_check(args.sides[0], fx, tuple(args.perturb))}
        rep["stable"] = all(j == 1.0 for row in rep["self"]
                            for j in row["jaccard"])
        print(json.dumps({"stable": rep["stable"]}), flush=True)
    else:
        rep = parity(fx)
        print(json.dumps({"round1_identical": rep["round1_identical"]}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f)


if __name__ == "__main__":
    main()
