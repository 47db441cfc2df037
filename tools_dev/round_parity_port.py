"""Multi-round (default 5) free-running active-learning parity of the
PyTorch port against the JAX package: run_al_rounds of each package from
one init, each compounding its own float noise round over round, with no
weight synchronisation between rounds. This is tools_dev/
round_parity_multi.py's protocol with the port as the twin side: where
that harness held the JAX package against torch transcriptions of the
reference, this one holds the port's whole round loop (selection, the
selection JSON and datalists, training with the best-val checkpoint
policy, eval) against the JAX package's.

Both sides run the recipe's round loop (train_AL.py:37-82 with
start_over: round 1 selects at random, rounds 2.. with the paper's
selector my_bvsb_predclsbal_pwr_banignore from the previous round's
best-val checkpoint, each round trains from the shared init on its own
labelled set) at the tiny sizes of tests/test_torch_port_rounds.py
(_cfg_kw, _datasets: the small separable twin, 33x33, nseg 16, 6 pool
images, 24 clicks a round, 4 steps validating every 2, learning rate
1e-4), float32, dropout off, with SGD (momentum 0.9) as
round_parity_multi.py trains: its error propagates deterministically
where AdamW's first step turns rounding into sign flips.

Per round it reports:
  - selection Jaccard between the two sides' selection JSONs (each
    side's own drifted model scores the pool);
  - the step-0 relative loss gap (the shared init on each side's own
    labelled set: tight iff the selections and the loss agree); in
    commit fbc153b round_parity_multi.py gave <= 1.5e-5 in each of 5
    rounds;
  - each side's eval mIoU on the val set.
Round 1's selection JSON and datalist must be byte-identical (my_random
from one seed).

At these sizes the loop is chaotic of itself: each package against
itself, from an init 1e-7 apart (--sides port port / jax jax --perturb
1e-7), selects other regions from round 2 or 3 on, as the port against
the JAX package does from round 3 (ROADMAP.md section C).

Run: python tools_dev/round_parity_port.py [--rounds N] [--lr F]
[--sides port jax] [--perturb EPS] (~2 min on a CPU at 5 rounds).
--sides port port (or jax jax) with --perturb 1e-7 runs one package
against itself from an init perturbed by float32 rounding, which
measures how chaotic the loop is on its own. XLA runs at the test suite's
optimisation level 0 (tests/conftest.py) unless XLA_FLAGS says otherwise.
tests/test_torch_port_round_parity.py asserts it at 5 rounds (slow).
"""

import argparse
import json
import os
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEL2 = "my_bvsb_predclsbal_pwr_banignore"


def _selected(path):
    with open(path) as f:
        return {(p, i) for _, p, i in json.load(f)}


def _jaccard(a, b):
    return len(a & b) / max(len(a | b), 1)


def _perturbed(v, eps, seed=0):
    """v with every parameter scaled by (1 + eps * N(0, 1)), elementwise."""
    import jax
    import numpy as np

    if not eps:
        return v
    rng = np.random.RandomState(seed)
    return {"params": jax.tree_util.tree_map(
        lambda a: (np.asarray(a) * (1.0 + eps * rng.randn(*np.shape(a)))
                   ).astype(np.float32), v["params"]),
        "batch_stats": v["batch_stats"]}


def _run_jax(ref, v, kw, d):
    """The JAX package's run_al_rounds from the variables v in d: (eval
    mIoU by round, step-0 loss by round)."""
    import jax

    from mulactseg_tpu.active import RegionActiveSet
    from mulactseg_tpu.config import Config
    from mulactseg_tpu.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu.engine import checkpoint
    from mulactseg_tpu.engine import rounds
    from mulactseg_tpu.engine.state import create_train_state
    from tests.test_torch_port_rounds import HH, _cfg_kw, _datasets

    cfg = Config(**_cfg_kw(d, **kw))
    state = create_train_state(ref, cfg, jax.random.PRNGKey(0),
                               (4, HH, HH, 3), total_itrs=cfg.finetune_itrs)
    state = state.replace(params=v["params"], batch_stats=v["batch_stats"],
                          opt_state=state.tx.init(v["params"]))
    init = os.path.join(d, "init")
    checkpoint.save_checkpoint(init, state)
    # the trainer builds fresh jitted steps every round; the first round's
    # serve every round (same model, same configuration)
    memo = {}
    patches = [mock.patch.object(rounds, "get_model", lambda *a, **k: ref)]
    for name in ("make_train_step", "make_eval_step"):
        real = getattr(rounds, name)
        patches.append(mock.patch.object(
            rounds, name, lambda *a, _r=real, _n=name, **k:
            memo.setdefault(_n, _r(*a, **k))))
    evaluator = rounds.Evaluator(ref, cfg)
    patches.append(mock.patch.object(rounds, "Evaluator",
                                     lambda *a, **k: evaluator))
    step0 = []
    pool, label, val = _datasets(SyntheticRegionDataset)
    for p in patches:
        p.start()
    try:
        miou = rounds.run_al_rounds(
            cfg, RegionActiveSet(cfg, pool, label), val_dataset=val,
            eval_dataset=val, init_checkpoint=init,
            metrics_cb=lambda it, aux: it or step0.append(
                float(aux["train_loss"])))
    finally:
        for p in patches:
            p.stop()
    return miou, step0


def _run_port(v, kw, d):
    """The port's run_al_rounds (on the CPU) from the variables v in d."""
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine import rounds
    from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
    from tests.test_torch_port_rounds import _cfg_kw, _datasets, _port_twin

    cfg = Config(**_cfg_kw(d, **kw))
    os.makedirs(d, exist_ok=True)
    init = os.path.join(d, "init")
    save_checkpoint(init, _port_twin(v))
    step0 = []
    pool, label, val = _datasets(SyntheticRegionDataset)
    with mock.patch.object(rounds, "get_model",
                           lambda *a, **k: _port_twin(v)):
        miou = rounds.run_al_rounds(
            cfg, RegionActiveSet(cfg, pool, label), val_dataset=val,
            eval_dataset=val, init_checkpoint=init, device="cpu",
            metrics_cb=lambda it, aux: it or step0.append(
                float(aux["train_loss"])))
    return miou, step0


def run(rounds=5, lr=1e-4, sides=("port", "jax"), perturb=0.0,
        workdir=None, verbose=True):
    """run_al_rounds of each package in `sides` ("port" or "jax"; the
    same one twice measures the loop's own sensitivity) for `rounds`
    rounds, in `workdir` (a new temporary directory by default), the
    second side's parameters scaled by (1 + perturb * N(0, 1)). Returns
    {"round1_identical": bool, "rounds": [per-round dicts]}, each pair
    listed in `sides` order."""
    import flax.linen as fnn
    import torch

    from tests.test_torch_port_model import jax_variables, twin_pair

    torch.set_num_threads(1)
    workdir = workdir or tempfile.mkdtemp(prefix="round_parity_port_")
    kw = dict(max_iterations=rounds, optimizer="sgd", train_lr=lr,
              log_period=1)
    _, ref = twin_pair(separable=True)
    dirs, out = [], []
    with mock.patch.object(fnn.Dropout, "__call__",
                           lambda self, x, **k: x):
        v = jax_variables(ref, 9)
        for i, side in enumerate(sides):
            d = os.path.join(workdir, f"{'ab'[i]}_{side}")
            vi = _perturbed(v, perturb) if i else v
            dirs.append(d)
            out.append(_run_jax(ref, vi, kw, d) if side == "jax"
                       else _run_port(vi, kw, d))

    def read(d, f):
        with open(os.path.join(d, f), "rb") as fh:
            return fh.read()

    report = {"sides": list(sides), "perturb": perturb, "lr": lr,
              "round1_identical": all(
                  read(dirs[0], f) == read(dirs[1], f)
                  for f in ("my_random_selection_01.json",
                            "datalist_01.json")),
              "rounds": []}
    (miou_a, loss_a), (miou_b, loss_b) = out
    for r in range(1, rounds + 1):
        f = f"{'my_random' if r == 1 else SEL2}_selection_{r:02d}.json"
        a, b = (_selected(os.path.join(d, f)) for d in dirs)
        row = {"round": r, "selection_jaccard": _jaccard(a, b),
               "n_selected": [len(a), len(b)],
               "step0_loss": [loss_a[r - 1], loss_b[r - 1]],
               "step0_rel": abs(loss_a[r - 1] - loss_b[r - 1])
               / max(abs(loss_b[r - 1]), 1e-6),
               "miou": [miou_a[r], miou_b[r]]}
        report["rounds"].append(row)
        if verbose:
            print(json.dumps(row), flush=True)
    return report


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0")
    import jax

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--sides", nargs=2, choices=("port", "jax"),
                    default=("port", "jax"))
    ap.add_argument("--perturb", type=float, default=0.0)
    args = ap.parse_args()
    rep = run(rounds=args.rounds, lr=args.lr, sides=tuple(args.sides),
              perturb=args.perturb)
    print(json.dumps({k: rep[k] for k in
                      ("sides", "perturb", "lr", "round1_identical")}))
