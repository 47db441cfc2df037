"""cfg.profile in the port's ALTrainer.train (engine/rounds.py) against the
JAX package's, on the CPU at test_torch_port_rounds.py's tiny sizes (the
small separable twin, 33x33, nseg 16, float32, dropout off), each
trainer taking 2 steps with one validation on a synthetic label set whose
superpixels are all labelled.

- Config(profile=True) writes exactly one Chrome trace under
  <model_save_dir>/profile/, named for rank 0 and the round, which parses
  as JSON and holds the step's aten:: ops; a second round, its items
  built in worker processes started inside the traced window, adds a
  second file beside it and ends at the first round's weights.
- The trace holds each step's train.step span and, inside it, the spans
  train.h2d, train.forward, train.loss, train.backward and
  train.optimizer, in that order.
- The profiled run's weights, optimizer state and step are bitwise those
  of an unprofiled run from the same init.
- The JAX ALTrainer at profile=True, with the same configuration, init
  and batches as a profiled run of the port, writes its trace under the
  same profile/ directory, and its parameters end within
  test_three_train_steps_match_jax's bound (1e-4 relative in L2 over all
  leaves) of the port's. This pair is the tiny conv/BN model of
  test_torch_port_parallel_criteria_jax.py, not the twin: the fixture's
  images are noise of one distribution, so the twin's ASPP pooling branch
  normalises 4 nearly equal values, whose float32 single-pass variance
  (E[x^2] - m^2, on both sides) cancels, and AdamW's first step turns the
  rounding into sign flips. The twin's parameters part by 2.4e-4 after 2
  steps there (4.3e-5 with make_batch's per-image scale and offset); the
  tiny pair's, by 3.7e-8 (tools_dev/trainer_gap_models.py).
- Two ranks under gloo (parallel.spawn), on the tiny pair, write one
  trace each.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data.synthetic import SyntheticRegionDataset as JaxDataset
from mulactseg_tpu.engine import rounds as jax_rounds
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.loader import shutdown_workers
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.engine.rounds import ALTrainer
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.parallel import mesh
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_criteria_step import _params_tree, tiny_pair
from tests.test_torch_port_model import NC, twin_pair
from tests.test_torch_port_rounds import HH, NSEG, _cfg_kw, _port_twin
from tests.test_torch_port_train import _global_rel

torch.set_num_threads(1)

ITRS = 2  # one validation, after step 2 (val_period 2, val_start 0)


class _Active:
    """The trainer reads only the training set of an active set."""

    def __init__(self, trainset):
        self.trainset = trainset

    def get_trainset(self):
        return self.trainset


def _sets(cls):
    mk = lambda s: cls(n_images=6, H=HH, W=HH, num_classes=NC - 1,
                       nseg=NSEG, split=s, seed=1)
    return mk("active-label"), mk("val")


def _kw(tmp, profile, **kw):
    return _cfg_kw(tmp, finetune_itrs=ITRS, val_period=2, profile=profile,
                   **kw)


def _port_run(tmp, v, profile, selection_iter=1, processes=False):
    """The port's trainer of one round; with processes, the loader builds
    the label set's items in worker processes, started (spawn) inside the
    traced window."""
    label, val = _sets(SyntheticRegionDataset)
    if processes:
        label = ranks.FilesLike(label)
    trainer = ALTrainer(Config(**_kw(tmp, profile)), selection_iter,
                        val_dataset=val, model=_port_twin(v), device="cpu")
    assert trainer.train(_Active(label)) > 0
    return trainer


def _trace_files(tmp):
    return sorted(os.listdir(os.path.join(tmp, "profile")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    v = convert.random_variables(twin_pair(separable=True)[0], 9)
    tmp = tmp_path_factory.mktemp("profile")
    out = {"dirs": tmp}
    out["profiled"] = _port_run(tmp / "profiled", v, True)
    out["round1_files"] = _trace_files(tmp / "profiled")
    try:
        out["round2"] = _port_run(tmp / "profiled", v, True, 2,
                                  processes=True)
    finally:
        shutdown_workers()
    out["round2_files"] = _trace_files(tmp / "profiled")
    out["plain"] = _port_run(tmp / "plain", v, False)
    return out


def test_profiled_train_writes_one_trace_per_round(runs):
    tmp = runs["dirs"]
    want = "rank0.round01.pt.trace.json"
    assert runs["round1_files"] == [want]
    assert runs["profiled"].trace_file == str(tmp / "profiled" / "profile"
                                              / want)
    assert runs["round2_files"] == [want, "rank0.round02.pt.trace.json"]
    # round 2's items came from worker processes, and its weights are
    # round 1's: the same init, data and steps
    for k, t in runs["profiled"].model.state_dict().items():
        assert torch.equal(runs["round2"].model.state_dict()[k], t), k
    with open(runs["profiled"].trace_file) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # the model's forward and backward and AdamW's update
    for op in ("aten::convolution", "aten::convolution_backward",
               "aten::lerp_", "aten::addcdiv_"):
        assert op in names, op
    # the validation inside the traced window saved the best checkpoint
    assert os.path.exists(tmp / "profiled" / "checkpoint01")
    assert not os.path.exists(tmp / "plain" / "profile")


def test_trace_holds_the_train_step_spans(runs):
    """Each step of the traced loop is a train.step span (utils/spans.py)
    holding its five layers' spans, in order, on its thread."""
    with open(runs["profiled"].trace_file) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith("train.")]
    children = ["train.h2d", "train.forward", "train.loss",
                "train.backward", "train.optimizer"]
    steps = [e for e in events if e["name"] == "train.step"]
    assert len(steps) == ITRS
    for s in steps:
        inner = sorted((e for e in events if e["name"] in children
                        and e["tid"] == s["tid"]
                        and s["ts"] <= e["ts"]
                        and e["ts"] + e["dur"] <= s["ts"] + s["dur"]),
                       key=lambda e: e["ts"])
        assert [e["name"] for e in inner] == children


def test_profiled_run_is_bitwise_the_unprofiled_one(runs):
    a, b = runs["profiled"], runs["plain"]
    assert a.step == b.step == ITRS
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys() and len(oa["state"])
    for i, st in oa["state"].items():
        for k, t in st.items():
            assert torch.equal(ob["state"][i][k], t), (i, k)
    assert a.best_iou == b.best_iou


def test_jax_profile_matches_port(tmp_path):
    port, ref, v = tiny_pair(NC, 3)
    label, val = _sets(SyntheticRegionDataset)
    losses = {}
    trainer = ALTrainer(Config(**_kw(tmp_path / "port", True, log_period=1)),
                        1, val_dataset=val, model=port, device="cpu")
    trainer.train(_Active(label), metrics_cb=lambda i, aux: losses.setdefault(
        "port", []).append(aux["train_loss"]))
    assert _trace_files(tmp_path / "port") == ["rank0.round01.pt.trace.json"]

    jcfg = JaxConfig(**_kw(tmp_path / "jax", True, log_period=1))
    jtrainer = jax_rounds.ALTrainer(jcfg, 1, model=ref)
    jtrainer.state = jtrainer.state.replace(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=jtrainer.state.tx.init(v["params"]))
    # the validation changes no parameter; the JAX side skips it to spare
    # an eval compile
    jlabel, _ = _sets(JaxDataset)
    jtrainer.train(_Active(jlabel), metrics_cb=lambda i, aux: losses.setdefault(
        "jax", []).append(float(aux["train_loss"])))
    traces = [f for _, _, fs in os.walk(tmp_path / "jax" / "profile")
              for f in fs]
    assert any(f.endswith(".xplane.pb") for f in traces), traces
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5)
    assert len(losses["jax"]) == ITRS
    want = jax.device_get(jtrainer.state.params)
    err = _global_rel(_params_tree(port), want)
    assert err < 1e-4, err
    # the steps moved the parameters by far more than the two sides differ
    assert _global_rel(v["params"], want) > 20 * err


def test_two_ranks_write_one_trace_each(tmp_path):
    port, _, _ = tiny_pair(ranks.NC, 3)
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    cfg_kw = ranks.cfg_kw("active_joint_multi_predignore_lossdecomp", {})
    cfg_kw.update(finetune_itrs=ITRS, profile=True, num_workers=0,
                  model_save_dir=str(tmp_path))
    data_kw = dict(n_images=4, H=ranks.HH, W=ranks.HH,
                   num_classes=ranks.NC - 1, nseg=ranks.NSEG,
                   split="active-label", seed=1)
    files = mesh.spawn(ranks.run_all, 2, "gloo", "cpu",
                       [("trace", "profiled_train",
                         (("tiny", state), cfg_kw, data_kw))], timeout=180)
    want = [f"rank{r}.round01.pt.trace.json" for r in (0, 1)]
    assert [os.path.basename(f["trace"]) for f in files] == want
    assert _trace_files(tmp_path) == want
    for name in want:
        with open(tmp_path / "profile" / name) as f:
            assert "aten::convolution" in {
                e.get("name") for e in json.load(f)["traceEvents"]}


def test_host_self_ms_subtracts_child_ops():
    """chip_smoke.host_self_ms, which ranks the profile phase's host ops:
    an op's self time is its span less its child ops' on its thread."""
    import chip_smoke

    def op(name, ts, dur, tid=1):
        return {"cat": "cpu_op", "ph": "X", "name": name, "ts": ts,
                "dur": dur, "pid": 0, "tid": tid}
    events = [op("a", 0, 10000), op("b", 2000, 3000), op("c", 3000, 1000),
              op("d", 6000, 2000), op("b", 0, 4000, tid=2),
              {"cat": "kernel", "ph": "X", "name": "k", "ts": 0, "dur": 9}]
    got = dict(chip_smoke.host_self_ms(events))
    assert got == {"a": 5.0, "b": 6.0, "c": 1.0, "d": 2.0}
    assert [n for n, _ in chip_smoke.host_self_ms(events, top=2)] == [
        "b", "a"]
