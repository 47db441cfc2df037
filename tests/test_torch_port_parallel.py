"""The port's data parallelism (mulactseg_tpu_torch/parallel/mesh.py and
its users) at world 2 against one rank and against the JAX package's own
data-parallel program on 2 of the conftest's 8 CPU devices.

The port's ranks run in two processes started by parallel.spawn (gloo
on the CPU, a file store in a temporary directory), which import
tests/torch_port_parallel_ranks.py and never JAX; one group runs every
job, joined with a timeout. The one-rank references run the same
functions in this process, without a group. Tiny shapes: the small
model twin of test_torch_port_model.py at 33x33, batch 4.

- FastBatchNorm at world 2 on the rows of a batch against world 1 on
  the whole batch: output, running statistics, input and parameter
  gradients within rtol 1e-5, atol 1e-6. A dropout mask at world 2 is
  the rows of world 1's.
- Step 0 of the recipe's fused lossdecomp at world 2 against the JAX
  package's step on a 2-device mesh (built as __graft_entry__.
  _grad_invariance builds it, dropout off on both sides): the loss parts
  within 1e-5 (the bar of test_torch_port_train.py), the gradients within
  1e-4 relative in L2 over all leaves.
- 3 SGD steps at world 2 against world 1, stage 1 with dropout on (at
  T = 1.0, see `case`) and stage 2's CE: losses and parameters within
  1e-4 relative; the world-2 checkpoint has world 1's names and values
  (1e-4 relative in L2).
- ALTrainer at world 2 with the paper's selector: an uneven pool batch
  of 3 images pads, gathers and slices back to world 1's logits; the
  selection equals the JAX 2-device ALTrainer's (Jaccard 1.0), its JSON
  is written once (rank 0) and byte for byte world 1's; the eval's
  confusion matrix over 3 images at batch 1 is exactly world 1's; the
  trainer then trains with validation, saves and evaluates.
- DataProvider(split="rows"): each rank's batches are bitwise its rows of
  the one-rank batches, on the synthetic set and on a file dataset with
  a PairedTransform.
- cli.train_al.main on each rank, as torchrun runs it: one synthetic
  round's mIoU within 1 point, world 1's files and metric lines (rank 0
  writes them).
- The guards (a batch the width does not divide, n_devices against the
  width, an unknown method: KeyError on both ranks), the spawn helper's
  failure and timeout paths, and the per-rank card choice.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from mulactseg_tpu.active import RegionActiveSet as JaxActiveSet
from mulactseg_tpu.acquisition import get_selector as jax_get_selector
from mulactseg_tpu.config import Config as JaxConfig
from mulactseg_tpu.data.synthetic import SyntheticRegionDataset as JaxDataset
from mulactseg_tpu.engine import rounds as jax_rounds
from mulactseg_tpu.engine.train import _build_loss_fn, get_criterion
from mulactseg_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from mulactseg_tpu_torch import device as port_device
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data.datasets import RegionDatasetOr
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.data.transforms import get_train_transform
from mulactseg_tpu_torch.engine.checkpoint import load_checkpoint
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.models.layers import Dropout
from mulactseg_tpu_torch.parallel import mesh
from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_model import jax_variables, twin_pair
from tests.test_torch_port_train import _global_rel, make_batch

torch.set_num_threads(1)

NC, B, HH, NSEG = ranks.NC, 4, 33, 12
SEL = "my_bvsb_predclsbal_pwr_banignore"
STAGE1 = "active_joint_multi_predignore_lossdecomp"


def _cfg_kw(tmp, **kw):
    base = dict(num_classes=NC - 1, nseg=NSEG, crop_size=(HH, HH),
                train_batch_size=B, finetune_itrs=2, val_period=1,
                val_start=0, active_selection_size=20, val_batch_size=1,
                num_workers=2, val_num_workers=2, model_save_dir=str(tmp),
                dtype="float32", train_lr=1e-3, cls_lr_scale=10.0,
                method=STAGE1)
    base.update(kw)
    return base


def _twin(variables, dropout=True):
    model = ranks.port_twin(separable=True)
    convert.load_variables(model, variables)
    if not dropout:
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return model


def _sets(cls, seed=1):
    mk = lambda s, n: cls(n_images=n, H=HH, W=HH, num_classes=NC - 1,
                          nseg=NSEG, split=s, seed=seed)
    pool, label, val = mk("active-ulabel", 4), mk("active-label", 4), \
        mk("val", 3)
    label.suppix, label.im_idx = {}, []
    return pool, label, val


def _ce_batches(rng, n):
    out = []
    for _ in range(n):
        labels = rng.randint(0, NC, (B, HH, HH)).astype(np.int64)
        labels[rng.rand(B, HH, HH) < 0.1] = 255
        images = (rng.randn(B, 3, HH, HH)
                  * np.linspace(0.5, 2.0, B)[:, None, None, None]
                  ).astype(np.float32)
        out.append({"images": images, "labels": labels})
    return out


def _file_dataset(root):
    dl = write_tree(str(root), 4, 2, 40, 56, 30, seed=1)
    cfg = Config(data_root=str(root), datalist_dir=dl, nseg=30,
                 crop_size=(24, 32), dtype="float32").derive_paths()
    ds = RegionDatasetOr(cfg, cfg.trg_datalist, cfg.region_dict,
                         "active-label", transform=get_train_transform(
                             "rescale_769_multi_notrg", cfg, seed=5))
    rng = np.random.RandomState(2)
    for key in list(ds.suppix):
        ds.suppix[key] = sorted(rng.choice(ds.suppix[key], 12,
                                           replace=False).tolist())
    return ds


def _cli_argv(run):
    """One synthetic stage-1 round of the recipe's command (cut)."""
    return ["-p", str(run), "--loader", "synthetic",
            "--num_classes", str(NC - 1), "--nseg", str(NSEG),
            "--crop_size", str(HH), str(HH), "--dtype", "float32",
            "--method", STAGE1, "--finetune_itrs", "2", "--val_period", "1",
            "--val_start", "0", "--max_iterations", "1",
            "--train_batch_size", str(B), "--val_batch_size", "1",
            "--num_workers", "0", "--val_num_workers", "0",
            "--active_selection_size", "30", "--train_lr", "0.0001"]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs of every job, the world-2 results (rank by rank) and
    the one-rank results of the same jobs."""
    tmp = tmp_path_factory.mktemp("dp")
    _, ref = twin_pair(separable=True)
    v = jax_variables(ref, 7)
    rng = np.random.RandomState(8)
    x = (rng.randn(B, 6, 5, 5) * np.linspace(0.5, 2.0, B)[:, None, None, None]
         + np.linspace(-1.0, 1.0, B)[:, None, None, None]).astype(np.float32)
    bn_args = (x, rng.randn(*x.shape).astype(np.float32),
               rng.uniform(0.5, 1.5, 6).astype(np.float32),
               rng.uniform(-0.2, 0.2, 6).astype(np.float32), (B, 3, 5, 5))
    # the first stage-1 batch of test_torch_port_train.py, held against
    # JAX at the recipe's temperatures and repeated for the trajectory.
    # A segment's first argmax flips under float32 noise where two pixels
    # nearly tie (chip_smoke.near_tie_pixels), and the gradient then
    # jumps: on the next two batches of that stream JAX's own 2-device
    # gradient strays ~2e-3 from its 1-device one, and at T = 0.1 (the
    # softmax saturates) a 3-step trajectory strays ~1e-2 between any two
    # summation orders. At T = 1.0 on this batch it holds to ~1e-6
    stage1 = [make_batch(np.random.RandomState(8), B, HH, HH, NC, NSEG)] * 3
    stage2 = _ce_batches(rng, 3)
    sgd = dict(optimizer="sgd", finetune_itrs=3, dtype="float32",
               num_classes=NC - 1, nseg=NSEG, crop_size=(HH, HH),
               train_batch_size=B)
    c0 = Config(method=STAGE1, train_lr=1e-4, **sgd)
    c1 = Config(method=STAGE1, group_ce_temp=1.0, multi_ce_temp=1.0,
                train_lr=1e-4, **sgd)
    c2 = Config(method="active_predignore", train_lr=1e-3, **sgd)
    images3 = np.stack([SyntheticRegionDataset(
        n_images=3, H=HH, W=HH, num_classes=NC - 1, nseg=NSEG,
        split="val", seed=4)[i]["images"] for i in range(3)])
    synth = SyntheticRegionDataset(n_images=6, H=HH, W=HH,
                                   num_classes=NC - 1, nseg=NSEG, seed=3)
    files = _file_dataset(tmp / "tree")

    def jobs(world):
        w = f"w{world}"
        return [
            ("bn", "bn_and_dropout", bn_args),
            ("step0", "train_steps", (_twin(v, dropout=False), c0,
                                      stage1[:1])),
            ("sgd1", "train_steps", (_twin(v), c1, stage1,
                                     "cpu", str(tmp / w / "ckpt"))),
            ("sgd2", "train_steps", (_twin(v), c2, stage2)),
            ("trainer", "trainer_round", (
                Config(**_cfg_kw(tmp / w / "run", n_devices=world)),
                _twin(v), _sets(SyntheticRegionDataset), images3)),
            ("synth", "loader_batches", (synth, B, 3, 7)),
            ("files", "loader_batches", (files, B, 2, 7)),
            ("cli", "cli_round", (_cli_argv(tmp / w / "cli"), v)),
        ]

    two = mesh.spawn(ranks.run_all, 2, "gloo", "cpu",
                     jobs(2) + [("guards", "guards", (_cfg_kw(tmp / "g"),
                                                     _twin(v)))],
                     timeout=120)
    one = ranks.run_all(jobs(1))
    return {"tmp": tmp, "variables": v, "ref": ref, "stage1": stage1,
            "bn_args": bn_args, "two": two, "one": one}


def _rows_of(one, r, world=2):
    return one[mesh.local_rows(len(one), r, world)]


def test_batchnorm_world2_matches_world1(case):
    one = case["one"]["bn"]
    for r, res in enumerate(case["two"]):
        got = res["bn"]
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], _rows_of(one[k], r),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        for k in ("dw", "db", "mean", "var"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_dropout_mask_is_rows_of_world1(case):
    one = case["one"]["bn"]["mask"]
    assert 0 < one.mean() < 1
    for r, res in enumerate(case["two"]):
        np.testing.assert_array_equal(res["bn"]["mask"], _rows_of(one, r))


def test_fused_step0_matches_jax_two_devices(case):
    """The port's step 0 at world 2 against the JAX package's loss and
    gradient on a 2-device mesh (state replicated, batch sharded)."""
    ref, v, batch = case["ref"], case["variables"], case["stage1"][0]
    jcfg = JaxConfig(num_classes=NC - 1, nseg=NSEG, crop_size=(HH, HH),
                     train_batch_size=B, method=STAGE1, dtype="float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
        loss_fn = _build_loss_fn(ref, jcfg, get_criterion(jcfg))

        def lg(params, bs, b):
            (loss, (aux, _)), g = jax.value_and_grad(loss_fn, has_aux=True)(
                params, bs, b, jax.random.PRNGKey(7), jnp.asarray(0))
            return aux, g

        mesh2 = make_mesh(2)
        state = replicate({"params": v["params"],
                           "batch_stats": v["batch_stats"]}, mesh2)
        jb = shard_batch({k: jnp.asarray(
            val.transpose(0, 2, 3, 1) if k == "images" else val)
            for k, val in batch.items()}, mesh2)
        aux, g = jax.jit(lg)(state["params"], state["batch_stats"], jb)
    for res in case["two"]:
        got = res["step0"]["losses"][0]
        for k in ("ce_loss", "mc_loss", "group_loss", "train_loss"):
            np.testing.assert_allclose(got[k], float(aux[k]), rtol=1e-5,
                                       err_msg=k)
        grads = convert.state_dict_to_variables(
            {n: torch.from_numpy(a) for n, a in res["step0"]["grads"].items()})
        assert _global_rel(grads["params"], g) < 1e-4


@pytest.mark.parametrize("job", ["sgd1", "sgd2"])
def test_sgd_trajectory_world2_matches_world1(case, job):
    one = case["one"][job]
    for res in case["two"]:
        got = res[job]
        assert len(got["losses"]) == 3
        for a, b in zip(got["losses"], one["losses"]):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        err = _rel(got["state"], one["state"])
        assert err < 1e-4
        # the steps moved the weights by far more than the widths differ
        init = {k: t.numpy() for k, t in
                _twin(case["variables"]).state_dict().items()}
        assert _rel(init, one["state"]) > 20 * err


def _rel(got, want):
    """||got - want|| / ||want|| over every entry of two state dicts."""
    d = sum(np.sum((got[k].astype(np.float64) - w) ** 2)
            for k, w in want.items())
    return np.sqrt(d / sum(np.sum(w.astype(np.float64) ** 2)
                           for w in want.values()))


def test_checkpoint_has_world1_names_and_values(case):
    tmp = case["tmp"]
    got = load_checkpoint(str(tmp / "w2" / "ckpt"))
    want = load_checkpoint(str(tmp / "w1" / "ckpt"))
    assert got.keys() == want.keys() and got["step"] == want["step"] == 3
    sd, ref_sd = got["model_state_dict"], want["model_state_dict"]
    assert list(sd) == list(ref_sd)
    assert all(sd[k].shape == w.shape for k, w in ref_sd.items())
    assert _rel({k: t.numpy() for k, t in sd.items()},
                {k: t.numpy() for k, t in ref_sd.items()}) < 1e-4


def test_pool_scoring_pads_gathers_and_slices(case):
    want = case["one"]["trainer"]["logits"]
    assert want.shape[0] == 3
    for res in case["two"]:
        np.testing.assert_allclose(res["trainer"]["logits"], want,
                                   rtol=1e-6, atol=1e-6)


def _regions(suppix):
    return {(k, int(i)) for k, ids in suppix.items() for i in ids}


def test_selection_matches_jax_two_device_trainer(case, tmp_path):
    ref, v = case["ref"], case["variables"]
    jcfg = JaxConfig(**_cfg_kw(tmp_path, n_devices=2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, **kw: x)
        trainer = jax_rounds.ALTrainer(jcfg, 1, model=ref)
        assert trainer.dp and trainer.mesh.size == 2
        trainer.state = replicate(trainer.state.replace(
            params=v["params"], batch_stats=v["batch_stats"]), trainer.mesh)
        pool, label, _ = _sets(JaxDataset)
        active = JaxActiveSet(jcfg, pool, label)
        active.selection_iter = 1
        jax_get_selector(SEL, jcfg).select_next_batch(
            trainer, active, jcfg.active_selection_size)
    want = _regions(label.suppix)
    assert want
    name = f"{SEL}_selection_01.json"
    w1 = (case["tmp"] / "w1" / "run" / name).read_bytes()
    for r, res in enumerate(case["two"]):
        assert _regions(res["trainer"]["suppix"]) == want
        # rank 0 writes the selection and the datalist, rank 1 nothing
        assert res["trainer"]["json_dumps"] == (2 if r == 0 else 0)
    assert (case["tmp"] / "w2" / "run" / name).read_bytes() == w1
    assert {(p, i) for _, p, i in json.loads(w1)} == {
        (p, i) for _, p, i in json.loads((tmp_path / name).read_text())}


def test_evaluator_confusion_world2_equals_world1(case):
    one = case["one"]["trainer"]
    assert one["init_confusion"].sum() > 0
    for res in case["two"]:
        np.testing.assert_array_equal(res["trainer"]["init_confusion"],
                                      one["init_confusion"])
        assert res["trainer"]["init_miou"] == one["init_miou"]


def test_trainer_trains_validates_saves_and_evaluates(case):
    one = case["one"]["trainer"]
    for res in case["two"]:
        got = res["trainer"]
        assert len(got["validations"]) == len(one["validations"]) == 1
        assert abs(got["miou"] - one["miou"]) <= 1.0
        assert got["files"] == one["files"] == [
            "checkpoint01", "datalist_01.json", f"{SEL}_selection_01.json"]


def test_train_al_cli_on_two_ranks(case):
    """cli.train_al.main on each rank of the group (as under torchrun):
    the round's mIoU, one rank's files and metric lines."""
    tmp, one = case["tmp"], case["one"]["cli"]
    for res in case["two"]:
        assert res["cli"].keys() == one.keys() == {1}
        assert abs(res["cli"][1] - one[1]) <= 1.0
    w1, w2 = tmp / "w1" / "cli", tmp / "w2" / "cli"
    assert sorted(p.name for p in w2.iterdir()) == sorted(
        p.name for p in w1.iterdir())
    lines = [[json.loads(x) for x in (d / "metrics.jsonl").read_text()
              .splitlines()] for d in (w1, w2)]
    assert [sorted(r) for r in lines[1]] == [sorted(r) for r in lines[0]]


@pytest.mark.parametrize("job", ["synth", "files"])
def test_loader_rank_rows_are_the_one_rank_batch(case, job):
    one = case["one"][job]
    for r, res in enumerate(case["two"]):
        got = res[job]
        assert len(got) == len(one)
        for g, w in zip(got, one):
            assert g.keys() == w.keys()
            for k, val in w.items():
                want = val[mesh.local_rows(B, r, 2)]
                if isinstance(val, np.ndarray):
                    assert g[k].dtype == val.dtype, k
                    np.testing.assert_array_equal(g[k], want, err_msg=k)
                else:
                    assert g[k] == want, k


@pytest.mark.parametrize("guard,match", [
    ("batch", "not divisible"), ("n_devices", "n_devices=3"),
    ("method", "'no_such_method' has no registered criterion")])
def test_world2_guards(case, guard, match):
    for res in case["two"]:
        assert match in res["guards"][guard]


def test_spawn_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh.spawn(ranks.fail_on_rank_1, 2, "gloo", "cpu", timeout=60)


def test_spawn_times_out_on_a_hung_rank():
    with pytest.raises(TimeoutError):
        mesh.spawn(ranks.hang, 2, "gloo", "cpu", timeout=8)


def test_local_rows_pad_and_card_choice(monkeypatch):
    assert mesh.local_rows(6, 1, 3) == slice(2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.local_rows(5, 0, 2)
    x = np.arange(6).reshape(3, 2)
    padded, n = mesh.pad_to_multiple(x, 2)
    assert n == 3 and padded.tolist() == [[0, 1], [2, 3], [4, 5], [4, 5]]
    t, n = mesh.pad_to_multiple(torch.from_numpy(x), 4)
    assert n == 3 and t.shape == (4, 2) and t[3].tolist() == [4, 5]
    assert mesh.pad_to_multiple(x, 3)[0] is x
    # without a group every helper is the identity
    assert not mesh.active() and mesh.world() == 1 and mesh.is_main()
    t = torch.ones(3)
    assert mesh.all_reduce_sum(t) is t and mesh.all_gather_rows(t) is t
    # a rank's card is LOCAL_RANK, never wrapped onto another rank's
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK is not set"):
        port_device.local_rank()
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one rank per card"):
        port_device.local_rank()
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert port_device.local_rank() == 0
