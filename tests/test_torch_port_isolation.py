"""The port stands alone: no module of mulactseg_tpu_torch/ and no line of
chip_smoke.py imports jax, flax, optax or the JAX package, and its entry
points refuse to run without a card unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mulactseg_tpu_torch
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.device import resolve_device
from mulactseg_tpu_torch.engine.evaluate import Evaluator
from mulactseg_tpu_torch.engine.rounds import ALTrainer, run_al_rounds
from mulactseg_tpu_torch.engine.train import make_eval_step, make_train_step
from mulactseg_tpu_torch.models.factory import get_model
from mulactseg_tpu_torch.ops import _build, pixel_loss, segment, segment_max
from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(mulactseg_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "flax", "optax", "mulactseg_tpu")
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module):
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_forbidden_matches_exact_names_and_prefixes_only():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("mulactseg_tpu") and _forbidden("mulactseg_tpu.ops")
    assert not _forbidden("mulactseg_tpu_torch")
    assert not _forbidden("mulactseg_tpu_torch.ops")
    assert not _forbidden("jaxlib")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mulactseg_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("deeplabv3pluswn_resnet50deepstem", 20)
    model = torch.nn.Conv2d(3, 3, 1)
    cfg = Config(method="active_joint_multi_predignore_lossdecomp")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PseudoLabelGenerator(model, cfg)
    assert resolve_device("cpu") == torch.device("cpu")
    assert callable(make_train_step(model, cfg, device="cpu"))
    assert Evaluator(model, cfg, device="cpu").dev.type == "cpu"
    assert PseudoLabelGenerator(model, cfg, device="cpu").dev.type == "cpu"


def test_round_loop_entry_points_raise_without_cuda(no_card, tmp_path):
    """ALTrainer, run_al_rounds and make_eval_step default to the card and
    raise without one before they build anything; on the CPU they build,
    cfg.profile too (test_torch_port_profile.py runs it), and a width
    other than the group's and train() of an eval-only method raise."""
    cfg = Config(model_save_dir=str(tmp_path), max_iterations=1)
    model = torch.nn.Conv2d(3, 3, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALTrainer(cfg, 1, model=model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_eval_step(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_al_rounds(cfg, active_set=type("A", (), {})())
    assert ALTrainer(cfg, 1, model=model, device="cpu").dev.type == "cpu"
    assert ALTrainer(Config(profile=True), 1, model=model,
                     device="cpu").cfg.profile
    # without a process group the data-parallel width is 1
    with pytest.raises(ValueError, match="n_devices=2, but 1 rank"):
        ALTrainer(Config(n_devices=2), 1, model=model, device="cpu")
    trainer = ALTrainer(Config(method="eval_save_cosplbl_prop_includeonehot"),
                        1, model=model, device="cpu")
    assert trainer.train_step is None
    with pytest.raises(RuntimeError, match="eval-only"):
        trainer.train(None)
    assert os.listdir(tmp_path) == []


def test_eval_entry_points_raise_without_cuda(no_card, tmp_path):
    """The sliding forward, the analysis evals, the probe and the eval CLI
    default to the card and raise without one; on the CPU they build."""
    from mulactseg_tpu_torch.cli import eval_al
    from mulactseg_tpu_torch.engine.analysis import (
        AnalysisEvaluator,
        SelectionAccuracyEvaluator,
    )
    from mulactseg_tpu_torch.engine.sliding import SlidingEval

    model = torch.nn.Conv2d(3, 3, 1)
    cfg = Config(method="eval_cosplbl_within_multihot")
    for build in (lambda **k: SlidingEval(model, 2, **k),
                  lambda **k: AnalysisEvaluator(model, cfg, cfg.method, **k),
                  lambda **k: AnalysisEvaluator(model, cfg, "eval_naive_vis",
                                                **k),
                  lambda **k: SelectionAccuracyEvaluator(model, cfg, **k),
                  lambda **k: Evaluator(model, Config(sliding_eval=True),
                                        **k),
                  lambda **k: PseudoLabelGenerator(
                      model, cfg, "cosprop_includeonehot_slide", **k),
                  lambda **k: PseudoLabelGenerator(model, cfg, "naive",
                                                   **k)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        assert build(device="cpu").dev.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_al.main(["--method", "active_joint_multi_analysis", "-p",
                      str(tmp_path / "run"), "--loader", "synthetic",
                      "--dontlog"])


def test_port_path_imports_no_pil():
    """The pseudo-label PNGs are written by utils/png.py: no module of the
    port imports Pillow (the machine with the card is not promised it)."""
    bad = [(str(p.relative_to(ROOT)), m) for p in SOURCES
           for m in _imports(p) if m == "PIL" or m.startswith("PIL.")]
    assert not bad, bad


def test_non_cpu_tensors_take_the_kernel_path(monkeypatch):
    """A tensor off the CPU never reaches a plain version: the wrapper goes
    to the kernel library (stubbed here to raise) and checks its input."""
    def no_library(name, argtypes):
        raise RuntimeError(f"kernel library {name} requested")

    monkeypatch.setattr(_build, "load", no_library)
    x = torch.empty(2, 20, 64, device="meta")
    bits = torch.empty(2, 1, 64, dtype=torch.int32, device="meta")
    g2 = torch.empty(2, device="meta")
    vals = torch.empty(8, 20, device="meta")
    pix = torch.empty(8, 20, dtype=torch.int32, device="meta")
    planes = torch.empty(20, 128, device="meta").t()
    sid = torch.empty(128, dtype=torch.int32, device="meta")
    rows = torch.empty(128, 20, device="meta")
    calls = [lambda: pixel_loss.pixel_ce_fwd(x, bits, 0.1),
             lambda: pixel_loss.pixel_ce_bwd(x, bits, g2, 0.1),
             lambda: segment.ssm_fwd(x, bits, 8, 0.1),
             lambda: segment.ssm_bwd(x, bits, vals, pix, vals, 0.1),
             lambda: segment_max.seg_max_fwd(planes, sid, 8),
             lambda: segment_max.segment_max_grad(planes, sid, 8),
             lambda: segment.prereduce_softmax_nchw(x, bits, 8, 0.1),
             # past the guard: K6 first
             lambda: segment.segment_softmax_max_nchw(x, bits, 9216, 0.1),
             lambda: segment.prereduce_softmax_rows(rows, sid, 8),
             lambda: segment.ssm_rows_fwd(rows, sid, 8),
             lambda: segment.segment_softmax_max(rows, sid, 8),
             lambda: pixel_loss.pixel_ce_rows_fwd(rows, sid, 0.1),
             lambda: pixel_loss.pixel_ce_rows_bwd(rows, sid, g2, 0.1),
             lambda: pixel_loss.pixel_partial_ce(rows, sid, 0.1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="kernel library"):
            call()
    with pytest.raises(TypeError):
        pixel_loss.pixel_ce_fwd(x.double(), bits, 0.1)
    with pytest.raises(ValueError):
        segment.ssm_fwd(x, bits[:, :, :32], 8, 0.1)
    with pytest.raises(TypeError):
        segment_max.seg_max_fwd(planes, sid.long(), 8)
    with pytest.raises(ValueError):
        segment_max.seg_max_fwd(planes, sid[:64], 8)
    with pytest.raises(ValueError):
        segment.ssm_rows_fwd(rows, sid[:64], 8)
    with pytest.raises(ValueError):
        pixel_loss.pixel_ce_rows_fwd(rows.t(), sid, 0.1)
    assert not _build.LAUNCHES.get("pixel_ce_fwd")
    assert not _build.LAUNCHES.get("seg_max_fwd")


def test_launch_counters_start_at_zero_and_reset():
    _build.LAUNCHES["pixel_ce_fwd"] += 3
    _build.reset_launches()
    assert dict(_build.LAUNCHES) == {}
    # CPU tensors take the plain versions and launch nothing
    pixel_loss.pixel_ce_fwd(torch.zeros(1, 3, 4),
                            torch.from_numpy(np.ones((1, 1, 4), np.int32)),
                            0.1)
    assert dict(_build.LAUNCHES) == {}
