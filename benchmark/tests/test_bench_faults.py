"""The check that decides `correct`, driven on the CPU at a small size with
the timed path broken underneath: each fault that a cell can have, and the
lower-precision control in the program's place, must come out as not
correct under the cell's own limits. The look for a card is skipped: the
loops run as run.py calls them, on the CPU."""

import time

import pytest
import torch

import bench_tiny
from benchmark import calibrate, common
from benchmark.loops import plbl, train

torch.set_num_threads(2)
SEED = 2 ** 31 + 101


def drive(name):
    w, cfg, mix, limits = bench_tiny.cell(name)
    drv = train if mix["kind"] == "train" else plbl
    out = drv.run(w, cfg, mix, limits, SEED, 0.5, False, bench_tiny.CPU,
                  time.perf_counter())
    return common.judge(out["values"], limits), out


@pytest.mark.parametrize("name", ["city_stage1", "voc_stage1"])
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    (ok, checks), _ = drive(name)
    assert not ok, checks


@pytest.mark.parametrize("name", ["city_stage1", "voc_stage1"])
def test_half_the_batch_is_not_correct(name, monkeypatch):
    from mulactseg_tpu_torch.engine import train as port_train

    make = port_train.make_train_step
    monkeypatch.setattr(port_train, "make_train_step",
                        lambda *a, **k: calibrate.half_batch(make(*a, **k)))
    (ok, checks), _ = drive(name)
    assert not ok, checks


@pytest.mark.parametrize("name", ["city_stage1", "voc_stage1"])
def test_a_loader_row_altered_is_not_correct(name, monkeypatch):
    """A loader fault reaches the program alone: the reference collates its
    batches from the benchmark's own pool."""
    from mulactseg_tpu_torch.data import loader

    real = loader.collate

    def altered(samples):
        out = real(samples)
        out["images"][0, :, :4] += 0.5
        return out

    monkeypatch.setattr(loader, "collate", altered)
    (ok, checks), out = drive(name)
    assert not ok and out["values"]["rows_not_in_pool"] >= 1, checks


def test_altered_pseudo_labels_are_not_correct(monkeypatch):
    from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator

    real = PseudoLabelGenerator.plbl_for_batch

    def altered(self, batch, suppix=None, prep=None):
        out = real(self, batch, suppix, prep)
        return torch.as_tensor(calibrate.altered(out.cpu().numpy(), 20))

    monkeypatch.setattr(PseudoLabelGenerator, "plbl_for_batch", altered)
    (ok, checks), _ = drive("city_plbl")
    assert not ok, checks


@pytest.mark.parametrize("name", ["city_stage1", "voc_stage1"])
def test_float8_control_is_not_correct(name):
    """The reference in float8 convolutions, put in the program's place
    and compared with the float32 reference under the cell's limits."""
    w, cfg, mix, limits = bench_tiny.cell(name)
    got = calibrate.train_readings(cfg, mix, SEED, bench_tiny.CPU,
                                   control=True, fault=False)
    ok, checks = common.judge(got["control"], limits)
    assert not ok, checks


def test_float8_control_of_pseudo_labels_is_not_correct():
    w, cfg, mix, limits = bench_tiny.cell("city_plbl")
    got = calibrate.plbl_readings(cfg, mix, SEED, bench_tiny.CPU,
                                  control=True, fault=False)
    ok, checks = common.judge(got["control"], limits)
    assert not ok, checks
