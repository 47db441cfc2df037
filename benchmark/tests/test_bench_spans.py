"""benchmark/spans.py on made spans, and span_run's reading of the
program's spans driven through the loops on the CPU at a small size."""

import time

import pytest
import torch

import bench_tiny
from benchmark import span_run, spans, yardstick
from benchmark.loops import plbl, train

torch.set_num_threads(2)
SEED = 2 ** 31 + 7

MAIN, OTHER = 1, 2
# kernels leave the device idle over [1, 2], [3, 5] and [6, 9]
KERNELS = [(0.0, 1.0), (2.0, 3.0), (5.0, 6.0), (9.0, 10.0)]


def _idle_total(kernels):
    return sum(e - s for s, e in yardstick.gaps(kernels, 0.0, 10.0))


def test_the_innermost_span_wins():
    made = [(0.5, 9.5, "train.step", MAIN), (2.5, 5.5, "train.loss", MAIN),
            (3.5, 4.5, "train.h2d", MAIN)]
    parts = spans.idle_parts(KERNELS, made)
    # [1, 2] and [6, 9] under train.step; [3, 5] under train.loss but for
    # [3.5, 4.5] under train.h2d
    assert parts == pytest.approx({"train.step": 1.0 + 3.0,
                                   "train.loss": 0.5 + 0.5,
                                   "train.h2d": 1.0})


def test_another_threads_spans_are_ignored():
    made = [(0.5, 9.5, "train.step", MAIN),
            (0.0, 10.0, "loader.build", OTHER),
            (3.0, 5.0, "loader.build", OTHER)]
    assert spans.caller_thread(made) == MAIN
    assert spans.idle_parts(KERNELS, made) == pytest.approx(
        {"train.step": _idle_total(KERNELS)})


def test_the_parts_and_unspanned_sum_to_the_idle_time():
    kernels = [(0.0, 0.1), (0.35, 0.4), (1.7, 2.2), (2.0, 2.05),
               (4.41, 4.9), (7.3, 10.0)]
    made = [(0.05, 2.5, "plbl.forward", MAIN), (2.6, 4.0, "plbl.next", MAIN),
            (4.2, 6.9, "plbl.save", MAIN), (4.3, 4.35, "plbl.k5", MAIN),
            (6.0, 9.9, "plbl.upload", MAIN)]
    parts = spans.idle_parts(kernels, made)
    assert set(parts) == {"plbl.forward", "plbl.next", "plbl.save",
                          "plbl.k5", "plbl.upload", spans.UNSPANNED}
    assert abs(sum(parts.values()) - _idle_total(kernels)) <= 1e-12


def test_a_gap_across_two_spans_is_split_at_the_boundary():
    made = [(0.0, 4.0, "train.forward", MAIN),
            (4.0, 10.0, "train.loss", MAIN)]
    parts = spans.idle_parts(KERNELS, made)
    # the gap [3, 5] is 1 s under each; [1, 2] and [6, 9] under one each
    assert parts == pytest.approx({"train.forward": 2.0, "train.loss": 4.0})


def test_readers_per_unit_and_nothing_to_read():
    ctx = {"prof_spans": [(s, e, "k") for s, e in KERNELS], "prof_steps": 2,
           "program_spans": [(0.5, 4.5, "train.step", MAIN),
                             (1.5, 3.5, "train.h2d", MAIN)],
           "span_totals": {"train.step": (4, 80_000_000, 20_000_000),
                           "train.h2d": (4, 8_000_000, 8_000_000)},
           "steps": 4}
    got = spans.metrics(ctx)
    assert got["train.host_ms_per_step"] == pytest.approx(20.0)
    assert got["train.h2d_host_ms_per_step"] == pytest.approx(2.0)
    assert got["device.idle_ms_per_step.h2d"] == pytest.approx(500.0)
    # train.step's own time (0.5 + 1.0 s) and the idle time after it
    # (0.5 + 3.0 s), over 2 steps
    assert got["device.idle_ms_per_step.unspanned"] == pytest.approx(
        (0.5 + 1.0 + 0.5 + 3.0) / 2 * 1e3)
    assert "device.idle_ms_per_step.loss" not in got  # no train.loss span
    assert "loss.host_ms_per_step" not in got
    assert spans.metrics({}) == {}
    assert spans.idle_by_span({}, "prof_steps") is None
    assert spans.host_ms({}, "train.step", "steps") is None


@pytest.mark.parametrize("name", ["city_stage1", "city_plbl"])
def test_span_run_reads_the_programs_spans_on_the_cpu(name, monkeypatch):
    w, cfg, mix, limits = bench_tiny.cell(name)
    state = {}
    span_run.install(state, monkeypatch.setattr)
    drv = train if mix["kind"] == "train" else plbl
    out = drv.run(w, cfg, mix, limits, SEED, 0.5, True, bench_tiny.CPU,
                  time.perf_counter())
    ctx = out["ctx"]
    got = span_run.summary(ctx)
    names = {n for _, _, n, _ in ctx["program_spans"]}
    if name == "city_stage1":
        assert {"train.step", "train.h2d", "train.forward", "train.loss",
                "train.backward", "train.optimizer"} <= names
        assert ctx["span_totals"]["train.step"][0] == ctx["steps"]
        # the CPU trace has no kernel: host metrics only
        assert set(got["span_metrics"]) == set(spans.HOST_MS_PER_STEP)
    else:
        assert {"plbl.next", "plbl.upload", "plbl.forward", "plbl.fetch",
                "plbl.save"} <= names
        assert ctx["span_totals"]["plbl.next"][0] == ctx["images"]
        assert got["span_metrics"] == {}
