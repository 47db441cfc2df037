"""The harness on the CPU: its arithmetic on hand-made spans and one
convolution of known FLOPs, BENCHMARK.json against its required shape,
every cell's files found by name, the run refused without a card, and the
import check."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_tiny
from benchmark import common, gen, readers, run, yardstick
from benchmark.loops import plbl

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_span_union_gaps_and_idle_share():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (6.0, 7.0)]
    assert yardstick.union(spans) == pytest.approx(4.0)
    assert yardstick.gaps(spans, 0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0),
                                               (7.0, 8.0)]
    # 4 s busy over 2 traced steps; the unprofiled window 10 s for 4 steps
    ctx = {"prof_busy_s": 4.0, "prof_steps": 2, "steps": 4, "window_s": 10.0}
    assert readers.idle_share(ctx) == pytest.approx(20.0)
    assert readers.idle_share({}) is None


def test_p95_counts_every_step():
    ms = list(range(1, 201))  # 200 steps: the 190th value, ten beyond it
    assert yardstick.percentile(ms, 95) == 190
    read = run.reader("train.step_ms_p95")
    assert read({"step_ms": ms}) == 190
    assert read({}) is None


def test_loss_kernel_bounds_on_a_made_batch():
    # two images of 2x2 pixels, C = 3, S = 2: pixel bits and ids by hand
    bits = np.array([[[1, 3], [0, 6]], [[2, 0], [7, 1]]], np.int32)
    spx = np.array([[[0, 0], [1, 1]], [[0, 1], [1, 1]]], np.int32)
    target = np.array([[[1, 1, 0], [0, 1, 1]], [[0, 1, 0], [1, 1, 1]]],
                      np.float32)
    b = yardstick.loss_kernel_bounds(bits, spx, target, 3)
    P, row = 8, 12
    n_live, n_valid, entries = 6, 3, 2 + 2 + 3  # multi-hot: 3, 6 / 7
    bw = yardstick.HBM_BYTES_PER_S
    assert b["pixel_ce_fwd"] == pytest.approx(
        max((P * 4 + n_live * row + 16) / bw,
            8 * n_live * 3 / yardstick.F32_OPS_PER_S))
    assert b["ssm_fwd"] == pytest.approx(
        (P * 4 + n_valid * row + 4 * 3 * 8) / bw)
    assert b["ssm_bwd"] == pytest.approx(
        (P * row + 3 * 4 * 3 * 4 + entries * row) / bw)


def test_roofline_reader_checks_launches():
    spans = [(0.0, 2e-6, "pixel_ce_fwd_kernel<20>"),
             (2e-6, 4e-6, "pixel_ce_bwd_kernel<20>"),
             (4e-6, 5e-6, "ssm_span_kernel"), (5e-6, 6e-6, "ssm_decode_kernel"),
             (6e-6, 8e-6, "ssm_bwd_kernel"), (8e-6, 9e-6, "void elementwise")]
    ctx = {"prof_spans": spans, "prof_steps": 1,
           "launches": {"pixel_ce_fwd": 1, "pixel_ce_bwd": 1, "ssm_fwd": 1,
                        "ssm_bwd": 1},
           "loss_bounds": {"pixel_ce_fwd": 1e-6, "pixel_ce_bwd": 1e-6,
                           "ssm_fwd": 1e-6, "ssm_bwd": 1e-6}}
    assert run.reader("loss_kernels.roofline")(ctx) == pytest.approx(50.0)
    assert run.reader("loss.kernel_ms_per_step")(ctx) == pytest.approx(8e-3)
    ctx["launches"]["ssm_bwd"] = 2  # a launch the trace lost
    assert run.reader("loss_kernels.roofline")(ctx) is None
    assert run.reader("loss.kernel_ms_per_step")(ctx) is None


def test_kinds():
    assert yardstick.kind_of("sm90_xmma_fprop_implicit_gemm_bf16") == "conv"
    assert yardstick.kind_of("void at::native::elementwise_kernel") == \
        "norm_eltwise"
    assert yardstick.kind_of("pixel_ce_bwd_kernel") == "loss"
    assert yardstick.kind_of("multi_tensor_apply_kernel") == "optimizer"


@pytest.mark.parametrize("groups,input_grad", [(1, True), (8, True),
                                               (8, False), (2, True)])
def test_mfu_from_a_conv_of_known_flops(groups, input_grad):
    from benchmark.loops import train

    with torch.device("meta"):
        conv = torch.nn.Conv2d(8, 16, 3, padding=1, bias=False,
                               groups=groups)
        x = torch.empty(2, 8, 10, 10, requires_grad=input_grad)
        flops = train.flops_of(conv, x)
    fwd = 2 * 2 * 16 * (8 // groups) * 9 * 10 * 10
    # forward, weight gradient, and the input's where it asks for one
    assert flops == (3 if input_grad else 2) * fwd
    ctx = {"flops_per_step": flops, "window_s": 2.0, "steps": 4}
    mfu = run.reader("train.mfu")(ctx)
    assert mfu == pytest.approx(flops / 0.5 / 989e12 * 100)


def test_step_flops_counts_the_recipe_network():
    _, cfg, _, _ = bench_tiny.cell("city_stage1")
    from benchmark.loops import train

    a = train.step_flops(cfg)
    cfg["batch"] *= 2
    assert train.step_flops(cfg) == pytest.approx(2 * a, rel=1e-3)


def test_benchmark_json_shape():
    b = bench_tiny.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "benchmark/run.py"
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    configs = [c["name"] for c in b["configs"]]
    for names in (cells, metrics, configs):
        assert len(names) == len(set(names))
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(w in cells for w in m.get("workloads", []))
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        # every cell the metric names reports the metric it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:  # each cell: setup_s, another end-to-end, a per-layer
        assert sum(w in m.get("workloads", cells)
                   for m in b["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_finds_its_files_by_name():
    b = bench_tiny.bench()
    kinds = os.listdir(os.path.join(bench_tiny.ROOT, "benchmark", "loops"))
    for w in b["workloads"]:
        cfg = bench_tiny.load("configs", w["config"])
        mix = bench_tiny.load("traffic", w["traffic"])
        limits = bench_tiny.load("limits", w["name"])["limits"]
        assert f"{mix['kind']}.py" in kinds and limits
        assert mix["rate"] in {m["name"] for m in b["end_to_end"]}
        assert cfg["name"] == w["config"]
    for m in b["per_layer"]:
        read = run.reader(m["name"])
        assert read({}) is None  # nothing to read: no number, never 0


@pytest.mark.parametrize("name", ["city_stage1", "voc_stage1", "city_plbl"])
def test_items_are_made_from_the_seed(name):
    _, cfg, mix, _ = bench_tiny.cell(name)
    a = gen.make_items(2 ** 31 + 17, cfg, mix)
    b = gen.make_items(2 ** 31 + 17, cfg, mix)
    c = gen.make_items(5, cfg, mix)
    if mix["kind"] == "plbl":
        a, b, c = ([{"image": s.image, "spx": s.spx} for s in x]
                   for x in (a, b, c))
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not all(np.array_equal(x[k], y[k])
                   for x, y in zip(a, c) for k in x)
    for it in a:  # the same sizes whatever the seed
        assert all(it[k].shape == c[0][k].shape for k in it)


def test_pool_batches_find_every_row_in_the_pool():
    from benchmark.loops import train
    from mulactseg_tpu_torch.data.loader import collate

    _, cfg, mix, _ = bench_tiny.cell("city_stage1")
    items = gen.make_items(2 ** 31 + 3, cfg, mix)
    batches = [collate([items[5], items[2]]), collate([items[7], items[0]])]
    got, bad = train.pool_batches(batches, items)
    assert bad == 0
    assert all(train.same(g[k], b[k]) for g, b in zip(got, batches)
               for k in items[0])
    rep = [batches[0], collate([items[2], items[1]])]  # a row repeated
    assert train.pool_batches(rep, items)[1] == 1
    cast = collate([items[5], items[2]])
    cast["target_bits"] = cast["target_bits"].astype(np.int64)
    assert train.pool_batches([cast], items)[1] == 2


def test_plbl_sample_takes_one_image_of_each_source():
    rng = np.random.RandomState(4)
    pick = plbl.sample(rng, 50, 8, 8)
    assert len(pick) == 8 and sorted({j % 8 for j in pick}) == list(range(8))
    assert plbl.sample(rng, 5, 8, 8) == [0, 1, 2, 3, 4]
    assert plbl.pooled_gap([[1, 10], [3, 30]]) == pytest.approx(0.1)
    got = np.array([[0, 1, 255], [255, 255, 2]], np.uint8)
    want = np.array([[0, 2, 255], [3, 255, 255]], np.uint8)
    assert plbl.map_counts(got, want) == [3, 4]


def test_png_reader_takes_every_row_filter(tmp_path):
    from mulactseg_tpu_torch.utils.png import write_gray8

    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, size=(5, 7)).astype(np.uint8)
    p = str(tmp_path / "a.png")
    write_gray8(p, img)
    assert np.array_equal(plbl.read_png_gray8(p), img)
    # the same rows written with the Sub, Up, Average and Paeth filters
    import struct
    import zlib

    rows, prev = [], np.zeros(7, np.int64)
    for y in range(5):
        f = y % 4 + 1
        cur = img[y].astype(np.int64)
        left = np.concatenate([[0], cur[:-1]])
        ul = np.concatenate([[0], prev[:-1]])
        if f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p_ = left + prev - ul
            pa, pb, pc = abs(p_ - left), abs(p_ - prev), abs(p_ - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8)
                    .tobytes())
        prev = cur

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    q = tmp_path / "b.png"
    q.write_bytes(data)
    assert np.array_equal(plbl.read_png_gray8(str(q)), img)


def test_run_without_a_card_exits_nonzero_and_prints_no_metric():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "city_stage1",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=bench_tiny.ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert "metrics" not in p.stdout and p.stdout.strip() == ""


def test_import_check_compares_top_level_names_whole():
    assert run.forbidden_modules({"mulactseg_tpu_torch.ops": 0,
                                  "numpy": 0, "jaxtyping": 0}) == []
    assert run.forbidden_modules({"mulactseg_tpu.engine": 0}) == [
        "mulactseg_tpu"]
    assert run.forbidden_modules({"jax.numpy": 0, "optax": 0}) == [
        "jax", "optax"]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(bench_tiny.ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            src = open(os.path.join(ref, f)).read()
            assert not re.search(r"^\s*(from|import)\s+(mulactseg_tpu|jax|"
                                 r"flax|optax)", src, re.M), f


def test_judge():
    ok, checks = common.judge({"a": 0.1, "b": 2.0}, {"a": 0.2, "b": 1.0})
    assert not ok and checks["a"] == {"value": 0.1, "limit": 0.2}
    assert common.judge({"a": float("nan")}, {"a": 1.0})[0] is False
    assert common.judge({"a": 0.1}, {"a": 0.2})[0] is True
