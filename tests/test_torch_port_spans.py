"""The port's span helper (utils/spans.py) and the spans at its layer
boundaries, on the CPU.

- The helper: a span's self time is its duration less its child spans'
  on the same thread (a fake clock: 10 ms with a 4 ms child reads 6 ms);
  spans on two threads do not nest; 4 threads x 10,000 spans count
  exactly 40,000 under a short switch interval; a span closes when its
  body raises; under torch.profiler each span is an event of its name.
- The train step at test_torch_port_rounds.py's tiny fixture: under the
  profiler each train.step holds train.h2d, train.forward, train.loss,
  train.backward and train.optimizer, in that order and each once.
- DataProvider: loader.next on the caller's thread and loader.build on
  the provider's threads, with items built on threads and in worker
  processes.
- PseudoLabelGenerator.generate on a cosine type: plbl.next, plbl.upload
  and the 8 spans the benchmark reads, once an image each.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.data import loader as loader_mod
from mulactseg_tpu_torch.data.loader import DataProvider, shutdown_workers
from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
from mulactseg_tpu_torch.engine.train import make_train_step
from mulactseg_tpu_torch.models import convert
from mulactseg_tpu_torch.plbl import PseudoLabelGenerator
from mulactseg_tpu_torch.utils import spans
from mulactseg_tpu_torch.utils.spans import span
from tests import torch_port_parallel_ranks as ranks
from tests.test_torch_port_rounds import HH, NSEG, _cfg_kw, _port_twin

torch.set_num_threads(1)

TRAIN_CHILDREN = ["train.h2d", "train.forward", "train.loss",
                  "train.backward", "train.optimizer"]
PLBL_SPANS = ["plbl.next", "plbl.forward", "plbl.softmax", "plbl.upload",
              "plbl.k5", "plbl.pass1", "plbl.threshold", "plbl.pass2",
              "plbl.fetch", "plbl.save"]


def _delta(before, name):
    """(count, total_ns, self_ns) of `name` since the snapshot `before`."""
    now = spans.snapshot().get(name, (0, 0, 0))
    was = before.get(name, (0, 0, 0))
    return tuple(a - b for a, b in zip(now, was))


class _Clock:
    """perf_counter_ns that moves only when told."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        return self.ns


def test_self_time_is_the_duration_less_the_child_spans(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(spans, "time", clock)
    before = spans.snapshot()
    with span("t.outer"):
        clock.ns += 3_000_000
        with span("t.child"):
            clock.ns += 4_000_000
        clock.ns += 3_000_000
    assert _delta(before, "t.outer") == (1, 10_000_000, 6_000_000)
    assert _delta(before, "t.child") == (1, 4_000_000, 4_000_000)


def test_spans_on_two_threads_do_not_nest():
    before = spans.snapshot()
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        with span("t.other"):
            pass
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with span("t.main"):
        inside.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    count, total, own = _delta(before, "t.main")
    assert count == 1 and own == total  # t.other is not its child
    assert _delta(before, "t.other")[0] == 1


def test_four_threads_count_every_span():
    before = spans.snapshot()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(10_000):
                with span("t.stress"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    count, total, own = _delta(before, "t.stress")
    assert count == 40_000 and own == total


def _events(prof, prefix):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def test_a_span_closes_when_its_body_raises():
    before = spans.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with span("t.outer"):
                with span("t.raises"):
                    raise ValueError("body")
    assert _delta(before, "t.raises")[0] == 1
    assert _delta(before, "t.outer")[0] == 1
    assert spans._LOCAL.stack == []  # nothing left open on this thread
    assert sorted(e.name for e in _events(prof, "t.")) == [
        "t.outer", "t.raises"]


def test_each_span_is_a_profiler_event_of_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.a"):
            with span("t.b"):
                torch.ones(3).sum()
        with span("t.a"):
            pass
    got = sorted(e.name for e in _events(prof, "t."))
    assert got == ["t.a", "t.a", "t.b"]
    a = min((e for e in _events(prof, "t.a")),
            key=lambda e: e.time_range.start)
    b = _events(prof, "t.b")[0]
    assert a.time_range.start <= b.time_range.start
    assert b.time_range.end <= a.time_range.end


def _label_set(n=6):
    return SyntheticRegionDataset(n_images=n, H=HH, W=HH,
                                  num_classes=ranks.NC - 1, nseg=NSEG,
                                  split="active-label", seed=1)


def _children(events, parent, names):
    """The names of `names`' events inside `parent`'s range on its thread,
    in the order they began."""
    inner = [e for e in events if e.name in names
             and e.thread == parent.thread
             and parent.time_range.start <= e.time_range.start
             and e.time_range.end <= parent.time_range.end]
    return [e.name for e in sorted(inner, key=lambda e: e.time_range.start)]


def test_train_step_holds_its_five_spans_in_order(tmp_path):
    model = _port_twin(convert.random_variables(ranks.port_twin(True), 9))
    step = make_train_step(model, Config(**_cfg_kw(tmp_path)), device="cpu")
    loader = DataProvider(_label_set(), 4, num_workers=1, seed=0)
    try:
        batches = [next(loader) for _ in range(2)]
    finally:
        loader.close()
    before = spans.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            step(b)
    events = _events(prof, "train.")
    steps = [e for e in events if e.name == "train.step"]
    assert len(steps) == 2
    for s in steps:
        assert _children(events, s, TRAIN_CHILDREN) == TRAIN_CHILDREN
    for name in ["train.step"] + TRAIN_CHILDREN:
        count, total, own = _delta(before, name)
        assert count == 2 and 0 < own <= total, name
    count, total, own = _delta(before, "train.step")
    assert own < total  # its children's time is not its own


@pytest.mark.parametrize("processes", [False, True])
def test_loader_spans_and_their_threads(monkeypatch, processes):
    seen = []

    class Recorded(span):
        __slots__ = ()

        def __enter__(self):
            seen.append((self.name, threading.get_ident()))
            return super().__enter__()

    monkeypatch.setattr(loader_mod, "span", Recorded)
    data = _label_set()
    if processes:
        data = ranks.FilesLike(data)
    before = spans.snapshot()
    loader = DataProvider(data, 2, num_workers=2, seed=0,
                          processes=processes)
    try:
        for _ in range(3):
            batch = next(loader)
            assert batch["images"].shape[0] == 2
    finally:
        loader.close()
        if processes:
            shutdown_workers()
    me = threading.get_ident()
    nexts = [t for n, t in seen if n == "loader.next"]
    builds = [t for n, t in seen if n == "loader.build"]
    assert nexts == [me] * 3
    assert len(builds) >= 3 and me not in builds
    assert _delta(before, "loader.next")[0] == 3
    assert _delta(before, "loader.build")[0] == len(builds)


def test_plbl_spans_once_an_image():
    model = ranks.port_twin(False)
    convert.load_variables(model, convert.random_variables(model, 7))
    model.eval()
    ds = SyntheticRegionDataset(n_images=3, H=32, W=32,
                                num_classes=ranks.NC - 1, nseg=16,
                                split="active-label", seed=3)
    rng = np.random.RandomState(6)
    batches = []
    for i in range(3):
        s = ds[i]
        spmask = np.isin(s["spx"], np.nonzero(rng.rand(16) < 0.6)[0])
        batches.append({"images": rng.randint(0, 256, (1, 3, 32, 32)
                                              ).astype(np.uint8),
                        "labels": s["labels"][None],
                        "target": s["target"][None], "spx": s["spx"][None],
                        "spmask": spmask[None], "fnames": [s["fnames"]]})
    gen = PseudoLabelGenerator(model, Config(num_classes=ranks.NC - 1,
                                             nseg=16, dtype="float32"),
                               "cosprop_includeonehot", max_protos=64,
                               device="cpu")
    before = spans.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen.generate(None, batches, suppix=ds.suppix)
    got = [e.name for e in _events(prof, "plbl.")]
    for name in PLBL_SPANS:
        assert got.count(name) == 3, name
        assert _delta(before, name)[0] == 3, name
