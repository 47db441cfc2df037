"""Named host spans at the port's layer boundaries.

`with span("train.forward"): ...` does two things:

- while torch.profiler records on the calling thread, it opens a
  `record_function` range of that name, so the profiler's trace (the
  benchmark's, and `cfg.profile`'s Chrome trace) carries the span on the
  kernels' clock;
- always, it adds the span to the process-wide table `TOTALS[name] =
  (count, total_ns, self_ns)`, timed with `time.perf_counter_ns`: self
  time is the duration less that of the span's child spans on the same
  thread.

`snapshot()` copies the table; the difference of two snapshots is what
ran in between. The table holds every thread's spans (the loader's too)
and is updated under a lock.

The spans and the layers they time:

  train.step, .h2d, .forward,     engine/train.make_train_step's step(),
  .loss, .backward, .optimizer    the caller's thread
  loader.next                     data/loader.DataProvider.__next__
  loader.build                    a batch's build and collate, on the
                                  provider's threads
  plbl.next, .upload, .forward,   plbl/generator.py, plbl/cosine_prop.py
  .softmax, .k5, .pass1,
  .threshold, .pass2, .fetch,
  .save
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import torch

TOTALS: Dict[str, Tuple[int, int, int]] = {}
_LOCK = threading.Lock()
_LOCAL = threading.local()


class span:
    """A context manager timing one named span (module docstring)."""

    __slots__ = ("name", "_range", "_t0", "_child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        stack.append(self)
        self._child_ns = 0
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = _LOCAL.stack
        stack.pop()
        if stack:
            stack[-1]._child_ns += ns
        with _LOCK:
            count, total, own = TOTALS.get(self.name, (0, 0, 0))
            TOTALS[self.name] = (count + 1, total + ns,
                                 own + ns - self._child_ns)
        return False


def snapshot() -> Dict[str, Tuple[int, int, int]]:
    """A copy of TOTALS: name -> (count, total_ns, self_ns)."""
    with _LOCK:
        return dict(TOTALS)
