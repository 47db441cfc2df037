"""Data parallelism across processes, one rank per card: the port of
mulactseg_tpu/parallel/mesh.py and of its users' sharding.

The JAX package shards every batch over a 1-D "data" mesh, replicates
the parameters and optimizer state, and lets XLA insert the psums. Here
each card is one process of a torch.distributed group (started by
torchrun, or by spawn below for the tests and chip_smoke.py), and the
collectives are written out:

- the weights are broadcast from rank 0 once (broadcast_state, called by
  make_train_step); every rank then takes the same optimizer step on the
  gradient SUMMED over the ranks (all_reduce_grads), because each rank's
  loss is its share of the global batch's loss: every batch-level
  normaliser is a global count (global_count; losses/), and the NaN
  guards read the global loss (global_isfinite). DDP would average,
  and divide the learning signal by the number of ranks. Group terms,
  prototypes and per-segment means stay per image: a segment never
  crosses ranks;
- BN statistics are global, the JAX package's choice (its mesh.py:10-24,
  MIGRATION.md:79-81): models/layers.FastBatchNorm all-reduces its
  [sum x, sum x^2] through all_reduce_sum, which is differentiable;
- dropout draws the global batch's mask on every rank and keeps its own
  rows (models/layers.Dropout);
- each rank loads only its rows of every global batch, in the one index
  order all ranks walk (data/loader.DataProvider(split="rows")).

So at a fixed global batch the results do not depend on the number of
ranks, as the JAX package's do not depend on its mesh size. Without a
process group every helper is the identity and launches nothing; in a
group of one rank every collective runs and is an identity.

The JAX package's height-sharded eval (its mesh.py:110-126) has no
counterpart: the port's evaluation gives whole batches to the ranks
(engine/evaluate.py).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from mulactseg_tpu_torch.device import local_rank


def init_distributed(backend=None, init_method=None, *, rank=None,
                     world=None, device="cuda") -> None:
    """Join the process group of this run. rank and world default to
    torchrun's RANK and WORLD_SIZE, init_method to env:// (MASTER_ADDR,
    MASTER_PORT). backend defaults to nccl for a CUDA device and gloo for
    the CPU; a caller may pass backend="gloo" for CUDA tensors (two ranks
    sharing one card, which nccl refuses). A CUDA rank runs on
    device's index, else on card LOCAL_RANK (device.local_rank)."""
    if active():
        raise RuntimeError("a process group is already up")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else local_rank())
        torch.cuda.set_device(dev)
        if backend == "nccl":  # binds the communicator to this card
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, **kw)


def init_from_env(device="cuda") -> None:
    """The CLIs' start: under torchrun (WORLD_SIZE > 1) join its group,
    unless one is up already."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not active():
        init_distributed(device=device)


def active() -> bool:
    """True inside a process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_main() -> bool:
    """Rank 0, the one that writes files and logs."""
    return rank() == 0


def local_rows(global_batch: int, rank_=None, world_=None) -> slice:
    """This rank's rows [r*B/W, (r+1)*B/W) of a global batch of B rows:
    the JAX package's shard_batch and global_batch_from_local contract."""
    r = rank() if rank_ is None else rank_
    w = world() if world_ is None else world_
    if global_batch % w:
        raise ValueError(f"batch {global_batch} not divisible by "
                         f"data-parallel width {w}")
    n = global_batch // w
    return slice(r * n, (r + 1) * n)


def pad_to_multiple(x, multiple: int):
    """Pad dim 0 up to a multiple by repeating the last row (the JAX
    package's mesh.py:68-78); numpy arrays or tensors. Returns (padded,
    original length)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])]), n
    x = np.asarray(x)
    return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)]), n


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks. Each rank's loss is its share of a
    sum over ranks, so dL/dx is the sum of the ranks' dL_r/dy: the
    backward is a SUM all-reduce too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks, differentiable; t itself without a
    group."""
    return _AllReduceSum.apply(t) if active() else t


def global_count(t: torch.Tensor) -> torch.Tensor:
    """A batch-level count summed over the ranks: detached, float64 (exact
    for any count). A loss's normaliser is 1 + global_count(n), not a sum
    of 1 + n over the ranks, so each rank's loss is its share of the
    global batch's. Without a group, t itself in float64."""
    return all_reduce_sum(t.detach().double())


def global_isfinite(x: torch.Tensor) -> torch.Tensor:
    """isfinite of x summed over the ranks (detached): where one rank's
    share of a loss is NaN, every rank sees the global loss as NaN, as
    one rank holding the whole batch would."""
    return torch.isfinite(all_reduce_sum(x.detach()))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated on dim 0, in rank
    order; not differentiable."""
    if not active():
        return t
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def barrier() -> None:
    if active():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's picklable `obj` on every rank (the others' is ignored);
    they wait here until rank 0 sends it."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def broadcast_state(model: torch.nn.Module) -> None:
    """Every parameter and buffer of `model` from rank 0, in place."""
    if not active():
        return
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, 0)


def all_reduce_grads(model: torch.nn.Module) -> None:
    """Sum the parameters' gradients over the ranks in one float32
    buffer laid out in model.parameters() order. A parameter without a
    gradient takes no part; the ranks run one graph, so it has none on
    any rank."""
    if not active():
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


# -- spawning ranks -----------------------------------------------------------
def _rank_main(fn, rank_, world_, backend, device, init_method, payload,
               out):
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(world_),
                      LOCAL_RANK=str(rank_))
    try:
        init_distributed(backend, init_method, device=device)
        result = pickle.dumps(fn(*pickle.loads(payload)))
    except BaseException:  # reported to the parent, which raises it
        out.put((rank_, False, traceback.format_exc()))
        return
    out.put((rank_, True, result))
    dist.destroy_process_group()


def spawn(fn, world_: int, backend: str, device, *args, timeout=120.0):
    """Run fn(*args) in `world_` new processes (the spawn start method),
    ranks 0.. of one group on `backend`, each process's device `device`
    (a CUDA device without an index takes card LOCAL_RANK = rank). fn must
    be importable from a module that imports no more than it needs. args
    and the results travel as plain pickles, by value: multiprocessing's
    own pickler would hand tensors over in shared memory, and the ranks
    would then update one copy of the weights. The group meets through a
    file store in a new temporary directory, so concurrent groups never
    race for a port.
    Returns the ranks' results in rank order. Raises RuntimeError with a
    rank's traceback when it fails or dies, TimeoutError when the ranks
    have not all finished after `timeout` seconds; every process is
    stopped before this returns or raises."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    payload = pickle.dumps(args)
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_, backend, device,
                                   init_method, payload, out))
                 for r in range(world_)]
        for p in procs:
            p.start()
        try:
            results = {}
            deadline = time.monotonic() + timeout
            while len(results) < world_:
                try:
                    r, ok, res = out.get(timeout=0.5)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if i not in results
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_} ranks of {fn.__name__} not done "
                            f"after {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {r} of {fn.__name__} "
                                       f"failed:\n{res}")
                results[r] = pickle.loads(res)
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
            return [results[r] for r in range(world_)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
            out.close()
