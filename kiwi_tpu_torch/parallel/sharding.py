"""Multi-device SPMD for the inversion engine on torch.distributed (port of
kiwi_tpu/parallel/sharding.py).

The reference scales out with a pool of `minimizer` processes, splitting
the receiver set by epicentral distance and walking sources serially
(seismosizer.py:89-124).  The JAX package renders that as a 2-D mesh over
("s", "r") under one controller; here it is one process per device, the
ranks of a torch.distributed group laid out row-major over the same axes:

* axis "s" (sources): the batch axis, embarrassingly parallel.
  `sharded_forward` and `sharded_grad` (`Engine.global_misfits_and_grad(
  mesh=)`) split a batch over it; every rank holds the whole GF window and
  misfit context.
* axis "r" (receivers): distance-contiguous receiver groups, each rank
  holding only its group's GF window (parallel/gfshard.py).

Each rank computes its own rows on its own device; the only communication
is one gather of the per-row results (a few floats per row) through a gloo
group on host tensors, so that every rank returns the whole answer.  Gloo
and not NCCL: the rows are tiny, and NCCL refuses two ranks on one card.

Run under torchrun, one process per device (several may share a card):

    torchrun --nproc-per-node 4 script.py
    # in script.py:
    torch.distributed.init_process_group("gloo")
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    eng = Engine(store, device=dev)   # ... the same session on every rank
    mesh = make_mesh(n_sources=4, device=dev)
    misfits, norms, shifts = sharded_forward(eng, rows, mesh)

`spawn_ranks` starts such a group from Python (spawned processes, a
file:// rendezvous), for the tests and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (sources x receivers) mesh of ranks.

    shape: {"s": ns, "r": nr}; coords: this rank's {"s": i, "r": j}, rank
    = i * nr + j of the group; device: the torch device this rank computes
    on; group: the gloo process group of the host combine (None for a
    one-rank mesh, which runs no collective)."""

    shape: dict
    coords: dict
    device: torch.device
    group: object = None
    axis_names = ("s", "r")

    @property
    def size(self):
        return self.shape["s"] * self.shape["r"]

    def all_gather(self, block):
        """Every rank's f32 host block [..] stacked in rank order, [size, ..]:
        one torch.distributed.all_gather over the gloo group."""
        t = torch.from_numpy(np.ascontiguousarray(block, dtype=np.float32))
        if self.group is None:
            return t.numpy()[None]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out).numpy()


def make_mesh(n_sources=None, n_receivers=1, device=None):
    """The mesh over the ranks of the default process group (a 1 x 1 mesh
    when none is initialized).  device: this rank's device, by default
    cuda:(LOCAL_RANK mod the card count)."""
    if dist.is_available() and dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
    else:
        n, rank = 1, 0
    if n_sources is None:
        n_sources = n // n_receivers
    if n_sources * n_receivers != n:
        raise ValueError(f"mesh {n_sources}x{n_receivers} != {n} devices")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    group = None
    if n > 1:
        group = dist.group.WORLD if dist.get_backend() == "gloo" else dist.new_group(
            backend="gloo")
    return Mesh({"s": int(n_sources), "r": int(n_receivers)},
                {"s": rank // n_receivers, "r": rank % n_receivers}, torch.device(device),
                group)


def check_device(engine, mesh):
    """Raise unless the engine computes on the mesh's device."""
    a, b = torch.device(engine.device), mesh.device
    if a.type != b.type or (a.index or 0) != (b.index or 0):
        raise ValueError(f"engine on {a}, mesh rank on {b}: build the rank's engine on its "
                         "mesh device")


def source_block(mesh, rows, axis="s"):
    """(padded, lo, hi): rows [B, ...] padded with its last row to a multiple
    of the mesh's size along `axis`, and this rank's block padded[lo:hi]
    of it (all of them for axis None)."""
    ns = mesh.shape[axis] if axis else 1
    b = rows.shape[0]
    bl = -(-b // ns)
    padded = np.concatenate([rows, np.repeat(rows[-1:], bl * ns - b, axis=0)])
    i = mesh.coords[axis] if axis else 0
    return padded, i * bl, (i + 1) * bl


def gather_source_rows(mesh, outs, b):
    """The arrays outs (host, a leading axis over this rank's block, 4-byte
    items) of every "s" block, concatenated and cut to the batch's b rows,
    on every rank: one gather (the ranks along "r" hold replicas; those at
    r = 0 are taken)."""
    outs = [np.ascontiguousarray(o) for o in outs]
    if any(o.dtype.itemsize != 4 for o in outs):
        raise ValueError(f"gather_source_rows takes 4-byte items, got {[o.dtype for o in outs]}")
    bl = outs[0].shape[0]
    cols = [o.reshape(bl, -1).view(np.float32) for o in outs]
    every = mesh.all_gather(np.concatenate(cols, axis=1))  # [size, bl, W]
    nr = mesh.shape["r"]
    full = every[::nr].reshape(-1, every.shape[-1])[:b]
    res, off = [], 0
    for o, c in zip(outs, cols):
        w = c.shape[1]
        res.append(np.ascontiguousarray(full[:, off:off + w]).view(o.dtype)
                   .reshape((b,) + o.shape[1:]))
        off += w
    return tuple(res)


def sharded_forward(engine, params_batch, mesh):
    """(misfits f32[B, RC], norms f32[B, RC], floating shifts i32[B, R]),
    tensors on the engine's device, like Engine.misfits_for_source_batch,
    with the batch split over the mesh's "s" axis.

    Every rank plans the whole batch (padded with its last row to a
    multiple of the "s" size, as the JAX package pads), runs its own
    block through the plan's batch forward (the window kernel, or the plain
    synthesis where the kernel does not apply, then the scan kernel on
    unfiltered floating plans), and the rows are gathered and the pad rows
    cut off."""
    from ..profiling import to_device, to_host

    check_device(engine, mesh)
    pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
    padded, lo, hi = source_block(mesh, pb)
    plan, rows, moments, risetimes, fwd = engine._batch_plan(padded, shared=False)
    out = to_host(*engine._run_rows(plan, fwd, rows, moments, risetimes, lo, hi))
    return tuple(to_device(x, engine.device) for x in gather_source_rows(mesh, out, pb.shape[0]))


def sharded_grad(engine, params_batch, mesh):
    """Engine.global_misfits_and_grad(mesh=): (g f32[B], grad f32[B,
    nparams]) host arrays on every rank, with the rows split over the
    mesh's "s" axis.  Every rank plans the whole batch, differentiates its
    own block (padded with the last row to a multiple of the "s" size) on
    its device, and the rows are gathered (each row is independent of the
    others: no other collective)."""
    check_device(engine, mesh)
    pb = np.atleast_2d(np.asarray(params_batch, dtype=np.float32))
    padded, lo, hi = source_block(mesh, pb)
    return gather_source_rows(mesh, engine._values_and_grads(padded[lo:hi], plan_rows=pb),
                              pb.shape[0])


def _rank_main(rank, nranks, init_method, timeout, fn, args, results):
    dist.init_process_group("gloo", init_method=init_method, world_size=nranks, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, nranks, args=(), timeout=600.0):
    """fn(*args) in nranks spawned processes joined in one gloo group (a
    file:// rendezvous in a fresh temporary directory); their results, in
    rank order.  fn must be importable by name (a module-level function)
    and its result picklable.  A rank that raises or dies fails the call
    (its traceback is on its stderr) and the other ranks are terminated;
    so is a group that outlives `timeout` seconds."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="kiwi_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, nranks, init_method, timeout, fn, args, results))
             for rank in range(nranks)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < nranks:
            try:
                rank, res = results.get(timeout=1.0)
                out[rank] = res
                continue
            except queue_mod.Empty:
                pass
            failed = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode]
            if failed:
                raise RuntimeError(f"spawn_ranks: rank(s) failed (rank, exit code): {failed}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: {nranks} ranks still running after "
                                   f"{timeout} s")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawn_ranks: rank(s) failed (rank, exit code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[rank] for rank in range(nranks)]
