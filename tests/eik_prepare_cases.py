"""Seeded eikonal batches for the batch preparation's tests (no JAX: the
card tests import this too).

`case(name)` gives (model name, rows f32[B, ncols], EikonalContext, the
ValueError's message or None).  The contexts are the benchmark's
(kiwibench_eikonal: kiwi's default constraints, z >= 1,500 m and the
crust's bottom at 41,000 m, over the crust at 30 N, 70 E) and the same with
a third, oblique half-space.  The cases: the benchmark cell's 384 radii
(200-798 m about the kiwibench point solution), dips of 10-90 deg at
random strikes, radii on a 2.5 m grid (their boxes' extents are multiples
of the fine grid's 5 m in exact arithmetic, so the rounding of every
product decides the fine grid's size), shallow ruptures that the 1,500 m
constraint clips, the
oblique half-space clipping them too, mt_eikonal rows, and two batches
that the preparation refuses: one with a rupture wholly above 1,500 m (and
a nucleation point outside another: the empty area is reported first),
one with a nucleation point outside its rupture.

`session(device)` is tests/test_torch_profiling.py's eikonal session on a
45 x 8 store, for the engine's path; `session_batch()` its 4-row batch.
"""

import numpy as np

from kiwi_tpu_torch import geo, profiling
from kiwi_tpu_torch.engine import Engine, Receiver
from kiwi_tpu_torch.gf import elseis
from kiwi_tpu_torch.gf.store import GFStore
from kiwi_tpu_torch.sources import eikonal as eiksrc

EDT = 0.1
# kiwibench_eikonal's base row and crust
BASE = (0.0, 0.0, 0.0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 700.0, 100.0, 0.0, 0.9, 0.2)
DEPTHS = (1000.0, 3000.0, 18000.0, 32000.0, 41000.0)
VS = (1200.0, 2100.0, 3600.0, 3700.0, 4000.0, 4700.0)
DEFAULT = [(np.array([0.0, 0.0, 1500.0]), np.array([0.0, 0.0, -1.0])),
           (np.array([0.0, 0.0, 41000.0]), np.array([0.0, 0.0, 1.0]))]
OBLIQUE = DEFAULT + [(np.array([250.0, 0.0, 0.0]), np.array([1.0, 0.3, 0.0]))]
EMPTY = "Empty rupture area"
NUKL = "position of nucleation point is outside of rupture region"

# the eikonal model's columns
DEPTH, STRIKE, DIP, RAKE, BSX, BSY, RADIUS, NSX, NSY = 3, 5, 6, 7, 8, 9, 10, 11, 12
VARIED = {STRIKE: (0.0, 360.0), DIP: (10.0, 90.0), RAKE: (-180.0, 180.0),
          RADIUS: (200.0, 800.0), BSX: (-50.0, 50.0), BSY: (-50.0, 50.0),
          NSX: (-100.0, 100.0), NSY: (-100.0, 100.0)}

# name -> (B, {column: (low, high)} drawn per row over BASE, constraints)
CASES = {
    "radius_sweep": (384, {}, DEFAULT),
    "dips": (256, VARIED, DEFAULT),
    "radii_on_the_grid": (240, VARIED, DEFAULT),
    "shallow": (256, VARIED | {DEPTH: (1600.0, 2600.0), NSX: (-50.0, 50.0),
                               NSY: (-50.0, 50.0)}, DEFAULT),
    "oblique": (256, VARIED | {DEPTH: (1600.0, 6000.0), 1: (-400.0, 50.0), 2: (-200.0, 200.0),
                               NSX: (-50.0, 50.0), NSY: (-50.0, 50.0)}, OBLIQUE),
    "mt_eikonal": (128, VARIED | {DEPTH: (1600.0, 6000.0)}, OBLIQUE),
    "empty": (16, VARIED, DEFAULT),
    "nukl_outside": (16, VARIED, DEFAULT),
}


def context(constraints=DEFAULT):
    return eiksrc.EikonalContext(constraints=list(constraints), layer_depths=np.array(DEPTHS),
                                 layer_vs=np.array(VS))


def _mt_rows(rows, rng):
    """The eikonal rows' geometry in mt_eikonal's columns, random moment
    tensors."""
    out = np.zeros((rows.shape[0], 20), np.float32)
    out[:, :7] = rows[:, :7]
    out[:, 4] = 1.0
    out[:, 7:13] = rows[:, 8:14]
    out[:, 13:19] = rng.normal(0.0, 1e12, (rows.shape[0], 6))
    out[:, 19] = rows[:, 14]
    return out


def case(name, seed=0):
    """(model name, rows, context, error message or None) of case `name`."""
    B, ranges, constraints = CASES[name]
    rng = np.random.default_rng([seed, sum(name.encode())])
    rows = np.tile(np.asarray(BASE, np.float32), (B, 1))
    for col, (lo, hi) in ranges.items():
        rows[:, col] = rng.uniform(lo, hi, B)
    error = None
    if name == "radius_sweep":  # the cell's grid, moved by a seeded offset
        rows[:, RADIUS] = 200.0 + 1.5625 * np.arange(B) + rng.uniform(0.0, 1.5625)
    if name == "radii_on_the_grid":
        rows[:, RADIUS] = 200.0 + 2.5 * np.arange(B)
    if name == "empty":  # a gently dipping rupture at 600 m: wholly above 1,500 m
        rows[5, [DEPTH, DIP, RADIUS]] = (600.0, 10.0, 300.0)
        rows[9, NSX] = 1.2 * rows[9, RADIUS]
        error = EMPTY
    if name == "nukl_outside":
        rows[7, NSX] = 1.2 * rows[7, RADIUS]
        error = NUKL
    model = "eikonal"
    if name == "mt_eikonal":
        model, rows = "mt_eikonal", _mt_rows(rows, rng)
    return model, rows.astype(np.float32), context(constraints), error


def host_prepare(name, seed=0):
    """The plain version's (static, arrays) of case `name` (raises its
    ValueError)."""
    model, rows, ctx, _error = case(name, seed)
    return eiksrc._prepare_batch_vec(*eiksrc.named_params_batch(model, rows), EDT, ctx)


SESSION_ROW = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0, 0.0, 0.0, 150.0, 20.0,
                        -10.0, 0.9, 0.2], np.float32)
# a device discretization at a calibrated shape: one wait for the summary,
# 7 pageable copies of the discretizer's context
SESSION_WAITS = {"syncs": 8, "h2d_pageable": 7, "eik.host_prepares": 0}


def session(device):
    """An eikonal session (constraints at 50 and 700 m) on a 45 x 8 store,
    3 `ned` receivers, its own synthetic as the reference."""
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    s = elseis.build_ahfull_store(nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0,
                                  firstz=0.0, material=(2300.0, 3200.0, 1600.0), stf=stf)
    eng = Engine(GFStore.from_numpy(s.dt, s.dx, s.dz, s.firstx, s.firstz, s.data, s.itmin,
                                    s.nsamples), device=device)
    olat, olon = 30.0, 70.0
    recs = []
    for i, d in enumerate([1500.0, 2300.0, 3100.0]):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d, 0.3 * i)
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_constraints([[0, 0, 50.0], [0, 0, 700.0]], [[0, 0, -1.0], [0, 0, 1.0]])
    eng.set_source_params("eikonal", SESSION_ROW)
    eng.set_floating_shiftrange(-0.3, 0.3)
    eng.set_misfit_method("floating_l1norm")
    eng.set_synthetic_reference()
    return eng


def session_batch():
    batch = np.tile(SESSION_ROW, (4, 1))
    batch[:, 10] = [120.0, 135.0, 150.0, 165.0]
    return batch


def waits(fn):
    """The differences of SESSION_WAITS' counters around fn()."""
    before = profiling.snapshot()
    fn()
    after = profiling.snapshot()
    return {k: after.get(k, 0) - before.get(k, 0) for k in SESSION_WAITS}
