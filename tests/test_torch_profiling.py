"""The port's spans and counters (kiwi_tpu_torch.profiling) on the CPU.

With spans off, `span` hands out one shared no-op and a profile of an
engine call holds no `kiwi.` range.  With spans on, a point sweep and a
two-chunk grid search give the layer spans nested as the engine and the
grid search call each other.  The waits of the host for the card, counted
by site whatever the device, are pinned per call: a new wait on the
sweep's or the grid's path fails here.  torch_trace's Chrome trace holds
the spans.  Sessions: tests/test_torch_engine.py's point source on a 40 x 6
store and tests/test_torch_invert.py's finite fault on a 45 x 8 store, 4
`ned` receivers each, no JAX.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kiwi_tpu_torch import geo, profiling
from kiwi_tpu_torch.engine import Engine, Receiver
from kiwi_tpu_torch.gf import elseis
from kiwi_tpu_torch.gf.store import GFStore
from kiwi_tpu_torch.invert import MisfitGrid, Source

POINT = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0.0, 0.0, 0.0, 2500.0, 0.2],
                 np.float32)
FAULT = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0,
                  2500.0, 0.2], np.float32)
STRIKES = np.linspace(0.0, 350.0, 8).astype(np.float32)
BAND = ([0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0])
# a call on a built plan: the sweep copies its base row and values to the
# device; each grid chunk its rows, moments and rise times, and the grid
# its results back once
SWEEP_WAITS = {"syncs": 2, "h2d_pageable": 2}
GRID_WAITS = {"syncs": 7, "h2d_pageable": 6}
BATCH = ["kiwi.engine.prep", "kiwi.engine.plan", "kiwi.engine.prep",
         "kiwi.synth.discretize", "kiwi.synth.forward", "kiwi.misfit.eval"]


def _engine(nx, nz, source, distances, filtered=False):
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    s = elseis.build_ahfull_store(nx=nx, nz=nz, dt=0.1, dx=100.0, dz=100.0, firstx=100.0,
                                  firstz=0.0, material=(2300.0, 3200.0, 1600.0), stf=stf)
    eng = Engine(GFStore.from_numpy(s.dt, s.dx, s.dz, s.firstx, s.firstz, s.data, s.itmin,
                                    s.nsamples), device="cpu")
    olat, olon = 30.0, 70.0
    recs = []
    for i, d in enumerate(distances):
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d, 0.3 * i)
        recs.append(Receiver(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    eng.set_receivers(recs)
    eng.set_source_location(olat, olon)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    if filtered:
        eng.set_misfit_filter(None, *BAND)
    eng.set_source_params("bilateral", source)
    eng.set_floating_shiftrange(-0.3, 0.3)
    eng.set_misfit_method("floating_l1norm")
    eng.set_synthetic_reference()
    return eng


@pytest.fixture(scope="module")
def point():
    eng = _engine(40, 6, POINT, [1200.0, 1600.0, 2000.0, 2400.0])
    eng.sweep_global_misfits(POINT, 5, STRIKES)  # the plan
    return eng


@pytest.fixture(scope="module", params=["unfiltered", "band-pass"])
def fault(request):
    eng = _engine(45, 8, FAULT, [1500.0, 2300.0, 3100.0, 2700.0],
                  filtered=request.param == "band-pass")
    _grid().compute(eng)  # the plan
    return eng


def _grid():
    """6 models in chunks of 3: two engine batches."""
    return MisfitGrid(Source("bilateral", FAULT),
                      [("strike", np.array([80.0, 95.0, 110.0])), ("dip", np.array([60.0, 85.0]))])


def _node(k):
    """A fresh base row: the sweep's repeat memo serves none of them."""
    base = POINT.copy()
    base[6] = 70.0 + k
    return base


@pytest.fixture
def spans_on():
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()


def _kiwi_events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith("kiwi.")]


def _children(events, parent):
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e.cpu_parent is parent]


def _waits(fn):
    before = profiling.snapshot()
    fn()
    after = profiling.snapshot()
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("syncs", "h2d_pageable")}


def test_spans_off_cost_a_shared_noop(point):
    assert profiling.span("kiwi.engine.prep") is profiling.span("kiwi.misfit.eval")
    assert _kiwi_events(lambda: point.sweep_global_misfits(_node(1), 5, STRIKES)) == []


def test_sweep_spans_nest_by_layer(point, spans_on):
    events = _kiwi_events(lambda: point.sweep_global_misfits(_node(2), 5, STRIKES))
    (top,) = [e for e in events if e.cpu_parent is None]
    assert top.name == "kiwi.engine.sweep"
    assert _children(events, top) == [
        "kiwi.engine.prep", "kiwi.engine.plan", "kiwi.engine.prep", "kiwi.synth.discretize",
        "kiwi.synth.forward", "kiwi.misfit.eval", "kiwi.misfit.eval"]
    assert len(events) == 8  # no span below the layers' boundaries


def test_grid_spans_nest_by_layer(fault, spans_on):
    events = _kiwi_events(lambda: _grid().compute(fault, chunk=3))
    (top,) = [e for e in events if e.cpu_parent is None]
    assert top.name == "kiwi.invert.grid"
    assert _children(events, top) == ["kiwi.engine.batch"] * 2 + ["kiwi.invert.to_host"]
    for batch in (e for e in events if e.name == "kiwi.engine.batch"):
        assert _children(events, batch) == BATCH
    assert len(events) == 4 + 2 * len(BATCH)  # no span below the layers' boundaries


def test_sweep_waits_are_pinned(point):
    assert _waits(lambda: point.sweep_global_misfits(_node(3), 5, STRIKES)) == SWEEP_WAITS
    # the repeat memo skips the base row's copy
    assert _waits(lambda: point.sweep_global_misfits(_node(3), 5, STRIKES * 0.5)) == {
        "syncs": 1, "h2d_pageable": 1}


def test_grid_waits_are_pinned(fault):
    builds = fault.plan_builds
    assert _waits(lambda: _grid().compute(fault, chunk=3)) == GRID_WAITS
    assert fault.plan_builds == builds
    after = profiling.snapshot()
    assert {"launches.window_synth", "launches.scan_sums", "launches.eik_sweep"} <= set(after)


def test_a_plan_build_is_counted_and_spanned(point, spans_on):
    point._invalidate()
    builds = point.plan_builds
    events = _kiwi_events(lambda: point.sweep_global_misfits(_node(4), 5, STRIKES))
    (plan,) = [e for e in events if e.name == "kiwi.engine.plan"]
    assert _children(events, plan) == ["kiwi.engine.plan_build"]
    assert point.plan_builds == builds + 1


def test_torch_trace_holds_the_spans(point, tmp_path):
    with profiling.torch_trace(str(tmp_path)) as path:
        point.sweep_global_misfits(_node(5), 5, STRIKES)
    assert profiling.span("kiwi.engine.prep") is profiling.span("kiwi.misfit.eval")  # off again
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"kiwi.engine.sweep", "kiwi.synth.forward", "kiwi.misfit.eval"} <= names


def test_to_host_and_to_device_count_every_wait():
    x = np.arange(4, dtype=np.float32)
    assert _waits(lambda: profiling.to_device(x, "cpu")) == {"syncs": 1, "h2d_pageable": 1}
    t = torch.ones(3)
    assert _waits(lambda: profiling.to_host(t, t)) == {"syncs": 1, "h2d_pageable": 0}


# -- the eikonal discretization ---------------------------------------------------

EIK = np.array([0.0, 0.0, 0.0, 400.0, 1e12, 30.0, 80.0, 164.0, 0.0, 0.0, 150.0, 20.0, -10.0,
                0.9, 0.2], np.float32)
EIK_RADII = np.array([120.0, 135.0, 150.0, 165.0], np.float32)
EIK_SPANS = ["kiwi.synth.eik_prepare", "kiwi.synth.eik_solve", "kiwi.synth.eik_tables"]


@pytest.fixture
def eikonal():
    """A fresh eikonal session (tests/test_torch_eikonal.py's constraints at
    50 and 700 m) on the 45 x 8 store: its first grid compute calibrates."""
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    s = elseis.build_ahfull_store(nx=45, nz=8, dt=0.1, dx=100.0, dz=100.0, firstx=100.0,
                                  firstz=0.0, material=(2300.0, 3200.0, 1600.0), stf=stf)
    eng = Engine(GFStore.from_numpy(s.dt, s.dx, s.dz, s.firstx, s.firstz, s.data, s.itmin,
                                    s.nsamples), device="cpu")
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
    eng.set_source_params("eikonal", EIK)
    eng.set_floating_shiftrange(-0.3, 0.3)
    eng.set_misfit_method("floating_l1norm")
    eng.set_synthetic_reference()
    return eng


def _eik_grid():
    return MisfitGrid(Source("eikonal", EIK), [("bord-radius", EIK_RADII)])


def _counts(fn):
    before = profiling.snapshot()
    fn()
    after = profiling.snapshot()
    return {k: after.get(k, 0) - before.get(k, 0) for k in ("eik.host_solves", "eik.fine_cells")}


def test_eikonal_spans_nest_inside_discretize(eikonal, spans_on):
    """The first compute: prepare, the calibration's host solves, the solve,
    the tables, then the first-use cross-check; the second: no calibration."""
    for want in (EIK_SPANS[:1] + ["kiwi.synth.eik_calibrate"] + EIK_SPANS[1:]
                 + ["kiwi.synth.eik_calibrate"], EIK_SPANS):
        events = _kiwi_events(lambda: _eik_grid().compute(eikonal))
        (disc,) = [e for e in events if e.name == "kiwi.synth.discretize"]
        assert disc.cpu_parent.name == "kiwi.engine.batch"
        assert _children(events, disc) == want
        assert all(e.cpu_parent is disc for e in events if e.name.startswith("kiwi.synth.eik"))


def test_eikonal_counters(eikonal):
    """eik.fine_cells: the batch times its padded fine grid; eik.host_solves:
    the calibration's members (first, last, widest) and the cross-check's
    (those, the first and three drawn with the first check's seed), then
    none at the same shape."""
    from kiwi_tpu_torch.sources import eikonal as eiksrc

    static, _arrays = eiksrc.prepare_batch(
        eiksrc.named_params_batch("eikonal", _eik_grid().params), 0.1,
        eikonal.eikonal_context())
    cells = len(EIK_RADII) * static["NF"][0] * static["NF"][1]
    b = len(EIK_RADII)
    members = {0, b - 1, int(np.argmax(EIK_RADII))}
    checked = members | {int(i) for i in np.random.default_rng(1).choice(b, 3, replace=False)}
    assert _counts(lambda: _eik_grid().compute(eikonal)) == {
        "eik.host_solves": len(checked), "eik.fine_cells": cells}
    assert _counts(lambda: _eik_grid().compute(eikonal)) == {
        "eik.host_solves": 0, "eik.fine_cells": cells}
    # a single row runs the host pipeline: one host solve, no device grid
    assert _counts(lambda: eikonal.global_misfits_for_source_batch(EIK[None])) == {
        "eik.host_solves": 1, "eik.fine_cells": 0}


def test_eikonal_spans_off_cost_the_shared_noop(eikonal):
    _eik_grid().compute(eikonal)
    assert profiling.span("kiwi.synth.eik_solve") is profiling.span("kiwi.synth.eik_prepare")
    assert _kiwi_events(lambda: _eik_grid().compute(eikonal)) == []
