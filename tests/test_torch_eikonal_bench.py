"""The benchmark's eikonal cell (portbench: configs/kiwibench_eikonal.json,
drivers/eikonal_grid.py, reference/eikonal.py) against the port on the CPU.

* The reference's solve against the port's host fast marching
  (eikonal.fmm_solve) on seeded grids whose speed is constant inside a disc
  and half of it outside, as a rupture's within one crust layer, on cells
  of 4.5-5 m a side, as the cell's 5 m grids, solved together as one
  padded batch: 1e-9 relative (both solve the same upwind equations in
  float64).  kiwi's fast marching also takes a two-sided update that fails
  the upwind test; that happens where the speed jumps inside the rupture
  (a layer interface) or the cells are far from square, and there the two
  part by up to 2% of a time: not this cell's grids.
* The reference's centroid tables against the host pipeline
  (discretize_eikonal_host) and the device pipeline's plain version
  (discretize_device_batch on CPU tensors) on seeded rows at radii of
  30-80 m: the same cells (the coarse index in integers in all three),
  tolerances with their reasons at each comparison.
* The configuration's crust profile and constraints are the port's at its
  origin.
* The cell run on a small copy of the benchmark (portbench.tests.small: 3
  receivers, the 40 x 20 store) over 8 radii of 200-375 m: the program's
  global misfits within the cell's limit, the TF32 control and two planted
  faults (the rupture velocity 1% off in the device discretizer, the
  solve's times 0.1% off) outside it.
"""

import json
import os

import numpy as np
import pytest
import torch

from kiwi_tpu_torch import crust2x2
from kiwi_tpu_torch import eikonal as teik
from kiwi_tpu_torch.engine import Engine
from kiwi_tpu_torch.ops import eik_sweep
from kiwi_tpu_torch.sources import eikonal as eiksrc
from kiwi_tpu_torch.sources import get_source_model
from portbench import control, harness
from portbench.reference import eikonal as eikref
from portbench.tests import small

CELL = "eikonal.radius_sweep"
CFG = json.load(open(os.path.join(harness.HERE, "configs", "kiwibench_eikonal.json")))
EDT = CFG["effective_dt"]
SEED = 2 ** 31 + 11


def _engine_context():
    eng = Engine(None, device="cpu")
    eng.set_source_location(*CFG["origin"])
    return eng.eikonal_context()


def test_config_is_the_ports_crust_and_constraints():
    depths, _vp, vs, _rho = crust2x2.default_model().layers_at(*CFG["origin"])
    got_depths, got_vs = eikref.profile(CFG)
    np.testing.assert_array_equal(got_depths, depths)
    np.testing.assert_array_equal(got_vs, vs)
    eng = Engine(None, device="cpu")
    eng.set_source_location(*CFG["origin"])
    want = eng.source_constraints()
    got = eikref.constraints(CFG)
    assert len(got) == len(want) == 2
    for (gp, gn), (wp, wn) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gn, wn)


def _disc_grids(seed, n=5):
    """Seeded grids: sizes, near-square cells, a disc of constant speed with
    half of it outside (the last grid uniform), the nucleation inside."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        nx, ny = (int(v) for v in rng.integers(12, 48, 2))
        delta = rng.uniform(4.5, 5.0, 2)
        x, y = np.meshgrid((np.arange(nx) + 0.5) * delta[0], (np.arange(ny) + 0.5) * delta[1],
                           indexing="ij")
        c = rng.uniform(0.3, 0.7, 2) * [nx * delta[0], ny * delta[1]]
        r = rng.uniform(0.3, 0.6) * min(nx * delta[0], ny * delta[1])
        v = rng.uniform(1000.0, 4000.0)
        inside = np.hypot(x - c[0], y - c[1]) <= r if k < n - 1 else np.ones((nx, ny), bool)
        nukl = c + rng.uniform(-0.3, 0.3, 2) * r
        out.append((np.where(inside, v, 0.5 * v), delta, nukl))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_solve_matches_fmm(seed):
    cases = _disc_grids(seed)
    grids = [{"nd": np.array(sp.shape), "speed": torch.as_tensor(sp), "delta": d,
              "seed": [min(max(int(nk[k] / d[k]), 0), sp.shape[k] - 1) for k in range(2)]}
             for sp, d, nk in cases]
    for (sp, d, nk), got in zip(cases, eikref.solve(grids)):
        want = teik.fmm_solve(sp, d, np.zeros(2), nk)
        rel = np.abs(got.numpy() - want) / np.maximum(want, 1e-12)
        assert rel.max() <= 1e-9, (sp.shape, rel.max())


def _rows(seed, n=6):
    """Seeded rows of the cell's source at radii of 30-80 m."""
    rng = np.random.default_rng(seed)
    rows = np.tile(np.asarray(CFG["base"], np.float32), (n, 1))
    rows[:, 5] = rng.uniform(0.0, 360.0, n)
    rows[:, 6] = rng.uniform(30.0, 90.0, n)
    rows[:, 7] = rng.uniform(-180.0, 180.0, n)
    rows[:, 8:10] = rng.uniform(-10.0, 10.0, (n, 2))
    rows[:, 10] = rng.uniform(30.0, 80.0, n)
    ang = rng.uniform(0.0, 2.0 * np.pi, n)
    reach = rng.uniform(0.0, 0.5, n) * rows[:, 10]
    rows[:, 11], rows[:, 12] = reach * np.cos(ang), reach * np.sin(ang)
    rows[:, 13] = rng.uniform(0.6, 1.0, n)
    return rows


def _matched(want, got):
    """got's entries in the order of want's nearest ones (one to one)."""
    wp = np.stack([want["north"], want["east"], want["depth"]], -1)
    gp = np.stack([got["north"], got["east"], got["depth"]], -1)
    order = np.argmin(np.linalg.norm(wp[:, None] - gp[None], axis=-1), axis=1)
    assert sorted(order.tolist()) == list(range(len(gp)))
    return {k: np.asarray(got[k], np.float64)[order] for k in ("north", "east", "depth", "time",
                                                               "m")}


@pytest.mark.parametrize("seed", [4, 5])
def test_reference_tables_match_host_and_device(seed):
    rows = _rows(seed)
    ctx = _engine_context()
    depths, vs = eikref.profile(CFG)
    refs = eikref.centroid_tables(rows, EDT, depths, vs, eikref.constraints(CFG))
    model = get_source_model("eikonal")
    static, arrays = eiksrc.prepare_batch(eiksrc.named_params_batch("eikonal", rows), EDT, ctx)
    dev = eiksrc.discretize_device_batch(static, arrays, EDT, ctx, nt_cell_max=2, device="cpu")
    assert not dev["overflow"].any()
    for i, (p, ref) in enumerate(zip(rows, refs)):
        host = model.discretize(p, EDT, ctx)
        act = dev["active"][i].numpy()
        devi = {k: dev[k][i].numpy()[act] for k in ("north", "east", "depth", "time", "m")}
        # the same cells (and one time cell each) in all three
        assert len(ref["north"]) == len(host["north"]) == int(act.sum()) >= 2
        scale = np.abs(ref["m"]).max()
        # host: the same float64 pipeline, each table rounded to float32
        # once: one float32 ulp apart at most
        h = _matched(ref, host)
        for k in ("north", "east", "depth"):
            np.testing.assert_allclose(h[k], ref[k], rtol=1.2e-7, atol=0, err_msg=k)
        np.testing.assert_allclose(h["time"], ref["time"], rtol=1.2e-7, atol=1e-9)
        np.testing.assert_allclose(h["m"], ref["m"], rtol=0, atol=2.4e-7 * scale)
        # device: float32 throughout -- points near 5,000 m deep carry 4.9e-4
        # m a rounding and their cell means sum hundreds of them; the
        # solve's times, their means and the centre time round at 1e-7 s
        d = _matched(ref, devi)
        for k in ("north", "east", "depth"):
            np.testing.assert_allclose(d[k], ref[k], rtol=0, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(d["time"], ref["time"], rtol=0, atol=2e-6)
        # the weights: exact counts over the rupture's fine cells, one
        # float32 division and the moment tensor's float32 products
        np.testing.assert_allclose(d["m"], ref["m"], rtol=0, atol=1e-6 * scale)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A small copy of the benchmark whose cell searches 8 radii of 200-375 m
    (small.make_root puts a strike x dip x slip-rake grid in every mix)."""
    root = small.make_root(tmp_path_factory.mktemp("portbench"))
    path = os.path.join(root, "portbench", "traffic", "eikonal_radius.json")
    mix = json.load(open(path))
    mix["grid"] = {"bord-radius": [200.0, 400.0, 25.0]}
    mix["sample"] = {"calls": 1, "rows": 6}
    json.dump(mix, open(path, "w"))
    return root


@pytest.fixture(scope="module")
def readings(root):
    cell = harness.Cell(CELL, root=root)
    program, ctl, _calls = control.readings(cell, SEED, 0.1, device="cpu", store=small.store())
    return cell.limits, program, ctl


def test_program_is_within_the_limit(readings):
    limits, program, _ctl = readings
    assert set(program) == set(limits) == {"max_gap"}
    assert program["max_gap"] <= limits["max_gap"]


def test_the_tf32_control_is_outside_the_limit(readings):
    limits, _program, ctl = readings
    assert ctl["max_gap"] > limits["max_gap"]


def _relv_off(orig):
    def broken(static, arrays, *args, **kwargs):
        arrays = dict(arrays, relv=arrays["relv"] * 1.01)
        return orig(static, arrays, *args, **kwargs)
    return broken


def _times_off(orig):
    def broken(*args, **kwargs):
        return orig(*args, **kwargs) * 1.001
    return broken


@pytest.mark.parametrize("fault", ["relv_off", "times_off"])
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    if fault == "relv_off":
        monkeypatch.setattr(eiksrc, "discretize_device_batch",
                            _relv_off(eiksrc.discretize_device_batch))
    else:
        monkeypatch.setattr(eik_sweep, "sweep_solve_batch",
                            _times_off(eik_sweep.sweep_solve_batch))
    result, run = small.run_cell(root, CELL, seed=SEED, seconds=0.1)
    assert not result["correct"], result
    assert all(r["eik.host_solves"] == 0 for r in run.records)  # no fallback answered


def test_eik_sweep_work_counts():
    """portbench/kernels/eik_sweep.py: 27 float operations a cell update, 4
    directions a round; the speeds read and the times written once, the
    deltas and seeds beside them."""
    k = harness.load_module(os.path.join(harness.HERE, "kernels", "eik_sweep.py"), "k_eik")
    speed, two = torch.zeros(3, 5, 4), torch.zeros(3, 2)
    assert k.work((speed, two, two, two), {"n_rounds": 2}) == (27 * 60 * 8, 4 * (120 + 12))
    assert k.work((speed, two, two, two, 1), {}) == (27 * 60 * 4, 4 * (120 + 12))
    assert k.key((speed, two, two, two), {"n_rounds": 2}) == (3, 5, 4, 2)


class _Run:
    def __init__(self, records):
        self.records = records

    def field(self, key):
        return [r[key] for r in self.records if key in r]


@pytest.mark.parametrize("metric,want", [("eik_host_solves_per_call", 0.5),
                                         ("eik_fine_cells_per_model", 100.0)])
def test_counter_metrics(metric, want):
    """The readers average what the driver recorded and read nothing from a
    program without the counters."""
    m = harness.load_module(os.path.join(harness.HERE, "metrics", metric + ".py"), metric)
    recs = [{"units": 4, "eik.host_solves": 1, "eik.fine_cells": 400},
            {"units": 4, "eik.host_solves": 0, "eik.fine_cells": 400}]
    assert m.read(_Run(recs)) == want
    assert m.read(_Run([{"units": 4}])) is None
