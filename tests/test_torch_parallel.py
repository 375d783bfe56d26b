"""Multi-device sharding of the port (kiwi_tpu_torch.parallel) against the
JAX package's (kiwi_tpu.parallel) on the CPU: tests/test_parallel.py's
40 x 6 fullspace store, 4 receivers and bilateral fault, both stores built
from the same numpy arrays.

The port's side runs in 4 spawned CPU ranks of one gloo group, started
once for the module (tests/torch_parallel_ranks.py, torch only: a rank
imports no JAX); every rank returns every case's results, and every rank
must hold the same.  The JAX package's side runs on the conftest's virtual
8-device CPU mesh, cut to 4 devices for the same mesh shapes.  Bars: the
reference's own (tests/test_parallel.py: rtol 2e-5 with atol 1e-8 for the
source-sharded forward, rtol 3e-5 with an absolute floor of 3e-5 of the
largest value for the distance shards), floating shifts exactly equal;
against the port's unsharded engine 1e-5 of the largest value; gradients
at tests/test_torch_gradient.py's bars.  In place of the reference's
pins on the compiled program's collectives, each rank counts its
torch.distributed calls: one gather per forward, none while planning.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from kiwi_tpu.engine import Engine as JEngine, Receiver as JReceiver
from kiwi_tpu.gf import elseis
from kiwi_tpu.parallel import gfshard as jgfshard, make_mesh as jmake_mesh
from kiwi_tpu.parallel import sharded_forward as jsharded_forward
from kiwi_tpu_torch import synth
from kiwi_tpu_torch.ops import synth_window
from kiwi_tpu_torch.parallel import gfshard, make_mesh, sharded_forward, spawn_ranks
from kiwi_tpu_torch.sources import get_source_model

NRANKS = 4


@pytest.fixture(scope="module")
def store_args():
    store = elseis.build_ahfull_store(**R.STORE, stf=R.STF)
    return (store.dt, store.dx, store.dz, store.firstx, store.firstz, store.data, store.itmin,
            store.nsamples)


@pytest.fixture(scope="module")
def ranks(store_args):
    return spawn_ranks(R.rank_cases, NRANKS, (store_args,), timeout=900.0)


@pytest.fixture(scope="module")
def res(ranks):
    return ranks[0]


@pytest.fixture(scope="module")
def jeng():
    store = elseis.build_ahfull_store(**R.STORE, stf=R.STF)
    return R.configure(JEngine(store), JReceiver)


@pytest.fixture
def teng(store_args):
    """The port's unsharded engine on the CPU, the session fresh."""
    return R.make_engine(store_args)


def jmesh(ns, nr):
    return jmake_mesh(n_sources=ns, n_receivers=nr, devices=jax.devices()[:ns * nr])


def close_sf(got, want):
    """tests/test_parallel.py's source-sharded bar."""
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-8)


def close_gf(got, want):
    """tests/test_parallel.py's distance-shard bar."""
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5 * float(np.abs(want).max()))


def close_port(got, want):
    """Against the port's unsharded engine: 1e-5 of the largest value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * max(float(np.abs(want).max()), 1e-30)


def unsharded(eng, pb):
    return tuple(np.asarray(x) for x in eng.misfits_for_source_batch(pb))


def check(got, jax_ref, port_ref, bar):
    """(m, n, shifts) against the JAX package's sharded result at its bar
    and the port's unsharded engine at 1e-5, shifts exactly equal."""
    for i in range(2):
        bar(got[i], np.asarray(jax_ref[i]))
        close_port(got[i], port_ref[i])
    np.testing.assert_array_equal(got[2], np.asarray(jax_ref[2]))
    np.testing.assert_array_equal(got[2], port_ref[2])


def test_every_rank_holds_the_same(ranks):
    assert [r["rank"] for r in ranks] == list(range(NRANKS))
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for other in ranks[1:]:
        for key, val in ranks[0].items():
            if key in ("rank", "coords", "gf_14_nxw", "gf_14_bytes"):
                continue
            for a, b in zip(val if isinstance(val, (tuple, list)) else [val],
                            other[key] if isinstance(val, (tuple, list)) else [other[key]]):
                if isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                else:
                    assert a == b, key


def test_sharded_matches_unsharded(res, jeng, teng):
    pb = R.BATCHES["sf"]
    want = unsharded(teng, pb)
    for key, (ns, nr), rows in (("sf_41", (4, 1), pb), ("sf_22", (2, 2), pb),
                                ("sf_41_10", (4, 1), pb[:10])):
        got = res[key]
        assert got[0].shape == (rows.shape[0], 12) and got[2].shape == (rows.shape[0], 4)
        check(got, jsharded_forward(jeng, rows, jmesh(ns, nr)),
              tuple(w[:rows.shape[0]] for w in want), close_sf)


def test_gf_distance_sharding_matches_unsharded(res, jeng, teng):
    pb = R.BATCHES["gf"]
    jplan = jgfshard.build_plan(jeng, jmesh(1, 4), axis="r")
    check(res["gf_14"], jplan.misfits(pb), unsharded(teng, pb), close_gf)
    nxw, full_nxw = res["gf_14_nxw"]
    assert nxw < full_nxw
    bytes_, full_bytes = res["gf_14_bytes"]
    assert 0 < bytes_ < full_bytes
    np.testing.assert_allclose(res["gf_14_gm"], jplan.global_misfits(pb), rtol=3e-5)
    close_port(res["gf_14_gm"], np.asarray(teng.global_misfits_for_source_batch(pb)))


def test_gf_distance_sharding_floating(res, jeng, teng):
    pb = R.BATCHES["float"]
    for eng in (jeng, teng):
        R.floating(eng, True)
    try:
        jplan = jgfshard.build_plan(jeng, jmesh(1, 4), axis="r")
        got, jref, tref = res["gf_float"], jplan.misfits(pb), unsharded(teng, pb)
    finally:
        R.floating(jeng, False)
    check(got, jref, tref, close_gf)
    assert np.abs(got[2]).max() > 0, "no row took a floating shift"


def test_gf_sharding_2d_sources_x_receivers(res, jeng, teng):
    pb = R.BATCHES["2d"]  # 7 rows over 2 source ranks: one pad row
    assert res["gf_22_axis"] == "s"
    jplan = jgfshard.build_plan(jeng, jmesh(2, 2), axis="r")
    assert jplan.source_axis == "s"
    check(res["gf_22_7"], jplan.misfits(pb), unsharded(teng, pb), close_gf)


def test_gfshard_rejects_out_of_coverage_batch(res, teng):
    m = res["cov_ok"][0]
    assert np.isfinite(m).all() and np.abs(m).max() > 0
    close_port(m, unsharded(teng, R.BATCHES["ok"])[0])
    for key in ("cov_far", "cov_late"):
        assert res[key] is not None and "coverage" in res[key], (key, res[key])
    assert "shard" in res["cov_far"] and "centroid times" in res["cov_late"]


def test_gfshard_picks_engine_formulation(res, jeng, teng, monkeypatch):
    pb = R.BATCHES["form"]
    assert res["form"][0], "sharded forward fell off the window kernel"
    assert res["form"][1] > 1, "sharded forward lost the grouped layout"
    monkeypatch.setenv("KIWI_WINDOW_INTERPRET", "1")
    jeng._invalidate()
    try:
        jplan = jgfshard.build_plan(jeng, jmesh(2, 2), axis="r")
        jref = jplan.misfits(pb)
        assert jplan.last_formulation.use_window
        assert res["form"][1] == jplan.last_formulation.group_size
    finally:
        jeng._invalidate()
    check(res["form_8"], jref, unsharded(teng, pb), close_gf)
    teng.misfits_for_source_batch(pb)
    assert teng._plan["formulation"] == "window"


def test_gfshard_shared_kinematics_branch(res, jeng, teng):
    pt = R.point_source()
    pb = R.sweep(8, 5, 0.0, 350.0, base=pt)
    assert get_source_model("bilateral").shared_kin_check(pb)
    assert len(res["shared_keys"]) == 1 and res["shared_keys"][0][2] is True, \
        "shared-kinematics branch not taken"
    for eng in (jeng, teng):
        eng.set_source_params("bilateral", pt)
        eng.set_synthetic_reference()
    try:
        jref = jgfshard.build_plan(jeng, jmesh(2, 2), axis="r").misfits(pb)
    finally:
        jeng.set_source_params("bilateral", R.BILAT)
        jeng.set_synthetic_reference()
    check(res["shared_8"], jref, unsharded(teng, pb), close_gf)


def test_forwards_gather_once_and_plan_without_collectives(res):
    """Each rank's torch.distributed calls: one gather per forward (the
    combine of the per-row misfits), none to build a distance-sharded plan."""
    assert res["calls_sf"] == {"all_gather": 1}
    assert res["calls_gf"] == {"all_gather": 1}
    assert res["calls_build"] == {}


def _scale(rows):
    rows = np.atleast_2d(np.asarray(rows, np.float64))
    norm = get_source_model("bilateral").norm.astype(np.float64)
    return np.where(rows != 0.0, np.abs(rows), 0.01 * norm)


def close_grad(got, want, rows):
    """tests/test_torch_gradient.py's bars: g at rtol 2e-5 with a floor of
    2e-5 of the largest; each gradient component on minimize_multistart's
    scale at 1e-4 of its row's largest."""
    g, grad = got
    g0, grad0 = want
    np.testing.assert_allclose(g, g0, rtol=2e-5, atol=2e-5 * float(np.abs(g0).max()))
    scale = _scale(rows)
    a, b = np.asarray(grad, np.float64) * scale, np.asarray(grad0, np.float64) * scale
    assert np.isfinite(a).all() and (np.abs(b).max(axis=1) > 0).all()
    assert (np.abs(a - b) <= 1e-4 * np.abs(b).max(axis=1, keepdims=True)).all()


@pytest.mark.parametrize("key,batch", [("grad_8", "grad"), ("grad_10", "grad10")])
def test_sharded_gradient_matches_unsharded(res, jeng, teng, key, batch):
    pb = R.BATCHES[batch]  # 10 rows over 4 source ranks: 2 pad rows
    got = res[key]
    assert got[0].shape == (pb.shape[0],) and got[1].shape == pb.shape
    close_grad(got, teng.global_misfits_and_grad(pb), pb)
    np.testing.assert_allclose(got[0], jeng.global_misfits_and_grad(pb, mesh=jmesh(4, 1))[0],
                               rtol=2e-5, atol=1e-8)


def test_sharded_multistart_matches_unsharded(res, teng):
    mask = np.isin(np.arange(R.BILAT.size), R.MULTISTART_FREE)
    rows, g, nsteps = res["multistart"]
    from kiwi_tpu_torch.invert import minimize_multistart

    rows0, g0, nsteps0 = minimize_multistart(teng, R.multistart_rows(), mask=mask, steps=3)
    assert nsteps == nsteps0 == 3
    np.testing.assert_allclose(g, g0, rtol=1e-4)
    np.testing.assert_allclose(rows, rows0, rtol=1e-5, atol=1e-4)


def test_shards_take_the_unsharded_statics(res, teng):
    """Where the port's engine differs from the reference's gfshard, the
    shards follow the port's engine: min_probe_length enters their probe
    span, and every shard's probe, static evaluation window and amplitude
    normalization are the unsharded plan's (the reference normalizes each
    shard by its own references, which can move a floating shift at a
    near-tie)."""
    shard_scale, full_scale = res["gf_14_amp_scale"]
    assert shard_scale == full_scale
    pb = R.BATCHES["gf"]
    shard_statics, full_statics = res["probe_st"]
    assert shard_statics == full_statics and shard_statics[2].pl >= 1024
    teng.min_probe_length = 1024
    close_port(res["probe_14"][0], unsharded(teng, pb)[0])
    assert teng._plan["st"] == shard_statics[2]


def test_partial_rows_land_as_unsharded(res, jeng, teng):
    """A receiver switched off (its rows 0) and an rc row without a
    reference land where the unsharded engine puts them, under a floating
    norm."""
    try:
        for eng in (jeng, teng):
            R.partial_references(eng)
            R.floating(eng, True)
        for key, (ns, nr), pb in (("partial_14", (1, 4), R.BATCHES["gf"]),
                                 ("partial_22", (2, 2), R.BATCHES["2d"])):
            got, tref = res[key], unsharded(teng, pb)
            check(got, jgfshard.build_plan(jeng, jmesh(ns, nr), axis="r").misfits(pb), tref,
                  close_gf)
            assert (got[0][:, 3 * R.OFF:3 * R.OFF + 3] == 0).all()
    finally:
        R.floating(jeng, False)
        R.configure(jeng, JReceiver)


def test_one_rank_mesh_runs_no_collective(teng):
    """Without a process group make_mesh gives a 1 x 1 mesh, and every
    entry point equals the unsharded engine bit for bit, calling no
    torch.distributed function."""
    mesh = make_mesh(device="cpu")
    assert mesh.group is None and mesh.shape == {"s": 1, "r": 1}
    pb = R.BATCHES["sf"][:6]
    want = unsharded(teng, pb)
    got, calls = R.count_calls(lambda: R.host(sharded_forward(teng, pb, mesh)))
    got2, calls2 = R.count_calls(lambda: gfshard.build_plan(teng, mesh).misfits(pb))
    g, calls3 = R.count_calls(lambda: teng.global_misfits_and_grad(pb, mesh=mesh))
    assert calls == calls2 == calls3 == {}
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got2, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(g, teng.global_misfits_and_grad(pb)):
        np.testing.assert_array_equal(a, b)


def test_make_mesh_rejects_a_shape_the_ranks_do_not_fill(teng):
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match=r"mesh 0x2 != 1 devices"):
        make_mesh(n_receivers=2, device="cpu")
    with pytest.raises(ValueError, match="mesh device"):
        sharded_forward(teng, R.BATCHES["sf"], make_mesh(device="meta"))


def test_partition_and_edge_extension_match_jax():
    rng = np.random.default_rng(7)

    class Geom:
        dist = rng.uniform(1e3, 5e4, 13)

    for n in (1, 2, 4, 5, 16):
        got, want = gfshard.partition_receivers(Geom, n), jgfshard.partition_receivers(Geom, n)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    data = rng.standard_normal((3, 4, 10, 20)).astype(np.float32)
    itmin = rng.integers(-5, 30, (3, 4, 10)).astype(np.int32)
    for e0, nt_ext in ((-8, 40), (3, 17), (25, 9)):
        cfg = synth.SynthConfig(dt=0.1, dx=1.0, dz=1.0, firstx=0.0, firstz=0.0, ng=10, nt=20,
                                ix0=0, nxw=3, iz0=0, nzw=4, out_it0=e0 + 5 + 4,
                                nt_out=nt_ext - 4, s_base=5, s_len=4)
        # the shards' windows are the engine's (synth.materialize_window)
        got = synth.materialize_window(torch.as_tensor(data), torch.as_tensor(itmin), cfg)
        np.testing.assert_array_equal(
            got.numpy(), jgfshard._edge_extend_host(data, itmin, e0, nt_ext))


@pytest.fixture(scope="module")
def long_store_args():
    """The 40 x 6 store sampled at 1 ms: the plan's extended time axis
    exceeds the window kernel's T_MAX (tests/test_torch_long_window.py)."""
    store = elseis.build_ahfull_store(**dict(R.STORE, dt=0.001), stf=R.STF)
    return (store.dt, store.dx, store.dz, store.firstx, store.firstz, store.data, store.itmin,
            store.nsamples)


@pytest.mark.parametrize("kind", ["finite", "point", "long"])
def test_choose_formulation_is_the_engine_choice(request, kind):
    """The engine's plans choose through synth.choose_formulation: the
    window kernel with the discretizer's groups where the config allows,
    else the plain synthesis with the values rows' grouping."""
    eng = R.make_engine(request.getfixturevalue(
        "long_store_args" if kind == "long" else "store_args"))
    p = R.point_source() if kind == "point" else R.BILAT
    eng.set_source_params("bilateral", p)
    eng.misfits_for_source_batch(np.tile(p, (2, 1)))
    plan = eng._plan
    cfg = plan["cfg"]
    ncent, gsize = eng._plan_key[4], eng._plan_key[5]
    form = synth.choose_formulation(cfg, ncent, gsize)
    if kind == "long":
        assert cfg.nt_out + cfg.s_len > synth_window.T_MAX
        assert plan["formulation"] == "plain" and not form.use_window
        return
    assert form.use_window and plan["formulation"] == "window"
    assert form.group_size == (gsize if ncent % gsize == 0 else 1)
    assert synth.choose_formulation(cfg, ncent + 1, gsize).group_size == (
        gsize if (ncent + 1) % gsize == 0 else 1)
