"""The rank side of tests/test_torch_parallel.py: tests/test_parallel.py's
session and cases on the port, run by each rank of a spawned gloo group.
Torch only: spawned ranks import this module and must not import JAX."""

import numpy as np
import torch
import torch.distributed as dist

from kiwi_tpu_torch import geo
from kiwi_tpu_torch.engine import Engine, Receiver
from kiwi_tpu_torch.gf.store import GFStore
from kiwi_tpu_torch.invert import minimize_multistart
from kiwi_tpu_torch.parallel import gfshard, make_mesh, sharded_forward

# tests/test_parallel.py's bilateral fault: (4, 3, 3) centroids, 4 `ned`
# receivers at 1.2-2.4 km
BILAT = np.array([0, 0, 0, 400.0, 1e12, 91.0, 87.0, 164.0, 0.0, 300.0, 200.0, 250.0, 2500.0,
                  0.2], dtype=np.float32)
STORE = dict(nx=40, nz=6, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
             material=(2300.0, 3200.0, 1600.0))
STF = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
# the rc row left without a reference and the receiver switched off in the
# reassembly case
NO_REF = (2, "e")
OFF = 1
MULTISTART_FREE = (5, 6, 7)
DIST_CALLS = ("all_gather", "all_gather_object", "all_gather_into_tensor", "all_reduce",
              "broadcast", "broadcast_object_list", "barrier", "gather", "gather_object",
              "scatter", "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
              "all_to_all_single", "send", "recv", "isend", "irecv", "new_group")


def receivers(receiver_cls):
    olat, olon = 30.0, 70.0
    recs = []
    for i in range(4):
        d = 1200.0 + 400.0 * i
        la, lo = geo.ne_to_latlon(np.radians(olat), np.radians(olon), d, 0.3 * i)
        recs.append(receiver_cls(np.degrees(float(la)), np.degrees(float(lo)), "ned"))
    return recs


def configure(eng, receiver_cls=Receiver):
    """tests/test_parallel.py's session (either package's engine)."""
    eng.set_receivers(receivers(receiver_cls))
    eng.set_source_location(30.0, 70.0, 0.0)
    eng.set_effective_dt(0.1)
    eng.set_local_interpolation(True)
    eng.set_source_params("bilateral", BILAT)
    eng.set_misfit_method("l2norm")
    eng.set_synthetic_reference()
    return eng


def sweep(n, col, lo, hi, base=BILAT):
    pb = np.tile(base, (n, 1))
    pb[:, col] = np.linspace(lo, hi, n).astype(np.float32)
    return pb


# the batches of tests/test_parallel.py's cases
BATCHES = {
    "sf": sweep(16, 5, 0.0, 350.0),
    "gf": sweep(6, 5, 10.0, 170.0),
    "2d": sweep(7, 5, 20.0, 160.0),
    "ok": sweep(4, 5, 0.0, 90.0),
    "far": sweep(4, 1, 0.0, 1500.0),
    "late": sweep(4, 0, 0.0, 30.0),
    "form": sweep(8, 5, 0.0, 350.0),
    "grad": sweep(8, 5, 40.0, 140.0),
    "grad10": sweep(10, 5, 40.0, 140.0),
}
BATCHES["float"] = np.tile(BILAT, (4, 1))
BATCHES["float"][:, 0] = np.array([-0.15, 0.0, 0.1, 0.2], np.float32)


def point_source():
    pt = BILAT.copy()
    pt[9:12] = 0.0  # zero lengths and width: a point source
    return pt


def multistart_rows():
    rng = np.random.default_rng(3)
    rows = np.tile(BILAT, (6, 1))
    rows[:, list(MULTISTART_FREE)] += rng.normal(0.0, 3.0, (6, 3)).astype(np.float32)
    return rows


def floating(eng, on):
    """floating_l1norm over +-0.3 s, or back to l2norm without shifts."""
    eng.set_misfit_method("floating_l1norm" if on else "l2norm")
    eng.set_floating_shiftrange(*((-0.3, 0.3) if on else (0.0, 0.0)))


def partial_references(eng):
    """The synthetic reference on every rc row but NO_REF, and receiver OFF
    switched off."""
    traces = eng.get_synthetic_seismograms()
    eng.set_receivers(eng.receivers)
    for irc, (r, c) in enumerate(eng._rc_layout()):
        if (r, c) != NO_REF:
            eng.set_ref_seismogram(r, c, *traces[irc])
    eng.switch_receiver(OFF, False)


def count_calls(fn):
    """(fn(), {torch.distributed function: calls} during it)."""
    counts = {}
    saved = {n: getattr(dist, n) for n in DIST_CALLS if hasattr(dist, n)}

    def counted(name, f):
        def call(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return f(*args, **kwargs)
        return call

    for name, f in saved.items():
        setattr(dist, name, counted(name, f))
    try:
        out = fn()
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)
    return out, counts


def host(out):
    return tuple(x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in out)


def coverage_error(plan, pb):
    """The ValueError message plan.misfits(pb) raises (None if none)."""
    try:
        plan.misfits(pb)
    except ValueError as e:
        return str(e)
    return None


def make_engine(store_args, device="cpu"):
    return configure(Engine(GFStore.from_numpy(*store_args), device=device))


def rank_cases(store_args):
    """Every case on this rank of a 4-rank group: results by case name."""
    torch.set_num_threads(1)
    eng = make_engine(store_args)
    m41, m22, m14 = (make_mesh(a, b, device="cpu") for a, b in ((4, 1), (2, 2), (1, 4)))
    B = BATCHES
    out = {"rank": dist.get_rank(), "coords": (m22.coords["s"], m22.coords["r"])}

    out["sf_41"] = host(sharded_forward(eng, B["sf"], m41))
    out["sf_22"] = host(sharded_forward(eng, B["sf"], m22))
    out["sf_41_10"] = host(sharded_forward(eng, B["sf"][:10], m41))

    plan, calls = count_calls(lambda: gfshard.build_plan(eng, m14))
    out["calls_build"] = calls
    out["gf_14"] = plan.misfits(B["gf"])
    out["gf_14_gm"] = plan.global_misfits(B["gf"])
    eng.misfits_for_source_batch(B["gf"])
    full = eng._plan["cfg"]
    out["gf_14_nxw"] = (plan.cfg.nxw, full.nxw)
    out["gf_14_bytes"] = (plan.shard_window_bytes(),
                          full.nxw * full.nzw * full.ng * (full.nt_out + full.s_len) * 4)
    (_fwd, shard_plan), = plan._fwds.values()
    out["gf_14_amp_scale"] = (shard_plan["ctx"]["amp_scale"], eng._plan["ctx"]["amp_scale"])

    floating(eng, True)
    out["gf_float"] = gfshard.build_plan(eng, m14).misfits(B["float"])
    floating(eng, False)

    plan = gfshard.build_plan(eng, m22)
    out["gf_22_axis"] = plan.source_axis
    out["gf_22_7"] = plan.misfits(B["2d"])

    plan = gfshard.build_plan(eng, m14)
    out["cov_ok"] = plan.misfits(B["ok"])
    out["cov_far"] = coverage_error(plan, B["far"])
    out["cov_late"] = coverage_error(plan, B["late"])

    plan = gfshard.build_plan(eng, m22)
    out["form_8"] = plan.misfits(B["form"])
    out["form"] = (plan.last_formulation.use_window, plan.last_formulation.group_size)
    _res, out["calls_gf"] = count_calls(lambda: plan.misfits(B["form"]))
    _res, out["calls_sf"] = count_calls(lambda: sharded_forward(eng, B["sf"], m41))

    eng.set_source_params("bilateral", point_source())
    eng.set_synthetic_reference()
    plan = gfshard.build_plan(eng, m22)
    out["shared_8"] = plan.misfits(sweep(8, 5, 0.0, 350.0, base=point_source()))
    out["shared_keys"] = list(plan._fwds)
    eng.set_source_params("bilateral", BILAT)
    eng.set_synthetic_reference()

    out["grad_8"] = eng.global_misfits_and_grad(B["grad"], mesh=m41)
    out["grad_10"] = eng.global_misfits_and_grad(B["grad10"], mesh=m41)
    mask = np.isin(np.arange(BILAT.size), MULTISTART_FREE)
    out["multistart"] = minimize_multistart(eng, multistart_rows(), mask=mask, steps=3,
                                            mesh=m41)

    eng.min_probe_length = 1024
    eng.set_floating_shiftrange(0.0, 0.0)  # invalidates the plan
    plan = gfshard.build_plan(eng, m14)
    out["probe_14"] = plan.misfits(B["gf"])
    eng.misfits_for_source_batch(B["gf"])
    out["probe_st"] = (plan.statics, eng._plan_statics(eng._plan["cfg"], eng._plan_key[3]))
    eng.min_probe_length = 0
    eng.set_floating_shiftrange(0.0, 0.0)

    partial_references(eng)
    floating(eng, True)
    out["partial_14"] = gfshard.build_plan(eng, m14).misfits(B["gf"])
    out["partial_22"] = gfshard.build_plan(eng, m22).misfits(B["2d"])
    return out


def card_gfshard_rank(store_args, pb):
    """One rank of the card test: distance shards (1 x 2 mesh) of the
    bilateral fault under floating_l1norm on cuda:0; (misfit, norm, shift,
    window_synth and scan_sums launches, shard window bytes)."""
    from kiwi_tpu_torch.ops import float_scan, synth_window

    dev = torch.device("cuda", 0)
    eng = make_engine(store_args, device=dev)
    floating(eng, True)
    plan = gfshard.build_plan(eng, make_mesh(1, dist.get_world_size(), device=dev))
    before = synth_window.launches["window_synth"], float_scan.launches["scan_sums"]
    out = plan.misfits(pb)
    launched = (synth_window.launches["window_synth"] - before[0],
                float_scan.launches["scan_sums"] - before[1])
    return (*out, launched, plan.shard_window_bytes())
