"""The benchmark's plain reference against kiwi_tpu_torch on the CPU at
small sizes: the store builder, the global misfits of point and finite
sources under the floating l1 norm, with and without the band-pass, and
the l2 norm, and the probe span of band-passed norms.  The reference
itself loads nothing of the program (checked in a fresh process)."""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest

from portbench.reference import oracle
from portbench.session import global_from_parts, make_engine, reference_session
from portbench.tests import small

POINT = np.array([0, 0, 0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 0, 0, 0, 2500.0, 0.2], np.float32)
FINITE = np.array([0, 0, 0, 5000.0, 1e12, 91.0, 87.0, 164.0, 0.0, 900.0, 700.0, 1000.0,
                   2500.0, 0.2], np.float32)
BAND = [[0.0, 0.2, 3.0, 4.0], [0.0, 1.0, 1.0, 0.0]]
# the program's float32 against the float64 reference: measured up to
# 4.6e-7 on these rows (global misfits 0.17-2.2); TF32 reads 7e-7 to 9e-5
TOL = 2e-6


def session_cfg(method, band=None):
    return {"effective_dt": 0.1, "origin": [30.0, 70.0], "local_interpolation": True,
            "receivers": {"north_m": [3000.0, 3333.0, 3666.0, 4000.0], "east_m": 0.0,
                          "components": "ned"},
            "source_type": "bilateral", "misfit_method": method,
            "floating_shiftrange": [-1.0, 1.0] if method.startswith("floating") else [0.0, 0.0],
            "filter": band}


def rows_around(truth, shared, n=6, seed=1):
    rng = np.random.default_rng(seed)
    rows = np.tile(truth, (n, 1))
    rows[:, 5] += rng.uniform(-40, 40, n)
    if not shared:
        rows[:, 6] = rng.uniform(40, 89, n)
        rows[:, 7] += rng.uniform(-50, 50, n)
        rows[:, 0] += rng.uniform(-0.3, 0.3, n)
    rows[0] = truth
    return rows


def test_store_is_the_programs_analytic_store():
    from kiwi_tpu_torch.gf import elseis

    st = small.store()
    port = elseis.build_ahfull_store(nx=40, nz=20, dt=0.1, dx=100.0, dz=100.0, firstx=1800.0,
                                     firstz=4000.0, material=(2300.0, 3200.0, 1600.0),
                                     stf=np.asarray(small.KIWIBENCH_STF, np.float64))
    assert np.array_equal(st.data, port.data)
    assert np.array_equal(st.itmin, port.itmin)
    assert np.array_equal(st.nsamples, port.nsamples)


@pytest.mark.parametrize("method,band,truth,shared", [
    ("floating_l1norm", None, POINT, True),
    ("floating_l1norm", None, FINITE, False),
    ("floating_l1norm", BAND, FINITE, False),
    ("l2norm", None, FINITE, False),
])
def test_global_misfits_match_the_program(method, band, truth, shared):
    cfg = session_cfg(method, band)
    st = small.store()
    eng = make_engine(cfg, st, "cpu", truth)
    rows = rows_around(truth, shared)
    m, n, _fs = eng.misfits_for_source_batch(rows)
    prog = global_from_parts(m.numpy(), n.numpy())
    ses = reference_session(cfg, st, truth, rows)
    if band is not None:
        assert ses.probe == (eng._plan["st"].ps0, eng._plan["st"].pl)
    gaps = [np.min(np.abs(ses.global_misfit(r, near=2e-5) - g)) for r, g in zip(rows, prog)]
    assert max(gaps) < TOL, gaps
    assert prog[0] < TOL and min(prog[1:]) > 0.05  # the truth fits, the others do not


def test_tf32_control_departs_from_the_reference():
    cfg = session_cfg("floating_l1norm")
    st = small.store()
    rows = rows_around(POINT, True)
    ref = reference_session(cfg, st, POINT)
    ctl = reference_session(cfg, st, POINT, precision="tf32")
    gaps = [abs(ctl.global_misfit(r)[0] - ref.global_misfit(r)[0]) for r in rows[1:]]
    assert max(gaps) > 10 * TOL


def test_round_tf32_keeps_ten_mantissa_bits():
    x = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 3.14159265],
                 np.float32)
    y = oracle.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2.0 ** -10
    assert y[2] == 1.0  # a tie rounds to even
    assert y[3] == 1.0 + 2.0 ** -9
    assert abs(float(y[4]) - 3.14159265) < 2.0 ** -10 * 2


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.oracle, portbench.reference.store; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kiwi_tpu_torch', 'kiwi_tpu', 'jax', 'jaxlib', 'torch'}); print(bad)")
    from portbench import harness

    out = subprocess.run([sys.executable, "-c", code, harness.ROOT], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
