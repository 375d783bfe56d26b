"""The small CLI tools (kiwi_tpu_torch.cli.tools) of the port against
kiwi_tpu's on the CPU, and the port's trace exporter
(kiwi_tpu_torch.profiling.torch_trace).

source_info, eulermt, crust and differential_azidist print identical
stdout; ahfull writes byte-identical files; eikonal_benchmark prints the
reference's two lines (its device line here on the CPU, through the sweep
kernel's plain version); the port's sweep_solve at the benchmark's inputs
agrees with kiwi_tpu.eikonal.sweep_solve to 1e-4 relative
(tests/test_torch_eikonal.py's bar against the XLA sweep); torch_trace
writes a Chrome trace.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiwi_tpu import eikonal as jeik
from kiwi_tpu.cli import tools as jtools
from kiwi_tpu_torch import eikonal as teik, profiling as tprof
from kiwi_tpu_torch.cli import tools as ttools
from kiwi_tpu_torch.ops import eik_sweep


def _stdout(capsys, fn, argv):
    fn(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [
    ("source_info", []),
    ("source_info", ["eikonal", "point_lp"]),
    ("eulermt", ["91", "87", "164"]),
    ("eulermt", ["0", "90", "-90"]),
    ("crust", ["40", "30"]),
    ("crust", ["-12.5", "170"]),
    ("differential_azidist", []),
])
def test_stdout_identical(capsys, tool, argv):
    want = _stdout(capsys, getattr(jtools, tool), argv)
    got = _stdout(capsys, getattr(ttools, tool), argv)
    assert got == want and got.strip()


@pytest.mark.parametrize("fmt", ["table", "mseed", "sac"])
def test_ahfull_files_identical(tmp_path, capsys, fmt):
    """Two sources summed at three receivers, n/e/d each."""
    src, rec, mat, stf = (str(tmp_path / n) for n in ("sources", "receivers", "material", "stf"))
    np.savetxt(src, [[0, 0, 1000, 1e12, -1e12, 0, 3e11, 0, 0],
                     [200, -100, 1100, 0, 0, 0, 0, 5e11, -2e11]])
    np.savetxt(rec, [[2000, 0, 0], [1500, 1500, 0], [-800, 2500, 300]])
    np.savetxt(mat, [[2300.0, 3200.0, 1600.0]])
    np.savetxt(stf, np.column_stack([np.arange(7) * 0.1, [0, 0, 0.3, 0.7, 1, 1, 1]]))
    outs = {}
    for name, mod in (("jax", jtools), ("torch", ttools)):
        base = str(tmp_path / name / "ahf")
        os.makedirs(os.path.dirname(base))
        outs[name] = _stdout(capsys, mod.ahfull, [src, rec, mat, stf, "0.1", base, fmt])
    assert outs["torch"] == outs["jax"] == "wrote 3 x 3 seismograms\n"
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 9 and sorted(os.listdir(tmp_path / "torch")) == names
    for n in names:
        with open(tmp_path / "jax" / n, "rb") as a, open(tmp_path / "torch" / n, "rb") as b:
            assert a.read() == b.read(), n


def test_eikonal_benchmark_cpu(capsys):
    before = dict(eik_sweep.launches)
    ttools.eikonal_benchmark(["24", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"host FMM      24x24: \d+\.\d{3} s", lines[0]), lines[0]
    assert re.fullmatch(r"device sweep  24x24: \d+\.\d{3} s  \(\d+\.\d+x\)", lines[1]), lines[1]
    assert eik_sweep.launches == before  # the CPU runs the plain version


def test_eikonal_benchmark_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttools.eikonal_benchmark(["8"])


def test_sweep_solve_at_benchmark_inputs():
    """eikonal_benchmark's field at n = 40, 8 rounds."""
    n = 40
    rng = np.random.default_rng(0)
    speed = (2500.0 + 500.0 * rng.random((n, n))).astype(np.float32)
    p0 = (n / 2 * 100.0, n / 2 * 100.0)
    want = np.asarray(jeik.sweep_solve(jnp.asarray(speed), (100.0, 100.0), (0.0, 0.0), p0,
                                       n_rounds=8))
    got = teik.sweep_solve(torch.as_tensor(speed), (100.0, 100.0), (0.0, 0.0), p0,
                           n_rounds=8).numpy()
    assert got.shape == (n, n) and (want < 1e29).all()
    assert float((np.abs(got - want) / np.maximum(np.abs(want), 1e-6)).max()) <= 1e-4


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.torch_trace(logdir) as path:
        x = torch.arange(1000, dtype=torch.float32)
        (x * x).sum()
    assert os.path.dirname(path) == logdir
    with open(path) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
