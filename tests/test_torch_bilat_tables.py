"""The bilateral tables kernel's wrapper and dispatch on the CPU
(kiwi_tpu_torch.ops.bilat_tables, sources/bilat.discretize).

On the CPU both the dispatch and the wrapper run the plain chain and launch
nothing; the wrapper refuses what the kernel does not take; the launch
counter reaches profiling.snapshot().  The kernel itself is held against
the plain chain on the card, bit for bit (tests/test_torch_cuda.py); the
plain chain against the JAX package here (tests/test_torch_synth.py,
tests/test_torch_finite.py).  No JAX.
"""

import pytest
import torch

import bilat_cases
from kiwi_tpu_torch import profiling
from kiwi_tpu_torch.ops import bilat_tables
from kiwi_tpu_torch.sources import bilat


@pytest.mark.parametrize("name", sorted(bilat_cases.CASES))
def test_cpu_dispatch_runs_the_plain_chain(name):
    rows, shape = bilat_cases.case(name)
    assert {bilat.grid_shape(r, bilat_cases.EDT) for r in rows} == {shape}
    p = torch.as_tensor(rows)
    before = bilat_tables.launches["bilat_tables"]
    got = bilat.discretize(p, bilat_cases.EDT, shape)
    wrapped = bilat_tables.bilat_tables(p, shape)
    want = bilat.discretize_reference(p, shape)
    assert bilat_tables.launches["bilat_tables"] == before
    C = shape[0] * shape[1] * shape[2]
    assert set(got) == set(wrapped) == set(want) == {"north", "east", "depth", "time", "m",
                                                     "active"}
    for k, w in want.items():
        assert w.shape == ((len(rows), C, 6) if k == "m" else (len(rows), C))
        assert torch.equal(got[k], w) and torch.equal(wrapped[k], w), k
    assert want["active"].all()


def test_gradient_takes_the_plain_chain():
    rows, shape = bilat_cases.case("lm4")
    leaf = torch.as_tensor(rows).requires_grad_()
    before = bilat_tables.launches["bilat_tables"]
    tables = bilat.discretize(leaf, bilat_cases.EDT, shape)
    (tables["time"].sum() + tables["depth"].sum() + tables["m"].sum()).backward()
    assert bilat_tables.launches["bilat_tables"] == before
    assert torch.isfinite(leaf.grad).all()
    assert (leaf.grad[:, [0, 3, 5, 6, 7, 9, 10, 12]] != 0).all()


def test_snapshot_carries_the_launch_counter():
    snap = profiling.snapshot()
    assert snap["launches.bilat_tables"] == bilat_tables.launches["bilat_tables"]


ROW = torch.as_tensor(bilat_cases.case("lm4")[0])


@pytest.mark.parametrize("params,shape,error", [
    (ROW.double(), (13, 5, 3), ValueError),      # not float32
    (ROW[:, :13], (13, 5, 3), ValueError),       # not 14 columns
    (ROW[0], (13, 5, 3), ValueError),            # not [B, 14]
    (ROW[None], (13, 5, 3), ValueError),
    (ROW, (13, 5), ValueError),                  # not three sizes
    (ROW, (13, 0, 3), ValueError),               # an empty axis
    (ROW, (13, 5, 2.5), ValueError),             # not an integer
    (ROW.clone().requires_grad_(), (13, 5, 3), RuntimeError),  # no backward
])
def test_wrapper_refuses(params, shape, error):
    with pytest.raises(error):
        bilat_tables.bilat_tables(params, shape)
