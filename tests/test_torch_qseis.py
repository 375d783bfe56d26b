"""The QSEIS and POEL store builders of the port (kiwi_tpu_torch.gf.qseis,
kiwi_tpu_torch.gf.poel) against kiwi_tpu's on the CPU.

The input decks must be the same text, character for character; both
builders run tests/test_qseis.py's stand-in binaries and must fill equal
stores (data, itmin, nsamples exactly: the same numpy code on the same
tables); a missing binary fails with the same error.
"""

import numpy as np
import pytest

from kiwi_tpu.gf import poel as jpoel, qseis as jqseis
from kiwi_tpu_torch.gf import poel as tpoel, qseis as tqseis
from test_qseis import FAKE_POEL, FAKE_QSEIS

MODEL = "0.  5.8 3.2 2.6 1000 500\n30. 8.0 4.4 3.3 1500 600\n"
GFDB = {"nx": 4, "nz": 2, "ng": 10, "dt": 0.5, "dx": 10e3, "dz": 5e3, "firstx": 100e3,
        "firstz": 5e3}
POEL_GFDB = {"nx": 3, "nz": 2, "ng": 14, "dt": 0.5, "dx": 50.0, "dz": 25.0, "firstx": 100.0,
             "firstz": 10.0}


def _binary(tmp_path, name, text):
    fn = tmp_path / name
    fn.write_text(text)
    fn.chmod(0o755)
    return str(fn)


def _qseis_config(mod, variant):
    conf = mod.QSeisConfig()
    if variant == "defaults":
        return conf
    conf.layered_model.set_model_from_string(MODEL, units="ugly")
    gfdb = dict(GFDB, ng=8) if variant == "ng8" else GFDB
    conf.autoconf_modelling(gfdb, allow_time_reduction=variant != "no_reduction")
    if variant == "filtered":
        conf.filter_no_roots, conf.roots = 1, [complex(0.0, 0.0)]
        conf.filter_no_poles, conf.poles = 2, [complex(-0.1, 0.2), complex(-0.1, -0.2)]
        conf.receiver_model.set_model([0.0], [5800.0], [3200.0], [2600.0], [1000.0], [500.0])
        conf.sw_equidistant = 0
        conf.distances_km = [100.0, 120.0, 250.0]
    return conf


@pytest.mark.parametrize("variant", ["defaults", "autoconf", "ng8", "no_reduction",
                                     "filtered"])
def test_qseis_deck_identical(variant):
    assert str(_qseis_config(tqseis, variant)) == str(_qseis_config(jqseis, variant))


def _poel_config(mod, variant):
    conf = mod.PoelConfig()
    if variant == "irregular":
        conf.sw_equidistant = 0
        conf.distances = [10.0, 35.0, 80.0]
        conf.model.set_model([0.0, 50.0], [0.4e9, 0.5e9], [0.2, 0.25], [0.4, 0.42],
                             [0.75, 0.8], [5.0, 4.0])
        conf.source_function.data = [[0.0, 0.0], [1.0, 2.0], [3.0, 0.5]]
    return conf


@pytest.mark.parametrize("variant", ["defaults", "irregular"])
def test_poel_deck_identical(variant):
    assert str(_poel_config(tpoel, variant)) == str(_poel_config(jpoel, variant))


def _same_store(a, b):
    assert (a.dt, a.dx, a.dz, a.firstx, a.firstz) == (b.dt, b.dx, b.dz, b.firstx, b.firstz)
    for k in ("data", "itmin", "nsamples"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("ng,block_nx", [(10, None), (8, 3)])
def test_qseis_builder_same_store(tmp_path, ng, block_nx):
    fake = _binary(tmp_path, "qseis", FAKE_QSEIS)
    gfdb = dict(GFDB, ng=ng)
    stores = []
    for mod in (jqseis, tqseis):
        conf = mod.QSeisConfig()
        conf.layered_model.set_model_from_string(MODEL, units="ugly")
        conf.autoconf_modelling(gfdb)
        stores.append(mod.QSeisGFBuilder(gfdb, conf, block_nx=block_nx, tmp=str(tmp_path),
                                         program=fake).build())
    _same_store(*stores)
    assert int((stores[1].nsamples > 0).sum()) == 4 * 2 * ng


def test_qseis_builder_cutting(tmp_path):
    """The cutting window (tcut0(x, z), tcut1(x, z)) trims both alike."""
    fake = _binary(tmp_path, "qseis", FAKE_QSEIS)
    cutting = (lambda x, z: x / 8000.0, lambda x, z: x / 5000.0 + 2.0)
    stores = []
    for mod in (jqseis, tqseis):
        conf = mod.QSeisConfig()
        conf.layered_model.set_model_from_string(MODEL, units="ugly")
        conf.autoconf_modelling(GFDB)
        stores.append(mod.QSeisGFBuilder(GFDB, conf, cutting=cutting, tmp=str(tmp_path),
                                         program=fake).build())
    _same_store(*stores)


@pytest.mark.parametrize("block_nx", [None, 2])
def test_poel_builder_same_store(tmp_path, block_nx):
    fake = _binary(tmp_path, "poel", FAKE_POEL)
    stores = [mod.PoelGFBuilder(POEL_GFDB, mod.PoelConfig(), block_nx=block_nx,
                                program=fake, tmp=str(tmp_path)).build()
              for mod in (jpoel, tpoel)]
    _same_store(*stores)
    assert stores[1].ng == 14


def test_missing_binary_errors_match(tmp_path):
    msgs = []
    for mod in (jqseis, tqseis):
        with pytest.raises(mod.QSeisError, match="could not start qseis") as e:
            mod.QSeisRunner(tmp=str(tmp_path), program="/nonexistent/qseis").run(
                mod.QSeisConfig())
        msgs.append(str(e.value))
    for mod in (jpoel, tpoel):
        with pytest.raises(mod.PoelError, match="could not start poel") as e:
            mod.PoelRunner(tmp=str(tmp_path), program="/nonexistent/poel").run(
                mod.PoelConfig())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]


def test_failing_binary_reports_alike(tmp_path):
    """A binary that exits nonzero and writes to stderr: the same problems
    listed, the input deck included."""
    bad = _binary(tmp_path, "bad", "#!/bin/sh\necho error >&2\nexit 3\n")
    msgs = []
    for mod in (jqseis, tqseis):
        with pytest.raises(mod.QSeisError) as e:
            mod.QSeisRunner(tmp=str(tmp_path), program=bad).run(mod.QSeisConfig())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "non-zero exit state: 3" in msgs[1]
