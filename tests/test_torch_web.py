"""The port's web seismosizer (kiwi_tpu_torch.web, device="cpu") over real
HTTP on 127.0.0.1: tests/test_web.py's six tests against it, parity with
kiwi_tpu's server on the same POSTs, and the port's own repairs (no
matplotlib, a card failure answered 500).

Parity bar: result.json rows with the same receiver, component, itmin and
length, their values within 1e-5 of each row's largest magnitude (float32
synthesis summed in another order); /source3d.json's centroid tables the
same length, within 1e-5 of each column's largest magnitude.  The eikonal
source's rows (a post-synthesis rise time) span fewer samples in the port,
which grows a folded span by the fold's live half width where the JAX
package adds its plan's margin: they are compared on the reference's
samples, the port's trace extended as a trace is (zero before it, its last
value after it).
"""

import json
import re
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest

from kiwi_tpu.gf import elseis
from kiwi_tpu.web import serve as jserve
from kiwi_tpu_torch.gf.store import GFStore
from kiwi_tpu_torch.ops.build import KernelError
from kiwi_tpu_torch.web import serve
from test_web import (test_web_calculate_cycle, test_web_file_validation,  # noqa: F401
                      test_web_get_hardening, test_web_interpolation_selection_preserved,
                      test_web_source3d_view, test_web_trace_browser)

TOL = 1e-5


@pytest.fixture(scope="module")
def store():
    """tests/test_web.py's store, deepened to 2100 m: an eikonal rupture
    must lie below the default constraint plane at 1500 m."""
    stf = np.array([0, 0, 0.3, 0.7, 1, 1, 1], dtype=np.float64)
    return elseis.build_ahfull_store(
        nx=40, nz=22, dt=0.1, dx=100.0, dz=100.0, firstx=100.0, firstz=0.0,
        material=(2300.0, 3200.0, 1600.0), stf=stf,
    )


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def port(store, tmp_path_factory):
    tstore = GFStore.from_numpy(store.dt, store.dx, store.dz, store.firstx, store.firstz,
                                store.data, store.itmin, store.nsamples)
    srv = serve(tstore, str(tmp_path_factory.mktemp("webwork_torch")), port=0, device="cpu")
    yield _start(srv), srv.RequestHandlerClass.app
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def server(port):
    """The port's server under the name tests/test_web.py's tests take."""
    return port[0]


@pytest.fixture(scope="module")
def reference(store, tmp_path_factory):
    srv = jserve(store, str(tmp_path_factory.mktemp("webwork_jax")), port=0)
    yield _start(srv)
    srv.shutdown()
    srv.server_close()


def _post(base, form, timeout=300):
    data = urllib.parse.urlencode(form).encode()
    return urllib.request.urlopen(base + "/", data=data, timeout=timeout).read().decode()


def _get(base, path, timeout=300):
    return urllib.request.urlopen(base + path, timeout=timeout).read()


BILATERAL = {
    "sourcetype": "bilateral", "param.depth": "400", "param.moment": "1e12",
    "param.strike": "91", "param.dip": "87", "param.slip-rake": "164",
    "param.length-a": "300", "param.length-b": "200", "param.width": "250",
    "param.rupture-velocity": "2500", "param.rise-time": "0.2",
}
EIKONAL = {
    "sourcetype": "eikonal", "param.depth": "1800", "param.moment": "1e12",
    "param.strike": "30", "param.dip": "80", "param.slip-rake": "164",
    "param.bord-radius": "200", "param.nukl-shift-x": "30", "param.nukl-shift-y": "-20",
    "param.rel-rupture-velocity": "0.9", "param.rise-time": "0.3",
}
MOMENT_TENSOR = {"sourcetype": "moment_tensor", "param.depth": "300", "param.mxx": "1e12",
                 "param.myy": "-5e11", "param.mxy": "3e11", "param.myz": "2e11",
                 "param.rise-time": "0.2"}


def _form(session, source, receivers="30.02 70.0 ned\n30.025 70.01 ne\n29.99 69.98 d"):
    return {"session": str(session), "source_latitude": "30.0", "source_longitude": "70.0",
            "effective_dt": "0.1", "interpolation": "bilinear", "receivers": receivers,
            "calculate": "1", **source}


def _on_axis(values, itmin, lo, hi):
    """A trace (zero before itmin, its last value after its end) at the
    absolute samples lo..hi."""
    idx = np.arange(lo, hi + 1) - itmin
    return np.where(idx < 0, 0.0, values[np.clip(idx, 0, len(values) - 1)])


def _close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    assert float(np.abs(got - want).max(initial=0.0)) <= TOL * scale, label


@pytest.mark.parametrize("session,source", [(41, BILATERAL), (42, EIKONAL),
                                            (43, MOMENT_TENSOR)],
                         ids=["bilateral", "eikonal", "moment_tensor"])
def test_parity_with_reference(port, reference, session, source):
    base = port[0]
    for url in (base, reference):
        assert "generation: 1" in _post(url, _form(session, source))
    name = f"/file?session={session}&generation=1&name=result.json"
    got, want = (json.loads(_get(url, name)) for url in (base, reference))
    assert got["form"] == want["form"] and got["dt"] == want["dt"]
    assert [(r["receiver"], r["component"]) for r in got["traces"]] == [
        (r["receiver"], r["component"]) for r in want["traces"]]
    assert len(got["traces"]) == 3 + 2 + 1
    for g, w in zip(got["traces"], want["traces"]):
        gv, wv, gi, wi = g["values"], w["values"], g["itmin"], w["itmin"]
        if source is EIKONAL:
            # the rise time's fold grows the port's span by its live half
            # width, the JAX package's by its plan's wider margin: the
            # port's span inside the reference's, equal on it
            assert wi <= gi and gi + len(gv) <= wi + len(wv)
            gv = _on_axis(np.asarray(gv), gi, wi, wi + len(wv) - 1)
        else:
            assert gi == wi
        _close(gv, wv, (g["receiver"], g["component"]))
    if source is MOMENT_TENSOR:
        return
    got, want = (json.loads(_get(url, f"/source3d.json?session={session}"))
                 for url in (base, reference))
    assert got["sourcetype"] == want["sourcetype"] == source["sourcetype"]
    assert len(got["north"]) > 1
    for k in ("north", "east", "depth", "time", "weight"):
        _close(got[k], want[k], k)


def test_without_matplotlib(port, monkeypatch):
    """A calculate where matplotlib does not import: the generation and its
    result.json are written, no PNG, the page says the figures were skipped
    and why; the trace browser serves."""
    import os

    base, app = port
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    body = _post(base, _form(51, BILATERAL))
    assert "generation: 1" in body
    assert "figures skipped" in body and "matplotlib" in body
    assert not re.findall(r'src="(/file[^"]+)"', body)
    gdir = app._gen_dir(51, 1)
    assert os.listdir(gdir) == ["result.json"]
    assert "kiwi-tpu trace browser" in _get(base, "/traces?session=51").decode()
    assert "figures skipped" in _get(base, "/?session=51").decode()


def test_card_failure_answers_500(port, monkeypatch):
    """A kernel or CUDA failure inside calculate is not a form error: HTTP
    500 (and a log line); an input error keeps the 200 error page."""
    base, app = port

    def broken():
        raise KernelError("kiwi_window_synth launch failed: CUDA error 700")

    monkeypatch.setattr(app.engine, "get_synthetic_seismograms", broken)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, _form(61, BILATERAL))
    assert e.value.code == 500
    assert "CUDA error 700" in e.value.read().decode()
    assert app.generations(61) == []

    def runtime():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(app.engine, "get_synthetic_seismograms", runtime)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, _form(61, BILATERAL))
    assert e.value.code == 500

    body = _post(base, {"session": "61", "sourcetype": "bilateral", "receivers": ""})
    assert "no receivers given" in body and "<h1>error</h1>" in body
    body = _post(base, _form(61, {**BILATERAL, "param.strike": "north"}))
    assert "<h1>error</h1>" in body


def test_refuses_a_missing_card(store, tmp_path, monkeypatch):
    import torch

    from kiwi_tpu_torch.web import SeismogramApp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SeismogramApp(GFStore.from_numpy(store.dt, store.dx, store.dz, store.firstx,
                                         store.firstz, store.data, store.itmin,
                                         store.nsamples), str(tmp_path))
