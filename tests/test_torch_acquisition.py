"""FDSN acquisition of the port (kiwi_tpu_torch.acquisition) against
recorded fixtures: tests/test_acquisition.py's four cases on the port with
the same fixture transport, and kiwi_tpu's fetch_dataset beside the port's
(byte-identical directories).  No network: every request goes to the
injected opener."""

import calendar
import os
import time as time_mod

import pytest

from kiwi_tpu import acquisition as jacq
from kiwi_tpu_torch import acquisition as acq
from kiwi_tpu_torch.io import mseed
from test_acquisition import Fixtures

T_DAY = calendar.timegm(time_mod.strptime("1999-08-17", "%Y-%m-%d"))


def test_catalog_parses_and_filters(tmp_path):
    fx = Fixtures(tmp_path)
    events = acq.FDSNCatalog("http://fixture", opener=fx).get_events(
        (T_DAY, T_DAY + 86400), min_magnitude=4.0)
    assert len(events) == 2
    ev = events[0]
    assert ev.name == "ev001"
    assert ev.mag == pytest.approx(7.6)
    assert ev.depth == pytest.approx(17000.0)
    assert ev.region == "TURKEY"
    assert abs(ev.timestamp - (T_DAY + 99.13)) < 1e-3
    assert "minmagnitude=4.0" in fx.urls[0]
    want = jacq.FDSNCatalog("http://fixture", opener=Fixtures(tmp_path)).get_events(
        (T_DAY, T_DAY + 86400), min_magnitude=4.0)
    assert [str(e) for e in events] == [str(e) for e in want]
    assert [vars(e) for e in events] == [vars(e) for e in want]


def test_stations_distance_annotation(tmp_path):
    ev = acq.Event(timestamp=9.3e8, mag=7.6, lat=40.74, lon=29.86, depth=17000.0,
                   name="ev001")
    sts = acq.FDSNWaveforms("http://fixture", opener=Fixtures(tmp_path)).get_stations(
        ev, dist_range_m=(1e5, 1e6))
    # APE (Aegean, ~560 km) is in range; FAR (Faroes, ~3800 km) is not
    assert [s.station for s in sts] == ["APE"]
    assert 4.0e5 < sts[0].dist_m < 7.0e5
    assert set(sts[0].channels) == {"BHE", "BHN", "BHZ"}
    jev = jacq.Event(**vars(ev))
    want = jacq.FDSNWaveforms("http://fixture", opener=Fixtures(tmp_path)).get_stations(
        jev, dist_range_m=(0.0, 1e7))
    got = acq.FDSNWaveforms("http://fixture", opener=Fixtures(tmp_path)).get_stations(
        ev, dist_range_m=(0.0, 1e7))
    assert [(s.nsl, s.dist_m, s.channels) for s in got] == [
        (s.nsl, s.dist_m, s.channels) for s in want]


def _tree(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def test_fetch_dataset_writes_raw_layout(tmp_path):
    ev = dict(timestamp=9.3e8, mag=7.6, lat=40.74, lon=29.86, depth=17000.0, name="ev001",
              region="TURKEY")
    dirs = {}
    for name, mod in (("jax", jacq), ("torch", acq)):
        fx = Fixtures(tmp_path)
        dirs[name] = str(tmp_path / name)
        stations, paths = mod.fetch_dataset(
            mod.Event(**ev), dirs[name], waveform_source=mod.FDSNWaveforms("http://fixture",
                                                                           opener=fx),
            dist_range_m=(1e5, 1e6))
        assert len(paths) == 1  # only BHZ had data; BHE/BHN 404ed gracefully
    for fn in ("stations.txt", "event.txt"):
        assert os.path.exists(os.path.join(dirs["torch"], fn))
    d, _t0, dt = mseed.read(paths[0])  # the fetched file is readable mseed
    assert len(d) == 400 and abs(dt - 0.05) < 1e-9
    assert _tree(dirs["torch"]) == _tree(dirs["jax"])


def test_autokiwi_pull_with_fdsn_fixtures(tmp_path):
    """The port's autokiwi pull drives the port's FDSN catalog and fetcher
    against the fixtures."""
    from kiwi_tpu_torch.cli.autokiwi import pull
    from kiwi_tpu_torch.config import Config

    fx = Fixtures(tmp_path)
    pull_config = Config(
        catalog=acq.fdsn_catalog("http://fixture", opener=fx, min_magnitude=5.0),
        fetch=acq.fdsn_fetcher("http://fixture", opener=fx, dist_range_m=(1e5, 1e6)),
        time_range=(T_DAY, T_DAY + 86400),
        event_filter=lambda ev: ev.magnitude > 6.0,
        seed_volume=str(tmp_path / "events" / "%(event_name)s" / "data"),
    )
    assert pull(pull_config, which="all") == ["ev001"]
    vol = str(tmp_path / "events" / "ev001" / "data")
    assert os.path.exists(os.path.join(vol, "stations.txt"))
    assert any(f.startswith("raw-GE.APE") for f in os.listdir(vol))


def test_autokiwi_event_round_trip():
    from kiwi_tpu_torch.cli.autokiwi import Event as AkEvent

    ak = AkEvent(name="ev9", time=9.3e8, lat=1.0, lon=2.0, depth=3000.0, magnitude=5.5,
                 region="R")
    ev = acq.as_acquisition_event(ak)
    assert (ev.timestamp, ev.mag, ev.lat, ev.lon, ev.depth, ev.region, ev.name) == (
        9.3e8, 5.5, 1.0, 2.0, 3000.0, "R", "ev9")
