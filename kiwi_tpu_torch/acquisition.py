"""Network data acquisition: event catalogs + waveform fetching (port of
kiwi_tpu/acquisition.py; host code, no tensor).

Role parity with the reference's tunguska/wilber.py (IRIS/Orfeus Wilber
HTML-form scraping for event lists + SEED volumes, wilber.py:53-399) and
sc_edump.py (SeisComP event dumps) -- redesigned against the modern FDSN
web services (fdsnws-event, fdsnws-station, fdsnws-dataselect) instead of
scraping a long-dead web UI.  The transport is a pluggable `opener`
callable so tests (and zero-egress environments) inject recorded fixtures;
the default opener is urllib.  Nothing is fetched at import time.

The output plugs directly into prepare.save_kiwi_dataset (Station/RawTrace
objects) and autokiwi's `pull_config.fetch` hook: `fdsn_fetcher(...)`
returns a `fetch(event, datadir)` callable populating an event data
directory with raw Mini-SEED + a stations file.
"""

from __future__ import annotations

import calendar
import dataclasses
import logging
import os
import time as time_mod

import numpy as np

from . import geo
from .prepare import Station

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Event:
    """Catalog event (wilber.py:15-30's Event, FDSN-sourced)."""

    timestamp: float  # epoch seconds
    mag: float
    lat: float
    lon: float
    depth: float  # m
    region: str = ""
    datasource: str = ""
    name: str = ""

    def __str__(self):
        t = time_mod.strftime("%Y-%m-%d_%H-%M-%S", time_mod.gmtime(self.timestamp))
        return (f"{t} M{self.mag:.1f} lat {self.lat:.2f} lon {self.lon:.2f} "
                f"z {self.depth/1000.0:.0f} km {self.region}")


def default_opener(url, timeout=60):
    """urllib transport; swapped out for fixtures in tests."""
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as f:
        return f.read()


def _parse_fdsn_time(s):
    """FDSN ISO8601 (with or without fractional seconds) -> epoch seconds."""
    s = s.strip().rstrip("Z")
    frac = 0.0
    if "." in s:
        s, fpart = s.split(".", 1)
        frac = float("0." + fpart)
    return calendar.timegm(time_mod.strptime(s, "%Y-%m-%dT%H:%M:%S")) + frac


def _fmt_fdsn_time(t):
    return time_mod.strftime("%Y-%m-%dT%H:%M:%S", time_mod.gmtime(t))


class FDSNCatalog:
    """Event catalog over fdsnws-event (replaces Wilber.get_events,
    wilber.py:209-260)."""

    def __init__(self, base_url="http://service.iris.edu", opener=None):
        self.base_url = base_url.rstrip("/")
        self.opener = opener or default_opener

    def get_events(self, time_range=None, min_magnitude=None, max_magnitude=None,
                   region=None):
        """Events in (tmin, tmax) epoch seconds; region = (latmin, latmax,
        lonmin, lonmax) optional."""
        if time_range is None:
            now = time_mod.time()
            time_range = (now - 24 * 3600, now)
        q = [
            f"starttime={_fmt_fdsn_time(time_range[0])}",
            f"endtime={_fmt_fdsn_time(time_range[1])}",
            "format=text",
        ]
        if min_magnitude is not None:
            q.append(f"minmagnitude={min_magnitude}")
        if max_magnitude is not None:
            q.append(f"maxmagnitude={max_magnitude}")
        if region is not None:
            latmin, latmax, lonmin, lonmax = region
            q += [f"minlatitude={latmin}", f"maxlatitude={latmax}",
                  f"minlongitude={lonmin}", f"maxlongitude={lonmax}"]
        url = f"{self.base_url}/fdsnws/event/1/query?" + "&".join(q)
        text = self.opener(url).decode("utf-8", "replace")
        events = []
        for line in text.splitlines():
            if not line.strip() or line.startswith("#"):
                continue
            w = line.split("|")
            # EventID|Time|Lat|Lon|Depth/km|Author|Catalog|Contributor|
            # ContributorID|MagType|Magnitude|MagAuthor|LocationName
            # -- some catalogs leave depth/magnitude blank or non-numeric;
            # skip those rows instead of aborting the whole response (same
            # policy as get_waveforms' per-channel failures)
            try:
                events.append(Event(
                    timestamp=_parse_fdsn_time(w[1]),
                    lat=float(w[2]),
                    lon=float(w[3]),
                    depth=float(w[4]) * 1000.0 if w[4].strip() else 0.0,
                    mag=float(w[10]) if len(w) > 10 and w[10].strip() else 0.0,
                    region=w[12].strip() if len(w) > 12 else "",
                    datasource=self.base_url,
                    name=w[0].strip(),
                ))
            except (ValueError, IndexError) as e:
                logger.info("skipping malformed event row %r: %s", line, e)
        events.sort(key=lambda e: e.timestamp)
        return events


class FDSNWaveforms:
    """Station metadata + waveform windows over fdsnws-station/dataselect
    (replaces Wilber.get_data's SEED-volume flow, wilber.py:262-399)."""

    def __init__(self, base_url="http://service.iris.edu", opener=None):
        self.base_url = base_url.rstrip("/")
        self.opener = opener or default_opener

    def get_stations(self, event, dist_range_m=(0.0, 1.0e7),
                     channels=("BHE", "BHN", "BHZ"), networks="*",
                     time_pad=3600.0):
        """Stations with the wanted channels open around the event time,
        annotated with epicentral distance (Station.dist_m)."""
        q = [
            f"network={networks}",
            f"channel={','.join(channels)}",
            f"starttime={_fmt_fdsn_time(event.timestamp - time_pad)}",
            f"endtime={_fmt_fdsn_time(event.timestamp + time_pad)}",
            "level=channel",
            "format=text",
        ]
        url = f"{self.base_url}/fdsnws/station/1/query?" + "&".join(q)
        text = self.opener(url).decode("utf-8", "replace")
        found = {}
        for line in text.splitlines():
            if not line.strip() or line.startswith("#"):
                continue
            w = line.split("|")
            # Network|Station|Location|Channel|Lat|Lon|Elev|Depth|...
            try:
                key = (w[0].strip(), w[1].strip(), w[2].strip())
                st = found.get(key)
                if st is None:
                    st = Station(
                        network=key[0], station=key[1], location=key[2],
                        lat=float(w[4]), lon=float(w[5]),
                        elevation=float(w[6] or 0.0), depth=float(w[7] or 0.0),
                    )
                    st.channels = []
                    found[key] = st
                st.channels.append(w[3].strip())
            except (ValueError, IndexError) as e:
                logger.info("skipping malformed station row %r: %s", line, e)
        out = []
        for st in found.values():
            d = geo.distance_accurate50m(
                np.radians(event.lat), np.radians(event.lon),
                np.radians(st.lat), np.radians(st.lon),
            )
            st.dist_m = float(d)
            if dist_range_m[0] <= st.dist_m <= dist_range_m[1]:
                out.append(st)
        out.sort(key=lambda s: s.dist_m)
        return out

    def get_waveforms(self, event, stations, channels=("BHE", "BHN", "BHZ"),
                      before=60.0, after=600.0):
        """Raw Mini-SEED bytes per (station, channel) window around the
        event; missing channels are skipped with a log line."""
        t0 = event.timestamp - before
        t1 = event.timestamp + after
        chunks = []
        for st in stations:
            for ch in channels:
                q = (f"network={st.network}&station={st.station}"
                     f"&location={st.location or '--'}&channel={ch}"
                     f"&starttime={_fmt_fdsn_time(t0)}"
                     f"&endtime={_fmt_fdsn_time(t1)}")
                url = f"{self.base_url}/fdsnws/dataselect/1/query?{q}"
                try:
                    data = self.opener(url)
                except Exception as e:  # noqa: BLE001
                    logger.info("no data for %s.%s.%s.%s: %s",
                                st.network, st.station, st.location, ch, e)
                    continue
                if data:
                    chunks.append((st, ch, data))
        return chunks


def fetch_dataset(event, workdir, catalog_source=None, waveform_source=None,
                  channels=("BHE", "BHN", "BHZ"), dist_range_m=(3.0e5, 1.0e7),
                  nstations_max=40, before=60.0, after=600.0):
    """Populate `workdir` with raw event data: per-channel Mini-SEED files,
    a stations file and an event file -- the raw layout prepare.py consumes
    (the role of wilber's SEED volume + extraction, wilber.py:262-399).

    Returns (stations, trace_paths)."""
    ws = waveform_source or FDSNWaveforms()
    stations = ws.get_stations(event, dist_range_m=dist_range_m,
                               channels=channels)[: int(nstations_max)]
    chunks = ws.get_waveforms(event, stations, channels=channels,
                              before=before, after=after)
    os.makedirs(workdir, exist_ok=True)
    paths = []
    for st, ch, data in chunks:
        fn = os.path.join(
            workdir, f"raw-{st.network}.{st.station}.{st.location}.{ch}.mseed"
        )
        with open(fn, "wb") as f:
            f.write(data)
        paths.append(fn)

    from .prepare import save_stations_file

    save_stations_file(os.path.join(workdir, "stations.txt"), stations)
    with open(os.path.join(workdir, "event.txt"), "w") as f:
        f.write(f"name = {event.name}\n")
        f.write(f"time = {_fmt_fdsn_time(event.timestamp)}\n")
        f.write(f"latitude = {event.lat}\n")
        f.write(f"longitude = {event.lon}\n")
        f.write(f"depth = {event.depth}\n")
        f.write(f"magnitude = {event.mag}\n")
        f.write(f"region = {event.region}\n")
    return stations, paths


def fdsn_fetcher(base_url="http://service.iris.edu", opener=None, **kwargs):
    """autokiwi `pull_config.fetch` factory: fetch(event, datadir) pulls the
    event's raw dataset from an FDSN endpoint into datadir."""
    ws = FDSNWaveforms(base_url, opener=opener)

    def fetch(event, datadir):
        if not hasattr(event, "timestamp"):  # autokiwi Event
            event = as_acquisition_event(event)
        fetch_dataset(event, datadir, waveform_source=ws, **kwargs)

    return fetch


def fdsn_catalog(base_url="http://service.iris.edu", opener=None, **filters):
    """autokiwi `pull_config.catalog` factory: a callable returning new
    events in autokiwi's Event form (the role of wilber's get_events
    polling loop)."""
    cat = FDSNCatalog(base_url, opener=opener)

    def get_events(time_range=None):
        from .cli.autokiwi import Event as AkEvent

        out = []
        for e in cat.get_events(time_range=time_range, **filters):
            name = e.name or time_mod.strftime(
                "ev_%Y-%m-%d_%H-%M-%S", time_mod.gmtime(e.timestamp))
            out.append(AkEvent(name=name, time=e.timestamp, lat=e.lat,
                               lon=e.lon, depth=e.depth, magnitude=e.mag,
                               region=e.region))
        return out

    return get_events


def as_acquisition_event(ak_event):
    """autokiwi Event -> acquisition Event (for fetch callables)."""
    return Event(timestamp=ak_event.time, mag=ak_event.magnitude,
                 lat=ak_event.lat, lon=ak_event.lon, depth=ak_event.depth,
                 region=ak_event.region, name=ak_event.name)
