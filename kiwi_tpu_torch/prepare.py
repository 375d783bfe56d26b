"""Raw-waveform -> kiwi dataset preparation (tunguska/prepare.py).

`save_kiwi_dataset` (prepare.py:62-171) turns a set of station descriptions
+ preprocessed displacement traces + an event into the kiwi data-directory
convention the engine consumes (dataset.standard_setup): receivers.table
rows sorted by epicentral distance, per-trace displacement files named from
a path template with the channel mapped to a kiwi component letter, the
source-origin/reference-time files and a pyrocko-style stations file.

The reference leans on pyrocko for the preprocessing itself (restitution,
downsampling); here `rotate_to_ned` covers the geometry step that the kiwi
dataset needs (arbitrary horizontal orientations -> north/east), and any
further processing is the caller's business.  Network fetching (wilber,
edump) stays out of scope here; local trace files plug straight
in.  Port of kiwi_tpu/prepare.py on the port's float64 numpy geo and
io.writeseismogram.
"""

from __future__ import annotations

import dataclasses
import os
import time as time_mod

import numpy as np

from . import geo
from .io import writeseismogram


@dataclasses.dataclass
class Station:
    """Station description (pyrocko.model.Station's role here)."""

    network: str
    station: str
    location: str
    lat: float
    lon: float
    elevation: float = 0.0
    depth: float = 0.0
    dist_m: float = 0.0  # filled by set_event_relative_data

    @property
    def nsl(self):
        return (self.network, self.station, self.location)

    def nsl_string(self):
        return ".".join(self.nsl)


@dataclasses.dataclass
class RawTrace:
    """One waveform channel."""

    network: str
    station: str
    location: str
    channel: str
    tmin: float  # absolute epoch seconds of first sample
    deltat: float
    ydata: np.ndarray

    @property
    def nsl(self):
        return (self.network, self.station, self.location)


def set_event_relative_data(stations, event):
    """Fill dist_m from the event location (pyrocko's
    Station.set_event_relative_data)."""
    for s in stations:
        _azi, _bazi = geo.azibazi(
            np.radians(event.lat), np.radians(event.lon),
            np.radians(s.lat), np.radians(s.lon))
        s.dist_m = float(geo.distance_accurate50m(
            np.radians(event.lat), np.radians(event.lon),
            np.radians(s.lat), np.radians(s.lon)))
    return stations


def rotate_to_ned(tr1, tr2, azi1, azi2):
    """Rotate two horizontal channels with azimuths azi1/azi2 (degrees,
    clockwise from north) onto north/east.  Returns (north, east) RawTraces
    (channels 'N'/'E'); the pair must share the sampling."""
    if abs(tr1.tmin - tr2.tmin) > 1e-6 or abs(tr1.deltat - tr2.deltat) > 1e-12:
        raise ValueError("horizontal pair must share time sampling")
    a1 = np.radians(azi1)
    a2 = np.radians(azi2)
    m = np.array([[np.cos(a1), np.cos(a2)], [np.sin(a1), np.sin(a2)]])
    n = min(len(tr1.ydata), len(tr2.ydata))
    ne = m @ np.vstack([tr1.ydata[:n], tr2.ydata[:n]])
    mk = lambda ch, y: RawTrace(tr1.network, tr1.station, tr1.location, ch,
                                tr1.tmin, tr1.deltat, y.astype(np.float32))
    return mk("N", ne[0]), mk("E", ne[1])


def save_stations_file(path, stations):
    """pyrocko-style stations file (model.dump_stations' essential columns:
    nsl, lat, lon, elevation, depth)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s in stations:
            f.write(f"{s.nsl_string()}  {s.lat:.6f} {s.lon:.6f} "
                    f"{s.elevation:g} {s.depth:g}\n")


def save_kiwi_dataset(stations, traces, event, config):
    """Write the kiwi data directory (prepare.py:62-171).

    stations: [Station]; traces: [RawTrace] already preprocessed to
    displacement; event: cli.autokiwi.Event; config: config.Config with
      wanted_channels        e.g. ["BHN", "BHE", "BHZ"]
      kiwi_component_map     channel -> component letter, e.g. {"BHZ": "d"}
      trace_time_zero        'event' (shift to event-relative) or 'system'
      trace_factor           amplitude scale (default 1.0)
      nsets                  duplicate receiver rows (default 1)
    and path templates (all optional except receivers/displacement):
      receivers_path, displacement_trace_path (with %(ireceiver)i,
      %(component)s, %(network)s, %(station)s, %(location)s, %(channel)s),
      source_origin_path, reference_time_path, event_info_path,
      stations_path.
    Returns the number of receivers written.
    """
    set_event_relative_data(stations, event)
    dstations = sorted(stations, key=lambda s: s.dist_m)
    wanted = list(config["wanted_channels"])
    cmap = dict(config["kiwi_component_map"])
    factor = float(config.get("trace_factor", 1.0))
    time_zero = config.get("trace_time_zero", "event")
    nsets = int(config.get("nsets", 1))

    dataset = []
    for station in dstations:
        rows = sorted(
            (tr for tr in traces
             if tr.nsl == station.nsl and tr.channel in wanted),
            key=lambda tr: tr.channel,
        )
        if rows:
            comps = "".join(cmap[tr.channel] for tr in rows)
            dataset.append((station, comps, rows))

    if config.has("event_info_path"):
        event.dump(config.path("event_info_path"))
    if config.has("stations_path"):
        save_stations_file(config.path("stations_path"),
                           [s for s, _c, _t in dataset])

    recf = None
    if config.has("receivers_path"):
        fpath = config.path("receivers_path")
        os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
        recf = open(fpath, "w")

    iref = 1
    for station, components, rows in dataset:
        nsl = station.nsl_string()
        for _ in range(nsets):
            if recf is not None:
                recf.write("%15.8e %15.8e %15.8e %3s %-15s\n" % (
                    station.lat, station.lon, station.depth, components, nsl))
            for tr in rows:
                tmin = tr.tmin - (event.time if time_zero == "event" else 0.0)
                fn = config.mkpath(config["displacement_trace_path"], {
                    "ireceiver": iref,
                    "component": cmap[tr.channel],
                    "network": tr.network,
                    "station": tr.station,
                    "location": tr.location,
                    "channel": tr.channel,
                })
                os.makedirs(os.path.dirname(fn) or ".", exist_ok=True)
                writeseismogram(fn, "*", tr.ydata * np.float32(factor),
                                tmin, tr.deltat)
            iref += 1
    if recf is not None:
        recf.close()

    if config.has("reference_time_path"):
        with open(config.path("reference_time_path"), "w") as f:
            f.write("%i %s\n" % (event.time, time_mod.strftime(
                "%Y/%m/%d %H:%M:%S", time_mod.gmtime(event.time))))

    if config.has("source_origin_path"):
        with open(config.path("source_origin_path"), "w") as f:
            t = event.time if time_zero == "system" else 0.0
            f.write("%e %e %f\n" % (event.lat, event.lon, t))

    return iref - 1
