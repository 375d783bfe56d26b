"""Event-driven inversion automation (python/scripts/autokiwi).

Same command surface as the reference's autokiwi script:

    python -m kiwi_tpu_torch.cli.autokiwi [options] pull    [ first | all | name ]
    python -m kiwi_tpu_torch.cli.autokiwi [options] prepare ( all | names ... )
    python -m kiwi_tpu_torch.cli.autokiwi [options] process ( all | missing | names ... )
    python -m kiwi_tpu_torch.cli.autokiwi [options] report  ( all | names ... )
    python -m kiwi_tpu_torch.cli.autokiwi [options] post    ( all | names ... )
    python -m kiwi_tpu_torch.cli.autokiwi [options] list

Configuration comes from an `autokiwi.conf` python file searched upward from
the working directory (autokiwi:504-516), defining chained `Config` objects
named base_config / pull_config / kiwi_config / post_config; plugin modules
listed in base_config.plugins may add commands through the same
`__autokiwi_commands__` protocol (autokiwi:419-440).

The reference pulls events from IRIS Wilber / GEOFON (autokiwi:36-110) and
posts results with rsync -- both need a network.  Here the catalog source is
pluggable: `pull_config.catalog` is either a local event-list file (one
`name time lat lon depth magnitude [region...]` row per line, '#' comments)
or a callable returning Event objects; a custom network fetcher drops in as
`pull_config.fetch` (called per event to populate its data directory).
`post` copies locally or via rsync when target_host is set.

Port of kiwi_tpu/cli/autokiwi.py on the port's config; its processing
command is the caller's, typically
`python -m kiwi_tpu_torch.cli.kiwi_main [--device cuda|cpu] work ...`.
"""

from __future__ import annotations

import calendar
import dataclasses
import glob
import logging
import os
import re
import shutil
import subprocess
import sys
import time as time_mod

from ..config import Config, load_pyconfig, setup_logging

logger = logging.getLogger("kiwi_tpu_torch.autokiwi")

COMMANDS = ["pull", "prepare", "process", "report", "post", "list"]


@dataclasses.dataclass
class Event:
    """Minimal event description (pyrocko.model.Event's role here)."""

    name: str
    time: float  # epoch seconds
    lat: float
    lon: float
    depth: float
    magnitude: float
    region: str = ""

    def dump(self, path):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for k in ("name", "time", "lat", "lon", "depth", "magnitude", "region"):
                f.write(f"{k} = {getattr(self, k)}\n")

    @classmethod
    def load(cls, path):
        kw = {}
        with open(path) as f:
            for line in f:
                if "=" not in line:
                    continue
                k, v = (s.strip() for s in line.split("=", 1))
                kw[k] = v
        return cls(
            name=kw.get("name", ""),
            time=float(kw.get("time", 0.0)),
            lat=float(kw.get("lat", 0.0)),
            lon=float(kw.get("lon", 0.0)),
            depth=float(kw.get("depth", 0.0)),
            magnitude=float(kw.get("magnitude", 0.0)),
            region=kw.get("region", ""),
        )


def load_catalog(source, time_range=None):
    """Events from a local catalog table or a callable (the offline stand-in
    for the reference's wilber/geofon catalog queries)."""
    if callable(source):
        events = list(source(time_range) if time_range else source(None))
    else:
        events = []
        with open(source) as f:
            for line in f:
                w = line.split()
                if not w or w[0].startswith("#"):
                    continue
                events.append(
                    Event(
                        name=w[0],
                        time=float(w[1]),
                        lat=float(w[2]),
                        lon=float(w[3]),
                        depth=float(w[4]),
                        magnitude=float(w[5]),
                        region=" ".join(w[6:]),
                    )
                )
    if time_range is not None:
        events = [e for e in events if time_range[0] <= e.time <= time_range[1]]
    return events


def event_names_from_paths(base_config):
    """Reverse-lookup event names from existing event dirs by matching the
    path template (autokiwi:114-127)."""
    pat_dirs = base_config.path("event_dir", additional={"event_name": "*"})
    names = []
    template = base_config.path("event_dir", additional={"event_name": "xxxEVENTNAMExxx"})
    pat = re.escape(template).replace("xxxEVENTNAMExxx", r"([^/]+)")
    for ev_dir in sorted(glob.glob(pat_dirs)):
        if not os.path.isdir(ev_dir):
            continue
        m = re.match(pat, ev_dir)
        if m:
            names.append(m.group(1))
    return names


def pull(pull_config, which="first", force=False, onlylist=False, specific=None):
    """Select (and optionally fetch) new events (autokiwi:129-179).

    Events already having a data volume are skipped unless force.  A
    `fetch(event, data_path)` callable in the config populates the data
    volume; without one the event description itself is written (enough to
    drive fully-synthetic pipelines offline)."""
    time_range = None
    if pull_config.has("time_range"):
        time_range = tuple(pull_config["time_range"])
    events = load_catalog(pull_config["catalog"], time_range)
    if pull_config.has("event_filter"):
        events = [e for e in events if pull_config["event_filter"](e)]
    if specific is not None:
        events.sort(key=lambda e: abs(e.time - specific))
    else:
        events.sort(key=lambda e: -e.time)  # newest first (autokiwi:152-155)

    pending = []
    for ev in events:
        vol = pull_config.path("seed_volume", additional={"event_name": ev.name})
        if force or not os.path.exists(vol):
            pending.append(ev)
    if onlylist:
        return [e.name for e in pending]

    if which not in ("first", "all"):
        pending = [e for e in pending if e.name == which]
    elif which == "first":
        pending = pending[:1]

    got = []
    fetch = pull_config.get("fetch")
    for ev in pending:
        vol = pull_config.path("seed_volume", additional={"event_name": ev.name})
        os.makedirs(os.path.dirname(vol) or ".", exist_ok=True)
        if fetch is not None:
            fetch(ev, vol + ".incomplete")
            os.rename(vol + ".incomplete", vol)
        else:
            ev.dump(vol)
        ev.dump(vol + ".event")
        logger.info("pulled event: %s", ev.name)
        got.append(ev.name)
    return got


def prepare(base_config, kiwi_config, event_names):
    """Create per-event processing directories (the role of tunguska
    prepare): the processing dir is laid out and the event description
    copied in; a `prepare_hook(event_name, processing_dir)` callable in
    kiwi_config does the dataset construction (GF selection, windowing,
    reference seismogram extraction)."""
    for name in event_names:
        pdir = kiwi_config.path("processing_dir", additional={"event_name": name})
        os.makedirs(pdir, exist_ok=True)
        evfn = None
        if base_config.has("seed_volume"):
            cand = base_config.path("seed_volume", additional={"event_name": name}) + ".event"
            if os.path.exists(cand):
                evfn = cand
        if evfn:
            shutil.copy(evfn, os.path.join(pdir, "event.txt"))
        hook = kiwi_config.get("prepare_hook")
        if hook is not None:
            hook(name, pdir)
        logger.info("prepared %s", pdir)


def run_processing_command(processing_dir_tmpl, command, event_names,
                           fail_label="", fail_filename=None):
    """Run a command in each event's processing dir (autokiwi:269-292)."""
    failures = False
    for name in event_names:
        pdir = processing_dir_tmpl % {"event_name": name}
        if not os.path.exists(pdir):
            logger.error("cannot run %s on %s (no processing directory)", fail_label, name)
            continue
        try:
            subprocess.check_call(command, cwd=pdir)
        except subprocess.CalledProcessError:
            logger.error('running "%s" on event %s failed', fail_label, name)
            if fail_filename is not None:
                with open(fail_filename % {"event_name": name}, "w") as f:
                    f.write(fail_label + "\n")
            failures = True
    return not failures


def post(post_config, event_names):
    """Publish results: local copy, or rsync when target_host is set
    (autokiwi:294-327).  Runs trigger_command afterwards if configured."""
    failures = False
    for name in event_names:
        source_dir = post_config.path("source_dir", additional={"event_name": name}).rstrip("/")
        target_dir = post_config.path("target_dir", additional={"event_name": name}).rstrip("/")
        if not os.path.isdir(source_dir):
            continue
        host = post_config.get("target_host")
        try:
            if host:
                subprocess.check_call(["rsync", "-a", source_dir + "/", f"{host}:{target_dir}"])
            else:
                os.makedirs(target_dir, exist_ok=True)
                shutil.copytree(source_dir, target_dir, dirs_exist_ok=True)
            tc = post_config.get("trigger_command")
            if tc:
                subprocess.check_call(
                    [post_config.mkpath(x, additional={"event_name": name}) for x in tc]
                )
        except (subprocess.CalledProcessError, OSError):
            logger.error("posting results for %s failed", name)
            failures = True
    return not failures


def find_config(start=None):
    """Search parent directories for autokiwi.conf (autokiwi:504-516)."""
    wd = os.path.abspath(start or os.getcwd())
    while True:
        fn = os.path.join(wd, "autokiwi.conf")
        if os.path.exists(fn):
            return fn
        nwd = os.path.dirname(wd)
        if nwd == wd:
            return None
        wd = nwd


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="autokiwi")
    p.add_argument("--loglevel", default="warning",
                   choices=("error", "warning", "info", "debug"))
    p.add_argument("--config", dest="config_filename")
    p.add_argument("--force", action="store_true")
    p.add_argument("--pending", action="store_true")
    p.add_argument("--specific", help='pull event closest to "YYYY-MM-DD HH:MM:SS"')
    p.add_argument("command")
    p.add_argument("args", nargs="*")
    opts = p.parse_args(argv)

    setup_logging(filename=None, level=getattr(logging, opts.loglevel.upper()))

    config_filename = opts.config_filename or find_config()
    if config_filename is None:
        sys.exit("no autokiwi.conf found in this or any parent directory")
    conf = load_pyconfig(config_filename)
    base_config = conf["base_config"]
    kiwi_config = conf.get("kiwi_config")
    pull_config = conf.get("pull_config")
    post_config = conf.get("post_config")

    available = list(COMMANDS)
    plugins = []
    if base_config.has("plugins_dir"):
        pdir = base_config.path("plugins_dir")
        if pdir not in sys.path:
            sys.path.insert(0, pdir)
        for pname in base_config.get("plugins", []):
            plugin = __import__(pname)
            for cmd in plugin.__autokiwi_commands__:
                if cmd in available:
                    sys.exit(f'command defined more than once: "{cmd}" (plugin {pname})')
                available.append(cmd)
            plugins.append(plugin)

    commands = opts.command.split(",")
    for command in commands:
        if command not in available:
            sys.exit(f"no such command: {command}")

    event_names = []
    if "pull" in commands or ("list" in commands and opts.pending):
        if pull_config is None:
            sys.exit("no pull configuration found")
        which = opts.args[0] if opts.args else "first"
        specific = None
        if opts.specific:
            # UTC, not local: catalog event times are UTC epochs and the
            # seismological convention is to quote event times in UTC
            # (mktime would shift the target by the host's TZ offset)
            specific = calendar.timegm(
                time_mod.strptime(opts.specific, "%Y-%m-%d %H:%M:%S")
            )
        event_names = pull(pull_config, which=which, force=opts.force,
                           onlylist=opts.pending, specific=specific)
        for name in event_names:
            print(name)
        if opts.pending:
            event_names = []
        if not event_names:
            return

    if not event_names:
        event_names = list(opts.args)

    if event_names and event_names[0] in ("all", "missing"):
        want_missing = event_names[0] == "missing"
        event_names = event_names_from_paths(base_config)
        if want_missing and kiwi_config is not None:
            done_tmpl = kiwi_config.get("done_filename")
            if done_tmpl:
                event_names = [
                    n for n in event_names
                    if not os.path.exists(kiwi_config.mkpath(
                        done_tmpl, additional={"event_name": n}))
                ]

    if "list" in commands and not opts.pending:
        for name in event_names_from_paths(base_config):
            print(name)

    if "prepare" in commands:
        prepare(base_config, kiwi_config, event_names)

    ok = True
    # expanded like processing_dir: a template naming other keys
    # (%(event_dir)s/failed) keeps only %(event_name)s for each event
    fail_fn = base_config.path_or_none("fail_filename")
    if "process" in commands:
        # path() leaves the unknown %(event_name)s placeholder in place for
        # run_processing_command to fill per event
        ok &= run_processing_command(
            kiwi_config.path("processing_dir"),
            kiwi_config["processing_command"], event_names,
            fail_label="process", fail_filename=fail_fn,
        )
    if "report" in commands:
        ok &= run_processing_command(
            kiwi_config.path("processing_dir"),
            kiwi_config["report_command"], event_names,
            fail_label="report", fail_filename=fail_fn,
        )
    if "post" in commands:
        ok &= post(post_config, event_names)

    for plugin in plugins:
        for command in commands:
            if command in getattr(plugin, "__autokiwi_commands__", ()):
                plugin.__autokiwi_main__(command, conf, event_names)

    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
