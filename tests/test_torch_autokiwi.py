"""The port's config and autokiwi: tests/test_pipeline.py's config
templating and offline autokiwi cycle (pull -> prepare -> process -> report
-> post -> list over event directories, a local catalog) on
kiwi_tpu_torch.config and kiwi_tpu_torch.cli.autokiwi, the catalog and
Event round trips against kiwi_tpu's, and a failing processing command
leaving a fail file and no done file."""

import logging

import pytest

from kiwi_tpu.cli import autokiwi as jak
from kiwi_tpu_torch import config as tconfig
from kiwi_tpu_torch.cli import autokiwi

CONF = (
    "import sys\n"
    "PY = sys.executable\n"
    "base_config = Config(base_dir='.',\n"
    "    event_dir='%(base_dir)s/events/%(event_name)s',\n"
    "    seed_volume='%(event_dir)s/data.kiwi',\n"
    "    fail_filename='%(event_dir)s/failed')\n"
    "pull_config = Config(base_config, catalog='catalog.txt')\n"
    "kiwi_config = Config(base_config,\n"
    "    processing_dir='%(event_dir)s/work',\n"
    "    processing_command=[PY, '-c', {process!r}],\n"
    "    report_command=[PY, '-c', \"open('r.html','w').write('x')\"],\n"
    "    done_filename='%(event_dir)s/work/result.txt')\n"
    "post_config = Config(base_config,\n"
    "    source_dir='%(event_dir)s/work',\n"
    "    target_dir='%(base_dir)s/pub/%(event_name)s')\n"
)
CATALOG = ("ev-a 1000.0 40.0 29.0 17000 7.6 SomeRegion\n"
           "# a comment\n"
           "ev-b 2000.0 38.0 142.0 29000 9.1 Other\n")


def test_config_path_templating(tmp_path):
    """Chained %(key)s path templating + python config files
    (configurator.py:12-96)."""
    from kiwi_tpu_torch.config import Config, load_pyconfig

    base = Config(base_dir="/data/events", event_name="ev2024")
    c = Config(base, event_dir="%(base_dir)s/%(event_name)s",
               work="%(event_dir)s/work-%(run)s")
    assert c.path("event_dir") == "/data/events/ev2024"
    assert c.mkpath(c["work"], additional={"run": 3}) == "/data/events/ev2024/work-3"
    assert c.mkpath(c["work"]) == "/data/events/ev2024/work-%(run)s"
    assert c.path_or_none("missing") is None
    assert c.event_name == "ev2024"  # attribute access walks the chain
    assert c.flat()["base_dir"] == "/data/events"
    c.save(str(tmp_path / "c.json"))
    assert Config.load(str(tmp_path / "c.json")).path("event_dir") == "/data/events/ev2024"
    loop = Config(a="%(b)s", b="%(a)s")
    with pytest.raises(ValueError, match="too many substitution levels"):
        loop.path("a")

    fn = tmp_path / "conf.py"
    fn.write_text("base = Config(gfdb='/gf/db')\n"
                  "run = Config(base, out='%(gfdb)s/out')\n")
    cfgs = load_pyconfig(str(fn))
    assert cfgs["run"].path("out") == "/gf/db/out"
    assert tconfig.logger.name == "kiwi_tpu_torch"
    assert tconfig.setup_logging(filename=None, level=logging.WARNING) is tconfig.logger


def test_catalog_and_event_as_the_reference(tmp_path):
    (tmp_path / "catalog.txt").write_text(CATALOG)
    got = autokiwi.load_catalog(str(tmp_path / "catalog.txt"), time_range=(0.0, 1500.0))
    want = jak.load_catalog(str(tmp_path / "catalog.txt"), time_range=(0.0, 1500.0))
    assert [vars(e) for e in got] == [vars(e) for e in want] and len(got) == 1
    got[0].dump(str(tmp_path / "t.event"))
    want[0].dump(str(tmp_path / "j.event"))
    assert (tmp_path / "t.event").read_text() == (tmp_path / "j.event").read_text()
    assert vars(autokiwi.Event.load(str(tmp_path / "j.event"))) == vars(want[0])


def test_autokiwi_workflow(tmp_path, monkeypatch, capsys):
    """Offline autokiwi cycle over event directories (python/scripts/
    autokiwi's command surface with a local catalog backend)."""
    (tmp_path / "autokiwi.conf").write_text(
        CONF.format(process="open('result.txt','w').write('x')"))
    (tmp_path / "catalog.txt").write_text(CATALOG)
    monkeypatch.chdir(tmp_path)

    autokiwi.main(["pull", "first"])
    assert capsys.readouterr().out.strip() == "ev-b"  # newest first
    autokiwi.main(["pull", "all"])
    autokiwi.main(["list"])
    assert set(capsys.readouterr().out.split()) >= {"ev-a", "ev-b"}

    autokiwi.main(["prepare,process,report", "all"])
    assert (tmp_path / "events/ev-a/work/result.txt").exists()
    assert (tmp_path / "events/ev-b/work/r.html").exists()
    assert (tmp_path / "events/ev-a/work/event.txt").exists()
    assert not (tmp_path / "events/ev-a/failed").exists()

    autokiwi.main(["post", "all"])
    assert (tmp_path / "pub/ev-a/result.txt").exists()

    # nothing missing once results exist
    autokiwi.main(["process", "missing"])

    ev = autokiwi.Event.load(str(tmp_path / "events/ev-b/data.kiwi.event"))
    assert ev.name == "ev-b" and ev.magnitude == 9.1


def test_failing_process_leaves_a_fail_file(tmp_path, monkeypatch):
    """A processing command that exits nonzero: autokiwi exits 1, writes the
    event's fail file, and no done file appears (what a caller checks).
    The port expands fail_filename's other keys as it does processing_dir's;
    kiwi_tpu formats the raw template with the event name alone and raises
    KeyError on this configuration (a divergence kept on purpose)."""
    (tmp_path / "autokiwi.conf").write_text(CONF.format(process="raise SystemExit(3)"))
    (tmp_path / "catalog.txt").write_text(CATALOG)
    monkeypatch.chdir(tmp_path)
    autokiwi.main(["pull", "all"])
    with pytest.raises(SystemExit) as e:
        autokiwi.main(["prepare,process", "ev-a"])
    assert e.value.code == 1
    assert (tmp_path / "events/ev-a/failed").read_text() == "process\n"
    assert not (tmp_path / "events/ev-a/work/result.txt").exists()
    assert not (tmp_path / "events/ev-b/failed").exists()
    assert autokiwi.find_config(str(tmp_path / "events/ev-a/work")) == str(
        tmp_path / "autokiwi.conf")
    with pytest.raises(KeyError, match="event_dir"):
        jak.main(["prepare,process", "ev-b"])
