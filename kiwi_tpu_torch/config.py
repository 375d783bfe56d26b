"""Framework configuration (counterpart of tunguska/config.py +
configurator.py).

Module-level switches (program behavior) plus a chainable `Config` object:
the reference chains pickled per-step config dicts (config.py:217-270); here
Config objects chain dictionaries and can be loaded from / saved to JSON
files for pipeline runs.  A copy of kiwi_tpu/config.py for the port (pure
Python; its logger is named kiwi_tpu_torch).
"""

from __future__ import annotations

import json
import logging

# module-level switches (tunguska/config.py:9-27)
show_progress = True
component_names = "aclrdunsew"

logger = logging.getLogger("kiwi_tpu_torch")


def setup_logging(filename="kiwi.log", level=logging.INFO):
    """Console + file logging like main.py:38-48."""
    logging.basicConfig(
        level=level,
        format="[%(asctime)s] %(levelname)-8s %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    if filename:
        fh = logging.FileHandler(filename)
        fh.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)-8s %(message)s")
        )
        logging.getLogger().addHandler(fh)
    return logger


class Config:
    """Chained configuration dictionaries: lookups walk the chain from the
    most specific to the base (Config, config.py:217-270)."""

    def __init__(self, *parents, **values):
        self.parents = list(parents)
        self.values = dict(values)

    def get(self, key, default=None):
        if key in self.values:
            return self.values[key]
        for p in self.parents:
            v = p.get(key, _MISSING)
            if v is not _MISSING:
                return v
        return default

    def __getitem__(self, key):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __contains__(self, key):
        return self.get(key, _MISSING) is not _MISSING

    def update(self, **values):
        self.values.update(values)
        return self

    def flat(self):
        out = {}
        for p in reversed(self.parents):
            out.update(p.flat() if isinstance(p, Config) else dict(p))
        out.update(self.values)
        return out

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.flat(), f, indent=2, sort_keys=True, default=str)

    @classmethod
    def load(cls, path, *parents):
        with open(path) as f:
            return cls(*parents, **json.load(f))

    # -- path templating (configurator.py:50-96) ------------------------------

    def __getattr__(self, key):
        # attribute-style access walking the chain, like configurator.Config
        if key in ("parents", "values"):
            raise AttributeError(key)
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise AttributeError(key)
        return v

    def has(self, key):
        return self.get(key, None) is not None

    def get_or_none(self, key):
        return self.get(key, None)

    def get_avail(self, *keys):
        return {k: self[k] for k in keys if self.has(k)}

    def mkpath(self, template, additional=None, maxrepl=100):
        """Iterative %(key)X substitution against the chained config
        (configurator.Config.mkpath, configurator.py:66-96): templates may
        reference other templated keys; unknown keys survive untouched
        (whatever their format char) so an `additional` dict can fill them
        in the same pass or the caller can fill them later."""
        import re

        pat = re.compile(r"%\((\w+)\)([sdifge])")

        def lookup(key):
            if additional is not None and key in additional:
                return additional[key]
            return self.get(key, _MISSING)

        s = template
        for _ in range(maxrepl):
            changed = False

            def sub(m):
                nonlocal changed
                v = lookup(m.group(1))
                if v is _MISSING:
                    return m.group(0)
                changed = True
                return ("%" + m.group(2)) % v

            s = pat.sub(sub, s)
            if not changed:
                return s
        raise ValueError(f"too many substitution levels in template: {template!r}")

    def path(self, name, additional=None):
        return self.mkpath(self[name], additional)

    def path_or_none(self, name, additional=None):
        return self.path(name, additional) if self.has(name) else None


def load_pyconfig(path, **namespace):
    """Execute a Python config file and return its Config objects by name
    (the reference's apps load python configuration modules defining
    chained Config instances).  `namespace` seeds the execution globals."""
    g = {"Config": Config, **namespace}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), g)
    return {k: v for k, v in g.items() if isinstance(v, Config)}


class _Missing:
    def __repr__(self):
        return "<missing>"


_MISSING = _Missing()
