"""Dict-like Source object over the registered source models (port of
kiwi_tpu/invert/source.py, numpy on the port's source registry).

Counterpart of tunguska/source.py: parameter access by name, defaults from
the model tables, grid expansion and randomization for searches.
"""

from __future__ import annotations

import numpy as np

from ..sources import get_source_model


class Source:
    """A parameterized source: model name + parameter vector."""

    def __init__(self, sourcetype="bilateral", params=None, **kwargs):
        self.sourcetype = sourcetype
        self.model = get_source_model(sourcetype)
        if params is None:
            self.params = self.model.defaults.copy()
        else:
            params = np.asarray(params, dtype=np.float32)
            if params.shape != (self.model.nparams,):
                raise ValueError(
                    f"{sourcetype} needs {self.model.nparams} params, got {params.shape}"
                )
            self.params = params.copy()
        for k, v in kwargs.items():
            self[k] = v

    def __getitem__(self, name):
        return float(self.params[self.model.param_index(name)])

    def __setitem__(self, name, value):
        self.params[self.model.param_index(name)] = value

    def keys(self):
        return list(self.model.names)

    def copy(self):
        return Source(self.sourcetype, self.params)

    def clip_to_hard_limits(self):
        self.params = np.clip(self.params, self.model.min_hard, self.model.max_hard)
        return self

    def randomize(self, rng=None):
        """Uniform draw within soft limits (source.py:166-188)."""
        rng = rng or np.random.default_rng()
        lo = np.maximum(self.model.min_soft, -1e20)
        hi = np.minimum(self.model.max_soft, 1e20)
        self.params = rng.uniform(lo, hi).astype(np.float32)
        return self

    def __repr__(self):
        pairs = ", ".join(f"{n}={v:g}" for n, v in zip(self.model.names, self.params))
        return f"Source({self.sourcetype!r}, {pairs})"


def source_grid(base: Source, param_values: list, constraint=None):
    """Cartesian-product source grid (Source.grid, source.py:119-164).

    param_values: [(name, values array)], ordered; constraint: optional
    callable(params_row) -> bool.  Returns (params [B, P], coords list of
    per-source value tuples).
    """
    model = base.model
    names = [n for n, _ in param_values]
    idx = [model.param_index(n) for n in names]
    grids = np.meshgrid(*[np.asarray(v, dtype=np.float32) for _, v in param_values],
                        indexing="ij")
    flat = [g.reshape(-1) for g in grids]
    b = flat[0].shape[0] if flat else 1
    params = np.tile(base.params, (b, 1))
    for i, col in zip(idx, flat):
        params[:, i] = col
    if constraint is not None:
        keep = np.array([bool(constraint(p)) for p in params])
        params = params[keep]
        flat = [c[keep] for c in flat]
    coords = list(zip(*flat)) if flat else [()]
    return params, coords
