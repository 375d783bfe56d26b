"""Parameterized source model registry (port of kiwi_tpu/sources/base.py).

Each model declares its parameter table (names, units, norms, hard and
soft limits, defaults) and a two-stage discretizer:

* `grid_shape(params, effective_dt)` -- host closed form for the static
  centroid-grid dimensions (the reference's psm_to_tdsm_size_*);
* `discretize(params, effective_dt, shape)` -- torch centroid tables for a
  whole batch of parameter rows f32[B, nparams] that share that shape
  (the batch dimension written out where the JAX package vmaps).

Centroid tables are dicts of tensors: north/east/depth/time f32[B, C],
m f32[B, C, 6], active bool[B, C].  The eikonal models discretize a batch
through an object instead (batch_discretizer; sources/eikonal.py).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from ..ops.bilat_tables import DEG2RAD_F32  # noqa: F401


@dataclasses.dataclass(frozen=True)
class SourceModel:
    name: str
    names: tuple
    units: tuple
    norm: np.ndarray
    min_hard: np.ndarray
    max_hard: np.ndarray
    min_soft: np.ndarray
    max_soft: np.ndarray
    defaults: np.ndarray
    grid_shape: typing.Callable  # (params_np, effective_dt) -> shape tuple
    discretize: typing.Callable  # (params f32[B, n], effective_dt, shape) -> centroids
    # conservative (extent_m, (depth_lo, depth_hi), (t_lo, t_hi)) bounds
    # from raw parameter rows, host-side: the engine plans static windows
    # without pulling discretized centroids off the device
    param_stats: typing.Callable
    # indices of the params grid_shape depends on (shape uniformity of a
    # batch is checked on these columns only)
    shape_param_idx: tuple
    # vectorized post factors: pb f32[B, n] tensor -> (moments [B],
    # risetimes [B]) tensors on pb's device
    post_factors_batch: typing.Callable
    # host predicate pb [B, n] -> bool: True iff the whole batch
    # discretizes to identical centroid positions/times/activity (only the
    # moment tensors differ) -- unlocks the shared-kinematics forward
    shared_kin_check: typing.Callable
    # None, or a factory of the callable that discretizes a whole batch,
    # (model, pb, effective_dt, eikonal_context, device) -> (tables, shape,
    # group size), holding its state across an engine's calls; discretize is
    # then (params_np, effective_dt, eikonal_context) -> numpy tables of one
    # source on the host (the eikonal models, sources/eikonal.BatchDiscretizer)
    batch_discretizer: typing.Callable | None = None
    # True: param_stats takes (pb, effective_dt, eikonal_context) -- the
    # time bound needs the layer shear speeds
    param_stats_ctx: bool = False

    @property
    def nparams(self):
        return len(self.names)

    def param_index(self, name):
        return self.names.index(name)


def _cols_const(pb, idx):
    """True iff the given param columns are identical across the batch."""
    sub = pb[:, list(idx)]
    return bool(np.all(sub == sub[0]))


SOURCE_REGISTRY: dict = {}


def register(model: SourceModel):
    SOURCE_REGISTRY[model.name] = model
    return model


def get_source_model(name) -> SourceModel:
    try:
        return SOURCE_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown source type {name!r}; available: {sorted(SOURCE_REGISTRY)}"
        ) from None
