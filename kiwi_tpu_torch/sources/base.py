"""Parameterized source model registry (port of kiwi_tpu/sources/base.py).

Each model declares its parameter table (names, units, norms, hard and
soft limits, defaults) and a two-stage discretizer:

* `grid_shape(params, effective_dt)` -- host closed form for the static
  centroid-grid dimensions (the reference's psm_to_tdsm_size_*);
* `discretize(params, effective_dt, shape)` -- torch centroid tables for a
  whole batch of parameter rows f32[B, nparams] that share that shape
  (the batch dimension written out where the JAX package vmaps).

Centroid tables are dicts of tensors: north/east/depth/time f32[B, C],
m f32[B, C, 6], active bool[B, C].  The eikonal models discretize on the
host instead (host_discretize; sources/eikonal.py).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

# degree->radian conversion in float32, matching the reference's real-kind
# d2r (orthodrome.f90:316-323 with constants.f90's single-precision pi)
DEG2RAD_F32 = float(np.float32(2.0 / 360.0 * 3.14159265358979))


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
    # True: discretize(params_np, effective_dt, eikonal_context) runs on the
    # host per source and returns numpy tables (the eikonal models; the
    # engine also has a batched device discretizer for them)
    host_discretize: bool = False
    # True: param_stats takes (pb, effective_dt, eikonal_context) -- the
    # time bound needs the layer shear speeds
    param_stats_ctx: bool = False

    @property
    def nparams(self):
        return len(self.names)


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


def init_euler(alpha, beta, gamma):
    """Rotation matrices f32[..., 3, 3] from Euler angles (euler.f90:28-67)."""
    ca, cb, cg = torch.cos(alpha), torch.cos(beta), torch.cos(gamma)
    sa, sb, sg = torch.sin(alpha), torch.sin(beta), torch.sin(gamma)
    return torch.stack(
        [
            torch.stack([cb * cg - ca * sb * sg, -cb * sg - ca * sb * cg, sa * sb], -1),
            torch.stack([sb * cg + ca * cb * sg, -sb * sg + ca * cb * cg, -sa * cb], -1),
            torch.stack([sa * sg, sa * cg, ca], -1),
        ],
        dim=-2,
    )


def mt_rot_from_sdr(strike_deg, dip_deg, rake_deg):
    """(rotmat_slip, m_rot) f32[..., 3, 3] from strike/dip/rake in degrees.

    m_rot = R . M_UNROT . R^T with the unrotated double couple
    M_UNROT = [[0,0,-1],[0,0,0],[-1,0,0]] (source_bilat.f90:342), written
    out: m[i, j] = -(R[i,2] R[j,0] + R[i,0] R[j,2]) -- the matrix product's
    nonzero terms in its order, with no host constant to copy per call."""
    strike = strike_deg * DEG2RAD_F32
    dip = dip_deg * DEG2RAD_F32
    rake = rake_deg * DEG2RAD_F32
    rot = init_euler(dip, strike, -rake)
    m = -(rot[..., :, 2, None] * rot[..., None, :, 0]
          + rot[..., :, 0, None] * rot[..., None, :, 2])
    return rot, m


def m3_to_m6(m):
    return torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
                        m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]], -1)


def plf4_cell_weights(xs, ys, ta, tb):
    """Area and centroid of a 4-point PLF over cells [ta, tb].

    xs, ys: f32[B, 4] control points (zero-width vertical jumps contribute
    no area); ta, tb: f32[B, nt].  Returns (wt[B, nt], toff[B, nt]) exactly
    as plf_integrate_and_centroid (piecewise_linear_function.f90:163-193).
    """
    area = torch.zeros_like(ta)
    moment = torch.zeros_like(ta)
    for i in range(3):
        x0, x1 = xs[:, i : i + 1], xs[:, i + 1 : i + 2]
        y0, y1 = ys[:, i : i + 1], ys[:, i + 1 : i + 2]
        lo = torch.maximum(ta, x0)
        hi = torch.minimum(tb, x1)
        valid = hi > lo
        dxseg = torch.where(x1 != x0, x1 - x0, 1.0)
        slope = torch.where(x1 != x0, (y1 - y0) / dxseg, 0.0)
        ylo = y0 + slope * (lo - x0)
        yhi = y0 + slope * (hi - x0)
        a = torch.where(valid, (ylo + yhi) * (hi - lo) / 2.0, 0.0)
        ysum = ylo + yhi
        cx = torch.where(
            ysum != 0.0,
            (lo * (2.0 * ylo + yhi) + hi * (ylo + 2.0 * yhi))
            / torch.where(ysum != 0.0, 3.0 * ysum, 1.0),
            (lo + hi) / 2.0,
        )
        area = area + a
        moment = moment + a * cx
    toff = torch.where(area != 0.0, moment / torch.where(area != 0.0, area, 1.0),
                       (ta + tb) / 2.0)
    return area, toff


def trapezoid_stf_points(dursf, risetime):
    """Control points f32[B, 4] of the box(x)box STF (source_bilat.f90:403-414)."""
    lo = torch.minimum(dursf, risetime)
    hi = torch.maximum(dursf, risetime)
    safe_hi = torch.where(hi > 0, hi, 1.0)
    xs = torch.stack([-(hi + lo) / 2.0, -(hi - lo) / 2.0, (hi - lo) / 2.0, (hi + lo) / 2.0], -1)
    ys = torch.stack([0.0 * hi, 1.0 / safe_hi, 1.0 / safe_hi, 0.0 * hi], -1)
    return xs, ys
