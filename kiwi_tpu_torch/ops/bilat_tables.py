"""The bilateral source's centroid tables: the CUDA kernel's wrapper.

The tables of sources/bilat.py (north, east, depth, time f32[B, C],
m f32[B, C, 6], active bool[B, C], C = nx * ny * nt) from the parameter
rows f32[B, 14], in one launch of csrc/bilat_tables.cu, which rounds every
entry as the plain version (discretize_reference, here with the torch
building blocks it shares with sources/circular.py) rounds it on the card.
The kernel replaces no TPU kernel: the JAX package leaves the
discretization to XLA, and the plain version's ~280 small launches a call
were what the card waited for.  See the source's header.

The wrapper is where the path is chosen, from the rows' device alone: on a
CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build, refuse_grad

F32 = torch.float32
NPARAMS = 14
# degree->radian conversion in float32, matching the reference's real-kind
# d2r (orthodrome.f90:316-323 with constants.f90's single-precision pi)
DEG2RAD_F32 = float(np.float32(2.0 / 360.0 * 3.14159265358979))

# kernel launches since the last reset (plain-version calls are not counted)
launches = {"bilat_tables": 0}


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("bilat_tables.cu")
    fn = lib.kiwi_bilat_tables
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(params, shape):
    if params.dtype != F32 or params.dim() != 2 or params.shape[1] != NPARAMS:
        raise ValueError(f"params must be f32[B, {NPARAMS}], got {params.dtype} "
                         f"{tuple(params.shape)}")
    if len(shape) != 3 or any(int(n) != n or n < 1 for n in shape):
        raise ValueError(f"shape must be three positive ints (nx, ny, nt), got {shape}")
    return params.shape[0], *(int(n) for n in shape)


def bilat_tables(params, shape):
    """Centroid tables {north, east, depth, time, m, active} of the rows
    params f32[B, 14] on one grid shape (nx, ny, nt)."""
    B, nx, ny, nt = _check(params, shape)
    refuse_grad("bilat_tables", params)
    dev = params.device
    if dev.type == "cpu":
        return discretize_reference(params, shape)
    if dev.type != "cuda":
        raise ValueError(f"bilat_tables runs on cpu or cuda tensors, not {dev}")
    C = nx * ny * nt
    out = {k: torch.empty((B, C), dtype=F32, device=dev) for k in ("north", "east", "depth", "time")}
    out["m"] = torch.empty((B, C, 6), dtype=F32, device=dev)
    out["active"] = torch.empty((B, C), dtype=torch.bool, device=dev)
    if B == 0:
        return out
    params = params.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_bilat_tables(
            params.data_ptr(), *(out[k].data_ptr() for k in ("north", "east", "depth", "time", "m",
                                                             "active")),
            B, nx, ny, nt, DEG2RAD_F32, stream)
    if err != 0:
        raise build.KernelError(f"kiwi_bilat_tables launch failed: CUDA error {err}")
    launches["bilat_tables"] += 1
    return out


def discretize_reference(params, shape):
    """sources/bilat.discretize in plain torch, differentiable: ~280 small
    device ops."""
    nx, ny, nt = shape
    p = params.to(torch.float32)
    bsz = p.shape[0]
    time, north, east, depth = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    strike, dip, slip_rake, rup_rake = p[:, 5], p[:, 6], p[:, 7], p[:, 8]
    length_a, length_b, width, rupvel, risetime = (p[:, i] for i in range(9, 14))
    length = length_a + length_b

    rotmat_rup = init_euler(dip * DEG2RAD_F32, strike * DEG2RAD_F32,
                            -rup_rake * DEG2RAD_F32)  # [B, 3, 3]
    _, m_rot = mt_rot_from_sdr(strike, dip, slip_rake)

    # spatial grid centered in the fault plane, rupture direction x
    # (source_bilat.f90:377-396); 0-based ix: (2*ix - nx + 1)/(2 nx) * length
    ix = torch.arange(nx, dtype=torch.float32, device=p.device)
    iy = torch.arange(ny, dtype=torch.float32, device=p.device)
    gx = (2.0 * ix - nx + 1.0) / (2.0 * nx) * length[:, None]  # [B, nx]
    gy = (2.0 * iy - ny + 1.0) / (2.0 * ny) * width[:, None]  # [B, ny]
    gxm = gx[:, :, None].expand(bsz, nx, ny)
    gym = gy[:, None, :].expand(bsz, nx, ny)
    c3 = lambda a: a[:, None, None]  # noqa: E731  [B] -> [B, 1, 1]
    tshift = (
        torch.abs(c3(length) / 2.0 - c3(length_b) + gxm) / c3(rupvel)
        + c3(time)
        - c3(torch.maximum(length_a, length_b)) / 2.0 / c3(rupvel)
    )
    # the fault-plane points are (gx, gy, 0): the rotation is two exact f32
    # product terms per axis (the JAX package pins this einsum to HIGHEST;
    # centroid POSITIONS must stay exact)
    rot = [rotmat_rup[:, i, 0, None, None] * gxm + rotmat_rup[:, i, 1, None, None] * gym
           for i in range(3)]
    gn = rot[0] + c3(north)
    ge = rot[1] + c3(east)
    gd = rot[2] + c3(depth)

    # STF cells (source_bilat.f90:403-427)
    dursf = length / nx / rupvel
    xs, ys = trapezoid_stf_points(dursf, risetime)
    durfull = dursf + risetime
    dt_cell = (durfull / nt)[:, None]
    it = torch.arange(nt, dtype=torch.float32, device=p.device)
    wt, toff = plf4_cell_weights(xs, ys, xs[:, :1] + dt_cell * it,
                                 xs[:, :1] + dt_cell * (it + 1))  # [B, nt]

    m6 = m3_to_m6(m_rot) / (nx * ny)  # unit moment spread over subfaults

    # assemble [B, nx*ny*nt] in the reference's (ip, it) nesting order
    def flat(a):
        return a[..., None].expand(bsz, nx, ny, nt).reshape(bsz, -1)

    return {
        "north": flat(gn),
        "east": flat(ge),
        "depth": flat(gd),
        "time": flat(tshift) + toff.repeat(1, nx * ny),
        "m": m6[:, None, :] * wt.repeat(1, nx * ny)[:, :, None],
        "active": torch.ones(bsz, nx * ny * nt, dtype=torch.bool, device=p.device),
    }


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
