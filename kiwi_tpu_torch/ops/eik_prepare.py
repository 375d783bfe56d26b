"""The eikonal batch preparation: the CUDA kernel's wrapper.

What fixes the shapes of the device eikonal discretizer
(sources/eikonal.make_device_discretizer), for every source of a batch: the
rupture's 180-gon clipped by the constraint half-spaces, its box in rupture
coordinates, the fine grid's size and spacing, the nucleation test, the
least rupture speed over the grid's depths and the coarse grid's size and
spacing, in one launch of csrc/eik_prepare.cu.  The kernel replaces no TPU
kernel: the JAX package prepares the batch in host numpy, as the port did
(_prepare_batch_vec, the plain version, at the end of this file), 45-65 ms
of a 384-row call while the card waited.  See the source's header.

In: the rows f64[B, 25] of `pack_rows` (named_params_batch's ten named
columns, rotmat, m6), which `rows_on` sends to the card in one pinned,
non-blocking copy, and the session's context (constraints, layer depths and
speeds, the 180-gon's unit circle) as one f64 tensor, sent once a device and
`EikonalContext.content_key()`.  Out: (summary, arrays) on the rows' device:
the arrays in the dtypes the discretizer takes (float32, int32 for `ndims`
and `cdims`) plus a per-row `status`, and the batch's summary i64[8], which
`static_from_summary` turns into the discretizer's static shape and the
host's hard bound on time cells, or the host's ValueError.

The wrapper is where the path is chosen, from the rows' device alone: on a
CPU tensor it runs the plain version and casts its arrays as the kernel
writes them (summary_of gives its summary); on a CUDA tensor it launches the
kernel or raises.  There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import geometry as geom
from ..profiling import to_device
from . import build, refuse_grad

F32 = torch.float32
I32 = torch.int32
F64 = torch.float64
NPOINTS = 180
# named_params_batch's named columns, in the rows' order
NAMED = ("time", "north", "east", "depth", "bord_shift_x", "bord_shift_y", "bord_radius",
         "nukl_shift_x", "nukl_shift_y", "rel_vrup")
NROW = len(NAMED) + 9 + 6
# the kernel's outputs, field-major (csrc/eik_prepare.cu): name, width
F32_FIELDS = (("first", 2), ("delta", 2), ("nukl", 2), ("center", 3), ("rotmat", 9), ("m6", 6),
              ("ccenter", 3), ("radius", 1), ("cdelta", 2), ("minspeed", 1), ("time0", 1),
              ("relv", 1))
I32_FIELDS = (("ndims", 2), ("cdims", 2), ("status", 1))
# status bits of a row and the summary's entries
EMPTY, NUKL_OUTSIDE, OVERFLOW = 1, 2, 4
S_ND, S_NC, S_EMPTY, S_NUKL, S_OVERFLOW, S_NTMAX = 0, 2, 4, 5, 6, 7
NSUMMARY = 8

# kernel launches since the last reset (plain-version calls are not counted)
launches = {"eik_prepare": 0}


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("eik_prepare.cu")
    fn = lib.kiwi_eik_prepare
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_double] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def pack_rows(named):
    """named_params_batch's (pv, m6s, rotmats) as rows f64[B, 25]."""
    pv, m6s, rotmats = named
    cols = np.stack([np.asarray(pv[k], np.float64) for k in NAMED], axis=-1)
    return np.concatenate([cols, np.asarray(rotmats, np.float64).reshape(-1, 9),
                           np.asarray(m6s, np.float64)], axis=1)


def unpack_rows(rows):
    """pack_rows' inverse: (pv, m6s, rotmats)."""
    rows = np.asarray(rows, np.float64)
    pv = {k: rows[:, i].copy() for i, k in enumerate(NAMED)}
    n = len(NAMED)
    return pv, rows[:, n + 9:].copy(), rows[:, n:n + 9].reshape(-1, 3, 3).copy()


def rows_on(named, device):
    """pack_rows on `device`: onto the card in one pinned, non-blocking copy."""
    rows = torch.from_numpy(pack_rows(named))
    device = torch.device(device)
    if device.type != "cuda":
        return rows
    return rows.pin_memory().to(device, non_blocking=True)


def context_array(constraints, layer_depths, layer_vs):
    """The session's context as f64[6 ncons + ndepth + nvs + 2 * 180] and its
    sizes (ncons, ndepth, nvs): each constraint's point and normal, the layer
    depths and speeds, the cos and sin of the 180-gon's angles (computed as
    _prepare_batch_vec computes them)."""
    cons = [np.concatenate([np.asarray(p, np.float64), np.asarray(n, np.float64)])
            for p, n in constraints]
    depths = np.asarray(layer_depths, np.float64).ravel()
    vs = np.asarray(layer_vs, np.float64).ravel()
    i = np.arange(1, NPOINTS + 1)
    ang = i * 2.0 * np.pi / NPOINTS
    arr = np.concatenate([np.concatenate(cons) if cons else np.zeros(0), depths, vs,
                          np.cos(ang), np.sin(ang)])
    return arr, (len(cons), depths.size, vs.size)


@functools.lru_cache(maxsize=16)
def _context_on(device, key):
    """context_array of a context's content_key() on `device`, sent once."""
    arr, sizes = context_array(*key)
    return to_device(arr, device, F64), sizes


def _fields(buf, fields, B):
    """The field-major buffer's fields as contiguous [B, w] tensors ([B] for
    a width of 1, [B, 3, 3] for rotmat)."""
    out, off = {}, 0
    for name, w in fields:
        t = buf[off * B:(off + w) * B]
        out[name] = t.view(B, 3, 3) if name == "rotmat" else t.view(B, w) if w > 1 else t
        off += w
    return out


def summary_of(arrays, effective_dt):
    """The kernel's summary of a batch prepared on the host (prepare_batch's
    arrays): the largest ndims and cdims, no failed test, and the largest
    floor(4 diag(cdelta) / max(minspeed, 1) / dt)."""
    diag = np.hypot(arrays["cdelta"][:, 0], arrays["cdelta"][:, 1])
    ntmax = np.floor(4.0 * diag / np.maximum(arrays["minspeed"], 1.0) / effective_dt).max()
    nd, nc = np.asarray(arrays["ndims"]), np.asarray(arrays["cdims"])
    return np.array([nd[:, 0].max(), nd[:, 1].max(), nc[:, 0].max(), nc[:, 1].max(), 0, 0, 0,
                     int(ntmax)], np.int64)


def pad8(n):
    return int(-(-max(n, 1) // 8) * 8)


def static_from_summary(summary):
    """(static {"NF", "NC"}, ntmax_hard) of a batch's summary (host numbers),
    or a ValueError: a polygon over the clip's capacity (where the host's
    buffers overflow too), then the host preparation's own, an empty rupture
    area before a nucleation point outside the rupture."""
    s = [int(x) for x in np.asarray(summary)]
    if s[S_OVERFLOW]:
        raise ValueError(f"a clipped rupture polygon has over {NPOINTS} + 2 vertices a "
                         "constraint")
    if s[S_EMPTY]:
        raise ValueError("Empty rupture area")
    if s[S_NUKL]:
        raise ValueError("position of nucleation point is outside of rupture region")
    static = {"NF": (pad8(s[S_ND]), pad8(s[S_ND + 1])), "NC": (s[S_NC], s[S_NC + 1])}
    # the host's rigorous bound on the time cells of a coarse cell
    return static, s[S_NTMAX] + 2


def eik_prepare(rows, ctx, effective_dt):
    """(summary i64[8], arrays) of the rows f64[B, 25] (pack_rows) under the
    session's context, on the rows' device."""
    if rows.dtype != F64 or rows.dim() != 2 or rows.shape[1] != NROW or rows.shape[0] < 1:
        raise ValueError(f"rows must be f64[B >= 1, {NROW}], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    refuse_grad("eik_prepare", rows)
    dev = rows.device
    B = rows.shape[0]
    if dev.type == "cpu":
        _static, arrays = _prepare_batch_vec(*unpack_rows(rows.numpy()), effective_dt, ctx)
        out = {k: torch.as_tensor(v, dtype=I32 if v.dtype.kind == "i" else F32)
               for k, v in arrays.items()}
        out["status"] = torch.zeros(B, dtype=I32)
        return torch.as_tensor(summary_of(arrays, effective_dt)), out
    if dev.type != "cuda":
        raise ValueError(f"eik_prepare runs on cpu or cuda tensors, not {dev}")
    ctx_dev, (ncons, ndepth, nvs) = _context_on(dev, ctx.content_key())
    if nvs < 1:
        raise ValueError("the context has no layer speeds")
    rows = rows.contiguous()
    fout = torch.empty(sum(w for _, w in F32_FIELDS) * B, dtype=F32, device=dev)
    iout = torch.empty(sum(w for _, w in I32_FIELDS) * B, dtype=I32, device=dev)
    summary = torch.empty(NSUMMARY, dtype=torch.int64, device=dev)
    deltagrid = min(100.0 * effective_dt / 2.0, 4000.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_eik_prepare(
            rows.data_ptr(), ctx_dev.data_ptr(), fout.data_ptr(), iout.data_ptr(),
            summary.data_ptr(), B, ncons, ndepth, nvs, deltagrid, float(effective_dt), stream)
    if err != 0:
        raise build.KernelError(f"kiwi_eik_prepare launch failed: CUDA error {err}")
    launches["eik_prepare"] += 1
    return summary, _fields(fout, F32_FIELDS, B) | _fields(iout, I32_FIELDS, B)


def _prepare_batch_vec(pv, m6s, rotmats, effective_dt, ctx):
    """Batched prepare: same quantities as sources/eikonal.
    _prepare_batch_loop, computed with batch-axis numpy.  Bit-compatible:
    every per-source float64 operation runs in the same order as the loop.
    ctx: the session's EikonalContext (constraints, layer depths and
    speeds)."""
    b = m6s.shape[0]
    centers = np.stack([pv["north"], pv["east"], pv["depth"]], axis=-1)

    # boundary polygons: transformed unit circles (circle_to_polygon),
    # batched; then the constraint clips (Sutherland-Hodgman) in one
    # batched pass per half-space
    shift_rc = np.stack(
        [pv["bord_shift_x"], pv["bord_shift_y"], np.zeros(b)], axis=-1)
    # np.matmul with the scalar loop's per-item shapes: bit-identical to
    # the loop (einsum picks different kernels and drifts by 1 ulp, which
    # could flip a grid-dim ceil against discretize_eikonal_host)
    ccenters = np.matmul(rotmats, shift_rc[..., None])[..., 0] + centers
    transforms = -rotmats * pv["bord_radius"][:, None, None]
    i = np.arange(1, NPOINTS + 1)
    ang = i * 2.0 * np.pi / NPOINTS
    unit = np.stack([np.cos(ang), np.sin(ang), np.zeros(NPOINTS)], axis=0)
    polys = (np.matmul(transforms, unit).transpose(0, 2, 1)
             + ccenters[:, None, :])
    counts = np.full(b, NPOINTS, dtype=np.int64)
    for hp, hn in ctx.constraints:
        polys, counts = geom.trim_polygon_batch(polys, counts, hp, hn)
        if (counts == 0).any():
            raise ValueError("Empty rupture area")

    polys_rc = np.matmul(polys - centers[:, None, :], rotmats)
    min_rc = polys_rc.min(axis=1)  # pad rows repeat vertex 0: box-safe
    max_rc = polys_rc.max(axis=1)

    # nucleation point must lie inside (psm_initial_point_intolerant_rc)
    nukls3 = np.stack(
        [pv["nukl_shift_x"], pv["nukl_shift_y"], np.zeros(b)], axis=-1)
    nukl_ned = np.matmul(rotmats, nukls3[..., None])[..., 0] + centers
    bad = np.hypot(nukls3[:, 0], nukls3[:, 1]) > pv["bord_radius"]
    for hp, hn in ctx.constraints:
        bad |= (np.asarray(hn) @ (np.asarray(hp)[None, :] - nukl_ned).T) < 0.0
    if bad.any():
        raise ValueError(
            "position of nucleation point is outside of rupture region")

    deltagrid = min(100.0 * effective_dt / 2.0, 4000.0)
    dims = (max_rc - min_rc)[:, :2]
    ndims = np.maximum(np.ceil(dims / deltagrid).astype(int), 1)
    deltas = np.where(ndims > 0, dims / ndims, 1.0)
    deltas = np.where(deltas == 0.0, 1.0, deltas)

    # min rupture speed over each grid's depth range: vs is a step
    # function of depth, so the min over [zlo, zhi] is the min of the
    # layer intervals the range touches (same candidates the loop probes)
    corners_x = np.stack([min_rc[:, 0], min_rc[:, 0],
                          max_rc[:, 0], max_rc[:, 0]], axis=-1)
    corners_y = np.stack([min_rc[:, 1], max_rc[:, 1],
                          min_rc[:, 1], max_rc[:, 1]], axis=-1)
    zs = (centers[:, 2:3] + rotmats[:, 2, 0:1] * corners_x
          + rotmats[:, 2, 1:2] * corners_y)  # [B, 4]
    zlo, zhi = zs.min(axis=1), zs.max(axis=1)
    depths = np.asarray(ctx.layer_depths, np.float64)
    vs = np.asarray(ctx.layer_vs, np.float64)
    nv = vs.shape[0]
    k0 = np.minimum(np.searchsorted(depths, zlo, side="left"), nv - 1)
    k1 = np.minimum(np.searchsorted(depths, zhi, side="left"), nv - 1)
    kk = np.arange(nv)[None, :]
    sel = (kk >= k0[:, None]) & (kk <= k1[:, None])
    vmins = np.where(sel, vs[None, :], np.inf).min(axis=1)
    minspeeds = vmins * pv["rel_vrup"]

    maxd = 0.5 * effective_dt * minspeeds
    nxy = np.where(
        dims != 0.0,
        np.maximum(np.floor(dims / maxd[:, None]).astype(int) + 1, 2),
        1,
    )
    cdims = nxy
    cdeltas = np.where(nxy > 0, dims / nxy, 1.0)

    static = {
        "NF": (pad8(ndims[:, 0].max()), pad8(ndims[:, 1].max())),
        "NC": (int(cdims[:, 0].max()), int(cdims[:, 1].max())),
    }
    arrays = dict(
        first=min_rc[:, :2], delta=deltas, ndims=ndims,
        nukl=nukls3[:, :2], center=centers, rotmat=rotmats, m6=m6s,
        ccenter=ccenters, radius=pv["bord_radius"].copy(), cdims=cdims,
        cdelta=cdeltas, minspeed=minspeeds, time0=pv["time"].copy(),
        relv=pv["rel_vrup"].copy(),
    )
    return static, arrays
