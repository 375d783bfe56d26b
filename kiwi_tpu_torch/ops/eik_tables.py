"""The eikonal device discretizer's passes over the fine grid: the CUDA
kernels' wrappers and their plain PyTorch versions.

Around the solve (ops/eik_sweep.py), sources/eikonal.make_device_discretizer
runs two passes over a batch's fine grids f32[B, nfx, nfy]:

* `eik_speeds`: the rupture speed of every fine cell, the layer's vs times
  rel-rupture-velocity inside the rupture (the circle, every constraint
  half-space and the source's own grid) and half the least speed outside it,
  which the solve reads;
* `eik_tables`: the solved times downsampled to the coarse grid
  (psm_downsample_grid: per coarse cell the count, the mean time and point
  and 4 x the mean |t - mean t| of its valid fine cells), then the centroid
  tables with their boxcar time cells (psm_to_tdsm_table_eikonal), under an
  optional budget of coarse cells, actives first.

On the card each is one call of csrc/eik_tables.cu (`eik_tables` launches
two kernels: one block per coarse cell, then one per source), which keeps
the fine grid's points and masks in registers; the speeds equal the card's
plain version bit for bit, the tables sum in float64.  Neither replaces a TPU
kernel: the JAX package leaves both passes to XLA.  See the source's header.

In: the prepared arrays of ops/eik_prepare.py (a dict of contiguous tensors
[B, ...] in the discretizer's dtypes) and the session's context as
eik_prepare.context_array's f64 tensor with its sizes (`context_on`: on the
card eik_prepare's cached copy, so a call copies nothing).  The plain
versions (speeds_reference, tables_reference) are the torch chains the
discretizer ran before the kernels, moved unchanged.

The wrappers choose the path from the tensors' device alone: on a CPU tensor
they run the plain version; on a CUDA tensor they launch the kernel or raise.
There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, eik_prepare, refuse_grad
from .eik_sweep import BIG

F32 = torch.float32
I32 = torch.int32
F64 = torch.float64
# the rows the kernels read (csrc/eik_tables.cu's Rows), in order: name,
# dtype, shape after the batch axis
ROW_FIELDS = (("first", F32, (2,)), ("delta", F32, (2,)), ("ndims", I32, (2,)),
              ("rotmat", F32, (3, 3)), ("center", F32, (3,)), ("ccenter", F32, (3,)),
              ("radius", F32, ()), ("relv", F32, ()), ("minspeed", F32, ()),
              ("cdims", I32, (2,)), ("m6", F32, (6,)), ("time0", F32, ()))
TABLE_FIELDS = ("north", "east", "depth", "time", "m", "active", "overflow")
NCELL_FIELDS = 6  # count, time, north, east, depth, duration a coarse cell

# kernel launches since the last reset (plain-version calls are not counted)
launches = {"eik_speeds": 0, "eik_tables": 0}


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("eik_tables.cu")
    lib.kiwi_eik_speeds.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.kiwi_eik_speeds.restype = ctypes.c_int
    lib.kiwi_eik_tables.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
                                    + [ctypes.c_int] * 8 + [ctypes.c_float]
                                    + [ctypes.c_void_p] * 2)
    lib.kiwi_eik_tables.restype = ctypes.c_int
    return lib


def coarse_index(i, nc, nd):
    """The coarse cell (of nc) that holds the centre of fine cell i (of nd)
    along one axis: floor((i + 1/2) delta / cdelta) with delta = dims / nd
    and cdelta = dims / nc, which is floor((2 i + 1) nc / (2 nd)), in
    integers.  A centre on a coarse boundary -- the middle fine cell of an
    odd nd under an even nc -- goes to the upper cell, as exact arithmetic
    puts it, where a floating-point quotient would decide it by rounding.
    Works on numpy arrays and torch tensors alike."""
    return ((2 * i + 1) * nc) // (2 * nd)


def context_on(device, ctx):
    """(f64 context tensor, (ncons, ndepth, nvs)) of the session's
    EikonalContext on `device` (eik_prepare.context_array): on the card the
    copy eik_prepare sends once a device and context, on the CPU the host
    array itself."""
    device = torch.device(device)
    if device.type == "cuda":
        return eik_prepare._context_on(device, ctx.content_key())
    arr, sizes = eik_prepare.context_array(*ctx.content_key())
    return torch.from_numpy(arr), sizes


def _check(name, arrays, ctx_arr, sizes, extra=()):
    """The batch size and device of the rows; raises on a dtype, shape,
    layout or device the kernels do not take, or on a gradient."""
    B = arrays["first"].shape[0]
    dev = arrays["first"].device
    if B < 1:
        raise ValueError("empty batch")
    for field, dtype, shape in ROW_FIELDS:
        a = arrays[field]
        if a.dtype != dtype or tuple(a.shape) != (B, *shape):
            raise ValueError(f"{field} must be {dtype}[{B}{''.join(f', {n}' for n in shape)}], "
                             f"got {a.dtype} {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{field} must be contiguous")
    ncons, ndepth, nvs = sizes
    if (ctx_arr.dtype != F64 or ctx_arr.dim() != 1 or not ctx_arr.is_contiguous()
            or ctx_arr.numel() < 6 * ncons + ndepth + nvs):
        raise ValueError(f"the context must be f64[>= {6 * ncons + ndepth + nvs}], got "
                         f"{ctx_arr.dtype} {tuple(ctx_arr.shape)}")
    if nvs < 1:
        raise ValueError("the context has no layer speeds")
    tensors = [arrays[field] for field, _, _ in ROW_FIELDS] + [ctx_arr, *extra]
    if any(t.device != dev for t in tensors):
        raise ValueError("all operands must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, not {dev}")
    refuse_grad(name, *(t for t in tensors if t.is_floating_point()))
    return B, dev


def _row_pointers(arrays):
    return (ctypes.c_void_p * len(ROW_FIELDS))(*(arrays[n].data_ptr() for n, _, _ in ROW_FIELDS))


def eik_speeds(arrays, ctx_arr, sizes, NF):
    """The solve's speeds f32[B, nfx, nfy] of the prepared rows `arrays` on
    the padded fine grid NF = (nfx, nfy)."""
    B, dev = _check("eik_speeds", arrays, ctx_arr, sizes)
    nfx, nfy = (int(n) for n in NF)
    if nfx < 1 or nfy < 1:
        raise ValueError(f"empty fine grid {NF}")
    if dev.type == "cpu":
        return speeds_reference(arrays, ctx_arr, sizes, NF)
    out = torch.empty((B, nfx, nfy), dtype=F32, device=dev)
    ncons, ndepth, nvs = sizes
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_eik_speeds(_row_pointers(arrays), ctx_arr.data_ptr(), ncons, ndepth,
                                         nvs, out.data_ptr(), B, nfx, nfy, stream)
    if err != 0:
        raise build.KernelError(f"kiwi_eik_speeds launch failed: CUDA error {err}")
    launches["eik_speeds"] += 1
    return out


def eik_tables(arrays, times, ctx_arr, sizes, NC, nt_cell_max, ncell_budget, edt):
    """The centroid tables of the solved times f32[B, nfx, nfy] on the coarse
    grid NC = (ncx, ncy): {north, east, depth, time f32[B, C], m f32[B, C, 6],
    active bool[B, C], overflow i32[B]}, C = ncell_out x nt_cell_max with
    ncell_out = ncell_budget where that is under ncx x ncy, else ncx x ncy.
    overflow counts a source's time cells over nt_cell_max and its active
    coarse cells over the budget."""
    B, dev = _check("eik_tables", arrays, ctx_arr, sizes, (times,))
    if times.dtype != F32 or times.dim() != 3 or times.shape[0] != B:
        raise ValueError(f"times must be f32[{B}, nfx, nfy], got {times.dtype} "
                         f"{tuple(times.shape)}")
    ncx, ncy = (int(n) for n in NC)
    ncell = ncx * ncy
    if ncx < 1 or ncy < 1 or nt_cell_max < 1 or (ncell_budget is not None and ncell_budget < 1):
        raise ValueError(f"empty tables: NC {NC}, nt_cell_max {nt_cell_max}, "
                         f"ncell_budget {ncell_budget}")
    if dev.type == "cpu":
        return tables_reference(arrays, times, ctx_arr, sizes, NC, nt_cell_max, ncell_budget, edt)
    budget = ncell_budget if ncell_budget is not None and ncell_budget < ncell else -1
    ncell_out = ncell if budget < 0 else budget
    C = ncell_out * nt_cell_max
    times = times.contiguous()
    out = {k: torch.empty((B, C), dtype=F32, device=dev) for k in TABLE_FIELDS[:4]}
    out["m"] = torch.empty((B, C, 6), dtype=F32, device=dev)
    out["active"] = torch.empty((B, C), dtype=torch.bool, device=dev)
    out["overflow"] = torch.empty(B, dtype=I32, device=dev)
    cells = torch.empty(NCELL_FIELDS * B * ncell, dtype=F32, device=dev)
    tables = (ctypes.c_void_p * len(TABLE_FIELDS))(*(out[k].data_ptr() for k in TABLE_FIELDS))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().kiwi_eik_tables(
            _row_pointers(arrays), times.data_ptr(), ctx_arr.data_ptr(), sizes[0],
            cells.data_ptr(), B, times.shape[1], times.shape[2], ncx, ncy, ncell_out,
            nt_cell_max, budget, edt, tables, stream)
    if err != 0:
        raise build.KernelError(f"kiwi_eik_tables launch failed: CUDA error {err}")
    launches["eik_tables"] += 1
    return out


# -- the plain versions: the discretizer's torch chains ----------------------


def _context(ctx_arr, sizes):
    """The plain versions' float32 context: layer depths, layer speeds and
    the constraints [(point, normal)]."""
    ncons, ndepth, nvs = sizes
    c = ctx_arr.to(F32)
    n = 6 * ncons
    return (c[n:n + ndepth], c[n + ndepth:n + ndepth + nvs],
            [(c[6 * i:6 * i + 3], c[6 * i + 3:6 * i + 6]) for i in range(ncons)])


def _geom(a, cons, nfx, nfy):
    """Fine-grid axes, points [B, nfx, nfy, 3] and rupture-area mask
    (recomputed on both sides of the solve, as the JAX package does)."""
    dev = a["first"].device
    ax = torch.arange(nfx, device=dev)
    ay = torch.arange(nfy, device=dev)
    first, delta, nd = a["first"], a["delta"], a["ndims"]
    px = first[:, 0, None] + (ax.to(F32) + 0.5) * delta[:, 0, None]  # [B, nfx]
    py = first[:, 1, None] + (ay.to(F32) + 0.5) * delta[:, 1, None]  # [B, nfy]
    bb = px.shape[0]
    PX = px[:, :, None].expand(bb, nfx, nfy)
    PY = py[:, None, :].expand(bb, nfx, nfy)
    inbounds = (ax[None, :, None] < nd[:, 0, None, None]) & (
        ay[None, None, :] < nd[:, 1, None, None])
    # rot @ (PX, PY, 0) + center, the product's terms in order, float32
    rot = a["rotmat"][:, None, None]  # [B, 1, 1, 3, 3]
    pts = (rot[..., 0] * PX[..., None] + rot[..., 1] * PY[..., None]
           + rot[..., 2] * 0.0) + a["center"][:, None, None, :]
    rvec = pts - a["ccenter"][:, None, None, :]
    inside = torch.sqrt((rvec * rvec).sum(-1)) <= a["radius"][:, None, None]
    for cp, cn in cons:
        inside = inside & (((cp - pts) * cn).sum(-1) >= 0.0)
    return ax, ay, pts, inside & inbounds


def speeds_reference(arrays, ctx_arr, sizes, NF):
    """eik_speeds in plain torch (on the CPU the discretizer's path)."""
    a = arrays
    layer_depths, layer_vs, cons = _context(ctx_arr, sizes)
    _ax, _ay, pts, inside = _geom(a, cons, *NF)
    k = torch.searchsorted(layer_depths, pts[..., 2].contiguous(), side="left")
    vs = layer_vs[torch.clamp(k, max=layer_vs.shape[0] - 1)]
    speed = torch.where(inside, vs * a["relv"][:, None, None], 0.0)
    return torch.where(speed == 0.0, 0.5 * a["minspeed"][:, None, None], speed)


def tables_reference(arrays, times, ctx_arr, sizes, NC, nt_cell_max, ncell_budget, edt):
    """eik_tables in plain torch (on the CPU the discretizer's path)."""
    a = arrays
    _layer_depths, _layer_vs, cons = _context(ctx_arr, sizes)
    ncx, ncy = NC
    ax, ay, pts, inside = _geom(a, cons, times.shape[1], times.shape[2])
    dev = times.device
    edt = torch.full((), edt, dtype=F32, device=dev)
    bb = pts.shape[0]
    valid = inside & (times < BIG * 0.5)

    # downsample fine -> coarse (psm_downsample_grid): the coarse cell of
    # a fine point is separable (cix depends on the x index only, ciy on
    # y), so the per-cell sums are two small 0/1 matmuls, float32 with
    # TF32 off (the JAX package pins precision=HIGHEST); the index in
    # integers (coarse_index), cells past a source's own grid masked
    nd, cdims = a["ndims"].long(), a["cdims"].long()
    cix1 = torch.clamp(coarse_index(ax[None, :], cdims[:, 0, None], nd[:, 0, None]),
                       max=ncx - 1)  # [B, nfx]
    ciy1 = torch.clamp(coarse_index(ay[None, :], cdims[:, 1, None], nd[:, 1, None]),
                       max=ncy - 1)  # [B, nfy]
    mx = (cix1[:, None, :] == torch.arange(ncx, device=dev)[None, :, None]).to(F32)
    my = (ciy1[:, None, :] == torch.arange(ncy, device=dev)[None, :, None]).to(F32)
    wmask = valid.to(F32)  # [B, nfx, nfy]
    ncell = ncx * ncy

    def seg2(field):
        """sum of field*w per coarse cell, flattened in cix*ncy+ciy order."""
        return torch.einsum("bcx,bxy,bdy->bcd", mx, field * wmask, my).reshape(bb, ncell)

    counts = seg2(torch.ones_like(wmask))
    have = counts > 0
    safe = torch.where(have, counts, 1.0)
    ctimes = seg2(times) / safe
    cn = seg2(pts[..., 0]) / safe
    ce = seg2(pts[..., 1]) / safe
    cd = seg2(pts[..., 2]) / safe
    npf = torch.clamp(wmask.sum(dim=(1, 2)), min=1.0)
    cweights = counts / npf[:, None]
    # broadcast cell means back to the fine grid with the transposes
    mu = torch.einsum("bcx,bcd,bdy->bxy", mx, ctimes.reshape(bb, ncx, ncy), my)
    cdur = 4.0 / safe * seg2(torch.abs(times - mu))

    centertime = torch.where(have, ctimes * cweights, 0.0).sum(dim=1)

    # per-cell boxcar time cells (risetime = 0 here): nt cells of equal
    # weight 1/nt at midpoints of [-dur/2, dur/2]
    nt_full = torch.where(have, torch.floor(cdur / edt).to(I32) + 1, 0)
    overflow = torch.clamp(nt_full - nt_cell_max, min=0).amax(dim=1)

    ncell_out = ncell
    if ncell_budget is not None and ncell_budget < ncell:
        # actives first, stable (cix-major order preserved among them);
        # dropped actives are counted in overflow, not silently lost
        order = torch.argsort(torch.where(have, 0, 1), dim=1, stable=True)[:, :ncell_budget]
        overflow = torch.maximum(overflow, have.sum(dim=1).to(I32) - ncell_budget)
        ctimes, cn, ce, cd, cdur, have, cweights, nt_full = (
            torch.gather(x, 1, order)
            for x in (ctimes, cn, ce, cd, cdur, have, cweights, nt_full))
        ncell_out = ncell_budget

    nt = torch.clamp(nt_full, max=nt_cell_max)
    it = torch.arange(nt_cell_max, dtype=F32, device=dev)
    ntf = torch.clamp(nt, min=1).to(F32)
    toff = -cdur[..., None] / 2.0 + cdur[..., None] / ntf[..., None] * (it + 0.5)
    live = (it < nt[..., None]) & have[..., None]
    wt = torch.where(live, 1.0 / ntf[..., None], 0.0)

    m = a["m6"][:, None, None, :] * (wt * cweights[..., None])[..., None]
    t0 = a["time0"][:, None, None]
    shape = (bb, ncell_out, nt_cell_max)
    return {
        "north": cn[..., None].expand(shape).reshape(bb, -1),
        "east": ce[..., None].expand(shape).reshape(bb, -1),
        "depth": cd[..., None].expand(shape).reshape(bb, -1),
        "time": (ctimes[..., None] + toff + t0 - centertime[:, None, None]).reshape(bb, -1),
        "m": m.reshape(bb, -1, 6),
        "active": live.reshape(bb, -1),
        "overflow": overflow,
    }


def boundary_cells(arrays, times, ctx_arr, sizes, NC, ncell_budget, edt, tol=1e-5):
    """bool[B, ncell_out]: the coarse cells of tables_reference's tables, in
    their order, whose duration over edt lies within `tol` of a whole number
    (the duration from float64 sums over the plain version's valid cells).
    There another order of the float32 sums can move the floor that sets a
    cell's time cells (nt, active).  A duration of 0, a cell whose valid
    fine cells share one time, is 0 in any order and is not near."""
    ncx, ncy = NC
    _depths, _vs, cons = _context(ctx_arr, sizes)
    ax, ay, _pts, inside = _geom(arrays, cons, times.shape[1], times.shape[2])
    w = (inside & (times < BIG * 0.5)).double().flatten(1)
    nd, cdims = arrays["ndims"].long(), arrays["cdims"].long()
    cix = coarse_index(ax[None, :], cdims[:, 0, None], nd[:, 0, None]).clamp(max=ncx - 1)
    ciy = coarse_index(ay[None, :], cdims[:, 1, None], nd[:, 1, None]).clamp(max=ncy - 1)
    cell = (cix[:, :, None] * ncy + ciy[:, None, :]).flatten(1)
    t = times.double().flatten(1) * w

    def per_cell(v):
        return torch.zeros(w.shape[0], ncx * ncy, dtype=F64,
                           device=w.device).scatter_add_(1, cell, v)

    cnt = per_cell(w)
    mean = per_cell(t) / cnt.clamp(min=1.0)
    q = 4.0 * per_cell((t - mean.gather(1, cell)).abs() * w) / cnt.clamp(min=1.0) / edt
    near = (q > 0) & ((q - q.round()).abs() < tol)
    if ncell_budget is not None and ncell_budget < ncx * ncy:
        order = torch.argsort(torch.where(cnt > 0, 0, 1), dim=1, stable=True)[:, :ncell_budget]
        near = torch.gather(near, 1, order)
    return near
