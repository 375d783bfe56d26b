"""Seismogram synthesis by GF superposition (port of the parts of
kiwi_tpu/synth.py that the point sweep and the finite-source batches reach).

For every source centroid: differential geodesy to each receiver, the
azimuth-dependent moment-tensor weights, bilinear GF node indices and the
fractional time shift (`_centroid_kinematics`, for one source or a batch).
Shared-kinematics plans blend and shift the GF rows once per receiver
(`values_matrix`) and contract each source's weights against them
(`weights_from_angles`); finite-source batches go through the window
kernel (ops/synth_window.py) with spans from per-node tables
(`span_tables`, `physical_spans_from_tables`).  Sources and receivers are
leading batch dimensions written out where the JAX package vmaps.

Per-receiver geodesy is host float64 numpy; the per-centroid differential
geodesy is float32 on the device, as in the reference (centroid_geodesy_fast).

Component channels ("ard"): 0 = away, 1 = right, 2 = down, in the
receiver-local frame; north/east come from rotating (away, right) by
backazimuth+pi (seismogram.f90:268-283).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geo
from .gf.store import GFStore
from .gf.trace import jnint, sample_ext

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32


# ---------------------------------------------------------------------------
# receiver geometry (host precompute, exact f64)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReceiverGeometry:
    """Per-receiver geodesy relative to the source origin (float64 host)."""

    azi: np.ndarray  # [R] azimuth source->receiver (rad)
    bazi: np.ndarray  # [R] backazimuth
    dist: np.ndarray  # [R] spheroid distance (m), distance_accurate50m
    sin_azi: np.ndarray
    cos_azi: np.ndarray
    sin_b: np.ndarray  # sin/cos of dist/earthradius
    cos_b: np.ndarray
    depth: np.ndarray  # [R] receiver depth (m), float32

    def to(self, device):
        out = {k: torch.as_tensor(getattr(self, k), dtype=F64, device=device)
               for k in ("azi", "bazi", "dist", "sin_azi", "cos_azi", "sin_b", "cos_b")}
        out["depth"] = torch.as_tensor(self.depth, dtype=F32, device=device)
        return out


def precompute_receiver_geometry(src_lat, src_lon, rec_lat, rec_lon, rec_depth=None):
    """Host-side exact geodesy (azibazi + distance_accurate50m per receiver),
    angles in radians (seismogram.f90:99-100)."""
    rec_lat = np.atleast_1d(np.asarray(rec_lat, dtype=np.float64))
    rec_lon = np.atleast_1d(np.asarray(rec_lon, dtype=np.float64))
    if rec_depth is None:
        rec_depth = np.zeros_like(rec_lat)
    rec_depth = np.atleast_1d(np.asarray(rec_depth, dtype=np.float64))

    t = np.cos(src_lat) * np.cos(rec_lat) * np.sin(rec_lon - src_lon)
    cd = np.sin(src_lat) * np.sin(rec_lat) + np.cos(src_lat) * np.cos(rec_lat) * np.cos(
        rec_lon - src_lon
    )
    azi = np.arctan2(t, np.sin(rec_lat) - np.sin(src_lat) * cd)
    bazi = np.arctan2(-t, np.sin(src_lat) - np.sin(rec_lat) * cd)

    # Meeus spheroid distance (orthodrome.f90:193-229)
    f = (src_lat + rec_lat) / 2.0
    g = (src_lat - rec_lat) / 2.0
    ll = (src_lon - rec_lon) / 2.0
    s = np.sin(g) ** 2 * np.cos(ll) ** 2 + np.cos(f) ** 2 * np.sin(ll) ** 2
    c = np.cos(g) ** 2 * np.cos(ll) ** 2 + np.sin(f) ** 2 * np.sin(ll) ** 2
    w = np.arctan(np.sqrt(s / c))
    r = np.sqrt(s * c) / w
    d = 2.0 * w * geo.EARTHRADIUS_EQUATOR
    h1 = (3.0 * r - 1.0) / (2.0 * c)
    h2 = (3.0 * r + 1.0) / (2.0 * s)
    dist = d * (
        1.0
        + geo.EARTH_OBLATENESS * h1 * np.sin(f) ** 2 * np.cos(g) ** 2
        - geo.EARTH_OBLATENESS * h2 * np.cos(f) ** 2 * np.sin(g) ** 2
    )

    b = dist / geo.EARTHRADIUS
    return ReceiverGeometry(
        azi=azi,
        bazi=bazi,
        dist=dist,
        sin_azi=np.sin(azi),
        cos_azi=np.cos(azi),
        sin_b=np.sin(b),
        cos_b=np.cos(b),
        depth=rec_depth.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# per-centroid differential geodesy (float32 on the device)
# ---------------------------------------------------------------------------


def grad_safe_norm(x, y, z=None):
    """sqrt(x^2 + y^2 [+ z^2]), 0 at the origin without a NaN gradient
    (the double-where of the reference; forward values are identical)."""
    s = x * x + y * y
    if z is not None:
        s = s + z * z
    is0 = s == 0.0
    return torch.where(is0, 0.0, torch.sqrt(torch.where(is0, 1.0, s)))


def centroid_geodesy_fast(dnorth, deast, rec):
    """Differential geodesy of centroids displaced (dnorth, deast) m from
    the source origin, float32 and free of inverse trig except one atan2
    (the exact-sphere branch of approx_differential_azidist,
    orthodrome.f90:121-152, as kiwi_tpu.synth.centroid_geodesy_fast).

    dnorth/deast and the rec leaves broadcast against each other (the
    engine passes rec leaves [R, 1] and centroids [C]).  Returns
    (sin_azi', cos_azi', sin_alpha, cos_alpha, dist') with alpha = bazi' -
    bazi, the rotation angle of seismogram.f90:195-204.
    """
    dn = dnorth.to(F32)
    de = deast.to(F32)
    r = grad_safe_norm(dn, de)
    a = r / np.float32(geo.EARTHRADIUS)
    a2 = a * a
    sin_a = a * (1.0 - a2 / 6.0 * (1.0 - a2 / 20.0))
    cos_a = 1.0 - a2 / 2.0 * (1.0 - a2 / 12.0)

    safe_r = torch.where(r == 0.0, 1.0, r)
    sin_lam = de / safe_r
    cos_lam = torch.where(r == 0.0, 1.0, dn / safe_r)

    sin_b = rec["sin_b"].to(F32)
    cos_b = rec["cos_b"].to(F32)
    sin_azi = rec["sin_azi"].to(F32)
    cos_azi = rec["cos_azi"].to(F32)

    # unit vectors (east, north, up) at the source origin
    pe, pn, pu = sin_a * sin_lam, sin_a * cos_lam, cos_a
    be, bn, bu = sin_b * sin_azi, sin_b * cos_azi, cos_b

    horiz = pe * be + pn * bn
    cos_c = horiz + pu * bu
    cx = pn * bu - pu * bn
    cy = pu * be - pe * bu
    cz = pe * bn - pn * be
    sin_c = grad_safe_norm(cx, cy, cz)
    dist = torch.atan2(sin_c, cos_c) * np.float32(geo.EARTHRADIUS)

    sin_gamma = sin_azi * cos_lam - cos_azi * sin_lam  # sin(azi - lam)
    safe_sc = torch.where(sin_c == 0.0, 1.0, sin_c)

    # angle at the receiver vertex (alpha = bazi' - bazi), with the
    # cancellation-prone numerator rewritten as same-magnitude products
    num_alpha = pu * (be * be + bn * bn) - bu * horiz
    safe_sb = torch.where(sin_b == 0.0, 1.0, sin_b)
    sin_al = sin_a * sin_gamma / safe_sc
    cos_al = num_alpha / (safe_sb * safe_sc)

    # angle at the centroid vertex (beta), then azi' = lam - pi - beta
    num_beta = bu * (pe * pe + pn * pn) - pu * horiz
    safe_sa = torch.where(sin_a == 0.0, 1.0, sin_a)
    sin_be = sin_b * sin_gamma / safe_sc
    cos_be = num_beta / (safe_sa * safe_sc)
    sin_azi_new = -(sin_lam * cos_be - cos_lam * sin_be)
    cos_azi_new = -(cos_lam * cos_be + sin_lam * sin_be)

    is0 = r == 0.0
    shape = sin_al.shape
    return (
        torch.where(is0, sin_azi, sin_azi_new).expand(shape),
        torch.where(is0, cos_azi, cos_azi_new).expand(shape),
        torch.where(is0, 0.0, sin_al),
        torch.where(is0, 1.0, cos_al),
        torch.where(is0, rec["dist"].to(F32), dist).expand(shape),
    )


def make_weights_sc(sa, ca, m6):
    """MT combination weights f1..f6 (seismogram.f90:316-336) from the
    (sin, cos) of the azimuth; m6 f32[..., 6] as (mxx,myy,mzz,mxy,mxz,myz)."""
    s2a = 2.0 * sa * ca
    c2a = ca * ca - sa * sa
    m = m6
    f1 = m[..., 0] * (ca * ca) + m[..., 1] * (sa * sa) + m[..., 3] * s2a
    f2 = m[..., 4] * ca + m[..., 5] * sa
    f3 = m[..., 2].expand(f2.shape)
    f4 = 0.5 * (m[..., 1] - m[..., 0]) * s2a + m[..., 3] * c2a
    f5 = m[..., 5] * ca - m[..., 4] * sa
    f6 = m[..., 0] * (sa * sa) + m[..., 1] * (ca * ca) - m[..., 3] * s2a
    return torch.stack([f1, f2, f3, f4, f5, f6], dim=-1)


# ---------------------------------------------------------------------------
# static synthesis configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    """Static parameters of the synthesis (kiwi_tpu.synth.SynthConfig)."""

    # GF grid metadata
    dt: float
    dx: float
    dz: float
    firstx: float
    firstz: float
    ng: int
    nt: int  # stored trace length
    # GF window (node subrange used by this problem)
    ix0: int
    nxw: int
    iz0: int
    nzw: int
    # output time window (absolute sample indices, time = i*dt)
    out_it0: int
    nt_out: int
    # integer-shift tap range: ish in [s_base, s_base + s_len)
    s_base: int
    s_len: int
    # options (minimizer_engine.f90:85-87)
    interpolate: bool = True
    xunder: int = 1
    zunder: int = 1


def gf_indices(cfg: SynthConfig, x, z):
    """Window-relative bilinear indices + fractional weights
    (gfdb_get_indices_bilin, gfdb.f90:781-815), float32 like the reference.

    x, z: f32[...].  Returns ixs, izs int64[..., 2] (window-relative,
    clipped), dix, diz f32[...], valid bool[...].  Floors stay floor-then-
    cast (a truncating cast would move negative offsets up a node).
    """
    x = x.to(F32)
    z = z.to(F32)
    dxf = np.float32(cfg.dx)
    dzf = np.float32(cfg.dz)
    fx = np.float32(cfg.firstx)
    fz = np.float32(cfg.firstz)
    if cfg.interpolate:
        xu = np.float32(cfg.xunder)
        zu = np.float32(cfg.zunder)
        ix1 = (torch.floor((x - fx) / (dxf * xu)) * cfg.xunder).to(I32)
        iz1 = (torch.floor((z - fz) / (dzf * zu)) * cfg.zunder).to(I32)
        ix2 = ix1 + cfg.xunder
        iz2 = iz1 + cfg.zunder
        dix = (x - fx - ix1.to(F32) * dxf) / (dxf * xu)
        diz = (z - fz - iz1.to(F32) * dzf) / (dzf * zu)
    else:
        ix1 = jnint((x - fx) / dxf)
        iz1 = jnint((z - fz) / dzf)
        ix2 = ix1 + 1
        iz2 = iz1 + 1
        dix = torch.zeros_like(x)
        diz = torch.zeros_like(z)

    ixs = torch.stack([ix1, ix2], dim=-1).long() - cfg.ix0
    izs = torch.stack([iz1, iz2], dim=-1).long() - cfg.iz0
    valid = (
        (ixs[..., 0] >= 0)
        & (ixs[..., 1] < cfg.nxw)
        & (izs[..., 0] >= 0)
        & (izs[..., 1] < cfg.nzw)
    )
    return ixs.clamp(0, cfg.nxw - 1), izs.clamp(0, cfg.nzw - 1), dix, diz, valid


def _group_weights(f, cos_l, sin_l, ng):
    """Per-GF-component weights wg[..., 3, ng] for the three ard channels
    (seismogram.f90:171-251 with the per-centroid backazimuth rotation
    :195-204 folded in)."""
    z = torch.zeros_like(f[..., 0])
    f1, f2, f3, f4, f5, f6 = (f[..., i] for i in range(6))
    cos_l = cos_l.expand(f1.shape)
    sin_l = sin_l.expand(f1.shape)
    away = [cos_l * f1, cos_l * f2, cos_l * f3, -sin_l * f4, -sin_l * f5, z, z, z]
    right = [sin_l * f1, sin_l * f2, sin_l * f3, cos_l * f4, cos_l * f5, z, z, z]
    down = [z, z, z, z, z, f1, f2, f3]
    if ng == 10:
        away += [cos_l * f6, z]
        right += [sin_l * f6, z]
        down += [z, f6]
    return torch.stack(
        [torch.stack(away, dim=-1), torch.stack(right, dim=-1), torch.stack(down, dim=-1)],
        dim=-2,
    )


def _centroid_kinematics(cfg: SynthConfig, rec, centroids):
    """Per-(receiver, centroid) geodesy, weights, indices and taps.

    rec: ReceiverGeometry.to(device) (leaves [R]); centroids: dict with
    north, east, depth, time f32[..., C], m f32[..., C, 6] (and optionally
    active), with an optional leading batch axis.  Returns a dict of
    [..., R, C, ...] tensors: [R, C] for one source, [B, R, C] for a batch
    (the JAX package's vmap over sources and receivers written out).
    """
    lead = centroids["north"].dim() - 1  # 0 (one source) or 1 (a batch)
    r1 = {k: v.reshape((1,) * lead + (-1, 1)) for k, v in rec.items()}  # [.., R, 1]
    cent = {k: v.unsqueeze(lead) for k, v in centroids.items()}  # [.., 1, C, ...]
    sin_az, cos_az, sin_l, cos_l, dist = centroid_geodesy_fast(
        cent["north"], cent["east"], r1)  # [.., R, C]

    f = make_weights_sc(sin_az, cos_az, cent["m"])  # [.., R, C, 6]

    z = cent["depth"] - r1["depth"].to(F32)
    ixs, izs, dix, diz, valid = gf_indices(cfg, dist, z)

    rshift = cent["time"].to(F32) / np.float32(cfg.dt)
    ish = torch.floor(rshift).to(I32)
    frac = rshift - ish.to(F32)

    # bilinear spatial weights (gfdb.f90:945-948)
    w00 = (1.0 - dix) * (1.0 - diz)
    w01 = (1.0 - dix) * diz
    w10 = dix * (1.0 - diz)
    w11 = dix * diz
    wsp = torch.stack([w00, w01, w10, w11], dim=-1)  # [.., R, C, 4]

    wg = _group_weights(f, cos_l, sin_l, cfg.ng)  # [.., R, C, 3, ng]

    if "active" in cent:
        valid = valid & cent["active"]

    rc_shape = sin_az.shape
    return {
        "ixs": ixs,  # [.., R, C, 2] window-relative
        "izs": izs,
        "wsp": wsp,  # [.., R, C, 4] order (00, 01, 10, 11)
        "wg": wg,  # [.., R, C, 3, ng]
        "ish": ish.expand(rc_shape),  # [.., R, C]
        "frac": frac.expand(rc_shape),
        "valid": valid,
        # angle factors kept so moment-only batches rebuild wg for new m6
        # without redoing the geodesy (weights_from_angles)
        "sin_az": sin_az,
        "cos_az": cos_az,
        "sin_l": sin_l,
        "cos_l": cos_l,
        "f": f,  # [.., R, C, 6] MT radiation weights (ops/synth_window packs them)
    }


def weights_from_angles(kin, m6, ng):
    """wg [..., 3, ng] for new moment tensors m6 on fixed kinematics (the
    batched only_moment_changed shortcut).  The kin angle leaves broadcast
    against m6[..., 0]."""
    f = make_weights_sc(kin["sin_az"], kin["cos_az"], m6)
    return _group_weights(f, kin["cos_l"], kin["sin_l"], ng)


def values_matrix(ext, cfg: SynthConfig, kin, group_size=1):
    """Per-centroid GF values v f32[R, C, ng, nt_out]: bilinear-blended,
    fractionally time-shifted -- everything of the synthesis except the
    moment-weight contraction.  Runs of `group_size` centroids share one
    spatial blend.  The shift window start is clamped into range, as
    jax.lax.dynamic_slice_in_dim does (torch slicing does not clamp)."""
    nrec, c = kin["ish"].shape
    g = group_size if (group_size > 1 and c % group_size == 0) else 1
    nt_ext = ext.shape[-1]
    start_k = cfg.s_base + cfg.s_len - 1
    ext2 = ext.reshape(cfg.nxw * cfg.nzw, cfg.ng, nt_ext)
    ixs, izs = kin["ixs"][:, ::g], kin["izs"][:, ::g]  # [R, P, 2]
    wsp = kin["wsp"][:, ::g]  # [R, P, 4]
    nodes = (
        ixs[..., 0] * cfg.nzw + izs[..., 0],
        ixs[..., 0] * cfg.nzw + izs[..., 1],
        ixs[..., 1] * cfg.nzw + izs[..., 0],
        ixs[..., 1] * cfg.nzw + izs[..., 1],
    )
    blended = (
        wsp[..., 0, None, None] * ext2[nodes[0]]
        + wsp[..., 1, None, None] * ext2[nodes[1]]
        + wsp[..., 2, None, None] * ext2[nodes[2]]
        + wsp[..., 3, None, None] * ext2[nodes[3]]
    )  # [R, P, ng, nt_ext]
    blended = blended.repeat_interleave(g, dim=1)  # [R, C, ng, nt_ext]

    start = (start_k - kin["ish"].long()).clamp(0, nt_ext - cfg.nt_out - 1)  # [R, C]
    idx = start[..., None] + torch.arange(cfg.nt_out + 1, device=ext.device)
    idx = idx[:, :, None, :].expand(nrec, c, cfg.ng, cfg.nt_out + 1)
    sl = torch.gather(blended, -1, idx)  # [R, C, ng, nt_out + 1]
    fr = kin["frac"][..., None, None]
    return (1.0 - fr) * sl[..., 1:] + fr * sl[..., :-1]


def materialize_window(gf_data, gf_itmin, cfg: SynthConfig):
    """Edge-extend the GF window onto the absolute index range the shifted
    slices read: e0 = out_it0 - s_base - s_len, length nt_out + s_len.
    Returns ext f32[nxw, nzw, ng, nt_ext]."""
    e0 = cfg.out_it0 - cfg.s_base - cfg.s_len
    nt_ext = cfg.nt_out + cfg.s_len
    idx = e0 + torch.arange(nt_ext, device=gf_data.device)
    return sample_ext(gf_data, gf_itmin, idx)


def physical_spans(gf_itmin, gf_nsamples, cfg: SynthConfig, kin):
    """Per-channel physical data spans (lo, hi) int32[R, 3] of the
    synthesized traces (trace_multiply_add span growth,
    sparse_trace.f90:648-668; away and right share a span,
    seismogram.f90:109-130), clipped to the output window."""
    ixs, izs = kin["ixs"], kin["izs"]  # [R, C, 2]
    rows_lo = gf_itmin[ixs[..., :, None], izs[..., None, :]].long()  # [R, C, 2, 2, ng]
    n = gf_nsamples[ixs[..., :, None], izs[..., None, :]].long()
    rows_hi = rows_lo + torch.clamp(n - 1, min=0)
    big = 1 << 30
    empty = n == 0
    lo4 = torch.where(empty, big, rows_lo).amin(dim=(2, 3))  # [R, C, ng]
    hi4 = torch.where(empty, -big, rows_hi).amax(dim=(2, 3))

    # component groups as slices [a, b) plus the ng == 10 near-field term
    # (indexing with a Python list would copy it to the device every call):
    # away+right share components 0-4 (+8), down has 5-7 (+9)
    active = kin["valid"]
    ish = kin["ish"].long()
    spans = {}
    for ch, (a, b, near) in ((0, (0, 5, 8)), (2, (5, 8, 9))):
        glo = lo4[..., a:b].amin(dim=-1)
        ghi = hi4[..., a:b].amax(dim=-1)
        if cfg.ng == 10:
            glo = torch.minimum(glo, lo4[..., near])
            ghi = torch.maximum(ghi, hi4[..., near])
        spans[ch] = (torch.where(active, glo + ish, big).amin(dim=-1),
                     torch.where(active, ghi + ish + 1, -big).amax(dim=-1))
    lo_out = [spans[ch][0] for ch in (0, 0, 2)]
    hi_out = [spans[ch][1] for ch in (0, 0, 2)]
    top = cfg.out_it0 + cfg.nt_out - 1
    lo = torch.stack(lo_out, dim=-1).clamp(cfg.out_it0, top).to(I32)
    hi = torch.stack(hi_out, dim=-1).clamp(cfg.out_it0, top).to(I32)
    return lo, hi


_BIG = 1 << 30  # the span sentinel, int32 as in the JAX package


def span_tables(gf_itmin, gf_nsamples, cfg: SynthConfig):
    """Per-node span-union tables i32[nxw*nzw, 4] for
    physical_spans_from_tables (kiwi_tpu.synth.span_tables): (lo, hi) of
    the away/right component group and (lo, hi) of the down group, unioned
    over each node's 4 bilinear neighbours (+xu, +zu stencil) and the
    group's GF components; empty traces are excluded through +-big
    sentinels.  Neighbours past the window's far edges clamp to the edge
    node, as the JAX package's edge padding does (built by clamped
    indexing: torch's replicate padding takes no integer tensors)."""
    lo_n = torch.where(gf_nsamples == 0, _BIG, gf_itmin).to(I32)  # [nxw, nzw, ng]
    hi_n = torch.where(gf_nsamples == 0, -_BIG,
                       gf_itmin + torch.clamp(gf_nsamples - 1, min=0)).to(I32)
    xu = cfg.xunder if cfg.interpolate else 1
    zu = cfg.zunder if cfg.interpolate else 1
    n1, n2 = gf_itmin.shape[:2]
    dev = gf_itmin.device
    ix2 = torch.clamp(torch.arange(n1, device=dev) + xu, max=n1 - 1)
    iz2 = torch.clamp(torch.arange(n2, device=dev) + zu, max=n2 - 1)

    def union4(a, reduce_min):
        op = torch.minimum if reduce_min else torch.maximum
        out = a
        for part in (a[:, iz2], a[ix2], a[ix2][:, iz2]):
            out = op(out, part)
        return out.reshape(-1)

    g0 = slice(0, 5)  # away+right share components 0-4 (+8 when ng == 10)
    g2 = slice(5, 8)  # down: 5-7 (+9)
    lo0, hi0 = lo_n[..., g0].amin(-1), hi_n[..., g0].amax(-1)
    lo2, hi2 = lo_n[..., g2].amin(-1), hi_n[..., g2].amax(-1)
    if cfg.ng == 10:
        lo0, hi0 = torch.minimum(lo0, lo_n[..., 8]), torch.maximum(hi0, hi_n[..., 8])
        lo2, hi2 = torch.minimum(lo2, lo_n[..., 9]), torch.maximum(hi2, hi_n[..., 9])
    return torch.stack([union4(lo0, True), union4(hi0, False),
                        union4(lo2, True), union4(hi2, False)], dim=-1)


def physical_spans_from_tables(tables, cfg: SynthConfig, kin):
    """physical_spans through span_tables: one [4] row gathered per
    centroid (kiwi_tpu.synth.physical_spans_from_tables), for kin leaves
    [..., C] with any leading axes ([B, R, C] from a batch).  Returns
    (lo, hi) int32[..., 3], clipped to the output window."""
    node = kin["ixs"][..., 0] * cfg.nzw + kin["izs"][..., 0]  # [.., C]
    t = tables[node]  # [.., C, 4]
    active = kin["valid"]
    ish = kin["ish"]
    lo_g = [torch.where(active, t[..., col] + ish, _BIG).amin(dim=-1) for col in (0, 2)]
    hi_g = [torch.where(active, t[..., col + 1] + ish + 1, -_BIG).amax(dim=-1)
            for col in (0, 2)]
    top = cfg.out_it0 + cfg.nt_out - 1
    lo = torch.stack([lo_g[0], lo_g[0], lo_g[1]], dim=-1).clamp(cfg.out_it0, top)
    hi = torch.stack([hi_g[0], hi_g[0], hi_g[1]], dim=-1).clamp(cfg.out_it0, top)
    return lo.to(I32), hi.to(I32)


# ---------------------------------------------------------------------------
# final component assembly
# ---------------------------------------------------------------------------

# component ids as in receiver.f90:35-48
C_AWAY, C_RIGHT, C_DOWN, C_NORTH, C_EAST = 1, 2, 3, 4, 5
COMPONENT_IDS = {
    "a": C_AWAY, "c": -C_AWAY,
    "r": C_RIGHT, "l": -C_RIGHT,
    "d": C_DOWN, "u": -C_DOWN,
    "n": C_NORTH, "s": -C_NORTH,
    "e": C_EAST, "w": -C_EAST,
}


def ard_to_components(ard, bazi, component_ids):
    """Map (away, right, down) channels ard f32[..., 3, nt] to the requested
    signed component ids; north/east rotate (away, right) by bazi+pi
    (seismogram.f90:268-283).  bazi: f64[...].  Returns f32[..., ncomp, nt]."""
    away, right, down = ard[..., 0, :], ard[..., 1, :], ard[..., 2, :]
    cl = torch.cos(bazi + np.pi).to(F32)[..., None]
    sl = torch.sin(bazi + np.pi).to(F32)[..., None]
    north = cl * away - sl * right
    east = cl * right + sl * away
    basis = {C_AWAY: away, C_RIGHT: right, C_DOWN: down, C_NORTH: north, C_EAST: east}
    rows = [float(np.sign(cid)) * basis[abs(cid)] for cid in component_ids]
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# config construction helpers (host side)
# ---------------------------------------------------------------------------


def _round_up(x, m):
    return -(-int(x) // m) * m


def plan_config(
    store: GFStore,
    geom: ReceiverGeometry,
    extent_m: float,
    depth_range: tuple,
    time_range: tuple,
    interpolate: bool = True,
    xunder: int = 1,
    zunder: int = 1,
) -> SynthConfig:
    """Choose static window/tap/output bounds covering a source search space
    (extent_m: max horizontal half-extent of any centroid, m; depth_range,
    time_range: centroid bounds in m and s)."""
    dist_lo = float(geom.dist.min()) - extent_m
    dist_hi = float(geom.dist.max()) + extent_m
    ix_lo = int(np.floor((dist_lo - store.firstx) / (store.dx * xunder))) * xunder - 1
    ix_hi = int(np.ceil((dist_hi - store.firstx) / (store.dx * xunder))) * xunder + xunder + 1
    ix_lo = max(ix_lo, 0)
    ix_hi = min(ix_hi, store.nx - 1)

    zmin = depth_range[0] - float(geom.depth.max())
    zmax = depth_range[1] - float(geom.depth.min())
    iz_lo = int(np.floor((zmin - store.firstz) / (store.dz * zunder))) * zunder - 1
    iz_hi = int(np.ceil((zmax - store.firstz) / (store.dz * zunder))) * zunder + zunder + 1
    iz_lo = max(iz_lo, 0)
    iz_hi = min(iz_hi, store.nz - 1)

    if ix_hi < ix_lo or iz_hi < iz_lo:
        raise ValueError(
            "source/receiver geometry lies outside the GF store coverage: "
            f"distances [{dist_lo:.0f}, {dist_hi:.0f}] m need ix [{ix_lo}, {ix_hi}] "
            f"(store nx={store.nx}), depths [{zmin:.0f}, {zmax:.0f}] m need "
            f"iz [{iz_lo}, {iz_hi}] (store nz={store.nz})"
        )
    nxw = _round_up(ix_hi - ix_lo + 1, 2)
    nzw = _round_up(iz_hi - iz_lo + 1, 2)
    nxw = min(nxw, store.nx - ix_lo)
    nzw = min(nzw, store.nz - iz_lo)

    s_base = int(np.floor(time_range[0] / store.dt)) - 1
    s_hi = int(np.ceil(time_range[1] / store.dt)) + 1
    s_len = _round_up(s_hi - s_base + 1, 8)

    # span of stored traces inside the window
    sub_n = store.nsamples[ix_lo : ix_lo + nxw, iz_lo : iz_lo + nzw]
    sub_i = store.itmin[ix_lo : ix_lo + nxw, iz_lo : iz_lo + nzw]
    used = sub_n > 0
    if used.any():
        tr_lo = int(sub_i[used].min())
        tr_hi = int((sub_i + sub_n - 1)[used].max())
    else:
        tr_lo, tr_hi = 0, 1
    out_it0 = tr_lo + s_base
    nt_out = _round_up(tr_hi - tr_lo + 1 + s_len + 2, 16)

    return SynthConfig(
        dt=store.dt,
        dx=store.dx,
        dz=store.dz,
        firstx=store.firstx,
        firstz=store.firstz,
        ng=store.ng,
        nt=store.nt,
        ix0=ix_lo,
        nxw=nxw,
        iz0=iz_lo,
        nzw=nzw,
        out_it0=out_it0,
        nt_out=nt_out,
        s_base=s_base,
        s_len=s_len,
        interpolate=interpolate,
        xunder=xunder,
        zunder=zunder,
    )


def window_arrays(store: GFStore, cfg: SynthConfig, device):
    """(data, itmin, nsamples) tensors of the GF window selected by cfg."""
    sl = np.s_[cfg.ix0 : cfg.ix0 + cfg.nxw, cfg.iz0 : cfg.iz0 + cfg.nzw]
    return tuple(torch.as_tensor(np.ascontiguousarray(a[sl]), device=device)
                 for a in (store.data, store.itmin, store.nsamples))


def choose_group_size(cfg: SynthConfig, ncent: int, gsize: int):
    """The centroid group size of kiwi_tpu.synth.choose_formulation's
    synthesis path: grouped-direct (gsize) when its per-source transient
    bytes do not exceed the scatter+conv formulation's, else 1 (conv).
    Only the values rows' grouping depends on it here; the window kernel
    and its chunk cap are not part of this slice."""
    def _pad(n, m):
        return -(-int(n) // m) * m

    if not (gsize > 1 and ncent % gsize == 0):
        return 1
    nt_ext = cfg.nt_out + cfg.s_len
    ng_p = _pad(cfg.ng, 8)
    conv_bytes = 3 * cfg.nxw * cfg.nzw * ng_p * _pad(cfg.s_len + 1, 128) * 4
    mult = 2 if ncent // gsize >= 2 else 1
    grouped_bytes = mult * (
        (ncent // gsize) * 4 * ng_p * _pad(nt_ext, 128)
        + ncent * ng_p * _pad(cfg.nt_out + 1, 128)
    ) * 4
    return gsize if grouped_bytes <= conv_bytes else 1
