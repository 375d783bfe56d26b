"""Euler rotations and moment-tensor helpers (numpy host + jnp variants).

Equivalent of the reference's euler.f90 plus the source modules' shared
strike/dip/rake -> moment-tensor construction and P/T-axis extraction
(source_bilat.f90:216-239, :565-593).
"""

from __future__ import annotations

import numpy as np

# the unrotated double couple used by all planar sources
# (source_bilat.f90:342): m_unrot = [[0,0,-1],[0,0,0],[-1,0,0]]
M_UNROT = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])


def init_euler(alpha, beta, gamma):
    """Rotation matrix from Euler angles (euler.f90:28-67).

    alpha: angle between z and zs axes (dip), beta: angle between x axis and
    line of nodes (strike), gamma: angle between line of nodes and xs axis.
    Works on numpy scalars or arrays (broadcasting over leading dims).
    """
    xp = np
    ca, cb, cg = xp.cos(alpha), xp.cos(beta), xp.cos(gamma)
    sa, sb, sg = xp.sin(alpha), xp.sin(beta), xp.sin(gamma)
    mat = xp.empty(xp.broadcast_shapes(xp.shape(alpha), xp.shape(beta), xp.shape(gamma)) + (3, 3))
    mat[..., 0, 0] = cb * cg - ca * sb * sg
    mat[..., 1, 0] = sb * cg + ca * cb * sg
    mat[..., 2, 0] = sa * sg
    mat[..., 0, 1] = -cb * sg - ca * sb * cg
    mat[..., 1, 1] = -sb * sg + ca * cb * cg
    mat[..., 2, 1] = sa * cg
    mat[..., 0, 2] = sa * sb
    mat[..., 1, 2] = -sa * cb
    mat[..., 2, 2] = ca
    return mat


def rotmats_from_sdr(strike_rad, dip_rad, rake_rad, rupdir_rad):
    """(rotmat_rup, rotmat_slip) as in source_bilat.f90:225-231."""
    rotmat_rup = init_euler(dip_rad, strike_rad, -rupdir_rad)
    rotmat_slip = init_euler(dip_rad, strike_rad, -rake_rad)
    return rotmat_rup, rotmat_slip


def mt_from_sdr(strike_rad, dip_rad, rake_rad):
    """Unit double-couple moment tensor (3x3, NED) from strike/dip/rake.

    m = R . M_UNROT . R^T with R = init_euler(dip, strike, -rake)
    (euler.f90:40-43, source_bilat.f90:437-438).
    """
    r = init_euler(dip_rad, strike_rad, -rake_rad)
    return r @ M_UNROT @ np.swapaxes(r, -1, -2)


def sym_to_m6(m):
    """3x3 symmetric tensor -> (mxx, myy, mzz, mxy, mxz, myz)."""
    m = np.asarray(m)
    return np.stack(
        [m[..., 0, 0], m[..., 1, 1], m[..., 2, 2], m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]],
        axis=-1,
    )


def m6_to_sym(m6):
    m6 = np.asarray(m6)
    out = np.empty(m6.shape[:-1] + (3, 3), dtype=m6.dtype)
    out[..., 0, 0] = m6[..., 0]
    out[..., 1, 1] = m6[..., 1]
    out[..., 2, 2] = m6[..., 2]
    out[..., 0, 1] = out[..., 1, 0] = m6[..., 3]
    out[..., 0, 2] = out[..., 2, 0] = m6[..., 4]
    out[..., 1, 2] = out[..., 2, 1] = m6[..., 5]
    return out


def _polar(xyz):
    """(r, azimuth, colatitude) of a 3-vector (source_bilat.f90:565-573)."""
    r = np.sqrt(np.dot(xyz, xyz))
    return np.array([r, np.arctan2(xyz[1], xyz[0]), np.arccos(xyz[2] / r)])


def _wrap(x, mi, ma):
    return x - np.floor((x - mi) / (ma - mi)) * (ma - mi)


def _domeshot(pol):
    """Fold a polar direction into the lower hemisphere (source_bilat.f90:575-587).

    Note: mirrors the reference's wrap(x, pi, -pi) argument order exactly.
    """
    out = pol.copy()
    out[1:3] = _wrap(pol[1:3], np.pi, -np.pi)
    if out[2] > np.pi / 2.0:
        out[1] = _wrap(out[1] + np.pi, -np.pi, np.pi)
        out[2] = np.pi - out[2]
    return out


def pt_axes(rotmat_slip):
    """P and T principal axes (azimuth, colatitude in degrees).

    source_bilat.f90:234-237: pax from rotmat_slip @ (sqrt2, 0, -sqrt2),
    tax from rotmat_slip @ (-sqrt2, 0, -sqrt2), folded to lower hemisphere.
    """
    s2 = np.sqrt(2.0)
    pax = np.degrees(_domeshot(_polar(rotmat_slip @ np.array([s2, 0.0, -s2]))))[1:3]
    tax = np.degrees(_domeshot(_polar(rotmat_slip @ np.array([-s2, 0.0, -s2]))))[1:3]
    return pax, tax


def sdr_to_m6_use(strike_rad, dip_rad, rake_rad):
    """m6 in up-south-east convention (eulermt.f90:36-47): derived from NED."""
    m = mt_from_sdr(strike_rad, dip_rad, rake_rad)
    # NED (n,e,d) -> USE (u,s,w):  u=-d, s=-n, e=e
    # m_use[r,t,p] with r=up, t=south, p=east
    conv = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    return sym_to_m6(conv @ m @ conv.T)
