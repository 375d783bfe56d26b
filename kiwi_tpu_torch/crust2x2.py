"""CRUST 2.0 global crustal model access (Laske, Masters & Reif).

Counterpart of crust2x2.f90: loads the 2x2-degree crustal type map
(CNtype2.txt / CNtype2_key.txt / CNelevatio2.txt, bundled public data in
kiwi_tpu_torch/data/crust2x2, the port's own copy of kiwi_tpu's) into dense
arrays and provides profile lookups, crustal averages, and velocity-at-depth
queries.  A numpy module, carried into the port unchanged otherwise.

Layer order after load (the key file stores ice before water; the load swaps
them, crust2x2.f90:284-288): 0=water, 1=ice, 2=soft sed., 3=hard sed.,
4=upper crust, 5=middle crust, 6=lower crust; index 7 of vp/vs/rho = mantle
below Moho.
"""

from __future__ import annotations

import functools
import os

import numpy as np

NLAYERS = 7
NTYPES = 360
NLA = 90
NLO = 180

DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "crust2x2")


class Crust2x2:
    """Dense-array crustal model: vp/vs/rho [nlo, nla, 8], thickness
    [nlo, nla, 7], elevation [nlo, nla]."""

    def __init__(self, directory=DATA_DIR):
        types = {}
        with open(os.path.join(directory, "CNtype2_key.txt")) as f:
            lines = f.read().splitlines()
        i = 5  # skip header (crust2x2.f90:263-265)
        order = []
        while i < len(lines) and len(order) < NTYPES:
            tid = lines[i].split()[0]
            vp = np.array(lines[i + 1].split()[: NLAYERS + 1], dtype=np.float64) * 1000.0
            vs = np.array(lines[i + 2].split()[: NLAYERS + 1], dtype=np.float64) * 1000.0
            rho = np.array(lines[i + 3].split()[: NLAYERS + 1], dtype=np.float64) * 1000.0
            th = np.array(lines[i + 4].split()[:NLAYERS], dtype=np.float64) * 1000.0
            # flip ice and water layers (crust2x2.f90:284-288)
            for a in (vp, vs, rho, th):
                a[0], a[1] = a[1], a[0]
            types[tid] = (vp, vs, rho, th)
            order.append(tid)
            i += 5

        self.vp = np.zeros((NLO, NLA, NLAYERS + 1))
        self.vs = np.zeros((NLO, NLA, NLAYERS + 1))
        self.rho = np.zeros((NLO, NLA, NLAYERS + 1))
        self.thickness = np.zeros((NLO, NLA, NLAYERS))
        self.elevation = np.zeros((NLO, NLA))

        with open(os.path.join(directory, "CNtype2.txt")) as f:
            rows = f.read().splitlines()[1:]
        for j in range(NLA):
            parts = rows[j].split()
            ids = parts[1:]
            if len(ids) != NLO:
                raise ValueError(f"bad CNtype2 row {j}: {len(ids)} entries")
            for i2, tid in enumerate(ids):
                vp, vs, rho, th = types[tid]
                self.vp[i2, j] = vp
                self.vs[i2, j] = vs
                self.rho[i2, j] = rho
                self.thickness[i2, j] = th

        with open(os.path.join(directory, "CNelevatio2.txt")) as f:
            rows = f.read().splitlines()[1:]
        for j in range(NLA):
            vals = np.array(rows[j].split()[1:], dtype=np.float64)
            self.elevation[:, j] = vals
            # more accurate water thickness from elevation (crust2x2.f90:329-334)
            wet = (vals < 0.0) & (self.thickness[:, j, 0] != 0.0)
            self.thickness[wet, j, 0] = -vals[wet]

    @staticmethod
    def indices(lat_deg, lon_deg):
        """(ilon, ilat) 0-based grid indices (crust2x2.f90:197-213)."""
        lat = np.clip(lat_deg, -90.0, 90.0)
        lon = lon_deg
        if not (-180.0 <= lon <= 180.0):
            lon = lon - np.floor((lon + 180.0) / 360.0) * 360.0
        dx = 360.0 / NLO
        ilat = int((90.0 - lat) / dx)
        ilon = int((lon + 180.0) / dx)
        return min(ilon, NLO - 1), min(ilat, NLA - 1)

    def profile(self, lat_deg, lon_deg):
        """(vp[8], vs[8], rho[8], thickness[7], elevation) at a location."""
        i, j = self.indices(lat_deg, lon_deg)
        return (
            self.vp[i, j],
            self.vs[i, j],
            self.rho[i, j],
            self.thickness[i, j],
            self.elevation[i, j],
        )

    @staticmethod
    def profile_averages(vp, vs, rho, thickness):
        """Crustal averages (ice included, water excluded) and thickness
        (crust2x2_get_profile_averages, crust2x2.f90:138-166): harmonic
        velocity means over 0-based layers 1..6 (ice through lower crust,
        water excluded).
        """
        th = thickness[1:NLAYERS]
        vpl = vp[1:NLAYERS]
        vsl = vs[1:NLAYERS]
        rhol = rho[1:NLAYERS]
        vthi = th.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            vvp = vthi / (th / vpl).sum()
            vvs = vthi / (th / vsl).sum()
            vrho = (th * rhol).sum() / vthi
        return vvp, vvs, vrho, vthi

    @staticmethod
    def at_depth(vp, vs, rho, thickness, depth):
        """(vp, vs, rho) at depth below surface, walking layers 3..7
        (1-based; skips ice/water -- crust2x2_get_at_depth,
        crust2x2.f90:168-193); mantle values below the crust."""
        d = 0.0
        for i in range(2, NLAYERS):
            d += thickness[i]
            if d >= depth:
                return vp[i], vs[i], rho[i]
        return vp[NLAYERS], vs[NLAYERS], rho[NLAYERS]

    def layers_at(self, lat_deg, lon_deg):
        """(interface_depths[6], vp[6], vs[6], rho[6]) step-function arrays
        for vectorized at-depth interpolation: interval k covers depths
        (depth[k-1], depth[k]] using layer 3..7 then mantle."""
        vp, vs, rho, th, _ = self.profile(lat_deg, lon_deg)
        depths = np.cumsum(th[2:NLAYERS])
        return (
            depths,
            vp[2 : NLAYERS + 1].copy(),
            vs[2 : NLAYERS + 1].copy(),
            rho[2 : NLAYERS + 1].copy(),
        )


@functools.lru_cache(maxsize=1)
def default_model() -> Crust2x2:
    return Crust2x2()
