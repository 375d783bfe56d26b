"""Piecewise linear functions (host-side numpy).

Equivalent of piecewise_linear_function.f90: boxcars, ramps, trapezoids used
as source-time functions, tapers and spectral filters.  The function jumps to
zero outside its endpoints.

Tapers/filters are static per configuration, so we evaluate them host-side
into dense weight vectors that the jitted misfit kernels consume; STF cell
integration (integrate_and_centroid) feeds the source discretizers.
"""

from __future__ import annotations

import numpy as np


class PLF:
    """A piecewise linear function defined by control points (x, y)."""

    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        if self.x.ndim != 1 or self.x.shape != self.y.shape or self.x.size < 2:
            raise ValueError("PLF needs >= 2 control points with matching x, y")

    @property
    def n(self):
        return self.x.size

    def span(self):
        """(x_first, x_last) (piecewise_linear_function.f90:122-133)."""
        return float(self.x[0]), float(self.x[-1])

    def discrete_span(self, dx):
        """Integer sample span [ceil(x1/dx), floor(xn/dx)] (comparator.f90:1157-1169)."""
        return int(np.ceil(self.x[0] / dx)), int(np.floor(self.x[-1] / dx))

    # -- integration ---------------------------------------------------------

    def integrate(self, a, b):
        """Area between x=a and x=b (piecewise_linear_function.f90:135-161)."""
        area, _ = self.integrate_and_centroid(a, b)
        return area

    def integrate_and_centroid(self, a, b):
        """Vectorized area and centroid of the function over cells [a, b].

        Matches plf_integrate_and_centroid (piecewise_linear_function.f90:
        163-193) including its centroid = c/area convention (0/0 -> nan is
        avoided: cells with zero area get centroid (a+b)/2, as the Fortran
        initializes centroid before possibly returning early).
        """
        a = np.atleast_1d(np.asarray(a, dtype=np.float64))
        b = np.atleast_1d(np.asarray(b, dtype=np.float64))
        x, y = self.x, self.y

        x0s = x[:-1][None, :]
        x1s = x[1:][None, :]
        y0s = y[:-1][None, :]
        y1s = y[1:][None, :]
        aa = a[:, None]
        bb = b[:, None]

        lo = np.maximum(aa, x0s)
        hi = np.minimum(bb, x1s)
        valid = hi > lo

        with np.errstate(divide="ignore", invalid="ignore"):
            slope = np.where(x1s != x0s, (y1s - y0s) / (x1s - x0s), 0.0)
        ylo = y0s + slope * (lo - x0s)
        yhi = y0s + slope * (hi - x0s)

        area_seg = np.where(valid, (ylo + yhi) * (hi - lo) / 2.0, 0.0)
        # trapezoid centroid (piecewise_linear_function.f90:285-294)
        ysum = ylo + yhi
        cx = np.where(
            ysum != 0.0,
            (lo * (2.0 * ylo + yhi) + hi * (ylo + 2.0 * yhi)) / np.where(ysum != 0, 3.0 * ysum, 1.0),
            (lo + hi) / 2.0,
        )
        c_seg = np.where(valid, area_seg * cx, 0.0)

        area = area_seg.sum(axis=1)
        c = c_seg.sum(axis=1)
        centroid = np.where(area != 0.0, c / np.where(area != 0, area, 1.0), (a + b) / 2.0)
        if centroid.size == 1:
            return float(area[0]), float(centroid[0])
        return area, centroid

    # -- taper application ---------------------------------------------------

    def taper_weights(self, span, dx, ip="cos"):
        """Dense multiplicative taper weights for samples span[0]..span[1].

        Sample j sits at coordinate j*dx.  Reproduces plf_taper_array
        (piecewise_linear_function.f90:195-237): zeros for j*dx at/before the
        first control point sample (j <= floor(x1/dx)), zeros from
        j >= floor(xn/dx)+1, interpolated ramps in between, with each
        segment i covering floor(x_i/dx)+1 .. floor(x_{i+1}/dx) and earlier
        segments taking precedence.  Samples inside the span not covered by
        any segment keep weight 1 (the Fortran leaves them untouched).

        ip: 'cos' (0.5-0.5cos ramp), 'linear', or 'zero_one' (mask).
        """
        j0, j1 = int(span[0]), int(span[1])
        n = j1 - j0 + 1
        w = np.ones(n, dtype=np.float64)
        x, y = self.x, self.y

        ibeg0 = int(np.floor(x[0] / dx))
        if j0 <= ibeg0:
            w[: min(ibeg0, j1) - j0 + 1] = 0.0

        ibegatleast = j0
        for i in range(self.n - 1):
            ibeg = max(int(np.floor(x[i] / dx)) + 1, j0, ibegatleast)
            iend = min(int(np.floor(x[i + 1] / dx)), j1)
            if ibeg <= iend:
                xi = np.arange(ibeg, iend + 1, dtype=np.float64) * dx
                if ip == "cos":
                    if y[i + 1] != y[i]:
                        val = y[i] + (y[i + 1] - y[i]) * (
                            0.5 - 0.5 * np.cos((xi - x[i]) / (x[i + 1] - x[i]) * np.pi)
                        )
                    else:
                        val = np.full(xi.shape, y[i])
                elif ip == "linear":
                    val = y[i] + (y[i + 1] - y[i]) / (x[i + 1] - x[i]) * (xi - x[i])
                elif ip == "zero_one":
                    val = np.zeros(xi.shape) if (y[i] == 0.0 and y[i + 1] == 0.0) else np.ones(xi.shape)
                else:
                    raise ValueError(f"unknown interpolation method {ip!r}")
                w[ibeg - j0 : iend - j0 + 1] = val
            ibegatleast = iend + 1

        iend_tail = int(np.floor(x[-1] / dx)) + 1
        if j1 >= iend_tail:
            w[max(iend_tail, j0) - j0 :] = 0.0
        return w


def boxcar_stf(risetime):
    """Normalized boxcar STF of length risetime (source_moment_tensor.f90:239-242)."""
    r = float(risetime)
    return PLF(
        [-r / 2.0, -r / 2.0, r / 2.0, r / 2.0],
        [0.0, 1.0 / r, 1.0 / r, 0.0],
    )


def trapezoid_stf(dursf, risetime):
    """Box(risetime) (x) box(dursf) STF, normalized to unit area.

    source_bilat.f90:403-414: a trapezoid with plateau 1/max(dursf,risetime).
    """
    dursf = float(dursf)
    risetime = float(risetime)
    lo, hi = min(dursf, risetime), max(dursf, risetime)
    return PLF(
        [-(hi + lo) / 2.0, -(hi - lo) / 2.0, (hi - lo) / 2.0, (hi + lo) / 2.0],
        [0.0, 1.0 / hi, 1.0 / hi, 0.0],
    )


def stf_cell_weights(stf: PLF, nt: int, tbeg: float, dt: float):
    """Per-time-cell (weight, centroid-offset) for a discretized STF.

    The pattern shared by all source discretizers
    (e.g. source_bilat.f90:421-427): cell it (0-based) covers
    [tbeg + dt*it, tbeg + dt*(it+1)); returns (wt[nt], toff[nt]).
    """
    ta = tbeg + dt * np.arange(nt)
    tb = tbeg + dt * (np.arange(nt) + 1)
    wt, toff = stf.integrate_and_centroid(ta, tb)
    return np.atleast_1d(wt), np.atleast_1d(toff)
