// The eikonal batch preparation in one launch, for Hopper.
//
// Replaces no TPU kernel: kiwi_tpu prepares the eikonal batch on the host
// in numpy (kiwi_tpu/sources/eikonal.py:_prepare_batch_vec), and so did the
// port (sources/eikonal.py:_prepare_batch_vec, which stays as the plain
// version).  That preparation is two Sutherland-Hodgman passes over
// [B, 180, 3] float64 polygons and ~20 more batch passes: 45-65 ms of host
// time a 384-row call while the card waits (PERF.md §5).  This kernel does,
// for every source of the batch, what _prepare_batch_vec does for a row:
//
//   - the rupture circle's centre (rotmat @ (bord-shift-x, bord-shift-y, 0)
//     + centre) and the 180-gon transform @ unit circle + circle centre;
//   - one Sutherland-Hodgman pass per constraint half-space, keeping vertex
//     order and the reference's single-precision parallel-edge rule
//     (geometry.trim_polygon);
//   - the polygon's box in rupture coordinates ((p - centre) @ rotmat);
//   - the nucleation test (inside the circle and every half-space);
//   - the fine grid's size ndims, spacing and first cell;
//   - the least layer speed over the grid's depth range (the layer
//     intervals that the range touches) and the coarse grid's size cdims and
//     spacing;
//
// and writes the device discretizer's arrays in the dtypes it takes them in
// (float32, int32 for ndims and cdims), a status per row (1 empty area,
// 2 nucleation outside, 4 polygon over the clip's capacity) and, by atomic
// maxima over the rows, the batch's summary: the largest ndims and cdims,
// whether any row failed each test, and the largest floor(4 diag(cdelta) /
// max(minspeed, 1) / dt) (the host's hard bound on time cells, less 2).
//
// Layouts (ops/eik_prepare.py holds the same):
//   rows   f64[B, 25]: time, north, east, depth, bord-shift-x, bord-shift-y,
//          bord-radius, nukl-shift-x, nukl-shift-y, rel-rupture-velocity,
//          rotmat (row-major, 9), m6 (6)
//   ctx    f64: ncons x (point 3, normal 3), layer depths (ndepth), layer
//          speeds (nvs), cos and sin of the 180-gon's angles (180 each)
//   fout   f32, field-major: field f of width w is [B, w] at offset off_f * B
//   iout   i32, field-major as fout: ndims 2, cdims 2, status 1
//   summary i64[8]: max ndims x, y; max cdims x, y; any empty, any nucleation
//          outside, any overflow; max time-cell floor
//
// What bounds it on this card: nothing of the card.  A 384-row call is
// ~70k vertices a pass, a few tens of float64 operations each: microseconds.
// So the design is plain: one block of 256 threads per source, one thread
// per polygon edge in a pass, a block scan for each vertex's place in the
// clipped polygon (at most 180 + 2 x ncons vertices, in shared memory), a
// block reduction for the box, and thread 0 for the row's scalar tail.
//
// Rounding: as the host's numpy rounds, so that a size whose quotient is an
// integer in exact arithmetic (a radius that is a multiple of the fine grid's
// spacing, an unclipped extent) falls on the host's side of it.  numpy's
// 3-term products go through OpenBLAS, whose x86-64 kernels contract them
// into FMAs (seen with OpenBLAS 0.3.27 and 0.3.30):
//   - matrix @ matrix (dgemm), a chain in k order: gemm3 below;
//   - matrix @ vector and vector @ matrix (dgemv_t's tail for 3 terms):
//     gemv3 below;
// every other operation is IEEE float64 on its own (the file is compiled
// with -fmad=false, ops/build.py).  hypot is CUDA's (2 ulp), which only the
// nucleation test's edge and the time-cell bound read.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRow = 25;
constexpr int kNPoints = 180;
constexpr int kSummary = 8;

// float32 fields: offsets in units of B
constexpr int F_FIRST = 0, F_DELTA = 2, F_NUKL = 4, F_CENTER = 6, F_ROTMAT = 9, F_M6 = 18,
              F_CCENTER = 24, F_RADIUS = 27, F_CDELTA = 28, F_MINSPEED = 30, F_TIME0 = 31,
              F_RELV = 32;
// int32 fields
constexpr int I_NDIMS = 0, I_CDIMS = 2, I_STATUS = 4;
// status bits and summary entries
constexpr int ST_EMPTY = 1, ST_NUKL = 2, ST_OVERFLOW = 4;
constexpr int S_NDX = 0, S_NDY = 1, S_NCX = 2, S_NCY = 3, S_EMPTY = 4, S_NUKL = 5,
              S_OVERFLOW = 6, S_NTMAX = 7;

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Every thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is written again by the next call
  return before + x - v;
}

// The block's min of v; every thread gets it.
__device__ double block_min(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, d));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmin(r, scratch[w]);
  __syncthreads();
  return r;
}

// a0 b0 + a1 b1 + a2 b2 as numpy's matrix @ matrix sums it
__device__ __forceinline__ double gemm3(double a0, double a1, double a2, double b0, double b1,
                                        double b2) {
  return __fma_rn(a2, b2, __fma_rn(a1, b1, a0 * b0));
}

// a0 x0 + a1 x1 + a2 x2 as numpy's matrix @ vector sums it (a: the matrix's
// row, x: the vector)
__device__ __forceinline__ double gemv3(double a0, double a1, double a2, double x0, double x1,
                                        double x2) {
  return __fma_rn(a2, x2, __fma_rn(a0, x0, a1 * x1));
}

__global__ void __launch_bounds__(kThreads)
eik_prepare_kernel(const double* __restrict__ rows, const double* __restrict__ ctx, int ncons,
                   int ndepth, int nvs, int cap, double deltagrid, double edt, int B,
                   float* __restrict__ fout, int* __restrict__ iout,
                   long long* __restrict__ summary) {
  extern __shared__ double poly[];  // two buffers of cap vertices
  __shared__ int warp_sums[kWarps];
  __shared__ double scratch[kWarps];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;

  const double* row = rows + (long long)b * kRow;
  const double t0 = row[0], radius = row[6], nsx = row[7], nsy = row[8], relv = row[9];
  const double c[3] = {row[1], row[2], row[3]};
  const double bsx = row[4], bsy = row[5];
  const double* R = row + 10;  // R[3 i + j]
  const double* m6 = row + 19;

  const double* cons = ctx;
  const double* depths = ctx + 6 * ncons;
  const double* vs = depths + ndepth;
  const double* ucos = vs + nvs;
  const double* usin = ucos + kNPoints;

  // circle centre: rotmat @ (bsx, bsy, 0) + centre
  double cc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cc[i] = gemv3(R[3 * i], R[3 * i + 1], R[3 * i + 2], bsx, bsy, 0.0) + c[i];

  // the 180-gon: (-rotmat * radius) @ (cos, sin, 0) + circle centre
  double* src = poly;
  double* dst = poly + 3 * cap;
  for (int j = tid; j < kNPoints; j += kThreads) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      src[3 * j + i] = gemm3(-R[3 * i] * radius, -R[3 * i + 1] * radius, -R[3 * i + 2] * radius,
                             ucos[j], usin[j], 0.0) + cc[i];
  }
  __syncthreads();

  // Sutherland-Hodgman, one pass per half-space (point hp, normal hn; a
  // point p is inside where hn . (hp - p) >= 0)
  int n = kNPoints, status = 0;
  for (int k = 0; k < ncons && n > 0; ++k) {
    const double* hp = cons + 6 * k;
    const double* hn = hp + 3;
    int nout = 0;
    for (int base = 0; base < n; base += kThreads) {
      const int e = base + tid;
      bool a_in = false, pierce = false;
      double a[3], pp[3];
      if (e < n) {
        const int f = e + 1 < n ? e + 1 : 0;
        double bv[3], ab[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          a[i] = src[3 * e + i];
          bv[i] = src[3 * f + i];
          ab[i] = bv[i] - a[i];
        }
        const double la = gemv3(hp[0] - a[0], hp[1] - a[1], hp[2] - a[2], hn[0], hn[1], hn[2]);
        const double lb = gemv3(hp[0] - bv[0], hp[1] - bv[1], hp[2] - bv[2], hn[0], hn[1], hn[2]);
        const double lab = gemv3(ab[0], ab[1], ab[2], hn[0], hn[1], hn[2]);
        a_in = la >= 0.0;
        pierce = a_in != (lb >= 0.0);
        if (pierce) {
          const bool parallel =
              lab * lab < ((ab[0] * ab[0] + ab[1] * ab[1]) + ab[2] * ab[2]) / 16777216.0;
          if (parallel) {
            const bool near_a = fabs(la) <= fabs(lb);
#pragma unroll
            for (int i = 0; i < 3; ++i) pp[i] = near_a ? a[i] : bv[i];
          } else {
            const double q = la / (lab == 0.0 ? 1.0 : lab);
#pragma unroll
            for (int i = 0; i < 3; ++i) pp[i] = a[i] + ab[i] * q;
          }
        }
      }
      int total;
      const int off = nout + block_exclusive_scan((int)a_in + (int)pierce, warp_sums, &total);
      if (a_in && off < cap) {
#pragma unroll
        for (int i = 0; i < 3; ++i) dst[3 * off + i] = a[i];
      }
      if (pierce && off + (int)a_in < cap) {
#pragma unroll
        for (int i = 0; i < 3; ++i) dst[3 * (off + (int)a_in) + i] = pp[i];
      }
      nout += total;
    }
    __syncthreads();
    if (nout > cap) {
      status |= ST_OVERFLOW;
      nout = cap;
    }
    n = nout;
    double* t = src;
    src = dst;
    dst = t;
  }
  if (n == 0) status |= ST_EMPTY;

  // the box in rupture coordinates: (p - centre) @ rotmat, columns 0 and 1
  double mnx = INFINITY, mny = INFINITY, mxx = -INFINITY, mxy = -INFINITY;
  for (int v = tid; v < n; v += kThreads) {
    const double d0 = src[3 * v] - c[0], d1 = src[3 * v + 1] - c[1], d2 = src[3 * v + 2] - c[2];
    const double x = gemm3(d0, d1, d2, R[0], R[3], R[6]);
    const double y = gemm3(d0, d1, d2, R[1], R[4], R[7]);
    mnx = fmin(mnx, x);
    mny = fmin(mny, y);
    mxx = fmax(mxx, x);
    mxy = fmax(mxy, y);
  }
  mnx = block_min(mnx, scratch);
  mny = block_min(mny, scratch);
  mxx = -block_min(-mxx, scratch);
  mxy = -block_min(-mxy, scratch);
  if (tid != 0) return;

  // the nucleation point: inside the circle and every half-space
  bool bad = hypot(nsx, nsy) > radius;
  double nk[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    nk[i] = gemv3(R[3 * i], R[3 * i + 1], R[3 * i + 2], nsx, nsy, 0.0) + c[i];
  for (int k = 0; k < ncons; ++k) {
    const double* hp = cons + 6 * k;
    const double* hn = hp + 3;
    bad |= gemv3(hp[0] - nk[0], hp[1] - nk[1], hp[2] - nk[2], hn[0], hn[1], hn[2]) < 0.0;
  }
  if (bad) status |= ST_NUKL;

  // the fine grid
  const double dims[2] = {mxx - mnx, mxy - mny};
  long long nd[2];
  double delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    nd[i] = (long long)ceil(dims[i] / deltagrid);
    if (nd[i] < 1) nd[i] = 1;
    delta[i] = dims[i] / (double)nd[i];
    if (delta[i] == 0.0) delta[i] = 1.0;
  }

  // the least speed over the grid's depth range: searchsorted(depths, z,
  // "left") at both ends, clipped to the last speed, and the speeds between
  const double cx[4] = {mnx, mnx, mxx, mxx}, cy[4] = {mny, mxy, mny, mxy};
  double zlo = INFINITY, zhi = -INFINITY;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double z = (c[2] + R[6] * cx[q]) + R[7] * cy[q];
    zlo = fmin(zlo, z);
    zhi = fmax(zhi, z);
  }
  int k0 = 0, k1 = 0;
  for (int i = 0; i < ndepth; ++i) {
    k0 += depths[i] < zlo;
    k1 += depths[i] < zhi;
  }
  k0 = min(k0, nvs - 1);
  k1 = min(k1, nvs - 1);
  double vmin = INFINITY;
  for (int i = k0; i <= k1; ++i) vmin = fmin(vmin, vs[i]);
  const double minspeed = vmin * relv;

  // the coarse grid
  const double maxd = 0.5 * edt * minspeed;
  long long cd[2];
  double cdelta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    cd[i] = 1;
    if (dims[i] != 0.0) {
      cd[i] = (long long)floor(dims[i] / maxd) + 1;
      if (cd[i] < 2) cd[i] = 2;
    }
    cdelta[i] = dims[i] / (double)cd[i];
  }
  const long long ntmax =
      (long long)floor(4.0 * hypot(cdelta[0], cdelta[1]) / fmax(minspeed, 1.0) / edt);

  float* fo = fout;
  auto put = [&](int field, int width, int i, double v) {
    fo[(long long)field * B + (long long)b * width + i] = (float)v;
  };
  put(F_FIRST, 2, 0, mnx);
  put(F_FIRST, 2, 1, mny);
  put(F_NUKL, 2, 0, nsx);
  put(F_NUKL, 2, 1, nsy);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    put(F_DELTA, 2, i, delta[i]);
    put(F_CDELTA, 2, i, cdelta[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    put(F_CENTER, 3, i, c[i]);
    put(F_CCENTER, 3, i, cc[i]);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) put(F_ROTMAT, 9, i, R[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) put(F_M6, 6, i, m6[i]);
  put(F_RADIUS, 1, 0, radius);
  put(F_MINSPEED, 1, 0, minspeed);
  put(F_TIME0, 1, 0, t0);
  put(F_RELV, 1, 0, relv);
  iout[(long long)I_NDIMS * B + 2 * b] = (int)nd[0];
  iout[(long long)I_NDIMS * B + 2 * b + 1] = (int)nd[1];
  iout[(long long)I_CDIMS * B + 2 * b] = (int)cd[0];
  iout[(long long)I_CDIMS * B + 2 * b + 1] = (int)cd[1];
  iout[(long long)I_STATUS * B + b] = status;

  if (status & ST_EMPTY) atomicMax(summary + S_EMPTY, 1LL);
  if (status & ST_NUKL) atomicMax(summary + S_NUKL, 1LL);
  if (status & ST_OVERFLOW) atomicMax(summary + S_OVERFLOW, 1LL);
  if (status == 0) {
    atomicMax(summary + S_NDX, nd[0]);
    atomicMax(summary + S_NDY, nd[1]);
    atomicMax(summary + S_NCX, cd[0]);
    atomicMax(summary + S_NCY, cd[1]);
    atomicMax(summary + S_NTMAX, ntmax);
  }
}

}  // namespace

extern "C" int kiwi_eik_prepare(const double* rows, const double* ctx, float* fout, int* iout,
                                long long* summary, int B, int ncons, int ndepth, int nvs,
                                double deltagrid, double edt, void* stream) {
  if (B < 1 || ncons < 0 || ndepth < 0 || nvs < 1) return (int)cudaErrorInvalidValue;
  const int cap = kNPoints + 2 * ncons;
  const size_t smem = 2 * 3 * (size_t)cap * sizeof(double);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(summary, 0, kSummary * sizeof(long long), s);
  if (err != cudaSuccess) return (int)err;
  eik_prepare_kernel<<<B, kThreads, smem, s>>>(rows, ctx, ncons, ndepth, nvs, cap, deltagrid, edt,
                                                B, fout, iout, summary);
  return (int)cudaGetLastError();
}
