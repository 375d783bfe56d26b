// The eikonal device discretizer's two passes over the fine grid, for Hopper:
// the speeds before the solve and the centroid tables after it.
//
// Replaces no TPU kernel: the JAX package leaves both passes to XLA
// (kiwi_tpu/sources/eikonal.py, make_device_discretizer's pre and post), and
// the port ran them as two torch chains (ops/eik_tables.py: speeds_reference
// and tables_reference, which stay as the plain versions).  The chains built
// the fine grid's points f32[B, nfx, nfy, 3] and the rupture mask in device
// memory on both sides of the solve: ~170 launches and ~13 ms of device time
// a call at the benchmark's 384 x 320 x 320 (PERF.md §5).  Here:
//
//   eik_speeds_kernel  one block per kRows fine rows of a source, one thread
//                      per column (consecutive threads along y, so a row is
//                      written in one coalesced run): per fine cell its
//                      point, the rupture test (inside the circle, every
//                      constraint half-space and the source's own grid), the
//                      layer's speed (searchsorted over the layer depths,
//                      side "left") times rel-rupture-velocity, half the
//                      least speed where that is 0 (outside the rupture);
//   eik_cells_kernel   one warp per (source, coarse cell).  coarse_index is
//                      separable, so a coarse cell is a rectangle of fine
//                      cells (32 x 32 at the benchmark's shape); the warp
//                      reads its times once, a row at a time, into registers
//                      (kPer a lane; a larger rectangle reads the rest
//                      again), takes the count and the sums of t, north,
//                      east and depth over the valid cells (inside the
//                      rupture and the grid, t < BIG / 2), then sum
//                      |t - mean t| over the same copy, and writes the
//                      cell's count, means and duration into a scratch
//                      f32[6][B, ncell];
//   eik_tables_kernel  one block per source: npf, the centre time, the
//                      boxcar time cells, the overflow count, the stable
//                      actives-first compaction under the cell budget (a
//                      block scan over the coarse cells) and the tables.
//
// What bounds them on this card: bytes.  At the benchmark's shape the solve's
// speeds are written once and its times read once, 157 MB each, ~0.1 ms at
// 3.35 TB/s; the arithmetic (~40 float operations a fine cell, ~4 float64
// sums) is ~2 GFLOP.  So nothing of the fine grid but the speeds and the
// times touches device memory: points, masks and the coarse cell of each fine
// cell are recomputed in registers from the source's dozen numbers, and the
// per-cell sums leave the chip as 6 floats a coarse cell.  What is left is
// instruction throughput: ~100 instructions a fine cell in each pass (the
// IEEE square root, the constraints, the layer search), so a cell's point is
// built from a row's and a column's terms computed once, and a thread tests
// a group of 8 cells against each constraint in turn, which it reads from
// shared memory once a group.
//
// Rounding.  The speeds equal the card's torch chain bit for bit, since the
// solve reads every speed: each product and sum rounds on its own (the file
// is built with -fmad=false, ops/build.py), the square root is IEEE sqrtf,
// and a sum over a last axis of 3 goes in the order of torch's CUDA
// reduction there, (e0 + e2) + e1 (a block two lanes wide; lane 0 takes
// elements 0 and 2, then the warp shuffle adds lane 1's element 1).  The
// tables sum in float64 in a fixed order (a lane's cells in turn, then warp
// shuffles; no atomics), so they repeat from run to run; they differ from the
// chain's float32 matrix products by that chain's rounding, ~1e-7 of a
// value.
//
// Layouts (ops/eik_tables.py holds the same):
//   rows   12 pointers, each a contiguous [B, w] array of ops/eik_prepare.py:
//          first f32 2, delta f32 2, ndims i32 2, rotmat f32 9, center f32 3,
//          ccenter f32 3, radius f32, relv f32, minspeed f32, cdims i32 2,
//          m6 f32 6, time0 f32
//   ctx    f64, ops/eik_prepare.context_array: ncons x (point 3, normal 3),
//          layer depths (ndepth), layer speeds (nvs), ...
//   speeds, times f32[B, nfx, nfy]
//   tables 7 pointers: north, east, depth, time f32[B, C], m f32[B, C, 6],
//          active bool[B, C], overflow i32[B]; C = ncell_out x ntmax, a coarse
//          cell's ntmax time cells consecutive, the cells in cix-major order
//          (actives first under a budget)

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kBig = 1e30f;  // an unreached cell of the solve (ops/eik_sweep.BIG)
constexpr int kMaxThreads = 256;
constexpr int kRows = 8;            // fine rows a block of eik_speeds_kernel takes
constexpr int kCellWarps = 8;       // coarse cells a block of eik_cells_kernel takes
constexpr int kPer = 32;            // times a lane of eik_cells_kernel keeps in registers
constexpr int kGroup = 8;           // of them, cells tested against the constraints together
static_assert(kPer % kGroup == 0, "a lane's cells split into whole groups");
constexpr int kTableThreads = 256;
enum { F_CNT, F_TIME, F_NORTH, F_EAST, F_DEPTH, F_DUR };  // scratch fields a coarse cell

struct Rows {
  const float* first;
  const float* delta;
  const int* ndims;
  const float* rotmat;
  const float* center;
  const float* ccenter;
  const float* radius;
  const float* relv;
  const float* minspeed;
  const int* cdims;
  const float* m6;
  const float* time0;
};

struct Tables {
  float* north;
  float* east;
  float* depth;
  float* time;
  float* m;
  bool* active;
  int* overflow;
};

// What the fine-grid geometry of source b needs, in registers (z: the
// product's third terms, rotmat[k][2] x 0).
struct Source {
  float first[2], delta[2], R[9], c[3], cc[3], z[3], radius;
  int nd[2];
};

__device__ Source load_source(const Rows& r, int b) {
  Source s;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.first[i] = r.first[2 * b + i];
    s.delta[i] = r.delta[2 * b + i];
    s.nd[i] = r.ndims[2 * b + i];
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) s.R[i] = r.rotmat[9 * b + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.c[i] = r.center[3 * b + i];
    s.cc[i] = r.ccenter[3 * b + i];
    s.z[i] = s.R[3 * i + 2] * 0.0f;
  }
  s.radius = r.radius[b];
  return s;
}

// The centre of fine cell (x, y) in NED is rotmat @ (px, py, 0) + center,
// the product's terms in order, each operation rounded on its own as the
// chain's kernels round it: ((a[k] + b[k]) + z[k]) + c[k] with the row's
// terms a[k] = rotmat[k][0] px and the column's b[k] = rotmat[k][1] py.
__device__ void row_terms(const Source& s, int x, float a[3]) {
  const float px = s.first[0] + ((float)x + 0.5f) * s.delta[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] = s.R[3 * k] * px;
}

__device__ void column_terms(const Source& s, int y, float b[3]) {
  const float py = s.first[1] + ((float)y + 0.5f) * s.delta[1];
#pragma unroll
  for (int k = 0; k < 3; ++k) b[k] = s.R[3 * k + 1] * py;
}

__device__ void fine_point(const Source& s, const float a[3], const float b[3], float p[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = ((a[k] + b[k]) + s.z[k]) + s.c[k];
}

// The constraint half-spaces, ncons x (point 3, normal 3) in float32 in
// shared memory.
struct Constraints {
  const float* q;
  int n;
};

// Whether point p lies in the rupture circle.
__device__ bool in_circle(const Source& s, const float p[3]) {
  const float r0 = p[0] - s.cc[0], r1 = p[1] - s.cc[1], r2 = p[2] - s.cc[2];
  return sqrtf((r0 * r0 + r2 * r2) + r1 * r1) <= s.radius;
}

// Clears in[k] where point p[k] of a group lies outside a constraint
// half-space.  The constraints form the outer loop, so each is read from
// shared memory once a group.
template <int kN>
__device__ void clip(const Constraints& cons, const float (&p)[kN][3], bool (&in)[kN]) {
  for (int i = 0; i < cons.n; ++i) {
    float q[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) q[m] = cons.q[6 * i + m];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const float d0 = (q[0] - p[k][0]) * q[3], d1 = (q[1] - p[k][1]) * q[4],
                  d2 = (q[2] - p[k][2]) * q[5];
      in[k] = in[k] && (d0 + d2) + d1 >= 0.0f;
    }
  }
}

// torch.searchsorted(depths, v, side="left") as its CUDA kernel searches.
__device__ int lower_bound(const float* depths, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(depths[mid] >= v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The least fine index x >= 0 whose centre lies in coarse cell c or later:
// coarse_index(x) = floor((2 x + 1) nc / (2 nd)) >= c  <=>  2 x + 1 >= q with
// q = ceil(2 nd c / nc).
__device__ int first_fine(int c, int nc, int nd) {
  const long long q = (2LL * nd * c + nc - 1) / nc;
  return (int)(q / 2);
}

// The fine cells [lo, hi) of coarse cell c along one axis: a source's nd fine
// cells (of the grid's nf) over its nc coarse cells, the index clamped to the
// grid's last coarse cell nc_grid - 1, as the chain clamps it.
__device__ void fine_range(int c, int nc, int nd, int nc_grid, int nf, int* lo, int* hi) {
  const int end = min(nd, nf);
  *lo = min(first_fine(c, nc, nd), end);
  *hi = c == nc_grid - 1 ? end : min(first_fine(c + 1, nc, nd), end);
}

// Sum of v over the block in a fixed order; every thread gets it.
template <typename T>
__device__ T block_sum(T v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r += scratch[w];
  __syncthreads();
  return r;
}

__device__ int block_max(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = max(v, __shfl_down_sync(0xffffffffu, v, d));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = max(r, scratch[w]);
  __syncthreads();
  return r;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
__device__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < nw; ++w) {
    if (w == warp) before = sum;
    sum += scratch[w];
  }
  *total = sum;
  __syncthreads();
  return before + x - v;
}

// The context's constraints (and, with depths, its layer depths and speeds)
// as float32 in shared memory, as the chain casts them.
__device__ void load_context(const double* ctx, int n, float* sh) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) sh[i] = (float)ctx[i];
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads) eik_speeds_kernel(
    Rows r, const double* __restrict__ ctx, int ncons, int ndepth, int nvs, int nfx, int nfy,
    float* __restrict__ speeds) {
  extern __shared__ float sh[];
  load_context(ctx, 6 * ncons + ndepth + nvs, sh);
  const Constraints cons{sh, ncons};
  const float* depths = sh + 6 * ncons;
  const float* vs = depths + ndepth;
  const int xblocks = (nfx + kRows - 1) / kRows;
  const int b = blockIdx.x / xblocks, x0 = blockIdx.x % xblocks * kRows;
  const int x1 = min(x0 + kRows, nfx);
  const Source s = load_source(r, b);
  const float relv = r.relv[b], half = 0.5f * r.minspeed[b];
  float* out = speeds + (long long)b * nfx * nfy;
  float a[kRows][3];
#pragma unroll
  for (int i = 0; i < kRows; ++i) row_terms(s, x0 + i, a[i]);
  for (int y = threadIdx.x; y < nfy; y += blockDim.x) {
    float bt[3];
    column_terms(s, y, bt);
    float p[kRows][3];
    bool in[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      fine_point(s, a[i], bt, p[i]);
      in[i] = in_circle(s, p[i]);
    }
    clip(cons, p, in);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int x = x0 + i;
      if (x >= x1) break;
      const int k = min(lower_bound(depths, ndepth, p[i][2]), nvs - 1);
      const float speed = in[i] && x < s.nd[0] && y < s.nd[1] ? vs[k] * relv : 0.0f;
      out[(long long)x * nfy + y] = speed == 0.0f ? half : speed;
    }
  }
}

// Fine cell (x, y) of source b: its point p and, where the cell is valid,
// its time, else -1 (a valid time is >= 0).
__device__ float valid_time(const Source& s, const Constraints& cons,
                            const float* __restrict__ t_b, int nfy, int x, int y, float p[3]) {
  float a[3], b[3], pt[1][3];
  row_terms(s, x, a);
  column_terms(s, y, b);
  fine_point(s, a, b, pt[0]);
  bool in[1] = {in_circle(s, pt[0])};
  clip(cons, pt, in);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = pt[0][k];
  const float t = t_b[(long long)x * nfy + y];
  return in[0] && t < 0.5f * kBig ? t : -1.0f;
}

// Sum of v over the warp; every lane gets the same bits (each butterfly
// step adds the same two values on both lanes).
template <typename T>
__device__ T warp_sum(T v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// One warp per (source, coarse cell).  The rectangle's rows are padded to a
// multiple of 32 columns; lane l takes columns l, l + 32, ... of each row, so
// a warp reads a row's times in one coalesced run.  The lane's first kPer
// cells stay in registers for the second pass; a larger rectangle reads the
// rest again.
__global__ void __launch_bounds__(32 * kCellWarps, 2) eik_cells_kernel(
    Rows r, const float* __restrict__ times, const double* __restrict__ ctx, int ncons, int nfx,
    int nfy, int ncx, int ncy, int B, float* __restrict__ cells) {
  extern __shared__ float sh[];
  load_context(ctx, 6 * ncons, sh);
  const Constraints cons{sh, ncons};
  const int lane = threadIdx.x & 31;
  const int ncell = ncx * ncy;
  const long long bc = (long long)blockIdx.x * kCellWarps + (threadIdx.x >> 5);
  if (bc >= (long long)B * ncell) return;
  const int b = (int)(bc / ncell), c = (int)(bc % ncell);
  const Source s = load_source(r, b);
  int x0, x1, y0, y1;
  fine_range(c / ncy, r.cdims[2 * b], s.nd[0], ncx, nfx, &x0, &x1);
  fine_range(c % ncy, r.cdims[2 * b + 1], s.nd[1], ncy, nfy, &y0, &y1);
  const int h = y1 - y0, hp = (h + 31) & ~31;
  const float* t_b = times + (long long)b * nfx * nfy;

  // pass 1: the lane's first kPer times, loaded together (BIG past the
  // rectangle), then the count and the sums of t, north, east, depth over
  // the valid cells.  A step to the next 32 columns wraps to the next row
  // on every lane at once (hp is a multiple of 32).
  float tv[kPer];
  int x = h > 0 ? x0 : x1, col = lane;  // this lane's next cell
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    tv[k] = x < x1 && col < h ? t_b[(long long)x * nfy + y0 + col] : kBig;
    col += 32;
    if (col >= hp) col -= hp, ++x;
  }
  int cnt = 0;
  double st = 0.0, sn = 0.0, se = 0.0, sd = 0.0;
  float p[3], a[3], bt[3];
  x = h > 0 ? x0 : x1, col = lane;
  row_terms(s, x, a);
  column_terms(s, y0 + col, bt);
#pragma unroll
  for (int g = 0; g < kPer; g += kGroup) {
    float pg[kGroup][3];
    bool in[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      fine_point(s, a, bt, pg[k]);
      in[k] = tv[g + k] < 0.5f * kBig && in_circle(s, pg[k]);
      col += 32;
      if (col >= hp) {
        col -= hp, ++x;
        row_terms(s, x, a);
      }
      if (hp > 32) column_terms(s, y0 + col, bt);
    }
    clip(cons, pg, in);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (in[k]) {
        ++cnt;
        st += tv[g + k];
        sn += pg[k][0];
        se += pg[k][1];
        sd += pg[k][2];
      } else {
        tv[g + k] = -1.0f;
      }
    }
  }
  const int xk = x, colk = col;  // the first cell past the registers
  for (; x < x1; col += 32) {
    if (col >= hp) {
      col -= hp;
      if (++x >= x1) break;
    }
    const float t = col < h ? valid_time(s, cons, t_b, nfy, x, y0 + col, p) : -1.0f;
    if (t >= 0.0f) {
      ++cnt;
      st += t;
      sn += p[0];
      se += p[1];
      sd += p[2];
    }
  }
  cnt = warp_sum(cnt);
  st = warp_sum(st);
  sn = warp_sum(sn);
  se = warp_sum(se);
  sd = warp_sum(sd);
  const float fc = (float)cnt;
  const float ctime = cnt > 0 ? (float)st / fc : 0.0f;

  // pass 2: sum |t - ctime| over the same cells
  double sa = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (tv[k] >= 0.0f) sa += fabsf(tv[k] - ctime);
  for (x = xk, col = colk; x < x1; col += 32) {
    if (col >= hp) {
      col -= hp;
      if (++x >= x1) break;
    }
    const float t = col < h ? valid_time(s, cons, t_b, nfy, x, y0 + col, p) : -1.0f;
    if (t >= 0.0f) sa += fabsf(t - ctime);
  }
  sa = warp_sum(sa);
  if (lane == 0) {
    const long long stride = (long long)B * ncell;
    const bool have = cnt > 0;
    cells[F_CNT * stride + bc] = fc;
    cells[F_TIME * stride + bc] = ctime;
    cells[F_NORTH * stride + bc] = have ? (float)sn / fc : 0.0f;
    cells[F_EAST * stride + bc] = have ? (float)se / fc : 0.0f;
    cells[F_DEPTH * stride + bc] = have ? (float)sd / fc : 0.0f;
    cells[F_DUR * stride + bc] = have ? 4.0f / fc * (float)sa : 0.0f;
  }
}

__global__ void __launch_bounds__(kTableThreads) eik_tables_kernel(
    Rows r, const float* __restrict__ cells, int B, int ncell, int ncell_out, int ntmax,
    int budget, float edt, Tables o) {
  __shared__ double dsum[kTableThreads / 32];
  __shared__ long long lsum[kTableThreads / 32];
  __shared__ int isum[kTableThreads / 32];
  const int b = blockIdx.x;
  const long long stride = (long long)B * ncell, at = (long long)b * ncell;
  const float* cnt = cells + F_CNT * stride + at;
  const float* ctime = cells + F_TIME * stride + at;
  const float* cdur = cells + F_DUR * stride + at;

  // the valid fine cells, the active coarse cells and the time cells over
  // the budget
  long long npf = 0;
  int nact = 0, over = 0;
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
    if (cnt[c] > 0.0f) {
      npf += (long long)cnt[c];
      ++nact;
      over = max(over, (int)floorf(cdur[c] / edt) + 1 - ntmax);
    }
  }
  npf = block_sum(npf, lsum);
  nact = block_sum(nact, isum);
  over = block_max(over, isum);
  if (budget >= 0) over = max(over, nact - budget);
  const float npff = fmaxf((float)npf, 1.0f);
  double ct = 0.0;
  for (int c = threadIdx.x; c < ncell; c += blockDim.x)
    if (cnt[c] > 0.0f) ct += ctime[c] * (cnt[c] / npff);
  const float centertime = (float)block_sum(ct, dsum);
  if (threadIdx.x == 0) o.overflow[b] = over;

  float m6[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) m6[k] = r.m6[6 * b + k];
  const float t0 = r.time0[b];
  int done = 0;  // actives before this chunk
  for (int base = 0; base < ncell; base += blockDim.x) {
    const int c = base + threadIdx.x;
    const bool have = c < ncell && cnt[c] > 0.0f;
    int total;
    const int rank = done + block_exclusive_scan(have, isum, &total);
    done += total;
    const int pos = budget < 0 ? c : have ? rank : nact + (c - rank);
    if (c >= ncell || pos >= ncell_out) continue;
    const float n = cnt[c], dur = cdur[c];
    const float north = cells[F_NORTH * stride + at + c], east = cells[F_EAST * stride + at + c],
                depth = cells[F_DEPTH * stride + at + c];
    const float w = n / npff;
    const int nt = min(have ? (int)floorf(dur / edt) + 1 : 0, ntmax);
    const float ntf = (float)max(nt, 1);
    for (int it = 0; it < ntmax; ++it) {
      const long long e = ((long long)b * ncell_out + pos) * ntmax + it;
      const float toff = -dur * 0.5f + dur / ntf * ((float)it + 0.5f);
      const bool live = it < nt && have;
      const float wt = (live ? 1.0f / ntf : 0.0f) * w;
      o.north[e] = north;
      o.east[e] = east;
      o.depth[e] = depth;
      o.time[e] = ((ctime[c] + toff) + t0) - centertime;
#pragma unroll
      for (int k = 0; k < 6; ++k) o.m[6 * e + k] = m6[k] * wt;
      o.active[e] = live;
    }
  }
}

Rows rows_of(const void* const* p) {
  return Rows{(const float*)p[0], (const float*)p[1], (const int*)p[2],   (const float*)p[3],
              (const float*)p[4], (const float*)p[5], (const float*)p[6],  (const float*)p[7],
              (const float*)p[8], (const int*)p[9],   (const float*)p[10], (const float*)p[11]};
}

int round_up32(int n) { return (n + 31) / 32 * 32; }

}  // namespace

extern "C" int kiwi_eik_speeds(const void* const* rows, const double* ctx, int ncons, int ndepth,
                               int nvs, float* speeds, int B, int nfx, int nfy, void* stream) {
  if (B < 1 || nfx < 1 || nfy < 1 || ncons < 0 || ndepth < 0 || nvs < 1 ||
      (long long)B * nfx > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 * ncons + ndepth + nvs) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int chunks = (nfy + kMaxThreads - 1) / kMaxThreads;
  const int blocks = B * ((nfx + kRows - 1) / kRows);
  const int threads = round_up32((nfy + chunks - 1) / chunks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Rows r = rows_of(rows);
  eik_speeds_kernel<<<blocks, threads, smem, st>>>(r, ctx, ncons, ndepth, nvs, nfx, nfy, speeds);
  return (int)cudaGetLastError();
}

extern "C" int kiwi_eik_tables(const void* const* rows, const float* times, const double* ctx,
                               int ncons, float* cells, int B, int nfx, int nfy, int ncx, int ncy,
                               int ncell_out, int ntmax, int budget, float edt,
                               void* const* tables, void* stream) {
  const long long ncell = (long long)ncx * ncy;
  if (B < 1 || nfx < 1 || nfy < 1 || ncx < 1 || ncy < 1 || ncons < 0 || ntmax < 1 ||
      ncell_out < 1 || ncell_out > ncell || B * ncell > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)6 * ncons * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (int)((B * ncell + kCellWarps - 1) / kCellWarps);
  const Rows r = rows_of(rows);
  eik_cells_kernel<<<blocks, 32 * kCellWarps, smem, st>>>(r, times, ctx, ncons, nfx, nfy, ncx, ncy,
                                                         B, cells);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const Tables o{(float*)tables[0], (float*)tables[1], (float*)tables[2], (float*)tables[3],
                 (float*)tables[4], (bool*)tables[5],  (int*)tables[6]};
  eik_tables_kernel<<<B, kTableThreads, 0, st>>>(r, cells, B, (int)ncell, ncell_out, ntmax,
                                                 budget, edt, o);
  return (int)cudaGetLastError();
}
