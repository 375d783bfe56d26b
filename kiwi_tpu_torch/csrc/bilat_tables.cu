// The bilateral source's centroid tables in one launch, for Hopper.
//
// Replaces no TPU kernel: kiwi_tpu discretizes the bilateral source with XLA
// (kiwi_tpu/sources/bilat.py:discretize), which fuses the elementwise chain
// into a few device loops.  The port's plain version
// (sources/bilat.py:discretize_reference) runs the same chain as ~280 small
// torch launches a call, which is what the card waits for on every sweep
// call and grid chunk.  This kernel writes all six tables of
// psm_to_tdsm_table_bilat (source_bilat.f90:318-459) at once:
//
//   north, east, depth, time f32[B, C], m f32[B, C, 6], active bool[B, C]
//
// with C = nx * ny * nt in the reference's (ix, iy, it) nesting order, from
// the parameter rows f32[B, 14].
//
// What bounds it on this card: nothing of the card.  The tables are 41 bytes
// an entry (43k entries a point sweep call, 98k a 512-row grid chunk), a few
// hundred float operations each; the launch is the cost.  So the design is
// the plainest: one thread per (row, centroid), each recomputing its row's
// two Euler matrices, the moment tensor, the trapezoid STF and its own PLF
// time cell.  The rows' trigonometry is repeated C times; it is a few
// hundred instructions a thread.
//
// The tables must equal the plain version's on the card bit for bit: a
// vertical fault's centroid depths fall on GF nodes, and one float32 ulp
// moves a centroid across a node (PERF.md §2).  So every operation is the
// plain chain's, in its order and rounding:
//   - products, sums and differences are __fmul_rn / __fadd_rn / __fsub_rn,
//     which nvcc never contracts into FMAs (each torch op is its own kernel,
//     so the chain contracts nothing either);
//   - torch divides a CUDA tensor by a host scalar as a product with the
//     scalar's float reciprocal (div_true_kernel_cuda): x / (2 nx),
//     length / nx, durfull / nt and m6 / (nx ny) are __fmul_rn(x, 1.0f / s),
//     x / 2.0 a product with 0.5f; tensor by tensor is __fdiv_rn, and
//     1.0 / t is torch's reciprocal (1.0f / t) times 1.0f;
//   - torch.maximum / torch.minimum pass a NaN through, then fmaxf / fminf;
//   - sinf / cosf are the precise library functions torch's sin and cos call.

#include <cuda_runtime.h>

namespace {

constexpr int kParams = 14;
constexpr int kThreads = 256;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / torch.minimum on float32 (MaxMinElementwiseKernel.cu)
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__global__ void __launch_bounds__(kThreads)
bilat_tables_kernel(const float* __restrict__ params, float* __restrict__ north,
                    float* __restrict__ east, float* __restrict__ depth,
                    float* __restrict__ time, float* __restrict__ m,
                    unsigned char* __restrict__ active, long long total, int nx, int ny,
                    int nt, float deg2rad, float inv_2nx, float inv_2ny, float inv_nx,
                    float inv_nt, float inv_nxny) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int C = nx * ny * nt;
  const long long b = idx / C;
  const int c = (int)(idx - b * C);
  const int it = c % nt;
  const int iy = (c / nt) % ny;
  const int ix = c / (nt * ny);

  const float* p = params + b * kParams;
  const float t0 = p[0], n0 = p[1], e0 = p[2], d0 = p[3];
  const float strike = p[5], dip = p[6], slip_rake = p[7], rup_rake = p[8];
  const float length_a = p[9], length_b = p[10], width = p[11], rupvel = p[12];
  const float risetime = p[13];
  const float length = fadd(length_a, length_b);

  // init_euler(dip, strike, gamma) (sources/base.py), shared by the
  // rupture rotation (gamma = -rupture-rake) and the slip's (-slip-rake)
  const float alpha = fmul(dip, deg2rad), beta = fmul(strike, deg2rad);
  const float ca = cosf(alpha), cb = cosf(beta), sa = sinf(alpha), sb = sinf(beta);
  const float casb = fmul(ca, sb), cacb = fmul(ca, cb);

  // rotmat_rup's first two columns: the fault-plane point (gx, gy, 0)
  const float g_rup = fmul(-rup_rake, deg2rad);
  const float cg = cosf(g_rup), sg = sinf(g_rup);
  const float r00 = fsub(fmul(cb, cg), fmul(casb, sg));
  const float r01 = fsub(fmul(-cb, sg), fmul(casb, cg));
  const float r10 = fadd(fmul(sb, cg), fmul(cacb, sg));
  const float r11 = fadd(fmul(-sb, sg), fmul(cacb, cg));
  const float r20 = fmul(sa, sg);
  const float r21 = fmul(sa, cg);

  // mt_rot_from_sdr: m[i][j] = -(S[i][2] S[j][0] + S[i][0] S[j][2])
  const float g_slip = -fmul(slip_rake, deg2rad);
  const float cs = cosf(g_slip), ss = sinf(g_slip);
  const float s00 = fsub(fmul(cb, cs), fmul(casb, ss));
  const float s10 = fadd(fmul(sb, cs), fmul(cacb, ss));
  const float s20 = fmul(sa, ss);
  const float s02 = fmul(sa, sb);
  const float s12 = fmul(-sa, cb);
  const float s22 = ca;
  const float m6[6] = {
      -fadd(fmul(s02, s00), fmul(s00, s02)), -fadd(fmul(s12, s10), fmul(s10, s12)),
      -fadd(fmul(s22, s20), fmul(s20, s22)), -fadd(fmul(s02, s10), fmul(s00, s12)),
      -fadd(fmul(s02, s20), fmul(s00, s22)), -fadd(fmul(s12, s20), fmul(s10, s22))};

  // the subfault's position in the fault plane and its rupture time
  const float gx = fmul(fmul(fadd(fsub(fmul(2.0f, (float)ix), (float)nx), 1.0f), inv_2nx), length);
  const float gy = fmul(fmul(fadd(fsub(fmul(2.0f, (float)iy), (float)ny), 1.0f), inv_2ny), width);
  const float tshift =
      fsub(fadd(fdiv(fabsf(fadd(fsub(fmul(length, 0.5f), length_b), gx)), rupvel), t0),
           fdiv(fmul(tmax(length_a, length_b), 0.5f), rupvel));
  const float gn = fadd(fadd(fmul(r00, gx), fmul(r01, gy)), n0);
  const float ge = fadd(fadd(fmul(r10, gx), fmul(r11, gy)), e0);
  const float gd = fadd(fadd(fmul(r20, gx), fmul(r21, gy)), d0);

  // trapezoid_stf_points
  const float dursf = fdiv(fmul(length, inv_nx), rupvel);
  const float lo = tmin(dursf, risetime), hi = tmax(dursf, risetime);
  const float safe_hi = hi > 0.0f ? hi : 1.0f;
  const float plateau = fmul(fdiv(1.0f, safe_hi), 1.0f);
  const float zero = fmul(hi, 0.0f);
  const float xs[4] = {fmul(-fadd(hi, lo), 0.5f), fmul(-fsub(hi, lo), 0.5f),
                       fmul(fsub(hi, lo), 0.5f), fmul(fadd(hi, lo), 0.5f)};
  const float ys[4] = {zero, plateau, plateau, zero};

  // plf4_cell_weights over this centroid's time cell [ta, tb]
  const float dt_cell = fmul(fadd(dursf, risetime), inv_nt);
  const float ta = fadd(xs[0], fmul(dt_cell, (float)it));
  const float tb = fadd(xs[0], fmul(dt_cell, (float)(it + 1)));
  float area = 0.0f, moment = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float x0 = xs[i], x1 = xs[i + 1], y0 = ys[i], y1 = ys[i + 1];
    const float l = tmax(ta, x0), h = tmin(tb, x1);
    const float dxseg = x1 != x0 ? fsub(x1, x0) : 1.0f;
    const float slope = x1 != x0 ? fdiv(fsub(y1, y0), dxseg) : 0.0f;
    const float ylo = fadd(y0, fmul(slope, fsub(l, x0)));
    const float yhi = fadd(y0, fmul(slope, fsub(h, x0)));
    const float a = h > l ? fmul(fmul(fadd(ylo, yhi), fsub(h, l)), 0.5f) : 0.0f;
    const float ysum = fadd(ylo, yhi);
    const float den = ysum != 0.0f ? fmul(ysum, 3.0f) : 1.0f;
    const float num = fadd(fmul(l, fadd(fmul(ylo, 2.0f), yhi)),
                           fmul(h, fadd(ylo, fmul(yhi, 2.0f))));
    const float cx = ysum != 0.0f ? fdiv(num, den) : fmul(fadd(l, h), 0.5f);
    area = fadd(area, a);
    moment = fadd(moment, fmul(a, cx));
  }
  const float toff = area != 0.0f ? fdiv(moment, area) : fmul(fadd(ta, tb), 0.5f);

  north[idx] = gn;
  east[idx] = ge;
  depth[idx] = gd;
  time[idx] = fadd(tshift, toff);
  float* mo = m + idx * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) mo[k] = fmul(fmul(m6[k], inv_nxny), area);
  active[idx] = 1;
}

}  // namespace

extern "C" int kiwi_bilat_tables(const float* params, float* north, float* east, float* depth,
                                 float* time, float* m, unsigned char* active, int B, int nx,
                                 int ny, int nt, float deg2rad, void* stream) {
  if (B < 1 || nx < 1 || ny < 1 || nt < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * nx * ny * nt;
  const long long blocks = (total + kThreads - 1) / kThreads;
  // the host scalars' float reciprocals, as torch forms them for x / scalar
  const float inv_2nx = 1.0f / (float)(2.0 * nx), inv_2ny = 1.0f / (float)(2.0 * ny);
  const float inv_nx = 1.0f / (float)nx, inv_nt = 1.0f / (float)nt;
  const float inv_nxny = 1.0f / (float)(nx * ny);
  bilat_tables_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, north, east, depth, time, m, active, total, nx, ny, nt, deg2rad, inv_2nx, inv_2ny,
      inv_nx, inv_nt, inv_nxny);
  return (int)cudaGetLastError();
}
