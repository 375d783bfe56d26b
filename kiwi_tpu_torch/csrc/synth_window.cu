// Finite-source window synthesis for Hopper.
//
// Replaces the TPU kernels kiwi_tpu/ops/synth_window.py:_kernel (VMEM-resident
// window), _kernel_dma (window in HBM, row DMA) and _kernel_compact (compact
// weights extracted in-kernel).  The three exist only because of TPU memory
// placement; on the card they are one kernel.  For every source b, receiver
// r and centroid group p (G centroids sharing one GF node), with the window
// ext[N, NG, nt_ext] (NG = 8 or 10 GF components, nodes flattened x-major):
//
//   blend[g, t] = sum_k wsp[b,r,p,k] * ext[node + off_k, g, t]
//                 (off = 0, s1, s2, s3: the +zu, +xu, +xu+zu neighbours)
//   p1 = f1*blend[0] + f2*blend[1] + f3*blend[2] (+ f6*blend[8])
//   p2 = f4*blend[3] + f5*blend[4]
//   dd = f1*blend[5] + f2*blend[6] + f3*blend[7] (+ f6*blend[9])
//   a  = cl*p1 - sl*p2,   r = sl*p1 + cl*p2     (backazimuth rotation)
//   out[b,r,c,t] += fr0*x_c[t + kk + 1] + fr1*x_c[t + kk]   for x_c in (a, r, dd)
//
// per centroid g of the group, with its weight row (f1..f6, cl, sl, fr0,
// fr1) and integer shift kk (kiwi_tpu/ops/synth_window.py:_group_math and
// the shift buckets of _scatter_group/_bucket_combine, which existed only to
// avoid dynamic lane rolls on the TPU; here the kernel indexes t + kk).
//
// What bounds it on this card.  Read in full for every (b, r, p), the
// blend's four node rows come to 4 * NG * nt_ext * 4 bytes each: 2.77 GB
// per 256-model call at the finite benchmark's shapes (R 10, P 65, G 3,
// NG 10, nt_ext 104) and 14.1 GB per 384-model call at the eikonal
// benchmark's (R 10, P 169, G 1, nt_ext 136).  The windows (13.5 and 4.6
// MB) stay in the 50 MB L2, so these are L2 reads.  The arithmetic (~50
// flop per centroid and output sample) is far below the FP32 peak.
//
// What the design does about it.  A group whose G centroids all carry
// f1..f6 = 0 (centroids outside the rupture: 38% of the eikonal groups) is
// skipped, and so is every such centroid of a live group.  A live group
// blends only the samples [kmin, kmax + nt_out + 1) that its live
// centroids' shifts reach (79% of nt_ext at the finite shapes, 71% at the
// eikonal ones), which cuts the reads to 2.2 and 6.2 GB.  The blend loads
// four floats at a time, and each output sample's contraction runs once,
// not twice.  Measured on an H100 (PERF.md), the result moves its trimmed
// reads at 5-6.4 TB/s whether or not neighbouring sources share rows.
// Deduplicating a tile's node rows in shared memory (cp.async staging,
// block barriers per group) cut the L2 reads 3-7x and ran about twice as
// slow, also at this kernel's 4 sources and 80 registers: its staging
// leaves 8-12 warps an SM, not 24.  So L2 bandwidth, issue and latency per
// warp all stand near the limit.  A skipped term is an exact zero on
// finite window data; a NaN or Inf in the rows of a skipped group or
// centroid no longer propagates into the output.
//
// Two instances, chosen by the wrapper (ops/synth_window.launch_plan):
//
// * source tile (window_tile_kernel): one block per (tile of bt <= 4
//   consecutive sources, receiver), one warp per source, no block barrier.
//   Per group the warp finds liveness and sample range (lanes over
//   centroids), blends its four rows over that range into its own shared
//   buffer (float4 loads where nt_ext % 4 == 0, two components' loads in
//   flight), then runs the channel math with the output samples over its
//   lanes.  Each lane evaluates the channels at one shifted sample and
//   takes the next sample's from its neighbour (__shfl_down_sync; the last
//   lane from lane 0 of the slot above).  Accumulators stay in registers,
//   at most 80 a thread, so that 24 warps (six blocks of 4) share an SM.
//   Shared memory: bt * NG * nt_ext floats.  Takes nt_out < 32 * kTileSlots.
// * direct (window_direct_kernel): one block of 128 threads per (source,
//   receiver), for windows too long for a tile's registers (nt_out >= 256)
//   and one-source batches.  Groups are planned 128 at a time; a live
//   group's rows are blended over its range into shared memory with
//   coalesced loads, then each thread accumulates the channels of its
//   output samples.
//
// Both keep the blend's order, w0*e0 + w1*e1 + w2*e2 + w3*e3, and the
// channel and accumulation order of the plain version.  The node index and
// kk are clamped in-kernel as the pack clamps them, so a bad index can never
// read outside the window.  Plain IEEE float32 (no fast math, no flush to
// zero): the output feeds the 1e-5 misfit parity bar.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // direct instance: threads per block
constexpr int kTileMaxBt = 4;      // source tile: at most 4 warps per block
constexpr int kTileMinBlocks = 6;  // source tile: 6 * 4 warps an SM, so at most 80 registers
constexpr int kTileSlots = 8;      // source tile: shifted samples per lane, at most
constexpr int kNW = 10;  // weight row: f1..f6, cos_l, sin_l, 1 - frac, frac
constexpr unsigned kFull = 0xffffffffu;

template <int NG>
__device__ __forceinline__ void channels(const float* __restrict__ bl, int nt_ext,
                                         int t, const float* f, float& a,
                                         float& r, float& d) {
  float p1 = f[0] * bl[0 * nt_ext + t] + f[1] * bl[1 * nt_ext + t] +
             f[2] * bl[2 * nt_ext + t];
  const float p2 = f[3] * bl[3 * nt_ext + t] + f[4] * bl[4 * nt_ext + t];
  float dd = f[0] * bl[5 * nt_ext + t] + f[1] * bl[6 * nt_ext + t] +
             f[2] * bl[7 * nt_ext + t];
  if (NG == 10) {
    p1 += f[5] * bl[8 * nt_ext + t];
    dd += f[5] * bl[9 * nt_ext + t];
  }
  a = f[6] * p1 - f[7] * p2;
  r = f[7] * p1 + f[6] * p2;
  d = dd;
}

__device__ __forceinline__ bool moment_live(const float* __restrict__ w) {
  bool live = false;
#pragma unroll
  for (int i = 0; i < 6; ++i) live |= __ldg(&w[i]) != 0.f;
  return live;
}

__device__ __forceinline__ float blend1(float w0, float w1, float w2, float w3, float a,
                                        float b, float c, float d) {
  return w0 * a + w1 * b + w2 * c + w3 * d;
}

__device__ __forceinline__ float4 blend4(float w0, float w1, float w2, float w3, float4 a,
                                         float4 b, float4 c, float4 d) {
  return make_float4(blend1(w0, w1, w2, w3, a.x, b.x, c.x, d.x),
                     blend1(w0, w1, w2, w3, a.y, b.y, c.y, d.y),
                     blend1(w0, w1, w2, w3, a.z, b.z, c.z, d.z),
                     blend1(w0, w1, w2, w3, a.w, b.w, c.w, d.w));
}

// The least and largest shift of a group's live centroids (those with a
// nonzero f1..f6), over the centroids first, first + step, ... of G, folded
// into *kmin and *kmax; *kmax stays -1 when none of them is live.
__device__ __forceinline__ void plan_group(const float* __restrict__ wg,
                                           const int* __restrict__ kg, int G, int first,
                                           int step, int kclamp, int* kmin, int* kmax) {
  for (int g = first; g < G; g += step) {
    if (!moment_live(wg + g * kNW)) continue;
    const int k = min(max(__ldg(&kg[g]), 0), kclamp);
    *kmin = min(*kmin, k);
    *kmax = max(*kmax, k);
  }
}

// ---------------------------------------------------------------- direct

template <int NG, int SLOTS>
__global__ void __launch_bounds__(kThreads)
window_direct_kernel(const float* __restrict__ ext, const int* __restrict__ node_rows,
                     const int* __restrict__ kk, const float* __restrict__ wrows,
                     const float* __restrict__ wsp, float* __restrict__ out, int N,
                     int nt_ext, int nt_out, int R, int P, int G, int s1, int s2,
                     int s3) {
  extern __shared__ float blend[];  // [NG][nt_ext]
  __shared__ int plan_lo[kThreads], plan_hi[kThreads];
  const size_t br = blockIdx.x;  // b * R + r
  const size_t b = br / R;
  const size_t row = (size_t)NG * nt_ext;  // floats per node
  const int kclamp = nt_ext - nt_out - 1;
  const int nmax = N - 1 - s3;

  float acc[3][SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) acc[0][j] = acc[1][j] = acc[2][j] = 0.f;

  for (int p0 = 0; p0 < P; p0 += kThreads) {
    const int np = min(kThreads, P - p0);
    __syncthreads();  // the previous chunk's plan and blend are consumed
    if (threadIdx.x < np) {
      const int p = p0 + threadIdx.x;
      int kmin = kclamp, kmax = -1;
      plan_group(wrows + (br * P + p) * (size_t)G * kNW, kk + (b * P + p) * (size_t)G, G,
                 0, 1, kclamp, &kmin, &kmax);
      plan_lo[threadIdx.x] = kmin;
      plan_hi[threadIdx.x] = kmax < 0 ? -1 : kmax + nt_out + 1;
    }
    __syncthreads();
    for (int pp = 0; pp < np; ++pp) {
      const int lo = plan_lo[pp], hi = plan_hi[pp];
      if (hi < 0) continue;  // no live centroid: uniform across the block
      const size_t brp = br * P + p0 + pp;
      const int node = min(max(__ldg(&node_rows[brp]), 0), nmax);
      const float w0 = __ldg(&wsp[brp * 4 + 0]), w1 = __ldg(&wsp[brp * 4 + 1]);
      const float w2 = __ldg(&wsp[brp * 4 + 2]), w3 = __ldg(&wsp[brp * 4 + 3]);
      const float* e0 = ext + (size_t)node * row;
      const float* e1 = e0 + (size_t)s1 * row;
      const float* e2 = e0 + (size_t)s2 * row;
      const float* e3 = e0 + (size_t)s3 * row;
      __syncthreads();  // the previous group's blend is fully consumed
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        const int o = c * nt_ext;
#pragma unroll 4
        for (int t = lo + threadIdx.x; t < hi; t += kThreads)
          blend[o + t] = blend1(w0, w1, w2, w3, __ldg(e0 + o + t), __ldg(e1 + o + t),
                                __ldg(e2 + o + t), __ldg(e3 + o + t));
      }
      __syncthreads();

      const float* wg = wrows + brp * (size_t)G * kNW;
      const int* kg = kk + (b * P + p0 + pp) * (size_t)G;
      for (int g = 0; g < G; ++g) {
        float f[kNW];
#pragma unroll
        for (int i = 0; i < kNW; ++i) f[i] = __ldg(&wg[g * kNW + i]);
        if (f[0] == 0.f && f[1] == 0.f && f[2] == 0.f && f[3] == 0.f && f[4] == 0.f &&
            f[5] == 0.f)
          continue;  // a dead centroid adds exact zeros
        const int k = min(max(__ldg(&kg[g]), 0), kclamp);
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          const int t = threadIdx.x + j * kThreads;
          if (t < nt_out) {
            float a0, r0, d0, a1, r1, d1;
            channels<NG>(blend, nt_ext, t + k + 1, f, a0, r0, d0);
            channels<NG>(blend, nt_ext, t + k, f, a1, r1, d1);
            acc[0][j] += f[8] * a0 + f[9] * a1;
            acc[1][j] += f[8] * r0 + f[9] * r1;
            acc[2][j] += f[8] * d0 + f[9] * d1;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int t = threadIdx.x + j * kThreads;
    if (t < nt_out)
      for (int c = 0; c < 3; ++c) out[(br * 3 + c) * nt_out + t] = acc[c][j];
  }
}

// ----------------------------------------------------------- source tile

// Blends samples [lo, hi) of the four rows e0..e3 (NG components of nt_ext
// samples each) into buf[NG][nt_ext], one warp, W floats per load (W = 4
// needs nt_ext % 4 == 0 and 16-byte aligned rows; the range widens to whole
// float4s, which stay inside the row).
template <int NG, int W>
__device__ __forceinline__ void warp_blend(const float* __restrict__ e0,
                                           const float* __restrict__ e1,
                                           const float* __restrict__ e2,
                                           const float* __restrict__ e3, float w0,
                                           float w1, float w2, float w3, int nt_ext,
                                           int lo, int hi, int lane, float* buf) {
  if (W == 4) {
    const int nt4 = nt_ext / 4, lo4 = lo / 4, hi4 = (hi + 3) / 4;
    const float4* a = reinterpret_cast<const float4*>(e0);
    const float4* b = reinterpret_cast<const float4*>(e1);
    const float4* c = reinterpret_cast<const float4*>(e2);
    const float4* d = reinterpret_cast<const float4*>(e3);
    float4* o = reinterpret_cast<float4*>(buf);
#pragma unroll
    for (int q = 0; q < NG; q += 2) {  // two components' eight loads in flight
      for (int i = lo4 + lane; i < hi4; i += 32) {
        const int x = q * nt4 + i, y = x + nt4;
        const float4 a0 = __ldg(a + x), b0 = __ldg(b + x), c0 = __ldg(c + x),
                     d0 = __ldg(d + x);
        const float4 a1 = __ldg(a + y), b1 = __ldg(b + y), c1 = __ldg(c + y),
                     d1 = __ldg(d + y);
        o[x] = blend4(w0, w1, w2, w3, a0, b0, c0, d0);
        o[y] = blend4(w0, w1, w2, w3, a1, b1, c1, d1);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < NG; q += 2) {
      for (int i = lo + lane; i < hi; i += 32) {
        const int x = q * nt_ext + i, y = x + nt_ext;
        const float a0 = __ldg(e0 + x), b0 = __ldg(e1 + x), c0 = __ldg(e2 + x),
                    d0 = __ldg(e3 + x);
        const float a1 = __ldg(e0 + y), b1 = __ldg(e1 + y), c1 = __ldg(e2 + y),
                    d1 = __ldg(e3 + y);
        buf[x] = blend1(w0, w1, w2, w3, a0, b0, c0, d0);
        buf[y] = blend1(w0, w1, w2, w3, a1, b1, c1, d1);
      }
    }
  }
}

template <int NG, int SLOTS, int W>
__global__ void __launch_bounds__(32 * kTileMaxBt, kTileMinBlocks)
window_tile_kernel(const float* __restrict__ ext, const int* __restrict__ node_rows,
                   const int* __restrict__ kk, const float* __restrict__ wrows,
                   const float* __restrict__ wsp, float* __restrict__ out, int N,
                   int nt_ext, int nt_out, int B, int R, int P, int G, int s1, int s2,
                   int s3) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = reinterpret_cast<float*>(smem4) + (size_t)warp * NG * nt_ext;  // [NG][nt_ext]
  const int r = blockIdx.x % R;
  const int b = (blockIdx.x / R) * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the ragged last tile: no barrier follows
  const size_t br = (size_t)b * R + r;
  const size_t row = (size_t)NG * nt_ext;
  const int kclamp = nt_ext - nt_out - 1;
  const int nmax = N - 1 - s3;

  // lane holds output sample o = 32 j + lane of slot j
  float acc[3][SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) acc[0][j] = acc[1][j] = acc[2][j] = 0.f;

  for (int p = 0; p < P; ++p) {
    const size_t brp = br * P + p;
    const float* wg = wrows + brp * G * kNW;
    const int* kg = kk + ((size_t)b * P + p) * G;
    int kmin = kclamp, kmax = -1;
    plan_group(wg, kg, G, lane, 32, kclamp, &kmin, &kmax);
    kmin = __reduce_min_sync(kFull, kmin);
    kmax = __reduce_max_sync(kFull, kmax);
    if (kmax < 0) continue;  // no live centroid: uniform across the warp

    const int node = min(max(__ldg(&node_rows[brp]), 0), nmax);
    const float* e0 = ext + (size_t)node * row;
    __syncwarp();  // the previous group's channel math is done with buf
    warp_blend<NG, W>(e0, e0 + (size_t)s1 * row, e0 + (size_t)s2 * row,
                      e0 + (size_t)s3 * row, __ldg(&wsp[brp * 4 + 0]),
                      __ldg(&wsp[brp * 4 + 1]), __ldg(&wsp[brp * 4 + 2]),
                      __ldg(&wsp[brp * 4 + 3]), nt_ext, kmin, kmax + nt_out + 1, lane,
                      buf);
    __syncwarp();

    for (int g = 0; g < G; ++g) {
      float f[kNW];
#pragma unroll
      for (int i = 0; i < kNW; ++i) f[i] = __ldg(&wg[g * kNW + i]);
      if (f[0] == 0.f && f[1] == 0.f && f[2] == 0.f && f[3] == 0.f && f[4] == 0.f &&
          f[5] == 0.f)
        continue;  // a dead centroid adds exact zeros
      const int k = min(max(__ldg(&kg[g]), 0), kclamp);
      // x at shifted samples o + k, o = 0..nt_out, from the top slot down:
      // output o takes x(o + k + 1) from lane + 1, or for lane 31 from lane
      // 0 of the slot above (carried in ua, ur, ud)
      float ua = 0.f, ur = 0.f, ud = 0.f;
#pragma unroll
      for (int j = SLOTS - 1; j >= 0; --j) {
        const int o = 32 * j + lane;
        float a = 0.f, ra = 0.f, d = 0.f;
        if (o <= nt_out) channels<NG>(buf, nt_ext, o + k, f, a, ra, d);
        float na = __shfl_down_sync(kFull, a, 1), nr = __shfl_down_sync(kFull, ra, 1),
              nd = __shfl_down_sync(kFull, d, 1);
        if (lane == 31) na = ua, nr = ur, nd = ud;
        acc[0][j] += f[8] * na + f[9] * a;
        acc[1][j] += f[8] * nr + f[9] * ra;
        acc[2][j] += f[8] * nd + f[9] * d;
        ua = __shfl_sync(kFull, a, 0);
        ur = __shfl_sync(kFull, ra, 0);
        ud = __shfl_sync(kFull, d, 0);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int o = 32 * j + lane;
    if (o < nt_out)
      for (int c = 0; c < 3; ++c) out[(br * 3 + c) * nt_out + o] = acc[c][j];
  }
}

// ---------------------------------------------------------------- launch

struct Args {
  const float* ext;
  const int* node_rows;
  const int* kk;
  const float* wrows;
  const float* wsp;
  float* out;
  int N, nt_ext, nt_out, B, R, P, G, s1, s2, s3, bt;
};

// Dynamic shared memory above the default 48 KB needs the attribute.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int NG, int SLOTS>
int launch_direct(const Args& a, cudaStream_t st) {
  const size_t smem = (size_t)NG * a.nt_ext * sizeof(float);
  auto kernel = window_direct_kernel<NG, SLOTS>;
  if (int e = prepare(kernel, smem)) return e;
  kernel<<<a.B * a.R, kThreads, smem, st>>>(a.ext, a.node_rows, a.kk, a.wrows, a.wsp,
                                             a.out, a.N, a.nt_ext, a.nt_out, a.R, a.P,
                                             a.G, a.s1, a.s2, a.s3);
  return (int)cudaGetLastError();
}

template <int NG, int SLOTS, int W>
int launch_tile(const Args& a, cudaStream_t st) {
  const size_t smem = (size_t)a.bt * NG * a.nt_ext * sizeof(float);
  auto kernel = window_tile_kernel<NG, SLOTS, W>;
  if (int e = prepare(kernel, smem)) return e;
  const long long blocks = (long long)((a.B + a.bt - 1) / a.bt) * a.R;
  kernel<<<(unsigned)blocks, 32 * a.bt, smem, st>>>(a.ext, a.node_rows, a.kk, a.wrows,
                                                    a.wsp, a.out, a.N, a.nt_ext, a.nt_out,
                                                    a.B, a.R, a.P, a.G, a.s1, a.s2, a.s3);
  return (int)cudaGetLastError();
}

template <int NG, int W>
int launch_tile_w(const Args& a, cudaStream_t st) {
  const int need = (a.nt_out + 1 + 31) / 32;  // shifted samples 0..nt_out per lane
  if (need <= 1) return launch_tile<NG, 1, W>(a, st);
  if (need <= 2) return launch_tile<NG, 2, W>(a, st);
  if (need <= 3) return launch_tile<NG, 3, W>(a, st);
  if (need <= 4) return launch_tile<NG, 4, W>(a, st);
  if (need <= 6) return launch_tile<NG, 6, W>(a, st);
  if (need <= kTileSlots) return launch_tile<NG, kTileSlots, W>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <int NG>
int launch_ng(const Args& a, bool vec, cudaStream_t st) {
  if (a.bt >= 2)
    return vec ? launch_tile_w<NG, 4>(a, st) : launch_tile_w<NG, 1>(a, st);
  const int need = (a.nt_out + kThreads - 1) / kThreads;  // output samples per thread
  if (need <= 1) return launch_direct<NG, 1>(a, st);
  if (need <= 2) return launch_direct<NG, 2>(a, st);
  if (need <= 4) return launch_direct<NG, 4>(a, st);
  if (need <= 8) return launch_direct<NG, 8>(a, st);
  return launch_direct<NG, 16>(a, st);
}

}  // namespace

// C entry, bound with ctypes.  ext f32[N, ng, nt_ext], node_rows i32[B, R, P],
// kk i32[B, P, G], wrows f32[B, R, P, G, 10], wsp f32[B, R, P, 4],
// out f32[B, R, 3, nt_out]; all contiguous on the current device.  (s1, s2,
// s3) are the neighbour node strides (zu, xu*nzw, xu*nzw + zu).  bt = 1
// takes the direct instance, bt in 2..4 the source tile of bt sources
// (bt * ng * nt_ext floats of dynamic shared memory, nt_out < 256); the
// wrapper's launch_plan chooses.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).
extern "C" int kiwi_window_synth(const float* ext, const int* node_rows,
                                 const int* kk, const float* wrows,
                                 const float* wsp, float* out, int N, int ng,
                                 int nt_ext, int nt_out, int B, int R, int P,
                                 int G, int s1, int s2, int s3, int bt, void* stream) {
  if ((ng != 8 && ng != 10) || nt_out < 1 || nt_ext < nt_out + 1 ||
      nt_ext > 2048 || B < 1 || R < 1 || P < 1 || G < 1 || s1 < 0 || s2 < 0 ||
      s3 < 0 || N - 1 - s3 < 0 || bt < 1 || bt > kTileMaxBt)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * R > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Args a{ext, node_rows, kk, wrows, wsp, out, N, nt_ext, nt_out, B, R, P, G,
               s1, s2, s3, bt};
  const bool vec = nt_ext % 4 == 0 && (reinterpret_cast<uintptr_t>(ext) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ng == 8 ? launch_ng<8>(a, vec, st) : launch_ng<10>(a, vec, st);
}
