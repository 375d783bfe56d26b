// Fused shared-kinematics synthesis + floating-shift scan sums for Hopper.
//
// Replaces the TPU kernels kiwi_tpu/ops/float_scan.py:_fused_kernel and
// _fused_kernel_masked.  For every receiver-channel row rc, trial shift s and
// source model b:
//
//   syn[w, b]      = sum_t v[rc / k_share, t, w] * wgt[rc, t, b]
//   out[rc, s, b]  = sum_w u(ref[rc, s, w] - syn[w, b]) * [s, rc, w live]
//
// with u = |d| (floating_l1norm) or d*d (floating_l2norm); every sample is
// live unmasked, and lo[s, rc] <= basei + w <= hi[s, rc] on filtered plans.
// The synthetic never leaves registers.
//
// What bounds it on this card: float32 instruction issue.  At the point
// sweep's shapes (RC 30, S 21, T 30, W 72) a (model, rc) needs 30 * 72 FFMA
// for the synthesis and 2 * 21 * 72 FADD for the scan (|d| accumulates as a
// subtraction and an add with the |.| operand modifier): 5,184 lane
// instructions against 4 * T bytes of weights.  Every shared-memory read
// takes one more issue slot.  No tensor cores: the values ARE the reported
// misfits and must hold 1e-5 relative parity, so every product is a plain
// IEEE float32 FMA (no TF32, no fast math).
//
// Design: 128 threads per block, grid (B blocks, RC, S chunks of at most
// 32).  The block copies its T values rows and its ref rows over the window
// into shared memory once, with cp.async (no register round trip, so the
// copy does not stall the block on device-memory latency), quad-major:
// [quad][TB + SB] float4 with an odd row stride, so the copy has no bank
// conflict and every read in the loops is a 16-byte broadcast at an
// immediate offset.  The window is padded to a multiple of 4 samples only
// (W 72: 18 quads); windows above 32 KB of rows take several passes.  Each
// thread keeps its weights and its shifts' running sums in registers and
// walks the window a quad at a time: T steps (one read, 4 FFMA a model),
// then S steps (one read, 8 adds a model).  The register arrays have
// compile-time sizes: T in 16 / 32 / 64 (padded values rows are zero rows,
// 2 of 32 steps at T = 30) and shift slots 4k + 1 up to 29, then 32 (a
// symmetric shift range gives an odd S; S = 21 runs no padded slot).  Both
// loops are fully unrolled straight-line code, so the compiler issues the
// reads ahead of the arithmetic.
//
// Masked (filtered plans): the prologue turns lo/hi into a window range
// [a, e) per shift, and the block's window is the hull of their union.  Per
// quad the block keeps two bit masks over its shifts: live (the range meets
// the quad) and edge (it covers the quad only in part).  A quad no shift
// meets is skipped with its synthesis.  Each slot's row is read three slots
// ahead; a dead (shift, quad) costs that read, a bit test and a uniform
// branch, and only edge quads select per lane.  There is no mask in shared
// memory and no multiply by 0, so a NaN or Inf outside every span no longer
// reaches the output (the plain version propagates it).
//
// Issue: the synthesis runs 4 independent FFMA chains a model.  Unmasked
// with T <= 32 a thread takes two models (b and b + 128): each shared read
// then feeds 8 FFMA or 16 adds, at ~155 registers, 3 blocks (12 warps) an
// SM.  Masked, one model a thread at ~95 registers, 5 blocks an SM: two
// models need ~170 registers and 3 blocks, which measured no faster.  At
// the sweep's shapes the last of ~4.3 waves runs a third full.  The ragged
// B edge is masked in-kernel (no padding to a block).  Stores are coalesced
// over b.  PERF.md (PR 7) has the forms measured and their times.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;           // threads per block
constexpr int kStageBytes = 32 * 1024;  // shared memory for one pass's rows
constexpr int kMaxSlots = 32;           // shifts per block (more: grid z)

struct Args {
  const float* ref;  // [RC, S, W]
  const float* v;    // [RC / k_share, T, W]
  const float* wgt;  // [RC, T, B]
  const int* lo;     // [S, RC], masked only
  const int* hi;
  float* out;        // [RC, S, B]
  int RC, S, T, W, B, k_share, basei;
  int s_stride;      // shifts per block (the last block may have fewer)
  int wc;            // samples per pass, a multiple of 4
};

// A 4-byte asynchronous copy from device memory into shared memory
// (cp.async, no register round trip); 0 is written where !valid.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

template <int TB, int SB, int MB, bool MASKED, bool L2>
__global__ void __launch_bounds__(kThreads) fused_scan_kernel(const Args p) {
  // this pass's rows, quad-major: [nq][R] float4, the values rows in slots
  // 0..T-1 and the ref rows in slots TB..TB+sc-1 (padded slots hold zeros),
  // then (masked) [nq] live / edge masks
  extern __shared__ float4 rows[];
  __shared__ int2 span[SB];  // masked: window range [a, e) of each slot
  __shared__ int hull[2];

  int b[MB];  // the thread's models
  bool live[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    b[m] = (blockIdx.x * MB + m) * kThreads + threadIdx.x;
    live[m] = b[m] < p.B;
  }
  const int rc = blockIdx.y;
  const int s0 = blockIdx.z * p.s_stride;
  const int sc = min(p.s_stride, p.S - s0);

  int wa = 0, we = p.W;  // the block's window [wa, we)
  if (MASKED) {
    if (threadIdx.x == 0) hull[0] = p.W, hull[1] = 0;
    __syncthreads();
    if ((int)threadIdx.x < sc) {
      const size_t j = (size_t)(s0 + threadIdx.x) * p.RC + rc;
      const long long a = max((long long)p.lo[j] - p.basei, 0LL);
      const long long e = min((long long)p.hi[j] - p.basei + 1, (long long)p.W);
      int2 r = make_int2(p.W, 0);  // empty
      if (e > a) {
        r = make_int2((int)a, (int)e);
        atomicMin(&hull[0], r.x);
        atomicMax(&hull[1], r.y);
      }
      span[threadIdx.x] = r;
    }
    __syncthreads();
    wa = hull[0] & ~3;  // quads stay aligned to the window's sample 0
    we = hull[1];
  }

  float acc[MB][SB];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int k = 0; k < SB; ++k) acc[m][k] = 0.f;

  if (we > wa) {
    float wt[MB][TB];
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int k = 0; k < TB; ++k)
        wt[m][k] = (live[m] && k < p.T) ? __ldg(&p.wgt[((size_t)rc * p.T + k) * p.B + b[m]]) : 0.f;
    const float* vrow = p.v + (size_t)(rc / p.k_share) * p.T * p.W;
    const float* rrow = p.ref + ((size_t)rc * p.S + s0) * p.W;

    constexpr int R = TB + SB + (SB % 2 == 0);  // rows of a quad, odd: no bank conflict
    for (int c0 = wa; c0 < we; c0 += p.wc) {
      const int nq = (min(p.wc, we - c0) + 3) >> 2;
      const int n = nq * 4;
      float* rf = reinterpret_cast<float*>(rows);
      uint2* mk = reinterpret_cast<uint2*>(rows + nq * R);
      if (c0 != wa) __syncthreads();  // the previous pass is fully consumed
      // a warp copies a row at a time, its lanes over the samples
      for (int row = threadIdx.x / 32; row < TB + SB; row += kThreads / 32) {
        const float* src = row < p.T ? vrow + (size_t)row * p.W
                           : (row >= TB && row < TB + sc) ? rrow + (size_t)(row - TB) * p.W
                                                           : nullptr;
        for (int l = threadIdx.x % 32; l < n; l += 32) {
          const bool in = src && c0 + l < p.W;
          copy_async(&rf[((l >> 2) * R + row) * 4 + (l & 3)], in ? src + c0 + l : p.ref, in);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (MASKED) {
        for (int q = threadIdx.x; q < nq; q += kThreads) {
          const int w0 = c0 + 4 * q;
          unsigned any = 0u, part = 0u;
          for (int k = 0; k < sc; ++k) {
            const int2 r = span[k];
            if (r.x < w0 + 4 && w0 < r.y) {
              any |= 1u << k;
              if (r.x > w0 || r.y < w0 + 4) part |= 1u << k;
            }
          }
          mk[q] = make_uint2(any, part);
        }
      }
      __syncthreads();

#pragma unroll 1
      for (int q = 0; q < nq; ++q) {
        unsigned any = ~0u, part = 0u;
        if (MASKED) {
          const uint2 m = mk[q];
          any = m.x;
          part = m.y;
          if (any == 0u) continue;  // no shift is live here: no synthesis
        }
        const float4* vq = rows + q * R;  // values row of slot k: vq[k]
        const float4* rq = vq + TB;       // ref row of slot k: rq[k]
        float4 syn[MB];
#pragma unroll
        for (int m = 0; m < MB; ++m) syn[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < TB; ++k) {
          const float4 x = vq[k];
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            syn[m].x = fmaf(wt[m][k], x.x, syn[m].x);
            syn[m].y = fmaf(wt[m][k], x.y, syn[m].y);
            syn[m].z = fmaf(wt[m][k], x.z, syn[m].z);
            syn[m].w = fmaf(wt[m][k], x.w, syn[m].w);
          }
        }
        const int w0 = c0 + 4 * q;
        // masked: each slot's row is read 3 slots ahead, before the branches,
        // so a skipped slot costs its read, a bit test and a branch
        float4 ahead[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (k < SB) ahead[k] = rq[k];
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const float4 r = ahead[k % 3];
          if (k + 3 < SB) ahead[k % 3] = rq[k + 3];
          if (MASKED && !(any & (1u << k))) continue;
          float4 d[MB];
#pragma unroll
          for (int m = 0; m < MB; ++m)
            d[m] = make_float4(r.x - syn[m].x, r.y - syn[m].y, r.z - syn[m].z, r.w - syn[m].w);
          if (MASKED && __builtin_expect((part & (1u << k)) != 0u, 0)) {
            const int la = span[k].x - w0, le = span[k].y - w0;  // live lanes [la, le)
#pragma unroll
            for (int m = 0; m < MB; ++m) {
              d[m].x = (la <= 0 && 0 < le) ? d[m].x : 0.f;
              d[m].y = (la <= 1 && 1 < le) ? d[m].y : 0.f;
              d[m].z = (la <= 2 && 2 < le) ? d[m].z : 0.f;
              d[m].w = (la <= 3 && 3 < le) ? d[m].w : 0.f;
            }
          }
#pragma unroll
          for (int m = 0; m < MB; ++m) {
            const float4 e = d[m];
            if (L2)
              acc[m][k] = fmaf(e.x, e.x, fmaf(e.y, e.y, fmaf(e.z, e.z, fmaf(e.w, e.w, acc[m][k]))));
            else
              acc[m][k] += (fabsf(e.x) + fabsf(e.y)) + (fabsf(e.z) + fabsf(e.w));
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (!live[m]) continue;
    float* o = p.out + ((size_t)rc * p.S + s0) * p.B + b[m];  // slot k: shift s0 + k
#pragma unroll
    for (int k = 0; k < SB; ++k)
      if (k < sc) o[(size_t)k * p.B] = acc[m][k];
  }
}

// Models per thread.  Two halve the shared reads a model and still let 3
// blocks share an SM (~155 registers at TB 32, SB 21).  Masked plans keep
// one (two measured no faster there), and so does TB 64, whose two models
// would not fit 255 registers.
constexpr int models(int tb, bool masked) { return (!masked && tb <= 32) ? 2 : 1; }

template <int TB, int SB>
void launch(bool masked, bool l2, dim3 grid, size_t smem, cudaStream_t st, const Args& p) {
  constexpr int MU = models(TB, false), MM = models(TB, true);
  if (masked) {
    if (l2) fused_scan_kernel<TB, SB, MM, true, true><<<grid, kThreads, smem, st>>>(p);
    else fused_scan_kernel<TB, SB, MM, true, false><<<grid, kThreads, smem, st>>>(p);
  } else {
    if (l2) fused_scan_kernel<TB, SB, MU, false, true><<<grid, kThreads, smem, st>>>(p);
    else fused_scan_kernel<TB, SB, MU, false, false><<<grid, kThreads, smem, st>>>(p);
  }
}

template <int TB>
void launch_tb(int sb, bool masked, bool l2, dim3 grid, size_t smem, cudaStream_t st,
               const Args& p) {
  switch (sb) {
    case 1: launch<TB, 1>(masked, l2, grid, smem, st, p); break;
    case 5: launch<TB, 5>(masked, l2, grid, smem, st, p); break;
    case 9: launch<TB, 9>(masked, l2, grid, smem, st, p); break;
    case 13: launch<TB, 13>(masked, l2, grid, smem, st, p); break;
    case 17: launch<TB, 17>(masked, l2, grid, smem, st, p); break;
    case 21: launch<TB, 21>(masked, l2, grid, smem, st, p); break;
    case 25: launch<TB, 25>(masked, l2, grid, smem, st, p); break;
    case 29: launch<TB, 29>(masked, l2, grid, smem, st, p); break;
    default: launch<TB, 32>(masked, l2, grid, smem, st, p); break;
  }
}

}  // namespace

// C entry, bound with ctypes.  ref f32[RC,S,W], v f32[RC/k_share,T,W],
// wgt f32[RC,T,B], lo/hi i32[S,RC] (masked only, else NULL), out f32[RC,S,B];
// all contiguous on the current device.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for shapes it does not take).
extern "C" int kiwi_fused_scan_sums(const float* ref, const float* v,
                                    const float* wgt, const int* lo,
                                    const int* hi, float* out, int RC, int S,
                                    int T, int W, int B, int k_share,
                                    int basei, int masked, int l2,
                                    void* stream) {
  if (RC < 1 || S < 1 || T < 1 || T > 64 || W < 1 || B < 1 || k_share < 1 ||
      RC % k_share != 0 || (masked && (lo == nullptr || hi == nullptr)))
    return (int)cudaErrorInvalidValue;
  // shifts split evenly over the fewest blocks of at most 32
  const int nz = (S + kMaxSlots - 1) / kMaxSlots;
  const int s_stride = (S + nz - 1) / nz;
  // shift slots: 4k + 1 up to 29, then 32.  A symmetric shift range gives
  // an odd S (21 at +-1 s and dt 0.1 s), which such a bucket fits exactly.
  const int sb = std::min(kMaxSlots, (s_stride + 2) / 4 * 4 + 1);
  // samples per pass: the whole window (to a multiple of 4) if its rows fit
  const int tb = T <= 16 ? 16 : T <= 32 ? 32 : 64;
  const int rows = tb + sb + (sb % 2 == 0);
  const int per_sample = 4 * rows + (masked ? 2 : 0);
  const int wc = std::min((W + 3) / 4 * 4, std::max(4, kStageBytes / per_sample / 4 * 4));
  const size_t smem = (size_t)rows * wc * 4 + (masked ? (size_t)wc / 4 * 8 : 0);
  const int per_block = kThreads * models(tb, masked);
  const dim3 grid((B + per_block - 1) / per_block, RC, (S + s_stride - 1) / s_stride);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  const Args p{ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei, s_stride, wc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tb == 16)
    launch_tb<16>(sb, masked, l2, grid, smem, st, p);
  else if (tb == 32)
    launch_tb<32>(sb, masked, l2, grid, smem, st, p);
  else
    launch_tb<64>(sb, masked, l2, grid, smem, st, p);
  return (int)cudaGetLastError();
}
