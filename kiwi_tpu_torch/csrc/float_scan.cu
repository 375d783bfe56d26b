// Fused shared-kinematics synthesis + floating-shift scan sums for Hopper.
//
// Replaces the TPU kernels kiwi_tpu/ops/float_scan.py:_fused_kernel and
// _fused_kernel_masked.  For every receiver-channel row rc, trial shift s and
// source model b:
//
//   syn[w, b]      = sum_t v[rc / k_share, t, w] * wgt[rc, t, b]
//   out[rc, s, b]  = sum_w u(ref[rc, s, w] - syn[w, b]) * mask[s, rc, w]
//
// with u = |d| (floating_l1norm) or d*d (floating_l2norm), and mask = 1
// unmasked, or lo[s, rc] <= basei + w <= hi[s, rc] (filtered plans).  The
// synthetic never leaves registers.
//
// What bounds it on this card: float32 FMA/ALU issue.  Per (model, rc) the
// work is W*(T FMAs + S*(sub, abs/square, add)), ~9 kflop at the point
// sweep's shapes (RC=30, S=21, T=30, W=72), against 4*T bytes of weights:
// ~70 flop per byte read, far above the ~20 flop/byte where float32 CUDA
// cores stop waiting on HBM.  No tensor cores: the values ARE the reported
// misfits and must hold 1e-5 relative parity, so every product is a plain
// IEEE float32 FMA (no TF32, no fast math).
//
// Design: one thread per model, 128 models per block, grid (B blocks, RC,
// S chunks).  The block stages its v rows and ref rows (and the span mask)
// in shared memory in window chunks of 64 samples; each thread keeps its T
// weights and S running sums in registers and walks the window four samples
// at a time, so every shared-memory read is a 16-byte broadcast that feeds
// 4 FMAs (T loop) or 4 sub/abs/add triples (S loop).  T and S are padded up
// to compile-time buckets (zero weights / zero ref rows) so the register
// arrays are statically indexed; S above 32 is split over the grid's z axis.
// The ragged B edge is masked in-kernel (no padding to 128).  Stores are
// coalesced over b.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // models per block, one per thread
constexpr int kWChunk = 64;    // window samples staged per pass
constexpr int kQ = kWChunk / 4;

template <int TB, int SB, bool MASKED, bool L2>
__global__ void __launch_bounds__(kThreads)
fused_scan_kernel(const float* __restrict__ ref, const float* __restrict__ v,
                  const float* __restrict__ wgt, const int* __restrict__ lo,
                  const int* __restrict__ hi, float* __restrict__ out, int RC,
                  int S, int T, int W, int B, int k_share, int basei) {
  __shared__ float4 v_s[TB][kQ];
  __shared__ float4 r_s[SB][kQ];
  __shared__ float4 m_s[MASKED ? SB : 1][kQ];

  const int b = blockIdx.x * kThreads + threadIdx.x;
  const int rc = blockIdx.y;
  const int s0 = blockIdx.z * SB;
  const int rv = rc / k_share;
  const bool live = b < B;

  float wt[TB];
#pragma unroll
  for (int t = 0; t < TB; ++t)
    wt[t] = (live && t < T) ? __ldg(&wgt[((size_t)rc * T + t) * B + b]) : 0.f;

  float acc[SB];
#pragma unroll
  for (int s = 0; s < SB; ++s) acc[s] = 0.f;

  float* vf = reinterpret_cast<float*>(v_s);
  float* rf = reinterpret_cast<float*>(r_s);
  float* mf = reinterpret_cast<float*>(m_s);

  for (int w0 = 0; w0 < W; w0 += kWChunk) {
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < TB * kWChunk; i += kThreads) {
      const int t = i / kWChunk, w = w0 + i % kWChunk;
      vf[i] = (t < T && w < W) ? v[((size_t)rv * T + t) * W + w] : 0.f;
    }
    for (int i = threadIdx.x; i < SB * kWChunk; i += kThreads) {
      const int s = s0 + i / kWChunk, w = w0 + i % kWChunk;
      const bool in = s < S && w < W;
      rf[i] = in ? ref[((size_t)rc * S + s) * W + w] : 0.f;
      if (MASKED) {
        const int j = basei + w;
        mf[i] = (in && lo[(size_t)s * RC + rc] <= j && j <= hi[(size_t)s * RC + rc])
                    ? 1.f : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int q = 0; q < kQ; ++q) {
      float4 syn = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < TB; ++t) {
        const float4 x = v_s[t][q];
        syn.x = fmaf(wt[t], x.x, syn.x);
        syn.y = fmaf(wt[t], x.y, syn.y);
        syn.z = fmaf(wt[t], x.z, syn.z);
        syn.w = fmaf(wt[t], x.w, syn.w);
      }
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        const float4 r = r_s[s][q];
        const float dx = r.x - syn.x, dy = r.y - syn.y;
        const float dz = r.z - syn.z, dw = r.w - syn.w;
        float ux = L2 ? dx * dx : fabsf(dx);
        float uy = L2 ? dy * dy : fabsf(dy);
        float uz = L2 ? dz * dz : fabsf(dz);
        float uw = L2 ? dw * dw : fabsf(dw);
        if (MASKED) {
          const float4 m = m_s[s][q];
          ux *= m.x;
          uy *= m.y;
          uz *= m.z;
          uw *= m.w;
        }
        acc[s] += (ux + uy) + (uz + uw);
      }
    }
  }

  if (live) {
#pragma unroll
    for (int s = 0; s < SB; ++s)
      if (s0 + s < S) out[((size_t)rc * S + s0 + s) * B + b] = acc[s];
  }
}

template <int TB, int SB>
void launch(bool masked, bool l2, dim3 grid, cudaStream_t stream,
            const float* ref, const float* v, const float* wgt, const int* lo,
            const int* hi, float* out, int RC, int S, int T, int W, int B,
            int k_share, int basei) {
#define KIWI_LAUNCH(M, L)                                                  \
  fused_scan_kernel<TB, SB, M, L><<<grid, kThreads, 0, stream>>>(          \
      ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei)
  if (masked) {
    if (l2) KIWI_LAUNCH(true, true); else KIWI_LAUNCH(true, false);
  } else {
    if (l2) KIWI_LAUNCH(false, true); else KIWI_LAUNCH(false, false);
  }
#undef KIWI_LAUNCH
}

template <int TB>
void launch_tb(int sb, bool masked, bool l2, dim3 grid, cudaStream_t stream,
               const float* ref, const float* v, const float* wgt,
               const int* lo, const int* hi, float* out, int RC, int S, int T,
               int W, int B, int k_share, int basei) {
  switch (sb) {
    case 8: launch<TB, 8>(masked, l2, grid, stream, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei); break;
    case 16: launch<TB, 16>(masked, l2, grid, stream, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei); break;
    case 24: launch<TB, 24>(masked, l2, grid, stream, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei); break;
    default: launch<TB, 32>(masked, l2, grid, stream, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei); break;
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
  const int sb = S <= 8 ? 8 : S <= 16 ? 16 : S <= 24 ? 24 : 32;
  const dim3 grid((B + kThreads - 1) / kThreads, RC, (S + sb - 1) / sb);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 16)
    launch_tb<16>(sb, masked, l2, grid, st, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei);
  else if (T <= 32)
    launch_tb<32>(sb, masked, l2, grid, st, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei);
  else
    launch_tb<64>(sb, masked, l2, grid, st, ref, v, wgt, lo, hi, out, RC, S, T, W, B, k_share, basei);
  return (int)cudaGetLastError();
}
