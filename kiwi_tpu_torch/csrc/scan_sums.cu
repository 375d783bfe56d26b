// Floating-shift scan sums over precomputed synthetics, for Hopper.
//
// Replaces the TPU kernels kiwi_tpu/ops/float_scan.py:_scan_kernel (reference
// stack resident in VMEM) and _scan_kernel_blocked (W-blocked when the stack
// exceeds the VMEM budget); on the card both are this one kernel, which
// stages the window in chunks whatever W is.  For every trial shift s,
// model b and receiver-channel row rc:
//
//   out[s, b, rc] = sum_w u(ref[s * RC + rc, w] - syn[rc, b, w])
//
// with u = |d| (floating_l1norm) or d*d (floating_l2norm).  The caller
// applies the tail correction, dt and the shift selection.
//
// What bounds it on this card: float32 ALU issue.  Per (s, b, rc) the work is
// 3 W flop against W * 4 bytes of synthetic that every shift re-reads; the
// block stages the synthetic tile once in shared memory and all S shifts
// read it there, so device memory sees each synthetic once per S chunk
// (~13 MB per 256-model call at the finite benchmark's RC = 30, W ~ 128-256).
//
// Design: one block per (32 models, rc, chunk of up to 64 shifts), 256
// threads.  The block stages ref rows s * RC + rc for its shifts and the
// syn[rc, b0:b0+32, :] tile in shared memory, 64 window samples at a time
// with coalesced loads.  Each thread owns up to 8 (s, b) pairs; a warp's 32
// threads share s and take consecutive b, so the ref read is a broadcast and
// the synthetic rows are padded to 65 floats to keep the b-strided reads
// free of bank conflicts.  B is ragged (masked in-kernel, no padding).
// Plain IEEE float32 without flush to zero: moment-1.0 sessions put
// samples near 1e-19.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBT = 32;   // models per block
constexpr int kWC = 64;   // window samples staged per pass
constexpr int kSB = 64;   // shifts per block (more go to the grid's z axis)
constexpr int kPairs = kSB * kBT / kThreads;

template <bool L2>
__global__ void __launch_bounds__(kThreads)
scan_sums_kernel(const float* __restrict__ ref, const float* __restrict__ syn,
                 float* __restrict__ out, int S, int RC, int B, int W) {
  __shared__ float ref_s[kSB][kWC];
  __shared__ float syn_s[kBT][kWC + 1];
  const int b0 = blockIdx.x * kBT;
  const int rc = blockIdx.y;
  const int s0 = blockIdx.z * kSB;
  const int sb = min(kSB, S - s0);
  const int bt = min(kBT, B - b0);

  float acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) acc[k] = 0.f;

  for (int w0 = 0; w0 < W; w0 += kWC) {
    const int wc = min(kWC, W - w0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = threadIdx.x; i < sb * kWC; i += kThreads) {
      const int s = i / kWC, w = i % kWC;
      ref_s[s][w] = w < wc ? ref[((size_t)(s0 + s) * RC + rc) * W + w0 + w] : 0.f;
    }
    for (int i = threadIdx.x; i < kBT * kWC; i += kThreads) {
      const int j = i / kWC, w = i % kWC;
      syn_s[j][w] = (j < bt && w < wc) ? syn[((size_t)rc * B + b0 + j) * W + w0 + w] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pair = threadIdx.x + k * kThreads;
      const int s = pair / kBT, j = pair % kBT;
      if (s < sb) {  // uniform across the warp
        float a = acc[k];
        for (int w = 0; w < wc; ++w) {
          const float d = ref_s[s][w] - syn_s[j][w];
          a += L2 ? d * d : fabsf(d);
        }
        acc[k] = a;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int pair = threadIdx.x + k * kThreads;
    const int s = pair / kBT, j = pair % kBT;
    if (s < sb && j < bt) out[((size_t)(s0 + s) * B + b0 + j) * RC + rc] = acc[k];
  }
}

}  // namespace

// C entry, bound with ctypes.  ref f32[S*RC, W], syn f32[RC, B, W],
// out f32[S, B, RC]; all contiguous on the current device.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for shapes
// it does not take).
extern "C" int kiwi_scan_sums(const float* ref, const float* syn, float* out,
                              int S, int RC, int B, int W, int l2, void* stream) {
  if (S < 1 || RC < 1 || B < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kBT - 1) / kBT, RC, (S + kSB - 1) / kSB);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l2)
    scan_sums_kernel<true><<<grid, kThreads, 0, st>>>(ref, syn, out, S, RC, B, W);
  else
    scan_sums_kernel<false><<<grid, kThreads, 0, st>>>(ref, syn, out, S, RC, B, W);
  return (int)cudaGetLastError();
}
