// Floating-shift scan sums over precomputed synthetics, for Hopper.
//
// Replaces the TPU kernels kiwi_tpu/ops/float_scan.py:_scan_kernel (reference
// stack resident in VMEM) and _scan_kernel_blocked (W-blocked when the stack
// exceeds the VMEM budget).  For every trial shift s, model b and
// receiver-channel row rc:
//
//   out[s, b, rc] = sum_w u(ref[s * RC + rc, w] - syn[rc, b, w])
//
// with u = |d| (floating_l1norm) or d*d (floating_l2norm).  The caller
// applies the tail correction, dt and the shift selection.  The operands are
// the caller's own views: a row of ref or syn may start anywhere (the row
// strides are arguments, not 16-byte multiples in general); only W has unit
// stride, so the wrapper copies nothing.  The output is written [S, RC, B]
// (b fastest: a block's stores are whole sectors) and the wrapper returns
// its [S, B, RC] view.
//
// What bounds it on this card: at the finite path's shapes (S 21, RC 30,
// B 256, W 88) the work is 14.2 M (s, b, rc, w) terms of two FP32 lane
// instructions each (a subtraction, then an add with |.| as an operand
// modifier, or an FFMA): 0.85 us at perfect issue, against 1.07 us to move
// the 3.57 MB once.  Both are below what one launch costs, so latency sets
// the time: the launch (~1 us), one round trip to L2 for the operands, the
// sums at the ~15 warps an SM has, the block's reduction and its stores.
// The design keeps the work per sample at its two instructions, starts
// every load at once, lets each warp start summing as soon as its own
// operands are in, and writes whole sectors.
//
// Design: one block per (32 models, rc, tile of up to 32 shifts), 8 warps.
// Lane l of every warp takes model b0 + l; warp p takes a contiguous share
// of the window (3 quads of 4 samples at the finite shapes: 1,920 warps,
// ~15 an SM).  A lane loads its own synthetic quads straight into registers
// (each synthetic sample serves one lane only), and the warp copies the ref
// rows of its quads, for every shift of the tile, into its own region of
// shared memory with cp.async (quad-major, [quad][slot]), then waits for its
// own copies: no block barrier before the sums.  With 16-byte copies and
// loads where ref and syn rows all start at one offset from a 16-byte
// boundary (the finite caller's slices of power-of-two probes): a row is
// read from the boundary before its start and the `lead` samples before the
// window count as 0; else 4-byte copies and loads.  Samples past the window
// are 0 in both and add 0.  A lane keeps the running sums of every shift of
// its tile in registers (a compile-time bucket of slots, 4k + 1 up to 29,
// then 32: S = 21 runs no padded slot) and per quad reads each shift's ref
// quad once, 16 bytes at the same address for all 32 lanes (a broadcast),
// for 8 FP32 instructions.  A window longer than the warps' 24 quads takes
// several passes (the role _scan_kernel_blocked plays on the TPU; long
// teleseismic probes), the next pass's quads and rows in flight while this
// one is summed.  The 8 warps' sums meet in shared memory, are added in
// warp order and stored as rows of 32 models.  Plain IEEE float32 without
// flush to zero: moment-1.0 sessions put samples near 1e-19.  PERF.md (PR 8)
// has the forms measured and their times.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kParts = 8;              // warps of a block, each a share of the window
constexpr int kModels = 32;            // models per block, one a lane
constexpr int kThreads = 32 * kParts;  // threads per block
constexpr int kCQ = 3;                 // quads a warp takes per pass
constexpr int kPassQ = kParts * kCQ;   // quads per pass
constexpr int kMaxSlots = 32;          // shifts per block (more: grid z)
static_assert(kParts * kMaxSlots * kModels * 4 <= 48 * 1024, "the warps' sums fit 48 KB");

struct Args {
  const float* ref;  // row s * RC + rc at ref + (s * RC + rc) * ref_row
  const float* syn;  // row (rc, b) at syn + rc * syn_rc + b * syn_b
  float* out;        // [S, RC, B]
  long long ref_row, syn_rc, syn_b;
  int S, RC, B, W;
  int s_stride;  // shifts per block (the last block may have fewer)
  int vec;       // 16-byte copies: all strides multiples of 4, ref and syn at one alignment
  int lead;      // vec: the samples between a row start and the 16-byte boundary before it
};

// Asynchronous copies from device memory into shared memory (cp.async, no
// register round trip): 4 bytes, or 0 written where !valid; 16 bytes of
// which the first `bytes` are read and the rest written as 0.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy16(float4* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

// A warp's ref quads [q0, q0 + nqs) of the tile's slots into buf ([nqs][R]
// float4), copied by its lanes; staged sample u is window sample u - lead.
// Dead slots and samples outside the window read as 0.
template <int SB, int R>
__device__ __forceinline__ void stage_ref(float4* buf, const Args& p, int s0, int sc, int rc,
                                          int q0, int nqs, int wl, int lane) {
  const float* dummy = p.ref - p.lead;  // valid and (vec) 16-byte aligned
  for (int i = lane; i < SB * nqs; i += 32) {
    const int k = i / nqs, q = i - k * nqs;  // lanes take consecutive quads of a row
    const int u0 = 4 * (q0 + q);
    float4* dst = buf + q * R + k;
    const bool live = k < sc;
    const float* row =
        live ? p.ref + (long long)((s0 + k) * p.RC + rc) * p.ref_row - p.lead : dummy;
    if (p.vec && !(u0 == 0 && p.lead > 0)) {
      const int bytes = live ? 4 * max(0, min(4, wl - u0)) : 0;
      copy16(dst, bytes ? row + u0 : dummy, bytes);
    } else {  // 4-byte copies: unaligned rows, or the quad holding the lead samples
      float* d = reinterpret_cast<float*>(dst);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = live && u0 + e >= p.lead && u0 + e < wl;
        copy4(d + e, in ? row + u0 + e : p.ref, in);
      }
    }
  }
}

// The lane's synthetic quads q0 + i (i < nqt) into x; samples outside the
// window are 0.
__device__ __forceinline__ void load_syn(float4 (&x)[kCQ], const float* row, const Args& p,
                                         int q0, int nqt, int wl) {
#pragma unroll
  for (int i = 0; i < kCQ; ++i) {
    const int u0 = 4 * (q0 + i);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nqt && u0 < wl) {
      if (p.vec) {  // the 16-byte word holds a window sample: it lies in the row's storage
        v = __ldg(reinterpret_cast<const float4*>(row + u0));
        if (u0 < p.lead || u0 + 4 > wl) {
          v.x = (u0 >= p.lead && u0 < wl) ? v.x : 0.f;
          v.y = (u0 + 1 >= p.lead && u0 + 1 < wl) ? v.y : 0.f;
          v.z = (u0 + 2 >= p.lead && u0 + 2 < wl) ? v.z : 0.f;
          v.w = (u0 + 3 >= p.lead && u0 + 3 < wl) ? v.w : 0.f;
        }
      } else {
        v.x = __ldg(row + u0);
        if (u0 + 1 < wl) v.y = __ldg(row + u0 + 1);
        if (u0 + 2 < wl) v.z = __ldg(row + u0 + 2);
        if (u0 + 3 < wl) v.w = __ldg(row + u0 + 3);
      }
    }
    x[i] = v;
  }
}

// Quads each warp takes in pass c of a window of nq quads.
__device__ __forceinline__ int warp_quads(int c, int nq) {
  return (min(kPassQ, nq - c * kPassQ) + kParts - 1) / kParts;
}

template <int SB, bool L2>
__global__ void __launch_bounds__(kThreads) scan_sums_kernel(const Args p) {
  // slots of a quad, odd: a lane's copy of the next quad of a row lands in
  // other banks
  constexpr int R = SB + (SB % 2 == 0);
  // two passes' ref quads ([kPassQ][R] float4 each, warp `part` at quad
  // part * kCQ); at the end the warps' sums [kParts][SB][kModels] floats
  // over them
  extern __shared__ float4 stage[];
  const int b0 = blockIdx.x * kModels;
  const int rc = blockIdx.y;
  const int s0 = blockIdx.z * p.s_stride;
  const int sc = min(p.s_stride, p.S - s0);
  const int bt = min(kModels, p.B - b0);
  const int lane = threadIdx.x % 32, part = threadIdx.x / 32;
  const int wl = p.W + p.lead;  // staged samples
  const int nq = (wl + 3) / 4;
  const int npass = (nq + kPassQ - 1) / kPassQ;
  // the lane's synthetic row, staged sample u at row[u]; a dead model reads
  // the last one's (its sums are not stored)
  const float* row =
      p.syn + rc * p.syn_rc + (long long)min(b0 + lane, p.B - 1) * p.syn_b - p.lead;

  float acc[SB];
#pragma unroll
  for (int k = 0; k < SB; ++k) acc[k] = 0.f;

  // pass c: warp `part` takes quads c * kPassQ + part * nqt + [0, nqt)
  float4 x[kCQ], xn[kCQ];
  int nqt = warp_quads(0, nq);
  load_syn(x, row, p, part * nqt, nqt, wl);
  stage_ref<SB, R>(stage + part * kCQ * R, p, s0, sc, rc, part * nqt, nqt, wl, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int c = 0; c < npass; ++c) {
    int nqn = 0;
    if (c + 1 < npass) {  // the next pass's quads and rows in flight during this one
      nqn = warp_quads(c + 1, nq);
      const int q0 = (c + 1) * kPassQ + part * nqn;
      load_syn(xn, row, p, q0, nqn, wl);
      stage_ref<SB, R>(stage + ((c + 1) & 1) * kPassQ * R + part * kCQ * R, p, s0, sc, rc, q0,
                       nqn, wl, lane);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();  // the warp's rows of this pass are in

    // all lanes read the same ref quad: a broadcast
    const float4* rq = stage + (c & 1) * kPassQ * R + part * kCQ * R;
#pragma unroll
    for (int i = 0; i < kCQ; ++i) {
      if (i < nqt) {  // uniform across the block
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const float4 y = rq[i * R + k];
          const float dx = y.x - x[i].x, dy = y.y - x[i].y, dz = y.z - x[i].z,
                      dw = y.w - x[i].w;
          if (L2)
            acc[k] = fmaf(dx, dx, fmaf(dy, dy, fmaf(dz, dz, fmaf(dw, dw, acc[k]))));
          else
            acc[k] += (fabsf(dx) + fabsf(dy)) + (fabsf(dz) + fabsf(dw));
        }
      }
    }
    __syncwarp();  // the warp's region is free for pass c + 2
#pragma unroll
    for (int i = 0; i < kCQ; ++i) x[i] = xn[i];
    nqt = nqn;
  }

  // the warps' sums through shared memory over the stage (once every warp
  // is done with it), added in warp order, then rows of models to out[s][rc][:]
  __syncthreads();
  float* red = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int k = 0; k < SB; ++k) red[(part * SB + k) * kModels + lane] = acc[k];
  __syncthreads();
  for (int i = threadIdx.x; i < sc * kModels; i += kThreads) {
    const int k = i / kModels, m = i % kModels;
    float v = red[k * kModels + m];
#pragma unroll
    for (int q = 1; q < kParts; ++q) v += red[(q * SB + k) * kModels + m];
    if (m < bt) p.out[((size_t)(s0 + k) * p.RC + rc) * p.B + b0 + m] = v;
  }
}

template <int SB>
void launch(bool l2, dim3 grid, cudaStream_t st, const Args& p) {
  constexpr int R = SB + (SB % 2 == 0);
  const size_t smem =
      std::max((size_t)2 * kPassQ * R * 16, (size_t)kParts * SB * kModels * 4);
  if (l2)
    scan_sums_kernel<SB, true><<<grid, kThreads, smem, st>>>(p);
  else
    scan_sums_kernel<SB, false><<<grid, kThreads, smem, st>>>(p);
}

}  // namespace

// C entry, bound with ctypes.  ref: S * RC rows of W floats, row i at
// ref + i * ref_row; syn: RC x B rows of W floats, row (rc, b) at
// syn + rc * syn_rc + b * syn_b (strides in elements, >= 0; W has unit
// stride); out f32[S, RC, B] contiguous; all on the current device.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for shapes it does not take).
extern "C" int kiwi_scan_sums(const float* ref, const float* syn, float* out,
                              long long ref_row, long long syn_rc, long long syn_b,
                              int S, int RC, int B, int W, int l2, void* stream) {
  if (S < 1 || RC < 1 || B < 1 || W < 1 || ref_row < 0 || syn_rc < 0 || syn_b < 0)
    return (int)cudaErrorInvalidValue;
  // shifts split evenly over the fewest blocks of at most 32
  const int nz = (S + kMaxSlots - 1) / kMaxSlots;
  const int s_stride = (S + nz - 1) / nz;
  // shift slots: 4k + 1 up to 29, then 32.  A symmetric shift range gives
  // an odd S (21 at +-1 s and dt 0.1 s), which such a bucket fits exactly.
  const int sb = std::min(kMaxSlots, (s_stride + 2) / 4 * 4 + 1);
  const dim3 grid((B + kModels - 1) / kModels, RC, nz);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies and loads where ref and syn rows all lie at one offset
  // from a 16-byte boundary (the finite caller's slices of power-of-two probes)
  const uintptr_t lead_ref = (uintptr_t)ref / 4 % 4, lead_syn = (uintptr_t)syn / 4 % 4;
  const int vec = (uintptr_t)ref % 4 == 0 && (uintptr_t)syn % 4 == 0 && lead_ref == lead_syn &&
                  ref_row % 4 == 0 && syn_rc % 4 == 0 && syn_b % 4 == 0;
  const int lead = vec ? (int)lead_ref : 0;
  const Args p{ref, syn, out, ref_row, syn_rc, syn_b, S, RC, B, W, s_stride, vec, lead};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sb) {
    case 1: launch<1>(l2, grid, st, p); break;
    case 5: launch<5>(l2, grid, st, p); break;
    case 9: launch<9>(l2, grid, st, p); break;
    case 13: launch<13>(l2, grid, st, p); break;
    case 17: launch<17>(l2, grid, st, p); break;
    case 21: launch<21>(l2, grid, st, p); break;
    case 25: launch<25>(l2, grid, st, p); break;
    case 29: launch<29>(l2, grid, st, p); break;
    default: launch<32>(l2, grid, st, p); break;
  }
  return (int)cudaGetLastError();
}
