// Shared helpers for the port's hand-written sm_90a kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// int8 scales are max(max|x|, eps) x kInv127: jitted JAX folds its division
// by the constant 127 into this multiplication (ops/quant.py)
constexpr float kInv127 = 1.0f / 127.0f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

// round-to-nearest-even, as torch's .to(torch.bfloat16) and jnp .astype
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- tensor-core building blocks (sm_80+ instructions, used on sm_90a):
// ldmatrix, mma.sync m16n8k16 with bf16 operands and f32 accumulators, and
// 16-byte cp.async copies into shared memory.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, q = lane % 4):
//   A (16 x 16, row-major) regs 0..3: (g, 2q..2q+1), (g+8, 2q..), (g, 2q+8..),
//     (g+8, 2q+8..); ldmatrix_x4 with lane l addressing row (l & 15), column
//     (l >> 4) * 8 of the tile loads exactly that.
//   B (16 x 8, "col") regs 0..1: (k 2q..2q+1, n g), (k 2q+8.., n g); from a
//     tile stored n-major (k contiguous) it is a plain ldmatrix, from one
//     stored k-major (n contiguous) ldmatrix .trans.
//   C (16 x 8 f32) regs 0..3: (g, 2q), (g, 2q+1), (g+8, 2q), (g+8, 2q+1).

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a * b (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy; with valid false the 16 bytes are zeroed
// (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two floats rounded to bf16 (round-to-nearest-even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Allow `kernel` the device's largest opt-in dynamic shared memory. A kernel
// launched with sizes that vary from call to call calls this once (a
// function-local static), not cudaFuncSetAttribute with each call's size:
// the attribute belongs to the kernel, so two host threads that set it to
// their own sizes and then launch can leave one launch above the other's
// limit (cudaErrorLaunchOutOfResources).
template <typename Kernel>
inline cudaError_t allow_max_dynamic_smem(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return e;
}

// ---- split-K decode attention (K2 flash_decode.cu, K4 ragged_decode.cu).
// One block of kSplitThreads threads runs per (head, slot, split). A split
// is kSplitRows consecutive cache rows: one row per thread in the softmax
// phase. The grid is (H, S, T / kSplitRows) whatever the write positions; a
// block whose rows start past write_pos[s] returns at once. The split is the
// grid's slowest index, so the blocks of the first splits, which have work
// whenever a slot does, are dispatched before the (often empty) later ones.
constexpr int kSplitRows = 128;
constexpr int kSplitThreads = 128;
constexpr int kHeadDim = 64;
// one split's partial in the workspace: m, l, 2 floats of padding, acc[64]
constexpr int kPartialFloats = 4 + kHeadDim;

__device__ __forceinline__ float max4(const float* r) {
  return fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3]));
}

// max / sum of one value per thread over the 4 warps of a block, in a fixed
// order (xor shuffles in the warp, then warps 0..3); every thread gets it.
// `scratch` is 4 floats of shared memory that belong to this call site
// alone: with one barrier, a warp may still read it when another warp
// reaches the next reduction.
__device__ __forceinline__ float block4_max(float v, float* scratch) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return max4(scratch);
}

__device__ __forceinline__ float block4_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return ((scratch[0] + scratch[1]) + scratch[2]) + scratch[3];
}

// The end of one split's block. The sum over the 4 warps' rows of `acc`
// (shared memory, complete; summed in warp order) is the split's
// unnormalised context sum(p_t v_t), m its largest logit and l its sum(p_t),
// with p_t = exp(logit_t - m).
// - A slot whose live rows fit in one split (n_live == 1) writes
//   out = acc / max(l, 1e-9) at once.
// - Otherwise the block stores its partial in `partials` (this (slot, head)'s
//   n_splits records), fences, and takes an int32 ticket. The block that
//   draws the last ticket merges the n_live partials in split order (M =
//   max m_i; out = sum acc_i e^(m_i - M) / max(sum l_i e^(m_i - M), 1e-9))
//   and resets the ticket to 0 for the next launch. The merge reads in a
//   fixed order whichever block arrives last, and no float atomic is used,
//   so two launches on the same inputs give the same bits.
template <typename O>
__device__ __forceinline__ void split_finish(const float (&acc)[4][kHeadDim], float m, float l,
                                             int split, int n_live, float* partials,
                                             int* ticket, O* out) {
  __shared__ int last;
  const int tid = threadIdx.x;
  const float a = tid < kHeadDim
                      ? ((acc[0][tid] + acc[1][tid]) + acc[2][tid]) + acc[3][tid] : 0.f;
  if (n_live == 1) {
    if (tid < kHeadDim) out[tid] = from_f32<O>(a / fmaxf(l, 1e-9f));
    return;
  }
  float* rec = partials + (size_t)split * kPartialFloats;
  if (tid < kHeadDim) rec[4 + tid] = a;
  if (tid == 0) {
    rec[0] = m;
    rec[1] = l;
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < kHeadDim) {
    float mx = -INFINITY;
    for (int i = 0; i < n_live; ++i) mx = fmaxf(mx, __ldcg(partials + i * kPartialFloats));
    float lt = 0.f, at = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float* r = partials + i * kPartialFloats;
      const float f = expf(__ldcg(r) - mx);
      lt += __ldcg(r + 1) * f;
      at += __ldcg(r + 4 + tid) * f;
    }
    out[tid] = from_f32<O>(at / fmaxf(lt, 1e-9f));
  }
  if (tid == 0) *ticket = 0;
}
