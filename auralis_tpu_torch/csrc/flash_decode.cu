// K2: decode attention with in-place K/V append on the slot cache, sm_90a.
//
// Replaces the Pallas kernel flash_decode_append_attention
// (auralis_tpu/ops/experimental/attention.py:151, body _kernel :34), which
// appends through an aligned 8-row read-modify-write window and DMAs
// CHUNK-row tiles per slot on the TPU's sequential grid.
//
// Bound: device-memory bandwidth. A step reads, per layer, sum over slots of
// (write_pos + 1) rows x 64 lanes x 2 (K and V) x sizeof(T) per head: at
// H*D = 1024 in bf16, ~4 KB per live row, 15 MB at the 3,683 live rows of
// chip_smoke's ragged mix (4.5 us at 3.35 TB/s). A real decode step reads a
// different layer's slab each call, so the rows come from HBM, not L2.
//
// Design (split-K flash-decoding; helpers in common.cuh):
// - One block of 4 warps per (head, slot, split): kSplitRows = 128 rows of
//   one head. The grid (H, S, T / 128) depends only on the cache's T, so
//   write_pos stays on the device and the launch can be captured in a CUDA
//   graph; a block whose rows start past write_pos[s] returns at once. 128
//   rows give one row per thread in the softmax phase, and at the ragged mix
//   ~4 busy blocks per SM, all resident in one wave (32 KB of staging each in
//   bf16), so no block walks more than 128 rows and the longest slot no
//   longer sets the launch time. Shorter splits would add partials and merge
//   work without adding bytes in flight.
// - Slot bound: the grid's S is the step's slot count (q's rows), which may
//   be below the cache's (a step over the live low slots only); the cache's
//   slot count is only its stride, and slots >= S are not touched.
// - Staging: the split's K rows, then its V rows, go to shared memory as
//   16-byte cp.async copies in two groups, so V is in flight while QK runs.
//   Neighbouring threads copy neighbouring 16 bytes of a row's head slice.
//   Row write_pos is staged from k_new/v_new, never read back from the cache.
// - Inputs in place: q, k_new and v_new are read at one row stride of their
//   own (in_stride), so the three column blocks of the step's fused QKV
//   product are read where the product left them, and no copy runs before
//   the launch. Only the caches and ctx are addressed by width = H * 64.
// - QK: CPR lanes (one 16-byte chunk each) per row, the row's dot reduced
//   over them with xor shuffles. Softmax: thread t owns row t; the split's
//   max and sum are block reductions in a fixed order (f32). PV: warp w takes
//   rows w, w + 4, ..., reading p from shared memory, lane = 2 head dims.
// - Append: the block of the split that holds row write_pos[s] writes its
//   own head's 64 lanes of the new K/V row; no other block touches or reads
//   those bytes.
// - Combine: a slot that fits one split writes ctx at once; otherwise each
//   split stores (m, l, acc[64]) and the last to arrive merges them in split
//   order (split_finish), so ctx is the same bits from launch to launch.

#include "common.cuh"

namespace {

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// q . one 16-byte chunk of a staged row (8 bf16 or 4 f32 lanes); q scaled
__device__ __forceinline__ float dot_chunk(const float* qv, const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(b2[j]);
    dot = fmaf(qv[2 * j], f.x, dot);
    dot = fmaf(qv[2 * j + 1], f.y, dot);
  }
  return dot;
}

__device__ __forceinline__ float dot_chunk(const float* qv, const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  return fmaf(qv[3], f.w, fmaf(qv[2], f.z, fmaf(qv[1], f.y, qv[0] * f.x)));
}

// T: the dtype of q, the new rows, the caches and ctx (bf16 or f32)
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                          const T* __restrict__ v_new, T* k_cache, T* v_cache,
                          const int* __restrict__ write_pos, T* __restrict__ ctx,
                          float* partials, int* tickets, int cache_slots, int n_heads,
                          int in_stride, int t_max, int layer, float scale) {
  constexpr int EPC = 16 / sizeof(T);   // lanes per 16-byte chunk
  constexpr int CPR = kHeadDim / EPC;   // chunks per row's head slice
  constexpr int RPP = kSplitThreads / CPR;  // rows per QK pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm_k = reinterpret_cast<T*>(smem_raw);  // [kSplitRows][kHeadDim]
  T* sm_v = sm_k + kSplitRows * kHeadDim;
  __shared__ float sm_s[kSplitRows];  // scores, then probabilities
  __shared__ float sm_acc[4][kHeadDim];
  __shared__ float sm_red[2][4];  // the softmax's max and sum scratch

  const int h = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
  const int width = n_heads * kHeadDim;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = write_pos[s];
  // no row to append into is a caller bug: abort the launch (the next
  // synchronising call raises) rather than write out of bounds or return
  // a made-up ctx
  if (wp < 0 || wp >= t_max) __trap();
  const int base = split * kSplitRows;
  if (base > wp) return;  // no live row in this split
  const int n_rows = min(kSplitRows, wp + 1 - base);
  const int n_live = wp / kSplitRows + 1;
  const size_t head = (size_t)h * kHeadDim;
  const T* kn = k_new + (size_t)s * in_stride + head;
  const T* vn = v_new + (size_t)s * in_stride + head;
  T* kc = k_cache + ((size_t)layer * cache_slots + s) * (size_t)t_max * width + head;
  T* vc = v_cache + ((size_t)layer * cache_slots + s) * (size_t)t_max * width + head;

  // ---- stage K, then V (two cp.async groups); row wp from the new rows
  for (int i = tid; i < n_rows * CPR; i += kSplitThreads) {
    const int r = i / CPR, c = i % CPR, t = base + r;
    cp_async16(sm_k + r * kHeadDim + c * EPC, (t == wp ? kn : kc + (size_t)t * width) + c * EPC,
               true);
  }
  cp_async_commit();
  for (int i = tid; i < n_rows * CPR; i += kSplitThreads) {
    const int r = i / CPR, c = i % CPR, t = base + r;
    cp_async16(sm_v + r * kHeadDim + c * EPC, (t == wp ? vn : vc + (size_t)t * width) + c * EPC,
               true);
  }
  cp_async_commit();

  // ---- append: only this split's block holds row wp of head h
  if (split == wp / kSplitRows && tid < kHeadDim) {
    kc[(size_t)wp * width + tid] = kn[tid];
    vc[(size_t)wp * width + tid] = vn[tid];
  }

  const int sub = tid % CPR, rq = tid / CPR;
  float qv[EPC];
  const T* qp = q + (size_t)s * in_stride + head + sub * EPC;
#pragma unroll
  for (int e = 0; e < EPC; ++e) qv[e] = to_f32(qp[e]) * scale;

  // ---- QK over the staged K rows
  cp_async_wait<1>();
  __syncthreads();
  for (int r0 = 0; r0 < n_rows; r0 += RPP) {  // n_rows is uniform: shuffles stay converged
    const int r = r0 + rq;
    float dot = r < n_rows ? dot_chunk(qv, sm_k + r * kHeadDim + sub * EPC) : 0.f;
#pragma unroll
    for (int o = CPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (sub == 0 && r < n_rows) sm_s[r] = dot;
  }
  __syncthreads();

  // ---- softmax over the split: thread t owns row t
  const bool live = tid < n_rows;
  const float sc = live ? sm_s[tid] : -INFINITY;
  const float m = block4_max(sc, sm_red[0]);  // finite: row 0 is live
  const float p = live ? expf(sc - m) : 0.f;
  const float l = block4_sum(p, sm_red[1]);
  sm_s[tid] = p;

  // ---- PV over the staged V rows: warp w takes rows w, w + 4, ...
  cp_async_wait<0>();
  __syncthreads();
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int r = warp; r < n_rows; r += 4) {
    const float pr = sm_s[r];
    const float2 v = load2(sm_v + r * kHeadDim + 2 * lane);
    a0 = fmaf(pr, v.x, a0);
    a1 = fmaf(pr, v.y, a1);
  }
  sm_acc[warp][2 * lane] = a0;
  sm_acc[warp][2 * lane + 1] = a1;
  __syncthreads();

  const size_t unit = (size_t)s * n_heads + h;
  split_finish<T>(sm_acc, m, l, split, n_live, partials + unit * gridDim.z * kPartialFloats,
                  tickets + unit, ctx + (size_t)s * width + head);
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const void* write_pos, void* ctx, void* partials, void* tickets, int n_slots,
           int cache_slots, int n_heads, int in_stride, int t_max, int layer, float scale,
           cudaStream_t stream) {
  // k_new and v_new are staged 16 bytes at a time: a row that does not start
  // on 16 bytes would fault inside the kernel, so the launch is refused
  if ((reinterpret_cast<uintptr_t>(k_new) | reinterpret_cast<uintptr_t>(v_new)) % 16 ||
      (size_t)in_stride * sizeof(T) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int smem = 2 * kSplitRows * kHeadDim * (int)sizeof(T);  // 32 KB bf16, 64 KB f32
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_heads, n_slots, t_max / kSplitRows);
  flash_decode_split_kernel<T><<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<const int*>(write_pos),
      static_cast<T*>(ctx), static_cast<float*>(partials), static_cast<int*>(tickets),
      cache_slots, n_heads, in_stride, t_max, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [S, H, 64] and k_new/v_new [S, H*64], each at row stride in_stride
// (elements; q's heads 64 apart, every row's lanes unit-stride, so the
// column blocks of one [S, 3*H*64] QKV product qualify at 3*H*64; contiguous
// rows at H*64); k_new, v_new and the stride in bytes on 16 bytes, or the
// launch is refused (cudaErrorMisalignedAddress). Caches [L, S_cache, T,
// H*64] with S <= S_cache (updated in place; the step covers cache slots
// 0..S-1 and leaves the others untouched), write_pos [S], ctx [S, H, 64]
// (contiguous), all of one dtype (is_bf16: bf16, else f32); partials [S, H,
// T / split, kPartialFloats] f32 and tickets [S, H] int32 (zero) are the
// workspace; split must be kSplitRows
extern "C" int flash_decode_append(const void* q, const void* k_new, const void* v_new,
                                   void* k_cache, void* v_cache, const void* write_pos,
                                   void* ctx, void* partials, void* tickets, int n_slots,
                                   int cache_slots, int n_heads, int in_stride, int t_max,
                                   int layer, int split, float scale, int is_bf16, void* stream) {
  if (split != kSplitRows || t_max % kSplitRows || n_slots > cache_slots)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k_new, v_new, k_cache, v_cache, write_pos, ctx, partials, tickets,
                        n_slots, cache_slots, n_heads, in_stride, t_max, layer, scale, st);
  return launch<float>(q, k_new, v_new, k_cache, v_cache, write_pos, ctx, partials, tickets,
                       n_slots, cache_slots, n_heads, in_stride, t_max, layer, scale, st);
}
