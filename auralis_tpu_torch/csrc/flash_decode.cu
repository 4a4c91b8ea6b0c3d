// K2: decode attention with in-place K/V append on the slot cache, sm_90a.
//
// Replaces the Pallas kernel flash_decode_append_attention
// (auralis_tpu/ops/experimental/attention.py:151, body _kernel :34), which
// appends through an aligned 8-row read-modify-write window and DMAs
// CHUNK-row tiles per slot on the TPU's sequential grid.
//
// Here one block runs per (slot, head): S x H blocks of 4 warps.
// - Append: the block writes only its own head's 64-lane slice of the new
//   K/V row at write_pos[s] of `layer`, so no two blocks touch the same
//   bytes and the append needs no cross-block ordering. The appended row is
//   then read from k_new/v_new, never back from the cache.
// - Attention: the block reads that slot's write_pos+1 live rows only. A
//   warp takes 32-row tiles (lane = key for QK^T, lane = 2 output dims for
//   PV), keeping its own f32 online-softmax state; the 4 warp states merge
//   through shared memory at the end.
// Bound: device-memory bandwidth. A step reads sum over slots of
// (write_pos+1) rows x 64 lanes x 2 (K and V) x 2 bytes per head, i.e.
// ~sum(live rows) x 4 KB per layer at H*D = 1024 in bf16, and writes 4 KB
// per slot: at S = 8 and ~600 live rows, ~20 MB per layer. With only
// S x 16 blocks in flight this first version does not reach that bound;
// splitting long rows across blocks is later work.

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// q . row over 64 lanes; q already scaled
__device__ __forceinline__ float dot64(const float* qv, const bf16* row) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint4 u = r4[i];
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(b2[j]);
      dot = fmaf(qv[i * 8 + 2 * j], f.x, dot);
      dot = fmaf(qv[i * 8 + 2 * j + 1], f.y, dot);
    }
  }
  return dot;
}

__device__ __forceinline__ float dot64(const float* qv, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float4 f = r4[i];
    dot = fmaf(qv[4 * i], f.x, dot);
    dot = fmaf(qv[4 * i + 1], f.y, dot);
    dot = fmaf(qv[4 * i + 2], f.z, dot);
    dot = fmaf(qv[4 * i + 3], f.w, dot);
  }
  return dot;
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// T: the dtype of q, the new rows, the caches and ctx (bf16 or f32)
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_append_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                           const T* __restrict__ v_new, T* k_cache, T* v_cache,
                           const int* __restrict__ write_pos, T* __restrict__ ctx,
                           int n_slots, int n_heads, int t_max, int layer, float scale) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][HD];

  const int s = blockIdx.x, h = blockIdx.y;
  const int width = n_heads * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = write_pos[s];
  // no row to append into is a caller bug: abort the launch (the next
  // synchronising call raises) rather than write out of bounds or return
  // a made-up ctx
  if (wp < 0 || wp >= t_max) __trap();
  T* ctx_row = ctx + (size_t)s * width + h * HD;
  const T* kn = k_new + (size_t)s * width + h * HD;
  const T* vn = v_new + (size_t)s * width + h * HD;
  const size_t slot_base = ((size_t)layer * n_slots + s) * (size_t)t_max * width + h * HD;
  if (tid < HD) {
    k_cache[slot_base + (size_t)wp * width + tid] = kn[tid];
    v_cache[slot_base + (size_t)wp * width + tid] = vn[tid];
  }

  float qv[HD];
  const T* qp = q + (size_t)s * width + h * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) qv[d] = to_f32(qp[d]) * scale;

  const int n_keys = wp + 1;
  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int t0 = warp * 32; t0 < n_keys; t0 += WARPS * 32) {
    const int t = t0 + lane;
    float sc = -INFINITY;
    if (t < n_keys) {
      const T* kr = (t == wp) ? kn : k_cache + slot_base + (size_t)t * width;
      sc = dot64(qv, kr);
    }
    const float m_new = fmaxf(m, warp_max(sc));  // finite: row t0 is live
    const float p = (t < n_keys) ? expf(sc - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    acc0 *= corr;
    acc1 *= corr;
    const int jmax = min(32, n_keys - t0);
    for (int j = 0; j < jmax; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
      const int tj = t0 + j;
      const T* vr = (tj == wp) ? vn : v_cache + slot_base + (size_t)tj * width;
      const float2 vv = load2(vr + 2 * lane);
      acc0 = fmaf(pj, vv.x, acc0);
      acc1 = fmaf(pj, vv.y, acc1);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_acc[warp][2 * lane] = acc0;
  sm_acc[warp][2 * lane + 1] = acc1;
  __syncthreads();
  if (tid < HD) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w] - mx);  // 0 for warps that saw no rows
      lt += sm_l[w] * f;
      at += sm_acc[w][tid] * f;
    }
    ctx_row[tid] = from_f32<T>(at / fmaxf(lt, 1e-9f));
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const void* write_pos, void* ctx, int n_slots, int n_heads, int t_max, int layer,
           float scale, cudaStream_t stream) {
  dim3 grid(n_slots, n_heads);
  flash_decode_append_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(k_cache), static_cast<T*>(v_cache), static_cast<const int*>(write_pos),
      static_cast<T*>(ctx), n_slots, n_heads, t_max, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_append(const void* q, const void* k_new, const void* v_new,
                                   void* k_cache, void* v_cache, const void* write_pos,
                                   void* ctx, int n_slots, int n_heads, int t_max, int layer,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k_new, v_new, k_cache, v_cache, write_pos, ctx, n_slots, n_heads,
                        t_max, layer, scale, st);
  return launch<float>(q, k_new, v_new, k_cache, v_cache, write_pos, ctx, n_slots, n_heads,
                       t_max, layer, scale, st);
}
