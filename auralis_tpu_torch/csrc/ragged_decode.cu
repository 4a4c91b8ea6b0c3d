// K4: ragged int8 decode attention with in-place int8 append, sm_90a.
//
// Replaces the Pallas kernel ragged_decode_attention
// (auralis_tpu/ops/experimental/attention.py:436, body _ragged_kernel :245).
// That kernel quantises q and the new rows outside the kernel, builds a
// block-diagonal q matrix and one-hot lane expansions for the MXU, appends
// through aligned 32-row read-modify-write windows, transposes the scale
// rows to patch them, and walks groups of slots on the TPU's sequential
// grid. None of that is needed here.
//
// One block runs per (slot, head): S x H blocks of 4 warps. q and the new
// rows are bf16, the activation dtype of the int8 decode path.
// - Quantisation, fused into the launch: the new K/V rows are quantised per
//   slot over all H*D lanes, so every block reduces the slot's two full rows
//   (2 x 1024 values) to their max itself, then quantises only its own
//   head's 64 lanes; q is quantised per (slot, head). Scales are
//   max(max|x|, 1e-8) x f32(1/127), int8 values rint(x / scale) with an
//   IEEE division (__fdiv_rn): bit-equal to ops/quant.py quantize_rows.
// - Append: the block writes its own head's 64 lanes of the int8 rows at
//   write_pos[s]; only head 0 writes the slot's two scales. No block reads
//   the appended row or its scale back from the cache: each uses the values
//   it holds in shared memory and registers, so there is no cross-block
//   read-after-write.
// - Attention over the write_pos + 1 live keys only: a warp takes 32-row
//   tiles, lane = key for the scores (16 __dp4a over the head's 64 int8
//   lanes, exact int32), lane = 2 output dims for the context. The logit is
//   float(dot) x k_scale[t] x (q_scale x attn_scale); f32 online softmax;
//   the context accumulates p x v_scale[t] x float(v_int8) and is divided by
//   max(l, 1e-9) after the 4 warps' states merge through shared memory.
// Bound: device-memory bandwidth. A step reads, per layer, sum over slots
// of (write_pos + 1) rows x (1 KB of K + 1 KB of V + 8 B of scales): half
// of K2's bf16 read. As in K2, one block walks each (slot, head) row alone,
// so the longest slot bounds the launch.

#include "common.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
static_assert(THREADS == 2 * HD, "K lanes on threads 0-63, V lanes on 64-127");

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(rintf(__fdiv_rn(x, scale)));
}

// int8 dot product of a 64-lane key row with the packed int8 query
__device__ __forceinline__ int dot64_i8(const int8_t* row, const int* qw) {
  const int4* r4 = reinterpret_cast<const int4*>(row);
  int dot = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 u = r4[i];
    dot = __dp4a(u.x, qw[4 * i], dot);
    dot = __dp4a(u.y, qw[4 * i + 1], dot);
    dot = __dp4a(u.z, qw[4 * i + 2], dot);
    dot = __dp4a(u.w, qw[4 * i + 3], dot);
  }
  return dot;
}

__global__ void __launch_bounds__(THREADS)
ragged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                     const bf16* __restrict__ v_new, int8_t* k_cache, int8_t* v_cache,
                     float* k_scale, float* v_scale, const int* __restrict__ write_pos,
                     float* __restrict__ ctx, int n_slots, int n_heads, int t_max, int layer,
                     float attn_scale) {
  __shared__ float sm_kmax[WARPS], sm_vmax[WARPS], sm_qmax[WARPS];
  __shared__ __align__(16) int8_t sm_kq[HD];
  __shared__ __align__(16) int8_t sm_vq[HD];
  __shared__ __align__(16) int8_t sm_qq[HD];
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float sm_acc[WARPS][HD];

  const int s = blockIdx.x, h = blockIdx.y;
  const int width = n_heads * HD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = write_pos[s];
  // no row to append into is a caller bug: abort the launch (the next
  // synchronising call raises) rather than write out of bounds
  if (wp < 0 || wp >= t_max) __trap();
  const size_t row0 = ((size_t)layer * n_slots + s) * t_max;  // row index of (layer, s, 0)
  const size_t head = (size_t)h * HD;

  // ---- the slot's row scales (full H*D rows) and this head's q scale
  const bf16* kn = k_new + (size_t)s * width;
  const bf16* vn = v_new + (size_t)s * width;
  float mk = 0.f, mv = 0.f;
  for (int i = tid; i < width; i += THREADS) {
    mk = fmaxf(mk, fabsf(to_f32(kn[i])));
    mv = fmaxf(mv, fabsf(to_f32(vn[i])));
  }
  const float qv = tid < HD ? to_f32(q[(size_t)s * width + head + tid]) : 0.f;
  mk = warp_max(mk);
  mv = warp_max(mv);
  const float mq = warp_max(fabsf(qv));
  if (lane == 0) {
    sm_kmax[warp] = mk;
    sm_vmax[warp] = mv;
    sm_qmax[warp] = mq;
  }
  __syncthreads();
  mk = fmaxf(fmaxf(sm_kmax[0], sm_kmax[1]), fmaxf(sm_kmax[2], sm_kmax[3]));
  mv = fmaxf(fmaxf(sm_vmax[0], sm_vmax[1]), fmaxf(sm_vmax[2], sm_vmax[3]));
  const float k_s = __fmul_rn(fmaxf(mk, 1e-8f), kInv127);
  const float v_s = __fmul_rn(fmaxf(mv, 1e-8f), kInv127);
  const float q_s = __fmul_rn(fmaxf(fmaxf(sm_qmax[0], sm_qmax[1]), 1e-8f), kInv127);

  // ---- quantise and append this head's lanes; head 0 appends the scales
  if (tid < HD) {
    const int8_t kq = quantize(to_f32(kn[head + tid]), k_s);
    sm_kq[tid] = kq;
    k_cache[(row0 + wp) * width + head + tid] = kq;
    sm_qq[tid] = quantize(qv, q_s);
  } else {
    const int i = tid - HD;
    const int8_t vq = quantize(to_f32(vn[head + i]), v_s);
    sm_vq[i] = vq;
    v_cache[(row0 + wp) * width + head + i] = vq;
  }
  if (h == 0 && tid == 0) {
    k_scale[row0 + wp] = k_s;
    v_scale[row0 + wp] = v_s;
  }
  __syncthreads();

  int qw[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) qw[i] = reinterpret_cast<const int*>(sm_qq)[i];
  const float qs = __fmul_rn(q_s, attn_scale);

  // ---- online softmax over the live keys, 32-row tiles per warp
  const int8_t* kbase = k_cache + row0 * width + head;
  const int8_t* vbase = v_cache + row0 * width + head;
  const float* ksc = k_scale + row0;
  const float* vsc = v_scale + row0;
  const int n_keys = wp + 1;
  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  for (int t0 = warp * 32; t0 < n_keys; t0 += WARPS * 32) {
    const int t = t0 + lane;
    float sc = -INFINITY, vs = 0.f;
    if (t < n_keys) {
      const bool fresh = t == wp;
      const int dot = dot64_i8(fresh ? sm_kq : kbase + (size_t)t * width, qw);
      sc = __fmul_rn(__fmul_rn((float)dot, fresh ? k_s : ksc[t]), qs);
      vs = fresh ? v_s : vsc[t];
    }
    const float m_new = fmaxf(m, warp_max(sc));  // finite: row t0 is live
    const float p = (t < n_keys) ? expf(sc - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    acc0 *= corr;
    acc1 *= corr;
    const float pw = p * vs;
    const int jmax = min(32, n_keys - t0);
    for (int j = 0; j < jmax; ++j) {
      const float pj = __shfl_sync(0xffffffffu, pw, j);
      const int tj = t0 + j;
      const int8_t* vr = (tj == wp) ? sm_vq : vbase + (size_t)tj * width;
      const char2 vv = *reinterpret_cast<const char2*>(vr + 2 * lane);
      acc0 = fmaf(pj, (float)vv.x, acc0);
      acc1 = fmaf(pj, (float)vv.y, acc1);
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
    ctx[(size_t)s * width + head + tid] = at / fmaxf(lt, 1e-9f);
  }
}

}  // namespace

// q [S, H, 64] and k_new/v_new [S, H*64] bf16; caches [L, S, T, H*64] int8
// and scales [L, S, T] f32, updated in place; write_pos [S]; ctx [S, H*64] f32
extern "C" int ragged_decode(const void* q, const void* k_new, const void* v_new, void* k_cache,
                             void* v_cache, void* k_scale, void* v_scale, const void* write_pos,
                             void* ctx, int n_slots, int n_heads, int t_max, int layer,
                             float attn_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ragged_decode_kernel<<<dim3(n_slots, n_heads), THREADS, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<int8_t*>(k_cache),
      static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(write_pos), static_cast<float*>(ctx), n_slots, n_heads, t_max,
      layer, attn_scale);
  return (int)cudaGetLastError();
}
