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
// Bound: device-memory bandwidth. A step reads, per layer, sum over slots of
// (write_pos + 1) rows x (1 KB of K + 1 KB of V + 8 B of scales): half of
// K2's bf16 read, 7.6 MB at chip_smoke's ragged mix (2.3 us at 3.35 TB/s).
// A real decode step reads a different layer's slab each call, from HBM.
//
// Design: K2's split-K layout (flash_decode.cu, helpers in common.cuh). One
// block of 4 warps per (head, slot, split of 128 rows); the grid (H, S,
// T / 128) depends only on the cache's T, and a block whose rows start past
// write_pos[s] returns at once. As in K2, the grid's S is the step's slot
// count, which may be below the cache's (its stride; slots >= S are not
// touched). q and the new rows are bf16, the activation dtype of the int8
// decode path.
// - Quantisation, fused into the launch: q per (slot, head) in every busy
//   block. The new K/V rows are quantised per slot over all H*D lanes, so
//   the blocks of the split that holds row write_pos[s] (one per head)
//   alone reduce the slot's two full rows (2 x 1024 values) to their max,
//   then quantise their own head's 64 lanes. Scales are
//   max(max|x|, 1e-8) x f32(1/127), int8 values rint(x / scale) with an IEEE
//   division (__fdiv_rn): bit-equal to ops/quant.py quantize_rows.
// - Given row scales (k_row_scale / v_row_scale, f32 [S], both or neither):
//   a model shard holds H/tp heads of each row, whose scale is over all of
//   the row's lanes, so the caller passes the scales (as the Pallas kernel
//   takes its k/v scales as scalar-prefetch inputs) and those blocks skip
//   the reduction of the new rows. Everything else is the same, so a
//   shard's int8 lanes, scales and ctx are the unsharded launch's, bit for
//   bit, for its heads.
// - Append: such a block writes its head's 64 lanes of both int8 rows at
//   write_pos[s]; head 0's also writes the slot's two scales. The block puts
//   the quantised row into its own staged tile and uses the scales it holds:
//   no block reads the appended row or its scales back from the cache, so
//   there is no cross-block read-after-write.
// - Staging: the split's int8 K rows, then V rows (64 B per head slice),
//   go to shared memory as 16-byte cp.async copies in two groups; each
//   thread loads its row's two scales.
// - QK: 4 lanes per row, 4 __dp4a each over 16 int8 lanes, summed with xor
//   shuffles: exact int32 scores. The logit is
//   float(dot) x k_scale[t] x (q_scale x attn_scale). f32 softmax over the
//   split (thread t owns row t); PV: warp w takes rows w, w + 4, ..., lane =
//   2 head dims, sum p x v_scale[t] x float(v_int8).
// - Combine: split_finish (common.cuh); ctx = acc / max(l, 1e-9), merged in
//   split order, so ctx is the same bits from launch to launch.

#include "common.cuh"

namespace {

__device__ __forceinline__ int8_t quantize(float x, float scale) {
  return static_cast<int8_t>(rintf(__fdiv_rn(x, scale)));
}

__global__ void __launch_bounds__(kSplitThreads)
ragged_decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                           const bf16* __restrict__ v_new, int8_t* k_cache, int8_t* v_cache,
                           float* k_scale, float* v_scale, const int* __restrict__ write_pos,
                           float* __restrict__ ctx, float* partials, int* tickets,
                           const float* __restrict__ k_row_scale,
                           const float* __restrict__ v_row_scale, int cache_slots,
                           int n_heads, int t_max, int layer, float attn_scale) {
  constexpr int CPR = kHeadDim / 16;         // 16-byte chunks per row's head slice
  constexpr int RPP = kSplitThreads / CPR;   // rows per QK pass
  __shared__ __align__(16) int8_t sm_k[kSplitRows * kHeadDim];
  __shared__ __align__(16) int8_t sm_v[kSplitRows * kHeadDim];
  __shared__ __align__(16) int8_t sm_qq[kHeadDim];
  __shared__ int sm_dot[kSplitRows];
  __shared__ float sm_p[kSplitRows];
  __shared__ float sm_acc[4][kHeadDim];
  __shared__ float sm_max[3][4];  // per-warp maxima of |q|, |k_new|, |v_new|
  __shared__ float sm_red[2][4];  // the softmax's max and sum scratch

  const int h = blockIdx.x, s = blockIdx.y, split = blockIdx.z;
  const int width = n_heads * kHeadDim;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = write_pos[s];
  // no row to append into is a caller bug: abort the launch (the next
  // synchronising call raises) rather than write out of bounds
  if (wp < 0 || wp >= t_max) __trap();
  const int base = split * kSplitRows;
  if (base > wp) return;  // no live row in this split
  const int n_rows = min(kSplitRows, wp + 1 - base);
  const int n_live = wp / kSplitRows + 1;
  const bool holds_wp = split == wp / kSplitRows;
  const size_t row0 = ((size_t)layer * cache_slots + s) * t_max;  // row index of (layer, s, 0)
  const size_t head = (size_t)h * kHeadDim;
  int8_t* kc = k_cache + row0 * width + head;
  int8_t* vc = v_cache + row0 * width + head;

  // ---- stage K, then V (two cp.async groups); row wp is quantised below
  for (int i = tid; i < n_rows * CPR; i += kSplitThreads) {
    const int r = i / CPR, c = i % CPR, t = base + r;
    if (t != wp) cp_async16(sm_k + r * kHeadDim + c * 16, kc + (size_t)t * width + c * 16, true);
  }
  cp_async_commit();
  for (int i = tid; i < n_rows * CPR; i += kSplitThreads) {
    const int r = i / CPR, c = i % CPR, t = base + r;
    if (t != wp) cp_async16(sm_v + r * kHeadDim + c * 16, vc + (size_t)t * width + c * 16, true);
  }
  cp_async_commit();
  const int t = base + tid;  // thread tid's row in the softmax phase
  float ks_t = 0.f, vs_t = 0.f;
  if (tid < n_rows && t != wp) {
    ks_t = k_scale[row0 + t];
    vs_t = v_scale[row0 + t];
  }

  // ---- q, and in the split holding row wp without given scales the slot's
  // two new rows (full H*D lanes, 8 bf16 per 16-byte load): all loads
  // issued before the first reduction waits on any of them
  const bf16* kn = k_new + (size_t)s * width;
  const bf16* vn = v_new + (size_t)s * width;
  const float qv = tid < kHeadDim ? to_f32(q[(size_t)s * width + head + tid]) : 0.f;
  const bool given = k_row_scale != nullptr;
  float mk = 0.f, mv = 0.f;
  if (holds_wp && !given) {
    for (int i = tid * 8; i < width; i += kSplitThreads * 8) {
      const uint4 ku = *reinterpret_cast<const uint4*>(kn + i);
      const uint4 vu = *reinterpret_cast<const uint4*>(vn + i);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&ku);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vu);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 kf = __bfloat1622float2(k2[j]), vf = __bfloat1622float2(v2[j]);
        mk = fmaxf(mk, fmaxf(fabsf(kf.x), fabsf(kf.y)));
        mv = fmaxf(mv, fmaxf(fabsf(vf.x), fabsf(vf.y)));
      }
    }
  }

  // ---- one reduction for the three maxima (|q| of this head, and the two
  // new rows in the split holding row wp when no scales are given), then q
  // quantised
  const float wq = warp_max(fabsf(qv)), wk = warp_max(mk), wv = warp_max(mv);
  if (lane == 0) {
    sm_max[0][warp] = wq;
    sm_max[1][warp] = wk;
    sm_max[2][warp] = wv;
  }
  __syncthreads();
  const float q_s = __fmul_rn(fmaxf(max4(sm_max[0]), 1e-8f), kInv127);
  if (tid < kHeadDim) sm_qq[tid] = quantize(qv, q_s);

  // ---- the split holding row wp: the slot's row scales (given, or from the
  // maxima), this head's lanes quantised, appended and staged; head 0
  // appends the scales
  if (holds_wp) {
    const float k_s = given ? k_row_scale[s] : __fmul_rn(fmaxf(max4(sm_max[1]), 1e-8f), kInv127);
    const float v_s = given ? v_row_scale[s] : __fmul_rn(fmaxf(max4(sm_max[2]), 1e-8f), kInv127);
    const int r = wp - base;
    if (tid < kHeadDim) {
      const int8_t kq = quantize(to_f32(kn[head + tid]), k_s);
      sm_k[r * kHeadDim + tid] = kq;
      kc[(size_t)wp * width + tid] = kq;
    } else {
      const int i = tid - kHeadDim;
      const int8_t vq = quantize(to_f32(vn[head + i]), v_s);
      sm_v[r * kHeadDim + i] = vq;
      vc[(size_t)wp * width + i] = vq;
    }
    if (h == 0 && tid == 0) {
      k_scale[row0 + wp] = k_s;
      v_scale[row0 + wp] = v_s;
    }
    if (t == wp) {
      ks_t = k_s;
      vs_t = v_s;
    }
  }

  // ---- QK over the staged K rows: exact int32 dots
  cp_async_wait<1>();
  __syncthreads();  // K tile, the fresh row and sm_qq visible
  const int sub = tid % CPR, rq = tid / CPR;
  int qw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) qw[j] = reinterpret_cast<const int*>(sm_qq)[sub * 4 + j];
  for (int r0 = 0; r0 < n_rows; r0 += RPP) {  // n_rows is uniform: shuffles stay converged
    const int r = r0 + rq;
    int dot = 0;
    if (r < n_rows) {
      const int4 u = *reinterpret_cast<const int4*>(sm_k + r * kHeadDim + sub * 16);
      dot = __dp4a(u.x, qw[0], dot);
      dot = __dp4a(u.y, qw[1], dot);
      dot = __dp4a(u.z, qw[2], dot);
      dot = __dp4a(u.w, qw[3], dot);
    }
#pragma unroll
    for (int o = CPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (sub == 0 && r < n_rows) sm_dot[r] = dot;
  }
  __syncthreads();

  // ---- softmax over the split: thread t owns row t
  const bool live = tid < n_rows;
  const float qs = __fmul_rn(q_s, attn_scale);
  const float sc = live ? __fmul_rn(__fmul_rn((float)sm_dot[tid], ks_t), qs) : -INFINITY;
  const float m = block4_max(sc, sm_red[0]);  // finite: row 0 is live
  const float p = live ? expf(sc - m) : 0.f;
  const float l = block4_sum(p, sm_red[1]);
  sm_p[tid] = p * vs_t;

  // ---- PV over the staged V rows: warp w takes rows w, w + 4, ...
  cp_async_wait<0>();
  __syncthreads();
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int r = warp; r < n_rows; r += 4) {
    const float pw = sm_p[r];
    const char2 vv = *reinterpret_cast<const char2*>(sm_v + r * kHeadDim + 2 * lane);
    a0 = fmaf(pw, (float)vv.x, a0);
    a1 = fmaf(pw, (float)vv.y, a1);
  }
  sm_acc[warp][2 * lane] = a0;
  sm_acc[warp][2 * lane + 1] = a1;
  __syncthreads();

  const size_t unit = (size_t)s * n_heads + h;
  split_finish<float>(sm_acc, m, l, split, n_live,
                      partials + unit * gridDim.z * kPartialFloats, tickets + unit,
                      ctx + (size_t)s * width + head);
}

}  // namespace

// q [S, H, 64] and k_new/v_new [S, H*64] bf16; caches [L, S_cache, T, H*64]
// int8 and scales [L, S_cache, T] f32 with S <= S_cache, updated in place
// (the step covers cache slots 0..S-1 and leaves the others untouched);
// write_pos [S]; ctx [S, H*64] f32; partials [S, H, T / split,
// kPartialFloats] f32 and tickets [S, H] int32 (zero) are the workspace;
// k_row_scale / v_row_scale are the new rows' scales, f32 [S], or both NULL
// (each row's scale is then over its H*64 lanes); split must be kSplitRows
extern "C" int ragged_decode(const void* q, const void* k_new, const void* v_new, void* k_cache,
                             void* v_cache, void* k_scale, void* v_scale, const void* write_pos,
                             void* ctx, void* partials, void* tickets, const void* k_row_scale,
                             const void* v_row_scale, int n_slots, int cache_slots, int n_heads,
                             int t_max, int layer, int split, float attn_scale, void* stream) {
  if (split != kSplitRows || t_max % kSplitRows || n_slots > cache_slots
      || (k_row_scale == nullptr) != (v_row_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_heads, n_slots, t_max / kSplitRows);
  ragged_decode_split_kernel<<<grid, kSplitThreads, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
      static_cast<const bf16*>(v_new), static_cast<int8_t*>(k_cache),
      static_cast<int8_t*>(v_cache), static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(write_pos), static_cast<float*>(ctx),
      static_cast<float*>(partials), static_cast<int*>(tickets),
      static_cast<const float*>(k_row_scale), static_cast<const float*>(v_row_scale),
      cache_slots, n_heads, t_max, layer, attn_scale);
  return (int)cudaGetLastError();
}
