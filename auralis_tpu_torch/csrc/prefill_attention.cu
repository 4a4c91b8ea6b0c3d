// K1: causal, length-masked prefill attention for sm_90a.
//
// Replaces the Pallas kernel prefill_flash_attention
// (auralis_tpu/ops/prefill_attention.py:61, body _attn_kernel :33), which
// keeps one head's whole [T, 64] Q/K/V and its [T, T] score matrix in VMEM.
// A [T, T] f32 tile at T = 1047 is 4.4 MB; a Hopper block has 227 KB of
// shared memory, so this kernel is flash-attention-2 shaped: one block per
// (64-row query tile, head) walks 64-row key tiles up to
// min(query-tile end, length) with an online softmax kept in f32 registers.
// Scores never reach device memory. At T <= 1047 the whole call is ~2.3
// GFLOP and a few MB of reads, so it is bound by FMA issue and latency; this
// first version uses plain f32 FMA on tiles staged in shared memory.
//
// Layout: q/k/v rows are [T, H*64] views with a shared row stride (they may
// be slices of one fused [T, 3*H*64] qkv row); out is [T, H, 64] f32.
// Thread map: 256 threads, 4 per query row; a thread scores keys
// sub, sub+4, ... of each tile and owns output dims sub, sub+4, ...

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // key rows per tile
constexpr int HD = 64;   // head dim
constexpr int THREADS = 256;
constexpr int KS = HD + 1;  // padded row pitch of the K and P tiles
constexpr size_t SMEM_BYTES = sizeof(float) * (BK * KS + BK * HD + BQ * (BK + 1));

template <typename T>
__global__ void __launch_bounds__(THREADS)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, float* __restrict__ out, int t_len,
                         int n_heads, int row_stride, int length, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;              // [BK][KS]
  float* vs = ks + BK * KS;      // [BK][HD]
  float* ps = vs + BK * HD;      // [BQ][BK + 1]

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int sub = tid & 3;
  const int qpos = q0 + row;
  const bool row_valid = qpos < t_len;

  float qr[HD];
  if (row_valid) {
    const T* qp = q + (size_t)qpos * row_stride + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = to_f32(qp[d]);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qr[d] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  const int kv_end = min(q0 + BQ, length);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int r = e / HD, c = e % HD;
      const int kp = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kp < t_len) {
        const size_t off = (size_t)kp * row_stride + h * HD + c;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      ks[r * KS + c] = kv;
      vs[r * HD + c] = vv;
    }
    __syncthreads();

    float s[BK / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) {
      const int c = sub + 4 * j;
      const int kp = k0 + c;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], ks[c * KS + d], dot);
      const bool ok = (kp <= qpos) && (kp < length);
      s[j] = ok ? dot * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    float corr = 1.f, psum = 0.f;
    if (m_new == -INFINITY) {
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) s[j] = 0.f;
    } else {
      corr = expf(m - m_new);
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j) ps[row * (BK + 1) + sub + 4 * j] = s[j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = ps[row * (BK + 1) + c];
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) acc[i] = fmaf(p, vs[c * HD + sub + 4 * i], acc[i]);
    }
  }

  if (row_valid) {
    const float inv = 1.f / l;
    float* op = out + ((size_t)qpos * n_heads + h) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) op[sub + 4 * i] = acc[i] * inv;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int t_len, int n_heads,
           int row_stride, int length, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(prefill_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + BQ - 1) / BQ, n_heads);
  prefill_attention_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), t_len, n_heads, row_stride, length, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prefill_attention(const void* q, const void* k, const void* v, void* out,
                                 int t_len, int n_heads, int row_stride, int length,
                                 float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<bf16>(q, k, v, out, t_len, n_heads, row_stride, length, scale, st);
  return launch<float>(q, k, v, out, t_len, n_heads, row_stride, length, scale, st);
}
