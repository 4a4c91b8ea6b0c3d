// K1: causal, length-masked prefill attention for sm_90a.
//
// Replaces the Pallas kernel prefill_flash_attention
// (auralis_tpu/ops/prefill_attention.py:61, body _attn_kernel :33), which
// keeps one head's whole [T, 64] Q/K/V and its [T, T] score matrix in VMEM.
// A [T, T] f32 tile at T = 1047 is 4.4 MB; a Hopper block has 227 KB of
// shared memory, so both instantiations are flash-attention-2 shaped: one
// block per (64-row query tile, head) walks 64-row key tiles up to
// min(query-tile end, length) with an online softmax kept in f32 registers.
// Scores never reach device memory.
//
// Bound: bytes (q, k, v read once, f32 ctx written: 3.2 us at T = 1047 on
// an H100); the ~2 GFLOP of QK^T and PV take ~2 us on the bf16 tensor cores
// but ~35 us at the f32 FMA rate. So:
//  - bf16 (the serving dtype): tensor cores. 4 warps x 16 query rows; Q is
//    staged once and held as mma A fragments; K and V tiles stream through
//    a cp.async double buffer straight from the fused qkv rows (16-byte
//    copies; the head offset is 128 B). S = Q K^T is mma.sync m16n8k16 into
//    f32 fragments; the mask and the online softmax work on the fragments
//    with quad shuffles. P stays in registers, re-packed from C to A
//    fragments and split into bf16 hi + lo parts (two mma's), so P carries
//    ~16 bits and ctx stays within 1e-3 of the f32 plain version.
//  - f32 (the reference engine's dtype): plain f32 FMA on tiles staged in
//    shared memory; tensor cores would round its inputs.
//
// Layout: q/k/v rows are [T, H*64] views with a shared row stride (they may
// be slices of one fused [T, 3*H*64] qkv row); out is [T, H, 64] f32.
//
// The prompt length is read from device memory (one int32) when a block
// starts, so a launch captured in a CUDA graph takes each replay's length
// from the graph's static input instead of the value seen at capture.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- f32 (FMA)
// Thread map: 256 threads, 4 per query row; a thread scores keys
// sub, sub+4, ... of each tile and owns output dims sub, sub+4, ...
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
                         int n_heads, int row_stride, const int* __restrict__ length_ptr,
                         float scale) {
  extern __shared__ float smem[];
  const int length = *length_ptr;
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

// ------------------------------------------------------ bf16 (tensor cores)
constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows
constexpr int PITCH = HD + 8;      // smem row pitch (bf16): 144 B, ldmatrix conflict-free

__global__ void __launch_bounds__(MMA_THREADS)
prefill_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, float* __restrict__ out, int t_len,
                             int n_heads, int row_stride, const int* __restrict__ length_ptr,
                             float scale) {
  __shared__ __align__(16) bf16 qs[BQ * PITCH];
  __shared__ __align__(16) bf16 ks[2][BK * PITCH];
  __shared__ __align__(16) bf16 vs[2][BK * PITCH];
  const int length = *length_ptr;  // first used after the first tiles' copies

  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;

  // 64 rows x 64 dims of one head, rows past T zero-filled: 512 16-B copies
  auto load_tile = [&](bf16* dst, const bf16* src, int r0) {
    for (int e = tid; e < BQ * (HD / 8); e += MMA_THREADS) {
      const int r = e >> 3, ch = e & 7;
      const bool ok = r0 + r < t_len;
      const bf16* p = src + (size_t)(ok ? r0 + r : 0) * row_stride + h * HD + ch * 8;
      cp_async16(dst + r * PITCH + ch * 8, p, ok);
    }
  };

  // the first tiles do not depend on the length: issue their copies before
  // the length's load is waited for
  load_tile(qs, q, q0);
  load_tile(ks[0], k, 0);
  load_tile(vs[0], v, 0);
  cp_async_commit();
  const int kv_end = min(q0 + BQ, length);
  const int n_tiles = (kv_end + BK - 1) / BK;

  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // fragment rows row0 and row0 + 8

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(ks[buf ^ 1], k, (it + 1) * BK);
      load_tile(vs[buf ^ 1], v, (it + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` (and Q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * PITCH + kk * 16 + (lane >> 4) * 8);
    }

    // S = Q K^T: 16 query rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < BK / 16; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, ks[buf] + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * PITCH + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * p], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * p + 1], qf[kk], b[2], b[3]);
      }
    }

    // mask, then the online softmax on the fragments (a row's 64 scores sit
    // in the 4 lanes of a quad)
    const int k0 = it * BK;
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k0 + j * 8 + qd * 2 + (e & 1);
        s[j][e] = (col <= row && col < length) ? s[j][e] * scale : -INFINITY;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m_r[r], tmax[r]);
      corr[r] = m_new == -INFINITY ? 1.f : expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = m_r[e >> 1];
        s[j][e] = m == -INFINITY ? 0.f : expf(s[j][e] - m);
        psum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_r[r] = l_r[r] * corr[r] + psum[r];
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }

    // O += P V, P as A fragments (keys 16 kk .. 16 kk + 15 are score
    // n-tiles 2 kk and 2 kk + 1), split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = s[2 * kk + (r >> 1)][(r & 1) * 2];
        const float x1 = s[2 * kk + (r >> 1)][(r & 1) * 2 + 1];
        ph[r] = pack_bf16x2(x0, x1);
        const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&ph[r]);
        pl[r] = pack_bf16x2(x0 - __low2float(hb), x1 - __high2float(hb));
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs[buf] + (kk * 16 + (lane & 15)) * PITCH + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], ph, b[0], b[1]);
        mma_bf16(o[2 * dp], pl, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= t_len) continue;
    const float inv = 1.f / l_r[r];
    float* op = out + ((size_t)row * n_heads + h) * HD + qd * 2;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(op + i * 8) = make_float2(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int t_len, int n_heads,
               int row_stride, const int* length, float scale, cudaStream_t stream) {
  // set once per process: launches may be captured into CUDA graphs
  static const cudaError_t err = cudaFuncSetAttribute(
      prefill_attention_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t_len + BQ - 1) / BQ, n_heads);
  prefill_attention_kernel<float><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), t_len, n_heads, row_stride, length, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int t_len, int n_heads,
                int row_stride, const int* length, float scale, cudaStream_t stream) {
  dim3 grid((t_len + BQ - 1) / BQ, n_heads);
  prefill_attention_mma_kernel<<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(out), t_len, n_heads, row_stride, length, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int prefill_attention(const void* q, const void* k, const void* v, void* out,
                                 int t_len, int n_heads, int row_stride, const void* length,
                                 float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  if (is_bf16) return launch_bf16(q, k, v, out, t_len, n_heads, row_stride, len, scale, st);
  return launch_f32(q, k, v, out, t_len, n_heads, row_stride, len, scale, st);
}
