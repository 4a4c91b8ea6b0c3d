// K3: the HiFi-GAN MRF stage as fused dilated-conv launches, sm_90a.
//
// Replaces the Pallas kernel behind _run_fused_stage
// (auralis_tpu/ops/mrf.py:216, body _make_stage_kernel :123), which keeps a
// halo'd time tile of all three ResBlock1 chains in VMEM. Its
// time-into-lane folding and block-Toeplitz weights exist only for
// Mosaic's 128-lane tiles and are not carried over. The whole chain does
// not fit one Hopper block either: at C = 256, k = 11 the chain's halo is
// 60 rows a side, so a 64-row output tile with an f32 residual and a bf16
// activation needs ~184 x 256 x 6 B = 280 KB > 227 KB.
//
// So each conv is one launch of a fused kernel:
//   mrf_conv_lrelu:    act = bf16(lrelu(conv_d(bf16(lrelu(y))) + b))
//   mrf_conv_residual: y  = y + conv_1(act) + b     (f32 residual stream)
//                      and, at a chain's end, the stage mean epilogue:
//                      acc = z1 (+ z2) ...; out = bf16((acc + zN) / N),
//                      z = float(bf16(y))  -- the Pallas order ((z1+z2)+z3)/3.
// Precision contract (shared with the plain version in ops/mrf.py): conv
// inputs are rounded to the block dtype, accumulation is f32, the residual
// is carried in f32 across the chain. Rows outside [0, T) read as zero,
// which is the per-conv zero padding of the reference.
//
// Bound: operations. A 600-token chunk's MRF is ~1.5 TFLOP (126 k-tap convs
// over 4 stages): 1.6 ms on the H100's bf16 tensor cores, 23 ms at its f32
// FMA rate. Once on tensor cores, the stages at C <= 128 meet a traffic
// floor: each chain iteration moves ~16 B per element (y f32 in, act bf16
// out, act and y in, y f32 out).
//  - bf16 (serving): an implicit GEMM on the tensor cores. Per conv M = T,
//    N = C_out, K = k * C_in with A[t, (tap, ci)] = in[t + (tap - half) dil,
//    ci]. A block computes 128 rows x min(C, 128) output channels with 8
//    warps (4 x 2, each 32 rows x BN/2 channels). It stages its halo'd
//    input once in shared memory as bf16 ((128 + (k-1) dil) rows x C_in,
//    lrelu and bf16 rounding applied on load, rows outside [0, T) zero);
//    every tap reads it at a row offset through ldmatrix (no im2col). The
//    weights, packed [tap, C_out, C_in] (K-contiguous, ops/mrf.py), stream
//    per (tap, 64 input channels) through a 3-stage cp.async ring. Products
//    are mma.sync m16n8k16 bf16 with f32 accumulators. Row pitches are C + 8
//    bf16 (16-byte rows, conflict-free ldmatrix).
//  - f32 (the reference engine): f32 FMA; a block computes a 128-row x
//    32-channel tile, walking (tap, 32-channel input chunk) pairs through
//    shared memory; each thread owns a 4 x 4 register tile. Tensor cores
//    would round its inputs.

#include "common.cuh"

#include <type_traits>

namespace {

constexpr float LRELU = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : LRELU * v; }

// ---------------------------------------------------------------- f32 (FMA)
constexpr int TT = 128;   // output rows per block
constexpr int TCO = 32;   // output channels per block
constexpr int TCI = 32;   // input channels per smem chunk
constexpr int THREADS = 256;

// acc[i][j] = sum_{tap, ci} in(t0 + ty*4 + i + off_tap, ci) * w[tap, ci, co0 + tx*4 + j]
// LRELU_IN: the input element is transformed to TA(lrelu(x)) on load.
template <typename TA, typename TIn, bool LRELU_IN>
__device__ __forceinline__ void conv_tile(const TIn* __restrict__ in, const TA* __restrict__ w,
                                          int t_len, int c, int k, int dil, int t0, int co0,
                                          float (&acc)[4][4]) {
  __shared__ float as[TT][TCI + 1];
  __shared__ __align__(16) float bs[TCI][TCO];
  const int tid = threadIdx.x;
  const int ty = tid / (TCO / 4);  // 0..31
  const int tx = tid % (TCO / 4);  // 0..7
  const int half = (k - 1) / 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < k; ++tap) {
    const int off = (tap - half) * dil;
    for (int ci0 = 0; ci0 < c; ci0 += TCI) {
      __syncthreads();
      for (int e = tid; e < TT * TCI; e += THREADS) {
        const int r = e / TCI, cc = e % TCI;
        const int t = t0 + r + off;
        float val = 0.f;
        if (t >= 0 && t < t_len) {
          val = to_f32(in[(size_t)t * c + ci0 + cc]);
          if (LRELU_IN) val = to_f32(from_f32<TA>(lrelu(val)));
        }
        as[r][cc] = val;
      }
      for (int e = tid; e < TCI * TCO; e += THREADS) {
        const int r = e / TCO, cc = e % TCO;
        bs[r][cc] = to_f32(w[((size_t)tap * c + ci0 + r) * c + co0 + cc]);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TCI; ++kk) {
        const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = as[ty * 4 + i][kk];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
  }
}

template <typename TA, typename TIn>
__global__ void __launch_bounds__(THREADS)
mrf_conv_lrelu_kernel(const TIn* __restrict__ src, const TA* __restrict__ w,
                      const TA* __restrict__ bias, TA* __restrict__ out, int t_len, int c, int k,
                      int dil) {
  const size_t base = (size_t)blockIdx.z * t_len * c;
  const int t0 = blockIdx.x * TT, co0 = blockIdx.y * TCO;
  float acc[4][4];
  conv_tile<TA, TIn, true>(src + base, w, t_len, c, k, dil, t0, co0, acc);
  const int ty = threadIdx.x / (TCO / 4), tx = threadIdx.x % (TCO / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      const float h = acc[i][j] + to_f32(bias[co]);
      out[base + (size_t)t * c + co] = from_f32<TA>(lrelu(h));
    }
  }
}

// epilogue: 0 = y only; 1 = chain end (acc = z or acc += z);
// 2 = stage end (out = TA((acc + z) / n_chains), or TA(z / n) for one chain)
template <typename TA, typename TRes>
__global__ void __launch_bounds__(THREADS)
mrf_conv_residual_kernel(const TA* __restrict__ act, const TRes* res, const TA* __restrict__ w,
                         const TA* __restrict__ bias, float* y, float* acc_buf,
                         TA* __restrict__ out, int t_len, int c, int k, int dil, int epilogue,
                         int first_chain, int n_chains) {
  const size_t base = (size_t)blockIdx.z * t_len * c;
  const int t0 = blockIdx.x * TT, co0 = blockIdx.y * TCO;
  float acc[4][4];
  conv_tile<TA, TA, false>(act + base, w, t_len, c, k, dil, t0, co0, acc);
  const int ty = threadIdx.x / (TCO / 4), tx = threadIdx.x % (TCO / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= t_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      const size_t idx = base + (size_t)t * c + co;
      const float yn = to_f32(res[idx]) + (acc[i][j] + to_f32(bias[co]));
      y[idx] = yn;
      if (epilogue == 0) continue;
      const float z = to_f32(from_f32<TA>(yn));
      const float total = first_chain ? z : acc_buf[idx] + z;
      if (epilogue == 1)
        acc_buf[idx] = total;
      else
        out[idx] = from_f32<TA>(total / (float)n_chains);
    }
  }
}

inline dim3 grid_for(int b, int t_len, int c) {
  return dim3((t_len + TT - 1) / TT, c / TCO, b);
}

// ------------------------------------------------------ bf16 (tensor cores)
namespace tc {

constexpr int BM = 128;       // output rows per block
constexpr int THREADS = 256;  // 8 warps: 4 along rows x 2 along channels
constexpr int STAGES = 3;     // weight ring depth

template <int BN>
struct Tile {
  static constexpr int KC = BN == 32 ? 32 : 64;  // input channels per weight stage
  static constexpr int NT = BN / 16;             // 8-channel n-tiles per warp
  static constexpr int WP = KC + 8;              // weight stage row pitch (bf16)
};

inline size_t smem_bytes(int bn, int c, int k, int dil) {
  const int kc = bn == 32 ? 32 : 64;
  return (size_t)(BM + (k - 1) * dil) * (c + 8) * 2 + (size_t)STAGES * bn * (kc + 8) * 2;
}

// eight consecutive input channels as bf16, lrelu applied first when asked
template <typename TIn, bool LRELU_IN>
__device__ __forceinline__ uint4 load8(const TIn* __restrict__ p) {
  float f[8];
  if constexpr (std::is_same<TIn, float>::value) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (!LRELU_IN) return raw;
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = LRELU_IN ? pack_bf16x2(lrelu(f[2 * i]), lrelu(f[2 * i + 1]))
                    : pack_bf16x2(f[2 * i], f[2 * i + 1]);
  return out;
}

// acc[mt][nt] = the warp's 32 x BN/2 tile of sum_{tap, ci} in(t + off_tap, ci) *
// w[tap, co, ci], as mma C fragments
template <int BN, typename TIn, bool LRELU_IN>
__device__ __forceinline__ void conv_mma(const TIn* __restrict__ in, const bf16* __restrict__ w,
                                         int t_len, int c, int k, int dil, int t0, int co0,
                                         bf16* smem, float (&acc)[2][Tile<BN>::NT][4]) {
  constexpr int KC = Tile<BN>::KC, NT = Tile<BN>::NT, WP = Tile<BN>::WP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int half = (k - 1) / 2;
  const int rows_in = BM + (k - 1) * dil;
  const int pitch = c + 8;
  bf16* xs = smem;                  // [rows_in][pitch]: the halo'd input
  bf16* ws = smem + rows_in * pitch;  // STAGES x [BN][WP]: the weight ring
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_ci = c / KC, n_iter = k * n_ci;
  auto load_w = [&](int i) {
    const int tap = i / n_ci, ci0 = (i - tap * n_ci) * KC;
    const bf16* src = w + ((size_t)tap * c + co0) * c + ci0;
    bf16* dst = ws + (i % STAGES) * BN * WP;
    for (int e = tid; e < BN * KC / 8; e += THREADS) {
      const int r = e / (KC / 8), ch = e % (KC / 8);
      cp_async16(dst + r * WP + ch * 8, src + (size_t)r * c + ch * 8, true);
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_iter) load_w(st);
    cp_async_commit();
  }
  // the halo'd input, once, while the first weight stages are in flight
  const int cpr = c / 8;
  const int tb = t0 - half * dil;
  for (int e = tid; e < rows_in * cpr; e += THREADS) {
    const int r = e / cpr, ch = e - r * cpr;
    const int t = tb + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t >= 0 && t < t_len) val = load8<TIn, LRELU_IN>(in + (size_t)t * c + ch * 8);
    *reinterpret_cast<uint4*>(xs + r * pitch + ch * 8) = val;
  }

  for (int i = 0; i < n_iter; ++i) {
    cp_async_wait<STAGES - 2>();  // stage i has landed
    __syncthreads();              // ... for every thread; stage i - 1 is free
    if (i + STAGES - 1 < n_iter) load_w(i + STAGES - 1);
    cp_async_commit();
    const int tap = i / n_ci, ci0 = (i - tap * n_ci) * KC;
    const bf16* wt = ws + (i % STAGES) * BN * WP + (wn * (BN / 2)) * WP;
    const bf16* xt = xs + (wm * 32 + tap * dil) * pitch + ci0;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], xt + (mt * 16 + (lane & 15)) * pitch + kk + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ldmatrix_x4(b, wt + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * WP + kk +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// the (row, channel) of accumulator entry acc[mt][nt][e]
struct FragPos {
  int t, co;
};
template <int BN>
__device__ __forceinline__ FragPos frag_pos(int t0, int co0, int mt, int nt, int hh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {t0 + (warp >> 1) * 32 + mt * 16 + (lane >> 2) + hh * 8,
          co0 + (warp & 1) * (BN / 2) + nt * 8 + (lane & 3) * 2};
}

template <int BN, typename TIn>
__global__ void __launch_bounds__(THREADS)
mrf_conv_lrelu_mma(const TIn* __restrict__ src, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ out, int t_len, int c,
                   int k, int dil) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t base = (size_t)blockIdx.z * t_len * c;
  const int t0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  float acc[2][Tile<BN>::NT][4];
  conv_mma<BN, TIn, true>(src + base, w, t_len, c, k, dil, t0, co0,
                          reinterpret_cast<bf16*>(smem_raw), acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tile<BN>::NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const FragPos p = frag_pos<BN>(t0, co0, mt, nt, hh);
        if (p.t >= t_len) continue;
        const float h0 = acc[mt][nt][2 * hh] + __bfloat162float(bias[p.co]);
        const float h1 = acc[mt][nt][2 * hh + 1] + __bfloat162float(bias[p.co + 1]);
        *reinterpret_cast<uint32_t*>(out + base + (size_t)p.t * c + p.co) =
            pack_bf16x2(lrelu(h0), lrelu(h1));
      }
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// epilogue as mrf_conv_residual_kernel's: 0 = y only; 1 = chain end;
// 2 = stage end
template <int BN, typename TRes>
__global__ void __launch_bounds__(THREADS)
mrf_conv_residual_mma(const bf16* __restrict__ act, const TRes* res, const bf16* __restrict__ w,
                      const bf16* __restrict__ bias, float* y, float* acc_buf,
                      bf16* __restrict__ out, int t_len, int c, int k, int dil, int epilogue,
                      int first_chain, int n_chains) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t base = (size_t)blockIdx.z * t_len * c;
  const int t0 = blockIdx.x * BM, co0 = blockIdx.y * BN;
  float acc[2][Tile<BN>::NT][4];
  conv_mma<BN, bf16, false>(act + base, w, t_len, c, k, dil, t0, co0,
                            reinterpret_cast<bf16*>(smem_raw), acc);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tile<BN>::NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const FragPos p = frag_pos<BN>(t0, co0, mt, nt, hh);
        if (p.t >= t_len) continue;
        const size_t idx = base + (size_t)p.t * c + p.co;
        const float2 r = load2<TRes>(res + idx);
        const float2 yn = make_float2(r.x + (acc[mt][nt][2 * hh] + __bfloat162float(bias[p.co])),
                                      r.y + (acc[mt][nt][2 * hh + 1] +
                                             __bfloat162float(bias[p.co + 1])));
        *reinterpret_cast<float2*>(y + idx) = yn;
        if (epilogue == 0) continue;
        const float z0 = __bfloat162float(__float2bfloat16_rn(yn.x));
        const float z1 = __bfloat162float(__float2bfloat16_rn(yn.y));
        float2 total = make_float2(z0, z1);
        if (!first_chain) {
          const float2 prev = *reinterpret_cast<const float2*>(acc_buf + idx);
          total = make_float2(prev.x + z0, prev.y + z1);
        }
        if (epilogue == 1)
          *reinterpret_cast<float2*>(acc_buf + idx) = total;
        else
          *reinterpret_cast<uint32_t*>(out + idx) =
              pack_bf16x2(total.x / (float)n_chains, total.y / (float)n_chains);
      }
}

template <int BN, typename TIn>
int launch_lrelu(const void* src, const void* w, const void* b, void* out, int batch, int t_len,
                 int c, int k, int dil, cudaStream_t st) {
  const size_t smem = smem_bytes(BN, c, k, dil);
  static const cudaError_t err = allow_max_dynamic_smem(mrf_conv_lrelu_mma<BN, TIn>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BM - 1) / BM, c / BN, batch);
  mrf_conv_lrelu_mma<BN, TIn><<<grid, THREADS, smem, st>>>(
      static_cast<const TIn*>(src), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<bf16*>(out), t_len, c, k, dil);
  return (int)cudaGetLastError();
}

template <int BN, typename TRes>
int launch_residual(const void* act, const void* res, const void* w, const void* b, void* y,
                    void* acc, void* out, int batch, int t_len, int c, int k, int dil,
                    int epilogue, int first_chain, int n_chains, cudaStream_t st) {
  const size_t smem = smem_bytes(BN, c, k, dil);
  static const cudaError_t err = allow_max_dynamic_smem(mrf_conv_residual_mma<BN, TRes>);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BM - 1) / BM, c / BN, batch);
  mrf_conv_residual_mma<BN, TRes><<<grid, THREADS, smem, st>>>(
      static_cast<const bf16*>(act), static_cast<const TRes*>(res), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<float*>(y), static_cast<float*>(acc),
      static_cast<bf16*>(out), t_len, c, k, dil, epilogue, first_chain, n_chains);
  return (int)cudaGetLastError();
}

// output channels per block: the widest of 128 / 64 / 32 that divides C
inline int block_n(int c) { return c % 128 == 0 ? 128 : c % 64 == 0 ? 64 : 32; }

template <typename TIn>
int lrelu_bf16(const void* src, const void* w, const void* b, void* out, int batch, int t_len,
               int c, int k, int dil, cudaStream_t st) {
  switch (block_n(c)) {
    case 128: return launch_lrelu<128, TIn>(src, w, b, out, batch, t_len, c, k, dil, st);
    case 64: return launch_lrelu<64, TIn>(src, w, b, out, batch, t_len, c, k, dil, st);
    default: return launch_lrelu<32, TIn>(src, w, b, out, batch, t_len, c, k, dil, st);
  }
}

template <typename TRes>
int residual_bf16(const void* act, const void* res, const void* w, const void* b, void* y,
                  void* acc, void* out, int batch, int t_len, int c, int k, int dil,
                  int epilogue, int first_chain, int n_chains, cudaStream_t st) {
  switch (block_n(c)) {
    case 128:
      return launch_residual<128, TRes>(act, res, w, b, y, acc, out, batch, t_len, c, k, dil,
                                        epilogue, first_chain, n_chains, st);
    case 64:
      return launch_residual<64, TRes>(act, res, w, b, y, acc, out, batch, t_len, c, k, dil,
                                       epilogue, first_chain, n_chains, st);
    default:
      return launch_residual<32, TRes>(act, res, w, b, y, acc, out, batch, t_len, c, k, dil,
                                       epilogue, first_chain, n_chains, st);
  }
}

}  // namespace tc

}  // namespace

extern "C" int mrf_conv_lrelu(const void* src, const void* w, const void* b, void* out, int batch,
                              int t_len, int c, int k, int dil, int is_bf16, int src_is_f32,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && !src_is_f32) return tc::lrelu_bf16<bf16>(src, w, b, out, batch, t_len, c, k, dil, st);
  if (is_bf16) return tc::lrelu_bf16<float>(src, w, b, out, batch, t_len, c, k, dil, st);
  mrf_conv_lrelu_kernel<float, float><<<grid_for(batch, t_len, c), THREADS, 0, st>>>(
      static_cast<const float*>(src), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), t_len, c, k, dil);
  return (int)cudaGetLastError();
}

extern "C" int mrf_conv_residual(const void* act, const void* res, const void* w, const void* b,
                                 void* y, void* acc, void* out, int batch, int t_len, int c,
                                 int k, int dil, int is_bf16, int res_is_f32, int epilogue,
                                 int first_chain, int n_chains, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && !res_is_f32)
    return tc::residual_bf16<bf16>(act, res, w, b, y, acc, out, batch, t_len, c, k, dil,
                                   epilogue, first_chain, n_chains, st);
  if (is_bf16)
    return tc::residual_bf16<float>(act, res, w, b, y, acc, out, batch, t_len, c, k, dil,
                                    epilogue, first_chain, n_chains, st);
  mrf_conv_residual_kernel<float, float><<<grid_for(batch, t_len, c), THREADS, 0, st>>>(
      static_cast<const float*>(act), static_cast<const float*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(y),
      static_cast<float*>(acc), static_cast<float*>(out), t_len, c, k, dil, epilogue,
      first_chain, n_chains);
  return (int)cudaGetLastError();
}
