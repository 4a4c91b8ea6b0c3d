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
// Bound: FLOPs. A 600-token chunk's MRF is ~1.5 TFLOP (126 k-tap convs
// over 4 stages). This first version is an f32-FMA tiled conv: a block
// computes a 128-row x 32-channel output tile, walking (tap, 32-channel
// input chunk) pairs through shared memory; each thread owns a 4 x 4
// register tile. Tensor-core mma and chain-resident tiles are later work.

#include "common.cuh"

namespace {

constexpr int TT = 128;   // output rows per block
constexpr int TCO = 32;   // output channels per block
constexpr int TCI = 32;   // input channels per smem chunk
constexpr int THREADS = 256;
constexpr float LRELU = 0.1f;

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : LRELU * v; }

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

}  // namespace

extern "C" int mrf_conv_lrelu(const void* src, const void* w, const void* b, void* out, int batch,
                              int t_len, int c, int k, int dil, int is_bf16, int src_is_f32,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(batch, t_len, c);
  if (is_bf16 && !src_is_f32)
    mrf_conv_lrelu_kernel<bf16, bf16><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(src), static_cast<const bf16*>(w), static_cast<const bf16*>(b),
        static_cast<bf16*>(out), t_len, c, k, dil);
  else if (is_bf16)
    mrf_conv_lrelu_kernel<bf16, float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(src), static_cast<const bf16*>(w),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), t_len, c, k, dil);
  else
    mrf_conv_lrelu_kernel<float, float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(src), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(out), t_len, c, k, dil);
  return (int)cudaGetLastError();
}

extern "C" int mrf_conv_residual(const void* act, const void* res, const void* w, const void* b,
                                 void* y, void* acc, void* out, int batch, int t_len, int c,
                                 int k, int dil, int is_bf16, int res_is_f32, int epilogue,
                                 int first_chain, int n_chains, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(batch, t_len, c);
  if (is_bf16 && !res_is_f32)
    mrf_conv_residual_kernel<bf16, bf16><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(act), static_cast<const bf16*>(res),
        static_cast<const bf16*>(w), static_cast<const bf16*>(b), static_cast<float*>(y),
        static_cast<float*>(acc), static_cast<bf16*>(out), t_len, c, k, dil, epilogue,
        first_chain, n_chains);
  else if (is_bf16)
    mrf_conv_residual_kernel<bf16, float><<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(act), static_cast<const float*>(res),
        static_cast<const bf16*>(w), static_cast<const bf16*>(b), static_cast<float*>(y),
        static_cast<float*>(acc), static_cast<bf16*>(out), t_len, c, k, dil, epilogue,
        first_chain, n_chains);
  else
    mrf_conv_residual_kernel<float, float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(act), static_cast<const float*>(res),
        static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(y),
        static_cast<float*>(acc), static_cast<float*>(out), t_len, c, k, dil, epilogue,
        first_chain, n_chains);
  return (int)cudaGetLastError();
}
