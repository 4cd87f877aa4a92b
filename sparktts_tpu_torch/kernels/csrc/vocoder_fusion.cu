// The WaveGenerator's DAC ResidualUnit, fp32 on CUDA cores.
//
// Replaces the Pallas kernel `fused_residual_unit` (`_residual_unit_carry_kernel`
// and `_residual_unit_kernel`) of sparktts_tpu/kernels/vocoder_fusion.py.  Same
// function, on a (B, T, C) fp32 tensor x with the JAX package's WIO weights
// (conv1.w (7, C, C), conv2.w (1, C, C), output channels contiguous):
//
//   y[t]   = snake1(x[t]), zero outside [0, T)
//   z[t]   = snake2(b1 + sum_k sum_c y[t + (k - 3) dil, c] w1[k, c, :])
//   out[t] = x[t] + b2 + sum_c z[t, c] w2[0, c, :]
//
// with snake(v) = v + sin^2(a v) / (a + 1e-9), `sinf` (no fast math), fp32
// sums.  TF32 or wgmma would change the codec's numbers, so they are not used.
//
// What bounds it on an H100: operations.  One unit is 16 T C^2 flops (seven
// taps and the 1x1, two flops per multiply-add) against 8 T C bytes of x in
// and out: at C = 96 that is 192 flops per byte, above the fp32 CUDA-core
// ridge of 67 TFLOP/s / 3.35 TB/s = 20.  So the design is a register-tiled
// fp32 GEMM, and bytes only have to stay out of the way.
//
// Design: two launches per unit, each a tiled GEMM over a (128 time rows x
// 96 output channels) tile per block, 256 threads, each thread 8 rows
// (strided by 16, so a warp reads two neighbouring strip rows, which
// broadcast) by 6 adjacent channels (three float2 reads of the weight tile,
// conflict-free across a half-warp).
//   1. the dilated k7 conv.  For each chunk of 8 input channels the block
//      stages the haloed strip of 128 + 6 dil rows through snake1 into
//      shared memory once (so each x element sees one `sinf` per chunk, not
//      one per tap), zero outside [0, T), then runs all seven taps from it
//      as shifted reads.  Epilogue: + b1, snake2, z to device memory.
//   2. the 1x1 conv over z, 32 channels a chunk.  Epilogue: + b2 + x.
// Why split: the 1x1 needs every channel of z for a time row.  Keeping the
// unit in one block means a block owns all C = 768 output channels, so at
// most 16 time rows fit its registers and the grid is too coarse for the
// early blocks; z's round trip costs 8 T C bytes, under 1% of the unit's
// time at the shapes the vocoder runs.  The Pallas kernel's sequential
// "carry" grid (each step finishing the previous tile) has no counterpart
// here: blocks run in parallel and simply re-read their halo, which comes
// from L2.  Rows past T are masked in the kernel, so any T works.  C must be
// a multiple of 96 (Spark-TTS-0.5B's 768, 384, 192, 96).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 128;          // time rows per block
constexpr int BN = 96;           // output channels per block
constexpr int TM = 8;            // rows per thread, strided by BT / TM
constexpr int TN = 6;            // adjacent output channels per thread
constexpr int THREADS = 256;     // (BT / TM) x (BN / TN) = 16 x 16
constexpr int ROW_STRIDE = BT / TM;
constexpr int K7_CHUNK = 8;      // input channels staged per step, k7 conv
constexpr int K1_CHUNK = 32;     // input channels staged per step, 1x1 conv

__device__ __forceinline__ float snake(float v, float a) {
  const float s = sinf(a * v);
  return v + s * s / (a + 1e-9f);
}

// Row pitch of the staged strip, [BK][ld] floats.  A warp stages 128 / BK
// rows of BK / 4 float4s each and scatters every float4 over four channel
// rows; ld = 32 / BK (mod 8) puts those 32 stores in 32 distinct banks.
__host__ __device__ __forceinline__ int strip_ld(int rows, int bk) {
  return rows + ((32 / bk - rows) % 8 + 8) % 8;
}

// TAPS == 7: in = x, epilogue snake2 -> z.  TAPS == 1: in = z, epilogue + x.
template <int TAPS, int BK>
__global__ void __launch_bounds__(THREADS, 2) unit_gemm(
    const float* __restrict__ in, const float* __restrict__ alpha_in,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ alpha_out, const float* __restrict__ resid,
    float* __restrict__ out, int T, int C, int dil) {
  extern __shared__ __align__(16) float smem[];
  const int halo = (TAPS / 2) * dil;
  const int strip_rows = BT + 2 * halo;
  const int ld = strip_ld(strip_rows, BK);
  float* w_s = smem;                    // [TAPS][BK][BN]
  float* strip = smem + TAPS * BK * BN;  // [BK][ld], time rows contiguous

  const int t0 = blockIdx.x * BT;
  const int n0 = blockIdx.y * BN;
  const long long batch = static_cast<long long>(blockIdx.z) * T * C;
  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN), tx = tid % (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    // strip rows t0 - halo + r, channels c0 .. c0 + BK, as float4 reads
    for (int e = tid; e < strip_rows * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), q = e % (BK / 4);
      const int t = t0 - halo + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) {
        v = *reinterpret_cast<const float4*>(in + batch + static_cast<long long>(t) * C + c0 + 4 * q);
        if (TAPS == 7) {
          const float4 a = *reinterpret_cast<const float4*>(alpha_in + c0 + 4 * q);
          v = make_float4(snake(v.x, a.x), snake(v.y, a.y), snake(v.z, a.z), snake(v.w, a.w));
        }
      }
      float* s = strip + (4 * q) * ld + r;
      s[0] = v.x;
      s[ld] = v.y;
      s[2 * ld] = v.z;
      s[3 * ld] = v.w;
    }
    // weight rows (tap, c0 + kk), channels n0 .. n0 + BN
    for (int e = tid; e < TAPS * BK * (BN / 4); e += THREADS) {
      const int row = e / (BN / 4), q = e % (BN / 4);
      const int tap = row / BK, kk = row % BK;
      reinterpret_cast<float4*>(w_s)[e] = *reinterpret_cast<const float4*>(
          w + (static_cast<long long>(tap) * C + c0 + kk) * C + n0 + 4 * q);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const float* a_base = strip + tap * dil + ty;
      const float* b_base = w_s + tap * BK * BN + tx * TN;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = a_base[kk * ld + i * ROW_STRIDE];
#pragma unroll
        for (int j = 0; j < TN; j += 2) {
          const float2 f = *reinterpret_cast<const float2*>(b_base + kk * BN + j);
          b[j] = f.x;
          b[j + 1] = f.y;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int n = n0 + tx * TN;
  float bn[TN], an[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    bn[j] = bias[n + j];
    an[j] = TAPS == 7 ? alpha_out[n + j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int t = t0 + ty + i * ROW_STRIDE;
    if (t >= T) continue;
    const long long off = batch + static_cast<long long>(t) * C + n;
    float o[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float v = acc[i][j] + bn[j];
      o[j] = TAPS == 7 ? snake(v, an[j]) : resid[off + j] + v;
    }
#pragma unroll
    for (int j = 0; j < TN; j += 2)
      *reinterpret_cast<float2*>(out + off + j) = make_float2(o[j], o[j + 1]);
  }
}

template <int TAPS, int BK>
cudaError_t launch(const float* in, const float* alpha_in, const float* w, const float* bias,
                   const float* alpha_out, const float* resid, float* out, int B, int T, int C,
                   int dil, cudaStream_t stream) {
  const int ld = strip_ld(BT + 2 * (TAPS / 2) * dil, BK);
  const size_t smem = sizeof(float) * (static_cast<size_t>(TAPS) * BK * BN +
                                       static_cast<size_t>(BK) * ld);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        unit_gemm<TAPS, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((T + BT - 1) / BT, C / BN, B);
  unit_gemm<TAPS, BK><<<grid, THREADS, smem, stream>>>(in, alpha_in, w, bias, alpha_out, resid,
                                                       out, T, C, dil);
  return cudaGetLastError();
}

}  // namespace

// x, z (scratch) and out (B, T, C) contiguous fp32, 16-byte aligned; alpha1,
// b1, alpha2, b2 (C,); w1 (7, C, C) and w2 (1, C, C) WIO, contiguous and
// 16-byte aligned.  Two launches on `stream`; returns the first launch
// error.  C not a multiple of 96, or a non-positive size or dilation,
// returns cudaErrorInvalidValue without launching.
extern "C" int fused_residual_unit_f32(const void* x, const void* alpha1, const void* w1,
                                       const void* b1, const void* alpha2, const void* w2,
                                       const void* b2, void* z, void* out, int B, int T, int C,
                                       int dilation, void* stream) {
  if (B < 1 || T < 1 || C < BN || C % BN != 0 || dilation < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch<7, K7_CHUNK>(
      static_cast<const float*>(x), static_cast<const float*>(alpha1),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(alpha2), nullptr, static_cast<float*>(z), B, T, C, dilation, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<1, K1_CHUNK>(
      static_cast<const float*>(z), nullptr, static_cast<const float*>(w2),
      static_cast<const float*>(b2), nullptr, static_cast<const float*>(x),
      static_cast<float*>(out), B, T, C, 0, s);
  return static_cast<int>(err);
}
