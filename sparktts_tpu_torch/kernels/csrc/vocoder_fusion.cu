// The WaveGenerator's DAC ResidualUnit, fp32-accurate on the tensor cores.
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
// with snake(v) = v + sin^2(a v) / (a + 1e-9), `sinf` (no fast math).
//
// Arithmetic: 3xTF32.  TF32 alone keeps 11 of fp32's 24 significant bits
// and would change the codec's numbers.  So every operand is split as
// a = a_hi + a_lo, a_hi = tf32(a), a_lo = tf32(a - a_hi) (`cvt.rna.tf32.f32`:
// round to nearest, ties away), and each product is taken as a_lo b_hi +
// a_hi b_lo + a_hi b_hi on `mma.sync.m16n8k8` tf32 with fp32 accumulation;
// the dropped a_lo b_lo is ~2^-22 of the product.  The result stays within
// fp32 summation-order error of the plain fp32 unit.  The kernel never reads
// PyTorch's TF32 flags.
//
// What bounds it on an H100: operations.  One unit is 16 T C^2 flops (seven
// taps and the 1x1, two flops per multiply-add) against 8 T C bytes of x in
// and out; the 3xTF32 route does three tensor products for each, so the
// least time of this fp32-accurate work is max(bytes / 3.35 TB/s,
// 3 x 16 T C^2 / 495 TFLOP/s): 1.98 ms for the 12 units of a 350-token
// vocode (4.88 ms at the 67 TFLOP/s fp32 CUDA-core rate).  The design before
// this one, an fp32 CUDA-core GEMM, took 16.12 ms for them on an H100 80GB
// HBM3 at 700.00 W, slower than cuDNN's fp32 convolutions (15.51).
//
// Design: two launches per unit, each a GEMM over a tile of 128 time rows x
// 96 output channels per block, 8 warps of 32 rows x 48 channels (2 x 6
// mma tiles, 48 fp32 sums a lane), two blocks an SM:
//   1. the dilated k7 conv, 8 input channels a chunk.  The chunk's haloed
//      strip (128 + 6 dil rows) arrives raw by 16-byte cp.async
//      (out-of-range rows zero-filled); one pass puts it through snake1 (one
//      `sinf` a staged element) and splits it once into hi and lo arrays, as
//      the seven taps read every strip element 7 times and two warps share
//      each row.  The taps are row-shifted reads of the same strip (shift
//      tap * dil).  The chunk's 7 x 8 x 96 weights are double-buffered by
//      cp.async, the next chunk's issued right after this chunk's strip is
//      split, so they land while this chunk's products run; a weight is
//      split where its fragment is loaded (3 ALU instructions for 3 mma):
//      designs that split the weights once in shared memory (as hi/lo
//      arrays, as pairs, or transposed for ldmatrix) needed more shared
//      memory or registers, spilled, and were slower.  The three products of
//      a k-step run in three passes over the warp's 12 tiles.
//      Epilogue: + b1, snake2, z to device memory.
//   2. the 1x1 conv over z, 32 channels a chunk, the same way without snake.
//      Epilogue: + b2 + x.
// Shared rows are padded so that fragment loads are conflict-free: the strip
// pitch is chunk + 4 floats (12 or 36: lane (g, t) reads bank 12g + t or
// 4g + t), the weight pitch 104 floats (lane (g, t) reads bank 8t + g).
// Why two launches: the 1x1 needs every channel of z for a time row, and
// z's round trip is 8 T C bytes, under 1% of the unit at the vocoder's
// shapes.  Blocks re-read their halo, which comes from L2 (the Pallas
// kernel's sequential "carry" grid has no counterpart: blocks run in
// parallel).  Rows past T are masked, so any T works; C must be a multiple
// of 96 (Spark-TTS-0.5B's 768, 384, 192, 96).
//
// Register and shared-memory use, and the times on the card, are in PERF.md
// (scripts/bench_torch_int8_vocoder.py, chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 128;       // time rows per block
constexpr int BN = 96;        // output channels per block
constexpr int THREADS = 256;  // 8 warps: 4 along time x 2 along channels
constexpr int WARP_ROWS = 32;
constexpr int WARP_COLS = 48;
constexpr int MT = WARP_ROWS / 16;  // m16 tiles per warp
constexpr int NT = WARP_COLS / 8;   // n8 tiles per warp
constexpr int WP = BN + 8;          // weight row pitch in floats
constexpr int K7_CHUNK = 8;         // input channels staged per step, k7 conv
constexpr int K1_CHUNK = 32;        // input channels staged per step, 1x1 conv
static_assert(THREADS % K7_CHUNK == 0 && THREADS % K1_CHUNK == 0, "a thread stages one channel");

__device__ __forceinline__ float snake(float v, float a) {
  const float s = sinf(a * v);
  return v + s * s / (a + 1e-9f);
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t* hi, uint32_t* lo) {
  const uint32_t h = tf32(v);
  *hi = h;
  *lo = tf32(v - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Floats of shared memory for one block: two buffers of weights, the raw
// strip, then the strip's hi and lo arrays.
__host__ __device__ constexpr int strip_pitch(int bk) { return bk + 4; }
__host__ __device__ inline size_t smem_floats(int taps, int bk, int rows) {
  return 2 * static_cast<size_t>(taps) * bk * WP + static_cast<size_t>(rows) * bk +
         2 * static_cast<size_t>(rows) * strip_pitch(bk);
}

// TAPS == 7: in = x, epilogue snake2 -> z.  TAPS == 1: in = z, epilogue + x.
template <int TAPS, int BK>
__global__ void __launch_bounds__(THREADS, 2) unit_gemm(
    const float* __restrict__ in, const float* __restrict__ alpha_in,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ alpha_out, const float* __restrict__ resid,
    float* __restrict__ out, int T, int C, int dil) {
  constexpr int SP = strip_pitch(BK);
  extern __shared__ __align__(16) float smem[];
  const int halo = (TAPS / 2) * dil;
  const int rows = BT + 2 * halo;
  float* w_s = smem;                                    // [2][TAPS * BK][WP]
  float* raw_x = w_s + 2 * TAPS * BK * WP;              // [rows][BK]
  uint32_t* s_hi = reinterpret_cast<uint32_t*>(raw_x + rows * BK);  // [rows][SP]
  uint32_t* s_lo = s_hi + rows * SP;

  const int t0 = blockIdx.x * BT;
  const int n0 = blockIdx.y * BN;
  const long long batch = static_cast<long long>(blockIdx.z) * T * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * WARP_ROWS, wn = (warp % 2) * WARP_COLS;

  auto issue = [&](int c0, float* w_buf) {
    for (int e = tid; e < rows * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), q = e % (BK / 4);
      const int tt = t0 - halo + r;
      const bool ok = tt >= 0 && tt < T;
      cp_async16(raw_x + r * BK + 4 * q,
                 ok ? in + batch + static_cast<long long>(tt) * C + c0 + 4 * q : in, ok ? 16 : 0);
    }
    for (int e = tid; e < TAPS * BK * (BN / 4); e += THREADS) {
      const int row = e / (BN / 4), q = e % (BN / 4);
      const int tap = row / BK, kk = row % BK;
      cp_async16(w_buf + row * WP + 4 * q,
                 w + (static_cast<long long>(tap) * C + c0 + kk) * C + n0 + 4 * q, 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  issue(0, w_s);
  for (int c0 = 0, buf = 0; c0 < C; c0 += BK, buf ^= 1) {
    const float* w_c = w_s + buf * TAPS * BK * WP;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // chunk c0 is in; the last chunk's products are done
    {  // a thread stages one channel k of every (THREADS / BK)-th row: its
       // alpha is loaded once, and the unrolled rows' sinf chains overlap
      const int k = tid % BK;
      const float a = TAPS == 7 ? alpha_in[c0 + k] : 0.f;
#pragma unroll 4
      for (int r = tid / BK; r < rows; r += THREADS / BK) {
        float v = raw_x[r * BK + k];
        if (TAPS == 7) v = snake(v, a);  // snake(0) = 0 off the sequence
        split(v, s_hi + r * SP + k, s_lo + r * SP + k);
      }
    }
    __syncthreads();  // hi/lo ready; the raw strip is free
    if (c0 + BK < C) issue(c0 + BK, w_s + (buf ^ 1) * TAPS * BK * WP);

#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int o = (wm + 16 * i + g + tap * dil) * SP + 8 * ks + t;
          ah[i][0] = s_hi[o];
          ah[i][1] = s_hi[o + 8 * SP];
          ah[i][2] = s_hi[o + 4];
          ah[i][3] = s_hi[o + 8 * SP + 4];
          al[i][0] = s_lo[o];
          al[i][1] = s_lo[o + 8 * SP];
          al[i][2] = s_lo[o + 4];
          al[i][3] = s_lo[o + 8 * SP + 4];
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (tap * BK + 8 * ks + t) * WP + wn + 8 * j + g;
          split(w_c[o], &bh[j][0], &bl[j][0]);
          split(w_c[o + 4 * WP], &bh[j][1], &bl[j][1]);
        }
        // the three products of a sum in three passes over the 12 tiles, so
        // that dependent mma are 12 apart
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
      }
    }
  }

  // fragment element v: row g (v < 2) or g + 8, column 2t + (v & 1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn + 8 * j + 2 * t;
    const float b0 = bias[n], b1 = bias[n + 1];
    const float a0 = TAPS == 7 ? alpha_out[n] : 0.f, a1 = TAPS == 7 ? alpha_out[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int tt = t0 + wm + 16 * i + g + 8 * half;
        if (tt >= T) continue;
        const long long off = batch + static_cast<long long>(tt) * C + n;
        float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        if (TAPS == 7) {
          v0 = snake(v0, a0);
          v1 = snake(v1, a1);
        } else {
          const float2 r = *reinterpret_cast<const float2*>(resid + off);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
      }
  }
}

template <int TAPS, int BK>
cudaError_t launch(const float* in, const float* alpha_in, const float* w, const float* bias,
                   const float* alpha_out, const float* resid, float* out, int B, int T, int C,
                   int dil, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(TAPS, BK, BT + 2 * (TAPS / 2) * dil);
  const cudaError_t err = cudaFuncSetAttribute(
      unit_gemm<TAPS, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
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
