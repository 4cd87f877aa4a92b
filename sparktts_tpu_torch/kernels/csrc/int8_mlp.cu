// Fused weight-only int8 SwiGLU MLP for a few decode rows.
//
// Replaces the Pallas kernel `int8_mlp_matvec` (`_mlp_kernel`) of
// sparktts_tpu/kernels/int8_mlp.py.  Same function and rounding points, with
// dt = bf16 (x's dtype on the main path):
//
//   g = dt(dt(x . Wg) * dt(sg)),   u = dt(dt(x . Wu) * dt(su))
//   h = dt(dt(silu_fp32(g)) * u)
//   out = dt(dt(h . Wd) * dt(sd))
//
// where every dot takes bf16 x times the int8 weight (exact in fp32) and sums
// in fp32.  x is (R, K) with R <= 16; gu_q (K, 2I) int8 holds the gate
// columns [0, I) then the up columns [I, 2I); down_q is (I, K) int8; the
// scales are fp32 per output column.
//
// What bounds it on an H100: at R <= 16 it does 2R operations per weight
// byte, far below the ~295 at which the tensor cores would be the limit, so
// it is bound by the bytes of the int8 weights: 3 I K = 13.07 MB per layer of
// Qwen2.5-0.5B, 3.9 us at 3.35 TB/s.  The design keeps every SM streaming
// weights and moves nothing else of size:
//
// * The Pallas grid walks the intermediate dim in order and carries the down
//   accumulator in VMEM.  Hopper blocks run in parallel, so the call is three
//   launches.  (1) gate/up + SwiGLU: a block owns 32 intermediate columns
//   (their gate and up bytes, 64 a row) over all K rows, so it can finish g,
//   u and h itself and write h (R, I) bf16: ceil(I/32) = 152 blocks at full
//   width.  (2) down partials: the 896 output columns alone would give a
//   handful of blocks, so the contraction over I is split too, into slices of
//   `rows_per_split` rows (19 x 14 = 266 blocks at full width), each writing
//   fp32 partial sums.  (3) a small pass sums the partials in slice order and
//   applies the down scale.  No float atomics: results repeat run to run.
// * Within a block, TPR neighbouring threads cover the block's columns of one
//   weight row (coalesced 16- or 4-byte loads) and THREADS / TPR rows are in
//   flight at once; the row loop is unrolled to keep several loads in
//   flight.  x (or the block's slice of h) sits in shared memory as bf16.
// * Each thread keeps R x VEC fp32 sums: VEC = 16 bytes a load for R <= 4,
//   VEC = 4 for R <= 16, 64 registers of sums at most.  The sums of threads
//   on the same columns are added by warp shuffles, then across warps in
//   shared memory in a fixed order.
// * Any I and K: columns past the edge read as zero, and a row that cannot
//   take an aligned vector load is read byte by byte.
//
// cp.async/TMA pipelining of the weight stream is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GU_COLS = 32;    // intermediate columns per gate/up block
constexpr int DOWN_COLS = 64;  // output columns per down block
constexpr int FINISH_THREADS = 256;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC int8 weights row[col .. col + VEC) as floats; columns at or past
// `ncols` read as 0.  `vec_ok`: the row allows aligned VEC-byte loads.
template <int VEC>
__device__ __forceinline__ void load_int8(const int8_t* __restrict__ row, int col, int ncols,
                                          bool vec_ok, float (&w)[VEC]) {
  if (vec_ok && col + VEC <= ncols) {
    int words[VEC / 4];
    if constexpr (VEC == 16) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(row + col));
      words[0] = v.x;
      words[1] = v.y;
      words[2] = v.z;
      words[3] = v.w;
    } else {
      static_assert(VEC == 4, "VEC is 4 or 16 bytes");
      words[0] = __ldg(reinterpret_cast<const int*>(row + col));
    }
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j)  // byte j, sign-extended from the top of the word
        w[4 * q + j] = static_cast<float>(
            static_cast<int>(static_cast<unsigned>(words[q]) << (24 - 8 * j)) >> 24);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[j] = col + j < ncols ? static_cast<float>(row[col + j]) : 0.f;
  }
}

// Adds the sums of the threads that share this thread's columns (lanes cg,
// cg + TPR, ... of the warp), then across warps through `red` (WARPS, R,
// WIDTH) fp32.  Ends with `red` filled by lanes 0..TPR-1 of every warp.
template <int R, int VEC, int TPR, int WIDTH>
__device__ __forceinline__ void reduce_to_shared(float (&acc)[R][VEC], float* red) {
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
  __syncthreads();  // the block is done with what shared memory held before
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < TPR) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * R + r) * WIDTH + lane * VEC + j] = acc[r][j];
  }
  __syncthreads();
}

// Pass 1: block c covers intermediate columns [32c, 32c + 32); writes h.
template <int R, int VEC>
__global__ void __launch_bounds__(THREADS) gateup_swiglu_kernel(
    const __nv_bfloat16* __restrict__ x, int rows, int K, const int8_t* __restrict__ gu_q,
    const float* __restrict__ gu_scale, int I, bool vec_ok, __nv_bfloat16* __restrict__ h) {
  constexpr int TPR = 2 * GU_COLS / VEC;  // threads per weight row: gate chunks, then up chunks
  constexpr int NRG = THREADS / TPR;      // weight rows in flight in the block
  constexpr int HALF = TPR / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // (R, K); rows >= `rows` zero
  float* red = reinterpret_cast<float*>(smem);                 // (WARPS, R, 2 GU_COLS), later

  for (int i = threadIdx.x; i < R * K; i += THREADS)
    xs[i] = i < rows * K ? x[i] : __float2bfloat16_rn(0.f);
  __syncthreads();

  const int cg = threadIdx.x % TPR, rg = threadIdx.x / TPR;
  const int c0 = blockIdx.x * GU_COLS;
  const int col = c0 + (cg % HALF) * VEC;
  const int8_t* base = gu_q + (cg < HALF ? 0 : I);
  const long long ld = 2LL * I;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

#pragma unroll 4
  for (int k = rg; k < K; k += NRG) {
    float w[VEC];
    load_int8<VEC>(base + k * ld, col, I, vec_ok, w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = __bfloat162float(xs[r * K + k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
    }
  }
  reduce_to_shared<R, VEC, TPR, 2 * GU_COLS>(acc, red);

  for (int i = threadIdx.x; i < R * GU_COLS; i += THREADS) {
    const int r = i / GU_COLS, j = i % GU_COLS, c = c0 + j;
    if (r >= rows || c >= I) continue;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      g += red[(w * R + r) * (2 * GU_COLS) + j];
      u += red[(w * R + r) * (2 * GU_COLS) + GU_COLS + j];
    }
    g = bf16_round(bf16_round(g) * bf16_round(gu_scale[c]));
    u = bf16_round(bf16_round(u) * bf16_round(gu_scale[I + c]));
    const float s = bf16_round(g / (1.f + expf(-g)));
    h[static_cast<long long>(r) * I + c] = __float2bfloat16_rn(s * u);
  }
}

// Pass 2: block (c, s) covers output columns [64c, 64c + 64) over the h
// columns (down rows) [s rps, (s + 1) rps); writes fp32 partials ws[s].
template <int R, int VEC>
__global__ void __launch_bounds__(THREADS) down_partial_kernel(
    const __nv_bfloat16* __restrict__ h, int rows, int I, const int8_t* __restrict__ down_q,
    int K, int rps, bool vec_ok, float* __restrict__ ws) {
  constexpr int TPR = DOWN_COLS / VEC;
  constexpr int NRG = THREADS / TPR;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);  // (R, rps)
  float* red = reinterpret_cast<float*>(smem);                 // (WARPS, R, DOWN_COLS), later

  const int s = blockIdx.y;
  const int k0 = s * rps;
  const int nk = min(I - k0, rps);
  for (int i = threadIdx.x; i < R * rps; i += THREADS) {
    const int r = i / rps, kk = i % rps;
    hs[i] = r < rows && kk < nk ? h[static_cast<long long>(r) * I + k0 + kk]
                                : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  const int cg = threadIdx.x % TPR, rg = threadIdx.x / TPR;
  const int c0 = blockIdx.x * DOWN_COLS;
  const int col = c0 + cg * VEC;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

#pragma unroll 4
  for (int kk = rg; kk < nk; kk += NRG) {
    float w[VEC];
    load_int8<VEC>(down_q + static_cast<long long>(k0 + kk) * K, col, K, vec_ok, w);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float hv = __bfloat162float(hs[r * rps + kk]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(hv, w[j], acc[r][j]);
    }
  }
  reduce_to_shared<R, VEC, TPR, DOWN_COLS>(acc, red);

  for (int i = threadIdx.x; i < R * DOWN_COLS; i += THREADS) {
    const int r = i / DOWN_COLS, j = i % DOWN_COLS, c = c0 + j;
    if (r >= rows || c >= K) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * R + r) * DOWN_COLS + j];
    ws[(static_cast<long long>(s) * rows + r) * K + c] = sum;
  }
}

// Pass 3: out = dt(dt(sum over slices, in order) * dt(sd)).
__global__ void __launch_bounds__(FINISH_THREADS) down_finish_kernel(
    const float* __restrict__ ws, int splits, int rows, int K, const float* __restrict__ down_scale,
    __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (i >= rows * K) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += ws[static_cast<long long>(s) * rows * K + i];
  out[i] = __float2bfloat16_rn(bf16_round(acc) * bf16_round(down_scale[i % K]));
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int R, int VEC>
cudaError_t run(const __nv_bfloat16* x, const int8_t* gu_q, const float* gu_scale,
                const int8_t* down_q, const float* down_scale, __nv_bfloat16* h, float* ws,
                __nv_bfloat16* out, int rows, int K, int I, int rps, cudaStream_t stream) {
  const bool aligned_gu = reinterpret_cast<uintptr_t>(gu_q) % 16 == 0 && I % VEC == 0;
  const bool aligned_down = reinterpret_cast<uintptr_t>(down_q) % 16 == 0 && K % VEC == 0;

  const size_t smem1 =
      std::max(sizeof(__nv_bfloat16) * R * K, sizeof(float) * WARPS * R * 2 * GU_COLS);
  cudaError_t err = allow_smem(gateup_swiglu_kernel<R, VEC>, smem1);
  if (err != cudaSuccess) return err;
  gateup_swiglu_kernel<R, VEC><<<(I + GU_COLS - 1) / GU_COLS, THREADS, smem1, stream>>>(
      x, rows, K, gu_q, gu_scale, I, aligned_gu, h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int splits = (I + rps - 1) / rps;
  const size_t smem2 =
      std::max(sizeof(__nv_bfloat16) * R * rps, sizeof(float) * WARPS * R * DOWN_COLS);
  if ((err = allow_smem(down_partial_kernel<R, VEC>, smem2)) != cudaSuccess) return err;
  down_partial_kernel<R, VEC><<<dim3((K + DOWN_COLS - 1) / DOWN_COLS, splits), THREADS, smem2,
                                stream>>>(h, rows, I, down_q, K, rps, aligned_down, ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  down_finish_kernel<<<(rows * K + FINISH_THREADS - 1) / FINISH_THREADS, FINISH_THREADS, 0,
                       stream>>>(ws, splits, rows, K, down_scale, out);
  return cudaGetLastError();
}

}  // namespace

// x (rows, K) bf16, gu_q (K, 2I) int8, gu_scale (2I,) fp32, down_q (I, K)
// int8, down_scale (K,) fp32, all contiguous; scratch h (rows, I) bf16 and
// ws (ceil(I / rows_per_split), rows, K) fp32; out (rows, K) bf16.  Three
// launches on `stream`; returns the first failing launch's cudaError_t, or
// cudaErrorInvalidValue without launching for rows outside 1..16.
extern "C" int int8_mlp_matvec_bf16(const void* x, const void* gu_q, const void* gu_scale,
                                    const void* down_q, const void* down_scale, void* h, void* ws,
                                    void* out, int rows, int K, int I, int rows_per_split,
                                    void* stream) {
  if (rows < 1 || rows > 16 || K < 1 || I < 1 || rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gq = static_cast<const int8_t*>(gu_q);
  const auto* gs = static_cast<const float*>(gu_scale);
  const auto* dq = static_cast<const int8_t*>(down_q);
  const auto* ds = static_cast<const float*>(down_scale);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  auto* wsf = static_cast<float*>(ws);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows == 1)
    err = run<1, 16>(xb, gq, gs, dq, ds, hb, wsf, ob, rows, K, I, rows_per_split, st);
  else if (rows <= 4)
    err = run<4, 16>(xb, gq, gs, dq, ds, hb, wsf, ob, rows, K, I, rows_per_split, st);
  else
    err = run<16, 4>(xb, gq, gs, dq, ds, hb, wsf, ob, rows, K, I, rows_per_split, st);
  return static_cast<int>(err);
}
