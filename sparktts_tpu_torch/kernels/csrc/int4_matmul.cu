// Weight-only int4 matvec with group scales, for a few decode rows.
//
// Replaces the Pallas kernel `int4_matvec` (`_int4_matvec_kernel`) of
// sparktts_tpu/kernels/int4_matmul.py.  Same function:
//
//   out[b, o] = dt( sum over groups g, in order, of
//                   (sum_{i in g} x[b, i] * W[i, o]) * gscale[g, o] )
//
// with each group's partial dot in fp32 and dt = bf16 (x's dtype).  W is
// nibble-packed (in/2, out) int8: input row 2p is the low nibble of packed
// row p and row 2p+1 its high nibble, both sign-extended (the layout of
// `lm/quant.unpack_int4`).  Groups are `group` input rows along the
// contraction dim.  x is (B, in) with B <= 32.
//
// What bounds it on an H100: at B <= 32 it does 4B operations per packed
// byte, so it is bound by the bytes of the packed weights and their fp32
// group scales: 7.92 MB per layer of Qwen2.5-0.5B (qkv, o, gateup, down),
// 2.36 us at 3.35 TB/s.  Design:
//
// * One block per (64-column tile, group, tile of x rows), so the contraction
//   is split by groups as well as the columns by tiles: o and down have only
//   896 columns (14 tiles), and their 7 and 38 groups multiply the blocks to
//   98 and 532.  Each block also loads only its group's slice of x into
//   shared memory (down at B = 32 would need 311 KB for all of x).
// * A block sums its group's partial dot, reduces it across its threads
//   (warp shuffles, then warps in a fixed order), multiplies by the group's
//   scale and writes the product to an fp32 workspace (G, B, out).  A second
//   launch sums the groups in order g = 0, 1, ... and rounds to bf16: the
//   Pallas kernel's accumulation order, with no float atomics.
// * Within a block, TPR neighbouring threads cover the 64 columns of one
//   packed row with 16-byte loads (B = 1; 16 columns a thread) or 4-byte
//   loads (B > 1; 4 columns a thread, 8 x rows a tile), so a thread keeps at
//   most 32 sums.  Nibbles are unpacked in registers by shifts: the low one
//   by a left shift to the top of a 32-bit word and an arithmetic right
//   shift, which sign-extends.
// * Any out: columns past the edge read as zero, and rows that cannot take
//   an aligned vector load are read byte by byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 64;  // output columns per block
constexpr int FINISH_THREADS = 256;

// The nibbles of packed[col .. col + VEC) as sign-extended floats: lo (even
// input row) and hi (odd input row); columns at or past `ncols` read as 0.
template <int VEC>
__device__ __forceinline__ void load_int4(const int8_t* __restrict__ row, int col, int ncols,
                                          bool vec_ok, float (&lo)[VEC], float (&hi)[VEC]) {
  if (vec_ok && col + VEC <= ncols) {
    unsigned words[VEC / 4];
    if constexpr (VEC == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + col));
      words[0] = v.x;
      words[1] = v.y;
      words[2] = v.z;
      words[3] = v.w;
    } else {
      static_assert(VEC == 4, "VEC is 4 or 16 bytes");
      words[0] = __ldg(reinterpret_cast<const unsigned*>(row + col));
    }
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // byte j holds bits [8j, 8j + 8): low nibble [8j, 8j + 4), high [8j + 4, 8j + 8)
        lo[4 * q + j] = static_cast<float>(static_cast<int>(words[q] << (28 - 8 * j)) >> 28);
        hi[4 * q + j] = static_cast<float>(static_cast<int>(words[q] << (24 - 8 * j)) >> 28);
      }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int v = col + j < ncols ? row[col + j] : 0;  // sign-extended byte
      lo[j] = static_cast<float>(static_cast<int>(static_cast<unsigned>(v) << 28) >> 28);
      hi[j] = static_cast<float>(v >> 4);
    }
  }
}

// Block (c, g, z): columns [64c, 64c + 64), group g, x rows [z BT, z BT + BT).
template <int BT, int VEC>
__global__ void __launch_bounds__(THREADS) int4_group_kernel(
    const __nv_bfloat16* __restrict__ x, int B, int in_dim, const int8_t* __restrict__ packed,
    const float* __restrict__ gscale, int out_dim, int group, bool vec_ok,
    float* __restrict__ ws) {
  constexpr int TPR = COLS / VEC;     // threads per packed row
  constexpr int NRG = THREADS / TPR;  // packed rows in flight in the block
  extern __shared__ __align__(16) float smem[];
  const int half = group / 2;
  float2* xs = reinterpret_cast<float2*>(smem);  // (BT, half): x at input rows (2p, 2p + 1)
  float* red = smem + 2 * BT * half;             // (WARPS, BT, COLS)

  const int g = blockIdx.y, b0 = blockIdx.z * BT;
  for (int i = threadIdx.x; i < BT * half; i += THREADS) {
    const int r = i / half, p = i % half;
    float2 v = make_float2(0.f, 0.f);
    if (b0 + r < B) {
      const __nv_bfloat16* xr = x + static_cast<long long>(b0 + r) * in_dim + g * group + 2 * p;
      v = make_float2(__bfloat162float(xr[0]), __bfloat162float(xr[1]));
    }
    xs[i] = v;
  }
  __syncthreads();

  const int cg = threadIdx.x % TPR, rg = threadIdx.x / TPR;
  const int c0 = blockIdx.x * COLS;
  const int col = c0 + cg * VEC;
  const int8_t* rows = packed + static_cast<long long>(g) * half * out_dim;
  float part[BT][VEC];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[r][j] = 0.f;

#pragma unroll 2
  for (int p = rg; p < half; p += NRG) {
    float lo[VEC], hi[VEC];
    load_int4<VEC>(rows + static_cast<long long>(p) * out_dim, col, out_dim, vec_ok, lo, hi);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const float2 xv = xs[r * half + p];
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[r][j] = fmaf(xv.y, hi[j], fmaf(xv.x, lo[j], part[r][j]));
    }
  }

  // threads on the same columns: lanes cg, cg + TPR, ... of each warp, then the warps
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[r][j] += __shfl_xor_sync(0xffffffffu, part[r][j], off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < TPR) {
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * BT + r) * COLS + lane * VEC + j] = part[r][j];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BT * COLS; i += THREADS) {
    const int r = i / COLS, j = i % COLS, c = c0 + j;
    if (b0 + r >= B || c >= out_dim) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * BT + r) * COLS + j];
    ws[(static_cast<long long>(g) * B + b0 + r) * out_dim + c] =
        sum * gscale[static_cast<long long>(g) * out_dim + c];
  }
}

// acc = 0; acc += ws[g] for g in order; out = bf16(acc).
__global__ void __launch_bounds__(FINISH_THREADS) int4_finish_kernel(
    const float* __restrict__ ws, int groups, int n, __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int g = 0; g < groups; ++g) acc += ws[static_cast<long long>(g) * n + i];
  out[i] = __float2bfloat16_rn(acc);
}

template <int BT, int VEC>
cudaError_t run(const __nv_bfloat16* x, const int8_t* packed, const float* gscale, float* ws,
                __nv_bfloat16* out, int B, int in_dim, int out_dim, int groups,
                cudaStream_t stream) {
  const int group = in_dim / groups;
  const bool vec_ok = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && out_dim % VEC == 0;
  const size_t smem = sizeof(float) * (2 * BT * (group / 2) + WARPS * BT * COLS);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        int4_group_kernel<BT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((out_dim + COLS - 1) / COLS, groups, (B + BT - 1) / BT);
  int4_group_kernel<BT, VEC><<<grid, THREADS, smem, stream>>>(x, B, in_dim, packed, gscale,
                                                              out_dim, group, vec_ok, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * out_dim;
  int4_finish_kernel<<<(n + FINISH_THREADS - 1) / FINISH_THREADS, FINISH_THREADS, 0, stream>>>(
      ws, groups, n, out);
  return cudaGetLastError();
}

}  // namespace

// x (B, in) bf16, packed (in/2, out) int8, gscale (groups, out) fp32, all
// contiguous; scratch ws (groups, B, out) fp32; out (B, out) bf16.  Two
// launches on `stream`; returns the first failing launch's cudaError_t, or
// cudaErrorInvalidValue without launching when B is outside 1..32 or the
// groups do not split `in` into even sizes.
extern "C" int int4_matvec_bf16(const void* x, const void* packed, const void* gscale, void* ws,
                                void* out, int B, int in_dim, int out_dim, int groups,
                                void* stream) {
  if (B < 1 || B > 32 || out_dim < 1 || groups < 1 || in_dim % groups ||
      (in_dim / groups) % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pk = static_cast<const int8_t*>(packed);
  const auto* gs = static_cast<const float*>(gscale);
  auto* wsf = static_cast<float*>(ws);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      B == 1 ? run<1, 16>(xb, pk, gs, wsf, ob, B, in_dim, out_dim, groups, st)
             : run<8, 4>(xb, pk, gs, wsf, ob, B, in_dim, out_dim, groups, st);
  return static_cast<int>(err);
}
