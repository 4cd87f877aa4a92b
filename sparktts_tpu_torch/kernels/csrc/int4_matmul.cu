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
// 2.36 us at 3.35 TB/s.  A layer's four calls are small (0.4 to 4.4 MB), so
// each call's time is mostly latency: the launch, the weight round trip, the
// unpacking, the reductions, the ordered sum.  The design before this one
// took two launches a call (group partials, then their ordered sum) over 98
// to 1064 blocks of 4 KB each: 26.21 us a layer at B = 1 on an H100 80GB HBM3
// at 700.00 W.  Design, one launch a call with two layouts:
//
// * B = 1 (`int4_matvec_kernel`): a block owns a 64-column tile and a run of
//   consecutive groups (a K-split), two warps a group.  The run is all of a
//   layer's groups when a block holds them (up to 8: qkv, o and gate/up at
//   in = 896 have 7, one block of 14 warps a tile, two blocks an SM), else
//   one (down has 38: 38 blocks a tile).  Four lanes read a packed row's 64
//   bytes with 16-byte loads, so a lane has 4 rows of its group in flight,
//   all issued before the first product; the run's x is staged in shared
//   memory (bf16 pairs) meanwhile.
// * B > 1 (`int4_rows_kernel`, 8 rows of x a block): four warps share each
//   group's rows (4-byte loads, 8 rows a lane in flight, the next batch's
//   loads issued before this batch's products), with x staged in fp32
//   pairs, and the block walks its run of groups in turn.  The run is one
//   group, so that a tile's groups work side by side, unless the column
//   tiles alone give every SM four blocks (gate/up at B = 32): then all of
//   them.  At most 80 registers, six blocks an SM.
// * A group's partial dot is reduced across a row's lanes by shuffles,
//   across its warps in shared memory, in a fixed order, and scaled by the
//   group's scales.  With one run the block then adds the groups in order
//   g = 0, 1, ... and rounds to bf16.  With several, each block writes its
//   scaled partials to the fp32 workspace (G, B, out), arrives on its column
//   tile's counter (arrivals.cuh's `arrive_last`, counters from
//   kernels/arrivals.py), and the last block of the tile sums the workspace
//   over g = 0, 1, ... in order.  Either way the sum starts from 0 and adds
//   the groups in order, the Pallas kernel's accumulation order, with no
//   float atomics: repeats are bit-equal.
// * Any out: columns past the edge read as zero, and rows that cannot take
//   an aligned vector load are read byte by byte.  Groups of any even size:
//   rows past a group's end are masked.
//
// Measured with scripts/bench_torch_paged_int4.py (H100 80GB HBM3, 700.00 W;
// device time per call in a CUDA graph, 24 layers' random weights in turn;
// the two-launch design before this one timed in the same run with
// `--tree`): qkv / o / gate-up / down at B = 1 4.27 / 4.27 / 7.34 / 6.68 us,
// 22.6 a layer (before: 26.1); at B = 8 6.27 / 6.20 / 14.28 / 11.71, 38.5
// (before: 43.8); at B = 32 8.50 / 7.78 / 37.40 / 24.89, 78.6 (before:
// 80.2).  Down is 3-7% slower than before at B > 1: one block of each tile
// sums its 38 groups.  One tiny elementwise kernel takes 1.1 us a call in
// the same harness, and the library's int4 matmul (`torch._weight_int4pack_mm`,
// on the tensor cores) 2.42 / 2.29 / 5.37 / 5.10 at B = 1, 15.2 a layer:
// faster.  What is left at B = 1 is the unpacking and the FMAs on CUDA
// cores, on the 18 and 14 SMs of qkv's and o's tiles.  Tried and rejected:
// at B = 1 one warp per group, nibbles turned into floats through the
// mantissa of 2^23, a K-split merged across a thread-block cluster and the
// last block's ordered sum unrolled by 8; at B > 1 two or four groups a
// block side by side, runs of 2 to 13 groups walked in turn, x kept in
// bf16 pairs, the 2^23 conversion, the last block's sum fed by cp.async or
// with 8 groups' loads in flight, and budgets of 64, 96 and 128 registers:
// each slower on most shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arrivals.cuh"

#ifndef INT4_RUN
#define INT4_RUN 0  // groups a block at B > 1: 0 is the kernel's own choice (a bench builds others)
#endif

namespace {

constexpr int COLS = 64;  // output columns per block
// B = 1: 16-byte loads, WPG warps a group, KB1 rows a lane in flight, up to
// RUN1 groups a block (512 threads; two blocks an SM).
constexpr int VEC1 = 16, WPG = 2, KB1 = 4, RUN1 = 8;
// B > 1: RT rows of x a block, 4-byte loads, RWARPS warps that walk the
// block's groups in turn, RKB packed rows a lane in flight; at most 80
// registers, so that ROWS_PER_SM blocks fit an SM.
constexpr int RT = 8, RVEC = 4, RWARPS = 4, RKB = 8, ROWS_PER_SM = 6;
constexpr int RTHREADS = 32 * RWARPS;

// The packed bytes row[col .. col + VEC) as VEC / 4 little-endian words;
// columns at or past `ncols` read as 0.
template <int VEC>
__device__ __forceinline__ void load_raw(const int8_t* __restrict__ row, int col, int ncols,
                                         bool vec_ok, unsigned (&w)[VEC / 4]) {
  if (vec_ok && col + VEC <= ncols) {
    if constexpr (VEC == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + col));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
      static_assert(VEC == 4, "VEC is 4 or 16 bytes");
      w[0] = __ldg(reinterpret_cast<const unsigned*>(row + col));
    }
  } else {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col + 4 * q + j;
        if (c < ncols) word |= static_cast<unsigned>(static_cast<uint8_t>(row[c])) << (8 * j);
      }
      w[q] = word;
    }
  }
}

// part[r][0 .. VEC) += one packed row's VEC columns (raw words) times its x
// pairs (BT rows of x, staged as bf16 pairs `xstride` apart).  Byte j of a
// word holds bits [8j, 8j + 8): the low nibble (even input row) is taken by a
// left shift to the top of the word and an arithmetic right shift, which
// sign-extends; the high nibble (odd input row) likewise.
__device__ __forceinline__ float2 as_float2(const __nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 as_float2(const float2 v) { return v; }

template <int BT, int VEC, class XP>
__device__ __forceinline__ void fma_row(const unsigned (&raw)[VEC / 4],
                                        const XP* xp, int xstride,
                                        float (&part)[BT][VEC]) {
  float lo[VEC], hi[VEC];
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[4 * q + j] = static_cast<float>(static_cast<int>(raw[q] << (28 - 8 * j)) >> 28);
      hi[4 * q + j] = static_cast<float>(static_cast<int>(raw[q] << (24 - 8 * j)) >> 28);
    }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const float2 xv = as_float2(xp[r * xstride]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[r][j] = fmaf(xv.y, hi[j], fmaf(xv.x, lo[j], part[r][j]));
  }
}

// The last block of a column tile to arrive: out[b0 + r, c] = bf16 of the
// sum over g = 0, 1, ... of ws[g, b0 + r, c], for the tile's NR x COLS
// outputs, THREADS threads.  Each thread's outputs side by side, so their
// loads are in flight together; an output past the edge reads element 0
// and is not stored.
template <int NR, int THREADS>
__device__ __forceinline__ void sum_groups_in_order(const float* __restrict__ ws, int groups,
                                                    int B, int out_dim, int b0, int c0,
                                                    __nv_bfloat16* __restrict__ out) {
  constexpr int N = NR * COLS;
  constexpr int PER = (N + THREADS - 1) / THREADS;  // outputs a thread, at most
  const long long stride = static_cast<long long>(B) * out_dim;
  long long at[PER];
  bool keep[PER];
  float acc[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = threadIdx.x + m * THREADS;
    const int r = i / COLS, c = c0 + i % COLS;
    keep[m] = i < N && b0 + r < B && c < out_dim;
    at[m] = keep[m] ? static_cast<long long>(b0 + r) * out_dim + c : 0;
    acc[m] = 0.f;
  }
  for (int k = 0; k < groups; ++k)
#pragma unroll
    for (int m = 0; m < PER; ++m) acc[m] += __ldcg(ws + k * stride + at[m]);
#pragma unroll
  for (int m = 0; m < PER; ++m)
    if (keep[m]) out[at[m]] = __float2bfloat16_rn(acc[m]);
}

// B = 1.  Block (c, y): columns [64c, 64c + 64), groups [y run, y run + run)
// (WPG warps each).  VEC packed bytes a lane; KB rows a lane in flight.
__global__ void __launch_bounds__(32 * WPG * RUN1, 2) int4_matvec_kernel(
    const __nv_bfloat16* __restrict__ x, int B, int in_dim, const int8_t* __restrict__ packed,
    const float* __restrict__ gscale, int out_dim, int groups, int group, int run, bool vec_ok,
    float* __restrict__ ws, int* __restrict__ arrivals, __nv_bfloat16* __restrict__ out) {
  constexpr int BT = 1, VEC = VEC1, KB = KB1, GMAX = RUN1;
  static_assert(WPG >= 2, "a block's thread count is then a multiple of COLS");
  constexpr int TPR = COLS / VEC;    // lanes per packed row
  constexpr int RPW = 32 / TPR;      // packed rows per warp instruction
  constexpr int RG = RPW * WPG;      // packed rows of a group per step of its warps
  constexpr int WORDS = VEC / 4;
  constexpr int N = BT * COLS;       // outputs of the block
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = group / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cgl = lane % TPR, rr = lane / TPR;
  const int c0 = blockIdx.x * COLS, col = c0 + cgl * VEC;
  const int b0 = 0;
  const int g0 = blockIdx.y * run;
  const int ng = min(run, groups - g0);     // groups of this block
  const int gi = warp / WPG, sub = warp % WPG;  // this warp's group in the run, its share
  const int g = g0 + gi;
  const bool active = gi < ng;              // warp-uniform
  // (run, BT, half) bf16 pairs of x | (warps, BT, COLS) warp sums
  __nv_bfloat162* xs = reinterpret_cast<__nv_bfloat162*>(smem);
  float* red = reinterpret_cast<float*>(smem + sizeof(__nv_bfloat162) * run * BT * half);

  // this warp's rows of its group: p = (k RG + sub RPW + rr), k = 0, 1, ...
  const int8_t* rows = packed + static_cast<long long>(g) * half * out_dim;
  const int steps = (half + RG - 1) / RG;
  unsigned raw[KB][WORDS];
  auto issue = [&](int k0) {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const int p = (k0 + k) * RG + sub * RPW + rr;
      if (active && k0 + k < steps && p < half) {
        load_raw<VEC>(rows + static_cast<long long>(p) * out_dim, col, out_dim, vec_ok, raw[k]);
      } else {
#pragma unroll
        for (int q = 0; q < WORDS; ++q) raw[k][q] = 0u;
      }
    }
  };
  issue(0);
  // the scales of this thread's output column (blockDim.x is a multiple of COLS)
  const int my_col = c0 + threadIdx.x % COLS;
  float gsv[GMAX];
#pragma unroll
  for (int k = 0; k < GMAX; ++k)
    gsv[k] = k < ng && my_col < out_dim
                 ? __ldg(gscale + static_cast<long long>(g0 + k) * out_dim + my_col)
                 : 0.f;
  // the run's x, as (x[2p], x[2p + 1]) pairs; rows past B are 0
  for (int i = threadIdx.x; i < ng * BT * half; i += blockDim.x) {
    const int gx = i / (BT * half), r = i / half % BT, p = i % half;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (b0 + r < B) {
      const __nv_bfloat16* xr =
          x + static_cast<long long>(b0 + r) * in_dim + (g0 + gx) * group + 2 * p;
      v.x = xr[0];
      v.y = xr[1];
    }
    xs[i] = v;
  }
  __syncthreads();

  float part[BT][VEC];
#pragma unroll
  for (int r = 0; r < BT; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) part[r][j] = 0.f;
  if (active) {
    const __nv_bfloat162* xg = xs + gi * BT * half;
    for (int k0 = 0;;) {
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int p = (k0 + k) * RG + sub * RPW + rr;
        if (k0 + k < steps && p < half) fma_row<BT, VEC>(raw[k], xg + p, half, part);
      }
      k0 += KB;
      if (k0 >= steps) break;
      issue(k0);
    }
  }
  // lanes on the same columns (cgl, cgl + TPR, ...): sum into the lanes rr == 0
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[r][j] += __shfl_xor_sync(0xffffffffu, part[r][j], off);
  if (rr == 0) {
#pragma unroll
    for (int r = 0; r < BT; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[(warp * BT + r) * COLS + cgl * VEC + j] = part[r][j];
  }
  __syncthreads();

  // each group's partial: its warps' sums in order, times its scales; then
  // the groups in order, here (one run) or by the tile's last block
  const bool one_run = gridDim.y == 1;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {  // i % COLS == threadIdx.x % COLS
    const int r = i / COLS, c = c0 + i % COLS;
    if (b0 + r >= B || c >= out_dim) continue;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < GMAX; ++k) {
      if (k >= ng) break;
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < WPG; ++s) sum += red[(k * WPG + s) * N + i];
      if (one_run) {
        acc += sum * gsv[k];
      } else {
        ws[(static_cast<long long>(g0 + k) * B + b0 + r) * out_dim + c] = sum * gsv[k];
      }
    }
    if (one_run) out[static_cast<long long>(b0 + r) * out_dim + c] = __float2bfloat16_rn(acc);
  }
  if (one_run) return;
  if (!arrivals::arrive_last(arrivals + blockIdx.x, gridDim.y)) return;
  sum_groups_in_order<BT, 32 * WPG>(ws, groups, B, out_dim, b0, c0, out);
}

// B > 1.  Block (c, y, z): columns [64c, 64c + 64), groups [y run, y run +
// run), x rows [z RT, z RT + RT).  The RWARPS warps share each group's rows
// and walk the groups in turn; each batch of RKB rows a lane is loaded while
// the batch before it is multiplied.  A group's partial is summed across
// lanes and warps in a fixed order and scaled; with one run the block adds
// the groups in order, else it writes them to the workspace and the tile's
// last block adds them.
__global__ void __launch_bounds__(RTHREADS, ROWS_PER_SM) int4_rows_kernel(
    const __nv_bfloat16* __restrict__ x, int B, int in_dim, const int8_t* __restrict__ packed,
    const float* __restrict__ gscale, int out_dim, int groups, int group, int run, bool vec_ok,
    float* __restrict__ ws, int* __restrict__ arrivals, __nv_bfloat16* __restrict__ out) {
  constexpr int TPR = COLS / RVEC;   // lanes per packed row: 16
  constexpr int RPW = 32 / TPR;      // packed rows per warp instruction: 2
  constexpr int RG = RPW * RWARPS;   // packed rows of a group per step of the block: 8
  constexpr int N = RT * COLS;       // outputs of the block
  constexpr int PER = N / RTHREADS;  // outputs a thread
  static_assert(TPR == 16 && N % RTHREADS == 0 && RTHREADS % COLS == 0,
                "one shuffle joins a row's lanes; a thread's outputs share one column");
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = group / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cgl = lane % TPR, rr = lane / TPR;
  const int c0 = blockIdx.x * COLS, col = c0 + cgl * RVEC;
  const int b0 = blockIdx.z * RT;
  const int g0 = blockIdx.y * run;
  const int ng = min(run, groups - g0);         // groups of this block
  const int steps = (half + RG - 1) / RG;       // steps of a group
  const int batches = (steps + RKB - 1) / RKB;  // load batches of a group
  const int total = ng * batches;
  const int my_col = c0 + threadIdx.x % COLS;   // the column of this thread's outputs
  const int xstride = ng * half;                // pairs of x a row of the block holds
  // (RT, ng half) pairs of x in fp32 | (RWARPS, N) warp sums
  float2* xs = reinterpret_cast<float2*>(smem);
  float* red = reinterpret_cast<float*>(smem + sizeof(float2) * RT * xstride);

  // batch j: group j / batches of the run, its steps from (j % batches) RKB
  auto issue = [&](int j, unsigned (&raw)[RKB][1]) {
    const int k0 = j % batches * RKB;
    const int8_t* rows = packed + static_cast<long long>(g0 + j / batches) * half * out_dim;
#pragma unroll
    for (int k = 0; k < RKB; ++k) {
      const int p = (k0 + k) * RG + warp * RPW + rr;
      raw[k][0] = 0u;
      if (k0 + k < steps && p < half)
        load_raw<RVEC>(rows + static_cast<long long>(p) * out_dim, col, out_dim, vec_ok, raw[k]);
    }
  };
  unsigned cur[RKB][1], nxt[RKB][1] = {};
  issue(0, cur);
  // the run's inputs [g0 group, (g0 + ng) group) of each row of x, as pairs
  // (x[2q], x[2q + 1]), with 16-byte loads where aligned; rows past B are 0
  const long long xoff = static_cast<long long>(g0) * group;
  if (in_dim % 8 == 0 && xoff % 8 == 0 && xstride % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int nv = xstride / 4;  // 16-byte vectors a row
#pragma unroll 4
    for (int i = threadIdx.x; i < RT * nv; i += RTHREADS) {
      const int r = i / nv, v = i % nv;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (b0 + r < B)
        val = __ldg(reinterpret_cast<const uint4*>(x + static_cast<long long>(b0 + r) * in_dim +
                                                   xoff) + v);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&val);
      const float2 p0 = __bfloat1622float2(h[0]), p1 = __bfloat1622float2(h[1]);
      const float2 p2 = __bfloat1622float2(h[2]), p3 = __bfloat1622float2(h[3]);
      float4* dst = reinterpret_cast<float4*>(xs + r * xstride) + 2 * v;
      dst[0] = make_float4(p0.x, p0.y, p1.x, p1.y);
      dst[1] = make_float4(p2.x, p2.y, p3.x, p3.y);
    }
  } else {
    for (int i = threadIdx.x; i < RT * xstride; i += RTHREADS) {
      const int r = i / xstride, q = i % xstride;
      float2 v = make_float2(0.f, 0.f);
      if (b0 + r < B) {
        const __nv_bfloat16* xr = x + static_cast<long long>(b0 + r) * in_dim + xoff + 2 * q;
        v = make_float2(__bfloat162float(xr[0]), __bfloat162float(xr[1]));
      }
      xs[i] = v;
    }
  }
  __syncthreads();

  const bool one_run = gridDim.y == 1;
  float part[RT][RVEC], acc[PER];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int jj = 0; jj < RVEC; ++jj) part[r][jj] = 0.f;
#pragma unroll
  for (int m = 0; m < PER; ++m) acc[m] = 0.f;
  float scale = 0.f;
  for (int j = 0; j < total; ++j) {  // block-uniform
    const int gi = j / batches, k0 = j % batches * RKB;
    if (k0 == 0 && my_col < out_dim)
      scale = __ldg(gscale + static_cast<long long>(g0 + gi) * out_dim + my_col);
    if (j + 1 < total) issue(j + 1, nxt);
    const float2* xg = xs + gi * half;
#pragma unroll
    for (int k = 0; k < RKB; ++k) {
      const int p = (k0 + k) * RG + warp * RPW + rr;
      if (k0 + k < steps && p < half)
        fma_row<RT, RVEC>(cur[k], xg + p, xstride, part);
    }
#pragma unroll
    for (int k = 0; k < RKB; ++k) cur[k][0] = nxt[k][0];
    if (k0 + RKB < steps) continue;  // the group goes on in the next batch
    // the group's partial: a row's two lanes, then the warps in order
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int jj = 0; jj < RVEC; ++jj) {
        const float v = part[r][jj] + __shfl_xor_sync(0xffffffffu, part[r][jj], 16);
        if (rr == 0) red[(warp * RT + r) * COLS + cgl * RVEC + jj] = v;
        part[r][jj] = 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int i = threadIdx.x + m * RTHREADS;  // i % COLS == threadIdx.x % COLS
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < RWARPS; ++w) sum += red[w * N + i];
      if (one_run) {
        acc[m] += sum * scale;
      } else if (b0 + i / COLS < B && my_col < out_dim) {
        ws[(static_cast<long long>(g0 + gi) * B + b0 + i / COLS) * out_dim + my_col] =
            sum * scale;
      }
    }
    __syncthreads();  // red is written again for the next group
  }
  if (one_run) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int r = (threadIdx.x + m * RTHREADS) / COLS;
      if (b0 + r < B && my_col < out_dim)
        out[static_cast<long long>(b0 + r) * out_dim + my_col] = __float2bfloat16_rn(acc[m]);
    }
    return;
  }
  if (!arrivals::arrive_last(arrivals + blockIdx.z * gridDim.x + blockIdx.x, gridDim.y))
    return;
  sum_groups_in_order<RT, RTHREADS>(ws, groups, B, out_dim, b0, c0, out);
}

cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem + 1024 <= 48 * 1024) return cudaSuccess;  // the static shared memory counts too
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// B = 1: all the groups in one block when it holds them (qkv, o and gate/up
// at in = 896 have 7), else one group a block.
cudaError_t launch_one_row(const __nv_bfloat16* x, const int8_t* packed, const float* gscale,
                           float* ws, int* arrivals, __nv_bfloat16* out, int in_dim,
                           int out_dim, int groups, cudaStream_t stream) {
  const int group = in_dim / groups;
  const int run = groups <= RUN1 ? groups : 1;
  const bool vec_ok = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && out_dim % VEC1 == 0;
  const int threads = run * WPG * 32;
  const size_t smem = sizeof(__nv_bfloat162) * run * (group / 2) + sizeof(float) * threads / 32 * COLS;
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(int4_matvec_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((out_dim + COLS - 1) / COLS, (groups + run - 1) / run);
  int4_matvec_kernel<<<grid, threads, smem, stream>>>(x, 1, in_dim, packed, gscale, out_dim,
                                                      groups, group, run, vec_ok, ws, arrivals,
                                                      out);
  return cudaGetLastError();
}

// B > 1: groups a block.  One, so that the blocks of a column tile work
// side by side, unless the tiles alone (`blocks`, the grid at a run of all
// the groups) give every SM four: then all of them, walked in turn with no
// workspace and no merge (gate/up at B = 32).
int rows_run(int groups, int blocks) {
  if (INT4_RUN > 0) return INT4_RUN < groups ? INT4_RUN : groups;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return blocks >= 4 * sms ? groups : 1;
}

cudaError_t launch_rows(const __nv_bfloat16* x, const int8_t* packed, const float* gscale,
                        float* ws, int* arrivals, __nv_bfloat16* out, int B, int in_dim,
                        int out_dim, int groups, cudaStream_t stream) {
  const int group = in_dim / groups;
  const int tiles = (out_dim + COLS - 1) / COLS, row_tiles = (B + RT - 1) / RT;
  const int run = rows_run(groups, tiles * row_tiles);
  const bool vec_ok = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && out_dim % RVEC == 0;
  const size_t smem =
      sizeof(float2) * run * RT * (group / 2) + sizeof(float) * RWARPS * RT * COLS;
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(int4_rows_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (groups + run - 1) / run, row_tiles);
  int4_rows_kernel<<<grid, RTHREADS, smem, stream>>>(x, B, in_dim, packed, gscale, out_dim,
                                                     groups, group, run, vec_ok, ws, arrivals,
                                                     out);
  return cudaGetLastError();
}

}  // namespace

// x (B, in) bf16, packed (in/2, out) int8, gscale (groups, out) fp32, all
// contiguous; scratch ws (groups, B, out) fp32, used when the groups take
// more than one run; arrivals int32, at least ceil(out / 64) ceil(B / 8)
// of them, all 0 before the launch and left 0 after it; out (B, out) bf16.
// One launch on `stream`; returns its cudaError_t, or cudaErrorInvalidValue
// without launching when B is outside 1..32 or the groups do not split `in`
// into even sizes.
extern "C" int int4_matvec_bf16(const void* x, const void* packed, const void* gscale, void* ws,
                                void* arrivals, void* out, int B, int in_dim, int out_dim,
                                int groups, void* stream) {
  if (B < 1 || B > 32 || out_dim < 1 || groups < 1 || in_dim % groups ||
      (in_dim / groups) % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* pk = static_cast<const int8_t*>(packed);
  const auto* gs = static_cast<const float*>(gscale);
  auto* wsf = static_cast<float*>(ws);
  auto* arr = static_cast<int*>(arrivals);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      B == 1 ? launch_one_row(xb, pk, gs, wsf, arr, ob, in_dim, out_dim, groups, st)
             : launch_rows(xb, pk, gs, wsf, arr, ob, B, in_dim, out_dim, groups, st);
  return static_cast<int>(err);
}
