// Causal, left-pad-masked GQA prefill attention with an online softmax.
//
// Replaces the Pallas kernel `flash_attention_prefill` (`_flash_kernel`) of
// sparktts_tpu/kernels/flash_attention.py.  Same function: out[b, h, t] is
// softmax over keys c with start[b] <= c <= t of (q[b, h, t] . k[b, h/group, c])
// * sm_scale, applied to v.  Query rows with no valid key (left-pad rows,
// t < start[b]) are written as zeros; callers never read them.
//
// Design: one block of 256 threads per (64-row query tile, query head,
// batch row).  The query tile is held in shared memory in fp32, pre-scaled
// by sm_scale; 32-key K/V tiles stream through shared memory.  Each thread
// owns a 4x2 patch of the 64x32 score tile and a 4x4 patch of the 64x64
// output accumulator, which stays in registers across KV tiles.  Each warp
// runs the online softmax (running max, sum, rescale factor in fp32) for 8
// query rows, one lane per key.  KV tiles wholly above the causal diagonal
// or wholly before start[b] are never loaded.  Rows and keys past T and S
// are masked here, so any T works (the Pallas kernel needed T to divide
// into its tiles).  The KV head of query head h is h / group: KV heads are
// read in place, never repeated.
//
// What bounds it on an H100: at the main path's shapes (T = 64 or 128, 14
// query heads, head_dim 64, one batch row) the whole call moves well under a
// megabyte and does a few MFLOP, so it is bound by launch latency and by
// the 14 * ceil(T/64) blocks it gives the 132 SMs, not by bytes or FLOPs.
// The scalar FMA body is the simple, right start; mma/wgmma tiles and more
// blocks per head are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 32;       // keys per KV tile
constexpr int THREADS = 256;
constexpr float MASK_VALUE = -0.7f * 3.402823466e38f;

struct Strides {
  long long b, h, t;  // element strides; the head-dim stride is 1
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ start,
    __nv_bfloat16* __restrict__ out, int T, int S, int group, Strides qs, Strides ks,
    Strides vs, Strides os, float sm_scale) {
  __shared__ float Qs[BQ][D + 1];
  __shared__ float Ks[BK][D + 1];
  __shared__ float Vs[BK][D];
  __shared__ float Ps[BQ][BK + 1];
  __shared__ float m_s[BQ], l_s[BQ], alpha_s[BQ];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int st = start[b];

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, t = q0 + r;
    Qs[r][d] = t < T ? __bfloat162float(qb[t * qs.t + d]) * sm_scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // KV tiles that can hold a valid key for some row of this query tile
  const int last_row = min(q0 + BQ, T) - 1;
  const int j_lo = max(st, 0) / BK;
  const int j_hi = min(last_row, S - 1) / BK;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // Qs/stats ready; the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, c = k0 + r;
      const bool in = c < S;
      Ks[r][d] = in ? __bfloat162float(kb[c * ks.t + d]) : 0.f;
      Vs[r][d] = in ? __bfloat162float(vb[c * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 c
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = Ks[tx][d], k1v = Ks[tx + 16][d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[ty + 16 * i][d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool ok = col <= row && col >= st && col < S;
        Ps[ty + 16 * i][tx + 16 * c] = ok ? s[i][c] : MASK_VALUE;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, lane = key
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = warp * 8 + rr;
      const int row = q0 + r, col = k0 + lane;
      const bool ok = col <= row && col >= st && col < S;
      const float x = Ps[r][lane];
      const float m_prev = m_s[r];
      const float m_next = fmaxf(m_prev, warp_max(x));
      const float p = ok ? expf(x - m_next) : 0.f;
      const float sum = warp_sum(p);
      Ps[r][lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_next);
        alpha_s[r] = a;
        l_s[r] = l_s[r] * a + sum;
        m_s[r] = m_next;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: rows ty + 16 i, dims tx + 16 jj
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) vv[jj] = Vs[kk][tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[ty + 16 * i][kk];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(p, vv[jj], acc[i][jj]);
      }
    }
  }
  __syncthreads();  // l_s final (also when no tile ran)

  __nv_bfloat16* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= T) continue;
    const float l = l_s[r];
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ob[t * os.t + tx + 16 * jj] = __float2bfloat16(acc[i][jj] * inv);
  }
}

}  // namespace

// q (B, Hq, T, 64), k/v (B, Hkv, S, 64), out (B, Hq, T, 64): bf16 with the
// given element strides (head dim contiguous); start (B,) int32.
extern "C" int flash_attention_prefill_bf16(
    const void* q, const void* k, const void* v, const void* start, void* out, int B, int Hq,
    int Hkv, int T, int S, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_st, float sm_scale, void* stream) {
  const dim3 grid((T + BQ - 1) / BQ, Hq, B);
  flash_prefill_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(start),
      static_cast<__nv_bfloat16*>(out), T, S, Hq / Hkv, Strides{q_sb, q_sh, q_st},
      Strides{k_sb, k_sh, k_st}, Strides{v_sb, v_sh, v_st}, Strides{o_sb, o_sh, o_st},
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}
