// One-token GQA decode attention over the stacked dense KV cache.
//
// Replaces the Pallas kernel `dense_decode_attention` (`_decode_kernel`) of
// sparktts_tpu/kernels/decode_attention.py.  Same function: for batch row b
// and query head h, softmax over the keys j in [start[b], pos[b]] of
// (q[b, h] . cache_k[layer, b, j, h / group]) * sm_scale, applied to
// cache_v.  An empty window (pos[b] < start[b]) gives zeros.
//
// Design: one block of 8 warps per (KV head, batch row).  The block reads
// its KV head once and scores all GROUP = 7 query heads of that KV head
// against each key (Qwen2.5-0.5B's 14 over 2), so KV bytes are read once per
// group, not once per query head.  The layer plane of the stacked
// (L, B, S, Hkv, D) cache is addressed by pointer arithmetic (no per-layer
// copy), and only keys inside the window are read: the GPU form of the
// Pallas kernel's clamped index map.  Warp w takes keys start + w, start + w
// + 8, ...; lane l holds head dims 2l and 2l+1, so one key row is one
// 128-byte coalesced load.  Each warp keeps its own online-softmax state in
// fp32 (running max, sum, accumulator); the 8 states are merged in shared
// memory at the end.  The TPU kernel's 8-row group padding and 128-lane
// scratch broadcasts have no counterpart.
//
// What bounds it on an H100: at batch 1 the grid is 2 blocks on 132 SMs, so
// the call is bound by launch latency and by one SM's latency per key, not
// by the few hundred KB of cache it reads.  Splitting the window across
// blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;
constexpr int GROUP = 7;  // query heads per KV head: Qwen2.5-0.5B has 14 over 2
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

__global__ void __launch_bounds__(THREADS) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache_k,
    const __nv_bfloat16* __restrict__ cache_v, const int* __restrict__ start,
    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, int layer, int B, int S,
    int Hkv, float sm_scale) {
  __shared__ float m_w[WARPS][GROUP];
  __shared__ float l_w[WARPS][GROUP];
  __shared__ float acc_w[WARPS][GROUP][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int Hq = Hkv * GROUP;

  // this lane's two head dims of every query head in the group, pre-scaled
  float q0[GROUP], q1[GROUP];
  const __nv_bfloat162* qrow =
      reinterpret_cast<const __nv_bfloat162*>(q + (static_cast<long long>(b) * Hq + h * GROUP) * D);
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    const float2 f = __bfloat1622float2(qrow[g * (D / 2) + lane]);
    q0[g] = f.x * sm_scale;
    q1[g] = f.y * sm_scale;
  }

  float m[GROUP], l[GROUP], a0[GROUP], a1[GROUP];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
    a0[g] = 0.f;
    a1[g] = 0.f;
  }

  const int lo = max(start[b], 0);
  const int hi = min(pos[b], S - 1);
  const long long plane = (static_cast<long long>(layer) * B + b) * S;  // row of key 0
  for (int j = lo + warp; j <= hi; j += WARPS) {
    const long long off = ((plane + j) * Hkv + h) * D;
    const float2 kf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(cache_k + off)[lane]);
    const float2 vf = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(cache_v + off)[lane]);
    float s[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) s[g] = fmaf(q0[g], kf.x, q1[g] * kf.y);
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 >>= 1)
#pragma unroll
      for (int g = 0; g < GROUP; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off2);
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float m_next = fmaxf(m[g], s[g]);
      const float alpha = expf(m[g] - m_next);
      const float p = expf(s[g] - m_next);
      l[g] = l[g] * alpha + p;
      a0[g] = fmaf(a0[g], alpha, p * vf.x);
      a1[g] = fmaf(a1[g], alpha, p * vf.y);
      m[g] = m_next;
    }
  }

#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    if (lane == 0) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
    acc_w[warp][g][2 * lane] = a0[g];
    acc_w[warp][g][2 * lane + 1] = a1[g];
  }
  __syncthreads();

  // merge the warps' states: out = sum_w acc_w e^(m_w - M) / sum_w l_w e^(m_w - M)
  for (int i = threadIdx.x; i < GROUP * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_w[w][g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float e = expf(m_w[w][g] - M);
        L = fmaf(l_w[w][g], e, L);
        A = fmaf(acc_w[w][g][d], e, A);
      }
    }
    const float o = L == 0.f ? 0.f : A / L;
    out[(static_cast<long long>(b) * Hq + h * GROUP + g) * D + d] = __float2bfloat16(o);
  }
}

}  // namespace

// q (B, Hq, 64) and out (B, Hq, 64) contiguous bf16; cache_k/v
// (L, B, S, Hkv, 64) contiguous bf16; start/pos (B,) int32.  Returns the
// launch's cudaError_t; Hq != 7 Hkv returns cudaErrorInvalidValue without
// launching.
extern "C" int dense_decode_attention_bf16(const void* q, const void* cache_k,
                                           const void* cache_v, const void* start,
                                           const void* pos, void* out, int layer, int B, int S,
                                           int Hkv, int Hq, float sm_scale, void* stream) {
  if (Hq != Hkv * GROUP) return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<<<dim3(Hkv, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache_k),
      static_cast<const __nv_bfloat16*>(cache_v), static_cast<const int*>(start),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), layer, B, S, Hkv,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}
