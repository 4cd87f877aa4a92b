// One-token GQA decode attention over a paged KV pool.
//
// Replaces the Pallas kernel `paged_decode_attention` (`_paged_kernel`) of
// sparktts_tpu/kernels/paged_attention.py.  Same function: for slot b and
// query head h, softmax over the keys j in [0, lengths[b]) of
// (q[b, h] . K[j]) * sm_scale, applied to V, where key j of slot b lies in
// page page_table[b, j / P] at offset j % P of the `layer` plane of the
// stacked (L, Hkv, n_pages, P, D) pools.  A slot whose length is 0 gives
// zeros.
//
// Design: one block of 8 warps per (KV head, slot), as in
// decode_attention.cu: the block reads its KV head once for all GROUP = 7
// query heads of that head (Qwen2.5-0.5B's 14 over 2).  The block walks only
// the slot's valid pages, p < min(ceil(len / P), pages_per_slot): the bound
// by the table's width keeps a finished slot whose length runs one past the
// table inside it.  Each page id is read once per page (one broadcast load)
// and nothing is gathered into device memory.  A key row of 64 bf16 is 128
// bytes: eight lanes read it with one 16-byte load each, so a warp holds four
// keys at a time and the block 32 key streams.  Each stream keeps its own
// fp32 online-softmax state (running max, sum, accumulator over its lane's 8
// head dims); the four streams of a warp merge by shuffles, the 8 warps in
// shared memory.  The TPU kernel's GQA padding to 8 sublanes, its 128-lane
// m/l scratch and its clamped (B, pages) grid have no counterpart.
//
// What bounds it on an H100: with 8 slots and 2 KV heads the grid is 16
// blocks on 132 SMs, and each layer reads ~512 bytes a valid key (K and V of
// two heads), about 2 MB at 500 keys a slot: 0.6 us at 3.35 TB/s.  So the call
// is bound by launch latency and by one SM's latency per key stream, not by
// bytes.  Splitting a slot's pages across blocks (flash-decoding) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int GROUP = 7;  // query heads per KV head: Qwen2.5-0.5B has 14 over 2
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANES_PER_KEY = 8;                   // 8 lanes x 16 bytes = one 128-byte row
constexpr int DIMS = D / LANES_PER_KEY;            // head dims a lane holds: 8
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY;  // 4
constexpr int STREAMS = THREADS / LANES_PER_KEY;   // keys in flight per block: 32

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[DIMS]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < DIMS / 2; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__global__ void __launch_bounds__(THREADS) paged_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, int layer, int Hkv,
    int n_pages, int P, int pps, float sm_scale) {
  __shared__ float m_w[WARPS][GROUP];
  __shared__ float l_w[WARPS][GROUP];
  __shared__ float acc_w[WARPS][GROUP][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % LANES_PER_KEY;  // which 16 bytes of the row
  const int Hq = Hkv * GROUP;

  // this lane's 8 head dims of every query head in the group, pre-scaled
  float qf[GROUP][DIMS];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    load8(q + (static_cast<long long>(b) * Hq + h * GROUP + g) * D + sub * DIMS, qf[g]);
#pragma unroll
    for (int i = 0; i < DIMS; ++i) qf[g][i] *= sm_scale;
  }

  float m[GROUP], l[GROUP], acc[GROUP][DIMS];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DIMS; ++i) acc[g][i] = 0.f;
  }

  const int len = max(lengths[b], 0);
  const int n_valid_pages = min((len + P - 1) / P, pps);
  const long long plane = (static_cast<long long>(layer) * Hkv + h) * n_pages;  // page 0 of this head
  for (int p = 0; p < n_valid_pages; ++p) {
    const int pid = page_table[b * pps + p];
    const int keys = min(P, len - p * P);
    const long long page = (plane + pid) * P;
    // the trip count is the warp's (j0), not the lane group's, so every lane
    // reaches the shuffles; a group past the page's last key only skips its
    // loads and its update
    for (int j0 = warp * KEYS_PER_WARP; j0 < keys; j0 += STREAMS) {
      const int j = j0 + lane / LANES_PER_KEY;
      const bool valid = j < keys;
      float kf[DIMS] = {}, vf[DIMS] = {};
      if (valid) {
        const long long off = (page + j) * D + sub * DIMS;
        load8(k_pages + off, kf);
        load8(v_pages + off, vf);
      }
      float s[GROUP];
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        float acc_s = 0.f;
#pragma unroll
        for (int i = 0; i < DIMS; ++i) acc_s = fmaf(qf[g][i], kf[i], acc_s);
        s[g] = acc_s;
      }
      // sum over the 8 lanes of the row (lanes differ in their low 3 bits)
#pragma unroll
      for (int o = LANES_PER_KEY / 2; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < GROUP; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
      if (!valid) continue;
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float m_next = fmaxf(m[g], s[g]);
        const float alpha = expf(m[g] - m_next);
        const float pr = expf(s[g] - m_next);
        l[g] = fmaf(l[g], alpha, pr);
#pragma unroll
        for (int i = 0; i < DIMS; ++i) acc[g][i] = fmaf(acc[g][i], alpha, pr * vf[i]);
        m[g] = m_next;
      }
    }
  }

  // merge the warp's four key streams (lanes 8 and 16 apart hold the same dims)
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    float M = m[g];
#pragma unroll
    for (int o = LANES_PER_KEY; o < 32; o <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float e = M == -INFINITY ? 0.f : expf(m[g] - M);
    float L = l[g] * e;
#pragma unroll
    for (int o = LANES_PER_KEY; o < 32; o <<= 1) L += __shfl_xor_sync(0xffffffffu, L, o);
#pragma unroll
    for (int i = 0; i < DIMS; ++i) {
      float a = acc[g][i] * e;
#pragma unroll
      for (int o = LANES_PER_KEY; o < 32; o <<= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[g][i] = a;
    }
    m[g] = M;
    l[g] = L;
  }
  if (lane < LANES_PER_KEY) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (lane == 0) {
        m_w[warp][g] = m[g];
        l_w[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DIMS; ++i) acc_w[warp][g][sub * DIMS + i] = acc[g][i];
    }
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

// q (B, Hq, 64) and out (B, Hq, 64) contiguous bf16; k_pages/v_pages
// (L, Hkv, n_pages, P, 64) contiguous bf16, 16-byte aligned; page_table
// (B, pps) and lengths (B,) contiguous int32.  Returns the launch's
// cudaError_t; Hq != 7 Hkv returns cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pages,
                                           const void* v_pages, const void* page_table,
                                           const void* lengths, void* out, int layer, int B,
                                           int Hkv, int Hq, int n_pages, int P, int pps,
                                           float sm_scale, void* stream) {
  if (Hq != Hkv * GROUP) return static_cast<int>(cudaErrorInvalidValue);
  paged_kernel<<<dim3(Hkv, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), layer, Hkv, n_pages,
      P, pps, sm_scale);
  return static_cast<int>(cudaGetLastError());
}
