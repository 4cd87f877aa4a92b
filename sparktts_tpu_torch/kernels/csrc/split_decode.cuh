// The split decode attention of kernels 2 and 6 (decode_attention.cu,
// paged_attention.cu).
//
// A split decode gives each block one chunk of CHUNK keys of one (row, KV
// head).  8 warps walk the chunk: a 128-byte key row is read by 8 lanes with
// one 16-byte load each, so a warp holds 4 keys and the block 32 key streams,
// and every K/V load of the chunk is issued before the first score is taken.
// The block scores all GROUP = 7 query heads of its KV head against each key
// (Qwen2.5-0.5B's 14 over 2), so KV bytes are read once per group.  Each
// stream keeps fp32 online-softmax state (running max in log2 units, sum,
// accumulator over its lane's 8 head dims); the 4 streams of a warp merge by
// shuffles, the 8 warps in shared memory.  A window inside one chunk is
// finished there.  Otherwise each block writes its partial (m, l, acc[7][64])
// in fp32 to scratch that the wrapper allocates and arrives on the integer
// counter of its (row, KV head); the last block to arrive merges the partials
// of every live chunk in chunk order.  One launch, no float atomics: the merge
// order is fixed, so repeated calls give bit-equal results.
//
// The counters and the rendezvous are arrivals.cuh's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "arrivals.cuh"

namespace split_decode {

constexpr int D = 64;
constexpr int GROUP = 7;  // query heads per KV head: Qwen2.5-0.5B has 14 over 2
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANES_PER_KEY = 8;                   // 8 lanes x 16 bytes = one 128-byte row
constexpr int DIMS = D / LANES_PER_KEY;            // head dims a lane holds: 8
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY;  // 4
constexpr int STREAMS = THREADS / LANES_PER_KEY;   // keys in flight per block: 32
constexpr int PARTIAL = GROUP * (D + 2);           // floats of one partial: m, l, acc
constexpr float LOG2E = 1.4426950408889634f;

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

// One block's chunk z of a split decode over the GROUP query heads of one
// KV head.  Local keys i in [lo, hi] of the chunk are valid; key_row(i) is
// the element offset of key i's 64-wide row in both k and v.  Live chunks
// are z_lo..z_hi; part_row is this (row, KV head)'s (chunks, PARTIAL) scratch
// and counter its arrival counter; orow receives the GROUP x D result.
template <int CHUNK, class KeyRow>
__device__ __forceinline__ void attend_chunk(
    const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, KeyRow key_row, int lo, int hi, int z, int z_lo,
    int z_hi, float* __restrict__ part_row, int* __restrict__ counter,
    __nv_bfloat16* __restrict__ orow, float scale_log2) {
  constexpr int ITERS = CHUNK / STREAMS;  // keys per stream
  static_assert(CHUNK % STREAMS == 0, "a chunk is a whole number of key batches");
  __shared__ float m_w[WARPS][GROUP];
  __shared__ float l_w[WARPS][GROUP];
  __shared__ float acc_w[WARPS][GROUP][D];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % LANES_PER_KEY;  // which 16 bytes of the row

  // issue every K/V load of this chunk first: local key i = it STREAMS +
  // warp KEYS_PER_WARP + lane / 8, valid inside [lo, hi]
  long long off[ITERS];
  bool valid[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = it * STREAMS + warp * KEYS_PER_WARP + lane / LANES_PER_KEY;
    valid[it] = i >= lo && i <= hi;
    off[it] = valid[it] ? key_row(i) + sub * DIMS : 0;
  }
  float kf[ITERS][DIMS], vf[ITERS][DIMS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    if (valid[it]) {
      load8(k + off[it], kf[it]);
      load8(v + off[it], vf[it]);
    } else {
#pragma unroll
      for (int i = 0; i < DIMS; ++i) kf[it][i] = vf[it][i] = 0.f;
    }
  }

  // this lane's 8 head dims of every query head in the group, pre-scaled
  float qf[GROUP][DIMS];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    load8(qg + g * D + sub * DIMS, qf[g]);
#pragma unroll
    for (int i = 0; i < DIMS; ++i) qf[g][i] *= scale_log2;
  }

  float m[GROUP], l[GROUP], acc[GROUP][DIMS];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DIMS; ++i) acc[g][i] = 0.f;
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    float s[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < DIMS; ++i) a = fmaf(qf[g][i], kf[it][i], a);
      s[g] = a;
    }
    // sum over the 8 lanes of the row (lanes differ in their low 3 bits);
    // every lane takes part, valid or not
#pragma unroll
    for (int o = LANES_PER_KEY / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GROUP; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);
    if (!valid[it]) continue;
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float m_next = fmaxf(m[g], s[g]);
      const float alpha = exp2f(m[g] - m_next);
      const float p = exp2f(s[g] - m_next);
      l[g] = fmaf(l[g], alpha, p);
#pragma unroll
      for (int i = 0; i < DIMS; ++i) acc[g][i] = fmaf(acc[g][i], alpha, p * vf[it][i]);
      m[g] = m_next;
    }
  }

  // merge the warp's four key streams (lanes 8 and 16 apart hold the same dims)
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    float M = m[g];
#pragma unroll
    for (int o = LANES_PER_KEY; o < 32; o <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float e = M == -INFINITY ? 0.f : exp2f(m[g] - M);
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

  // merge the warps' states into the chunk's (m, l, acc); a live chunk holds
  // at least one valid key, so M is finite and L > 0
  const bool single = z_lo == z_hi;
  float* pz = part_row + static_cast<long long>(z) * PARTIAL;
  for (int i = tid; i < GROUP * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_w[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = m_w[w][g] == -INFINITY ? 0.f : exp2f(m_w[w][g] - M);
      L = fmaf(l_w[w][g], e, L);
      A = fmaf(acc_w[w][g][d], e, A);
    }
    if (single) {
      orow[i] = __float2bfloat16(A / L);
    } else {
      pz[2 * GROUP + i] = A;
      if (d == 0) {
        pz[g] = M;
        pz[GROUP + g] = L;
      }
    }
  }
  if (single) return;

  // count this chunk in; the last of the live chunks merges them all in order
  if (!arrivals::arrive_last(counter, z_hi - z_lo + 1)) return;
  for (int i = tid; i < GROUP * D; i += THREADS) {
    const int g = i / D;
    float M = -INFINITY;
    for (int zz = z_lo; zz <= z_hi; ++zz) M = fmaxf(M, __ldcg(part_row + zz * PARTIAL + g));
    float L = 0.f, A = 0.f;
    for (int zz = z_lo; zz <= z_hi; ++zz) {
      const float* pp = part_row + zz * PARTIAL;
      const float e = exp2f(__ldcg(pp + g) - M);
      L = fmaf(__ldcg(pp + GROUP + g), e, L);
      A = fmaf(__ldcg(pp + 2 * GROUP + i), e, A);
    }
    orow[i] = __float2bfloat16(A / L);
  }
}

}  // namespace split_decode
