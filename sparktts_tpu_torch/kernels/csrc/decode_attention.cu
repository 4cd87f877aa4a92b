// One-token GQA decode attention over the stacked dense KV cache, with the
// key window split across blocks (flash-decoding).
//
// Replaces the Pallas kernel `dense_decode_attention` (`_decode_kernel`) of
// sparktts_tpu/kernels/decode_attention.py.  Same function: for batch row b
// and query head h, softmax over the keys j in [start[b], min(pos[b], S-1)]
// of (q[b, h] . cache_k[layer, b, j, h / group]) * sm_scale, applied to
// cache_v.  An empty window (pos[b] < start[b]) gives zeros.
//
// Design: the grid is (KV head, batch row, split), with one split for each
// CHUNK keys of the cache: splits = ceil(S / CHUNK), known to the host
// without reading the device, so a launch stays valid inside a CUDA graph.
// A block whose chunk lies outside the row's window exits at once.  Inside a
// block, 8 warps walk the chunk as kernel 6 (paged_attention.cu) walks a
// page: a 128-byte key row is read by 8 lanes with one 16-byte load each, so
// a warp holds 4 keys and the block 32 key streams, and every load of the
// chunk is issued before the first score is taken.  The block scores all
// GROUP = 7 query heads of its KV head against each key (Qwen2.5-0.5B's 14
// over 2), so KV bytes are read once per group.  Each stream keeps fp32
// online-softmax state (running max in log2 units, sum, accumulator over its
// lane's 8 head dims); the 4 streams of a warp merge by shuffles, the 8 warps
// in shared memory.  A window inside one chunk is finished there.  Otherwise
// each block writes its partial (m, l, acc[7][64]) in fp32 to scratch that
// the wrapper allocates, and counts its arrival on an integer counter of its
// (row, KV head).  The last block to arrive merges the partials of every
// live chunk in chunk order and resets the counter to 0, so the next launch
// (and a graph replay) finds it clean.  One launch, no float atomics: the
// merge order is fixed, so repeated calls give bit-equal results.  The
// layer plane of the (L, B, S, Hkv, D) cache is addressed in place.
//
// What bounds it on an H100: a call reads 512 bytes of K and V for each
// valid key (two KV heads): at S = 960 with 669 keys, 0.34 MB, a bound of
// 0.10 us.  So the time is latency: the launch, one load round trip per
// chunk, the two merges.  Splitting gives ceil(window / CHUNK) blocks per
// (row, KV head), so every chunk's loads are in flight at once, and the
// serial part left is the merge of at most S / CHUNK partials.
//
// Measured (chip_smoke.py, H100 80GB HBM3, 700.00 W; device time in a CUDA
// graph): B = 1, S = 960, 669 keys, 9.72 us against 52.3 for the design
// this replaces (one block per (KV head, row), one key per warp at a time)
// and 11.11 for SDPA; B = 1, S = 576, 294 keys, 7.97 us against 24.2 and
// 10.81; the dense engine's 8 rows after its first dispatch (S = 960, 1078
// keys) 8.25 us against 54.3 (its trace) and 11.79.  171 registers, 14,788
// bytes of shared memory, no spills.  CHUNK = 64 was chosen with
// scripts/bench_torch_decode_chunk.py (creation, cloning, 8 engine-like
// rows): 32 keys 8.69 / 11.65 / 15.32 us, 64 keys 7.90 / 9.71 / 11.29, 128
// keys 8.72 / 9.91 / 9.55 (241 registers): 64 is fastest at B = 1, where
// the pipeline decodes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef DECODE_CHUNK
#define DECODE_CHUNK 64
#endif

namespace {

constexpr int D = 64;
constexpr int GROUP = 7;  // query heads per KV head: Qwen2.5-0.5B has 14 over 2
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LANES_PER_KEY = 8;                   // 8 lanes x 16 bytes = one 128-byte row
constexpr int DIMS = D / LANES_PER_KEY;            // head dims a lane holds: 8
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY;  // 4
constexpr int STREAMS = THREADS / LANES_PER_KEY;   // keys in flight per block: 32
constexpr int CHUNK = DECODE_CHUNK;                // keys per split
constexpr int ITERS = CHUNK / STREAMS;             // keys per stream
constexpr int PARTIAL = GROUP * (D + 2);           // floats of one partial: m, l, acc
constexpr float LOG2E = 1.4426950408889634f;
static_assert(CHUNK % STREAMS == 0, "a chunk is a whole number of key batches");

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

__global__ void __launch_bounds__(THREADS) split_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache_k,
    const __nv_bfloat16* __restrict__ cache_v, const int* __restrict__ start,
    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ arrivals, int layer, int B, int S, int Hkv, float scale_log2) {
  __shared__ float m_w[WARPS][GROUP];
  __shared__ float l_w[WARPS][GROUP];
  __shared__ float acc_w[WARPS][GROUP][D];
  __shared__ int is_last;

  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sub = lane % LANES_PER_KEY;  // which 16 bytes of the row
  const int Hq = Hkv * GROUP;
  __nv_bfloat16* orow = out + (static_cast<long long>(b) * Hq + h * GROUP) * D;

  const int lo = max(start[b], 0);
  const int hi = min(pos[b], S - 1);
  if (hi < lo) {  // empty window: zeros, written by split 0
    if (z == 0)
      for (int i = tid; i < GROUP * D; i += THREADS) orow[i] = __float2bfloat16(0.f);
    return;
  }
  const int z_lo = lo / CHUNK, z_hi = hi / CHUNK;
  if (z < z_lo || z > z_hi) return;

  // issue every K/V load of this chunk first: key j = z CHUNK + it STREAMS +
  // warp KEYS_PER_WARP + lane / 8, valid inside [lo, hi]
  const long long plane = (static_cast<long long>(layer) * B + b) * S;  // row of key 0
  float kf[ITERS][DIMS], vf[ITERS][DIMS];
  bool valid[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int j = z * CHUNK + it * STREAMS + warp * KEYS_PER_WARP + lane / LANES_PER_KEY;
    valid[it] = j >= lo && j <= hi;
    if (valid[it]) {
      const long long off = ((plane + j) * Hkv + h) * D + sub * DIMS;
      load8(cache_k + off, kf[it]);
      load8(cache_v + off, vf[it]);
    } else {
#pragma unroll
      for (int i = 0; i < DIMS; ++i) kf[it][i] = vf[it][i] = 0.f;
    }
  }

  // this lane's 8 head dims of every query head in the group, pre-scaled
  float qf[GROUP][DIMS];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    load8(q + (static_cast<long long>(b) * Hq + h * GROUP + g) * D + sub * DIMS, qf[g]);
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
  float* pz = part + ((static_cast<long long>(b) * Hkv + h) * gridDim.z + z) * PARTIAL;
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

  // count this chunk in; the last of the row's live chunks merges them all
  __threadfence();
  __syncthreads();
  int* counter = arrivals + b * Hkv + h;
  if (tid == 0) is_last = atomicAdd(counter, 1) == z_hi - z_lo;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* prow = part + (static_cast<long long>(b) * Hkv + h) * gridDim.z * PARTIAL;
  for (int i = tid; i < GROUP * D; i += THREADS) {
    const int g = i / D;
    float M = -INFINITY;
    for (int zz = z_lo; zz <= z_hi; ++zz) M = fmaxf(M, __ldcg(prow + zz * PARTIAL + g));
    float L = 0.f, A = 0.f;
    for (int zz = z_lo; zz <= z_hi; ++zz) {
      const float* pp = prow + zz * PARTIAL;
      const float e = exp2f(__ldcg(pp + g) - M);
      L = fmaf(__ldcg(pp + GROUP + g), e, L);
      A = fmaf(__ldcg(pp + 2 * GROUP + i), e, A);
    }
    orow[i] = __float2bfloat16(A / L);
  }
  if (tid == 0) *counter = 0;  // every live chunk has arrived: clean for the next launch
}

}  // namespace

// Keys per split; the wrapper sizes the scratch with it.
extern "C" int dense_decode_chunk() { return CHUNK; }

// q (B, Hq, 64) and out (B, Hq, 64) contiguous bf16; cache_k/v
// (L, B, S, Hkv, 64) contiguous bf16, 16-byte aligned; start/pos (B,)
// int32; part (B, Hkv, ceil(S / CHUNK), 7 * 66) fp32 scratch; arrivals
// (B * Hkv,) int32, all 0 before the launch and left 0 after it.  Returns
// the launch's cudaError_t; Hq != 7 Hkv returns cudaErrorInvalidValue
// without launching.
extern "C" int dense_decode_attention_bf16(const void* q, const void* cache_k,
                                           const void* cache_v, const void* start,
                                           const void* pos, void* out, void* part,
                                           void* arrivals, int layer, int B, int S, int Hkv,
                                           int Hq, float sm_scale, void* stream) {
  if (Hq != Hkv * GROUP) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B, (S + CHUNK - 1) / CHUNK);
  split_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache_k),
      static_cast<const __nv_bfloat16*>(cache_v), static_cast<const int*>(start),
      static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(out), static_cast<float*>(part),
      static_cast<int*>(arrivals), layer, B, S, Hkv, sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
