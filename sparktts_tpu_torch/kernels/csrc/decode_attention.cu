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
// A block whose chunk lies outside the row's window exits at once.  The rest
// is split_decode.cuh's `attend_chunk`, shared with kernel 6: each block
// walks its chunk with 32 key streams, every load issued first, scores the 7
// query heads of its KV head, and the last block of a (row, KV head) to
// arrive on its counter merges the chunks' partials in chunk order, in the
// same launch.  The layer plane of the (L, B, S, Hkv, D) cache is addressed
// in place.
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
// keys) 8.25 us against 54.3 (its trace) and 11.79.  169 registers (171
// before the chunk routine moved to split_decode.cuh), 14,788 bytes of
// shared memory, no spills.  CHUNK = 64 was chosen with
// scripts/bench_torch_decode_chunk.py (creation, cloning, 8 engine-like
// rows): 32 keys 8.69 / 11.65 / 15.32 us, 64 keys 7.90 / 9.71 / 11.29, 128
// keys 8.72 / 9.91 / 9.55 (241 registers): 64 is fastest at B = 1, where
// the pipeline decodes.

#include "split_decode.cuh"

#ifndef DECODE_CHUNK
#define DECODE_CHUNK 64
#endif

using namespace split_decode;

namespace {

constexpr int CHUNK = DECODE_CHUNK;  // keys per split

__global__ void __launch_bounds__(THREADS) split_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache_k,
    const __nv_bfloat16* __restrict__ cache_v, const int* __restrict__ start,
    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ arrivals, int layer, int B, int S, int Hkv, float scale_log2) {
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int Hq = Hkv * GROUP;
  const long long head0 = static_cast<long long>(b) * Hq + h * GROUP;  // first query head
  __nv_bfloat16* orow = out + head0 * D;

  const int lo = max(start[b], 0);
  const int hi = min(pos[b], S - 1);
  if (hi < lo) {  // empty window: zeros, written by split 0
    if (z == 0)
      for (int i = threadIdx.x; i < GROUP * D; i += THREADS) orow[i] = __float2bfloat16(0.f);
    return;
  }
  const int z_lo = lo / CHUNK, z_hi = hi / CHUNK;
  if (z < z_lo || z > z_hi) return;

  const int j0 = z * CHUNK;  // key of local index 0
  const long long plane = (static_cast<long long>(layer) * B + b) * S;  // row of key 0
  auto key_row = [&](int i) { return ((plane + j0 + i) * Hkv + h) * D; };
  attend_chunk<CHUNK>(q + head0 * D, cache_k, cache_v, key_row, lo - j0, hi - j0, z, z_lo, z_hi,
                      part + (static_cast<long long>(b) * Hkv + h) * gridDim.z * PARTIAL,
                      arrivals + b * Hkv + h, orow, scale_log2);
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
