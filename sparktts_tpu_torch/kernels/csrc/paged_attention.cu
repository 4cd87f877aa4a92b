// One-token GQA decode attention over a paged KV pool, with each slot's keys
// split across blocks (flash-decoding through the page table).
//
// Replaces the Pallas kernel `paged_decode_attention` (`_paged_kernel`) of
// sparktts_tpu/kernels/paged_attention.py.  Same function: for slot b and
// query head h, softmax over the keys j in [0, lengths[b]) of
// (q[b, h] . K[j]) * sm_scale, applied to V, where key j of slot b lies in
// page page_table[b, j / P] at offset j % P of the `layer` plane of the
// stacked (L, Hkv, n_pages, P, D) pools.  A slot whose length is 0 gives
// zeros.  Keys past the table (a finished slot's length runs one past it,
// pps P + 1) are not read: the window is [0, min(len, pps P)).
//
// Design: kernel 2's split (split_decode.cuh), read through the page table.
// The grid is (KV head, slot, chunk), one chunk for each CHUNK keys of the
// table: chunks = ceil(pps P / CHUNK), known to the host without reading the
// device, so a launch stays valid inside a CUDA graph.  Every block reads
// its slot's length and the page id of its chunk's first key together (two
// independent loads), exits if its chunk starts past ceil(min(len, pps P) /
// CHUNK) chunks, and otherwise issues all of its chunk's K/V loads before
// its first score.  A chunk that spans pages (P < CHUNK, or P not a
// multiple of CHUNK) looks up each later page's id per key.  Within a page a
// KV head's keys are contiguous 128-byte rows, so a chunk of 128 keys inside
// one page is one 16 KB run.  If the slot has more than one live chunk, the
// block writes its partial (m, l, acc[7][64]) to scratch and arrives on its
// (slot, KV head) counter (kernels/arrivals.py); the last to arrive merges
// the partials in chunk order and sets the counter back to 0.  One launch,
// no float atomics, bit-equal repeats.  The TPU kernel's GQA padding to 8
// sublanes, its 128-lane m/l scratch and its sequential page walk have no
// counterpart.
//
// What bounds it on an H100: a layer reads 512 bytes a valid key (K and V of
// two heads): at the paged engine's state in chip_smoke.py (8 slots, 941
// keys) 0.48 MB, 0.15 us at 3.35 TB/s.  So the time is latency: the launch,
// the length and page-id loads, one K/V round trip, the merge.  The design it
// replaces walked every key of a slot in one block per (KV head, slot): 16
// blocks on 132 SMs, one dependent load round trip per 32 keys, so its time
// grew with the keys a slot holds (15.66 us at that state on an H100 80GB
// HBM3 at 700.00 W, 19.2-19.5 us a call in the engine's trace).  Split,
// every live chunk's loads are in flight at once and the serial part left
// is the merge of at most pps P / CHUNK partials.
//
// CHUNK = 128 was chosen with scripts/bench_torch_paged_int4.py (H100 80GB
// HBM3, 700.00 W; 8 slots, P = 256, pps = 4): 32 / 64 / 128 keys took 11.85 /
// 9.59 / 9.78 us with slots of 40-430 keys and 20.93 / 14.80 / 10.16 us with
// every slot near the full 1024-key table; a burst spends most of its steps
// between the two.  250 registers at 128 (165 at 64), no spills: one block
// of 256 threads an SM either way.

#include "split_decode.cuh"

#ifndef PAGED_CHUNK
#define PAGED_CHUNK 128
#endif

using namespace split_decode;

namespace {

constexpr int CHUNK = PAGED_CHUNK;  // keys per split

__global__ void __launch_bounds__(THREADS) paged_split_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
    int* __restrict__ arrivals, int layer, int Hkv, int n_pages, int P, int pps,
    float scale_log2) {
  const int h = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int Hq = Hkv * GROUP;
  const int j0 = z * CHUNK;  // slot key of local index 0; j0 < pps P
  const int page0 = j0 / P;
  const int* table_row = page_table + static_cast<long long>(b) * pps;
  const int len = lengths[b];
  const int pid0 = table_row[page0];
  const long long head0 = static_cast<long long>(b) * Hq + h * GROUP;  // first query head
  __nv_bfloat16* orow = out + head0 * D;

  const int n = min(len, pps * P);  // valid keys [0, n)
  if (n <= 0) {  // empty slot: zeros, written by chunk 0
    if (z == 0)
      for (int i = threadIdx.x; i < GROUP * D; i += THREADS) orow[i] = __float2bfloat16(0.f);
    return;
  }
  const int z_hi = (n - 1) / CHUNK;
  if (z > z_hi) return;

  const long long plane = (static_cast<long long>(layer) * Hkv + h) * n_pages;  // page 0, this head
  auto key_row = [&](int i) {
    const int j = j0 + i, page = j / P;
    const int pid = page == page0 ? pid0 : __ldg(table_row + page);
    return ((plane + pid) * P + (j - page * P)) * D;
  };
  attend_chunk<CHUNK>(q + head0 * D, k_pages, v_pages, key_row, 0, min(CHUNK, n - j0) - 1, z, 0,
                      z_hi, part + (static_cast<long long>(b) * Hkv + h) * gridDim.z * PARTIAL,
                      arrivals + b * Hkv + h, orow, scale_log2);
}

}  // namespace

// Keys per split; the wrapper sizes the scratch with it.
extern "C" int paged_decode_chunk() { return CHUNK; }

// q (B, Hq, 64) and out (B, Hq, 64) contiguous bf16; k_pages/v_pages
// (L, Hkv, n_pages, P, 64) contiguous bf16, 16-byte aligned; page_table
// (B, pps) and lengths (B,) contiguous int32; part (B, Hkv, ceil(pps P /
// CHUNK), 7 * 66) fp32 scratch; arrivals (B * Hkv,) int32, all 0 before the
// launch and left 0 after it.  Returns the launch's cudaError_t; Hq != 7 Hkv
// returns cudaErrorInvalidValue without launching.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pages,
                                           const void* v_pages, const void* page_table,
                                           const void* lengths, void* out, void* part,
                                           void* arrivals, int layer, int B, int Hkv, int Hq,
                                           int n_pages, int P, int pps, float sm_scale,
                                           void* stream) {
  if (Hq != Hkv * GROUP) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Hkv, B, (pps * P + CHUNK - 1) / CHUNK);
  paged_split_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(arrivals), layer, Hkv, n_pages, P, pps,
      sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
