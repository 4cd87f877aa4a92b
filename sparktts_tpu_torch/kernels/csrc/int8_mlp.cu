// Fused weight-only int8 SwiGLU MLP for a few decode rows, one launch a call.
//
// Replaces the Pallas kernel `int8_mlp_matvec` (`_mlp_kernel`) of
// sparktts_tpu/kernels/int8_mlp.py.  Same function and rounding points, with
// dt = bf16 (x's dtype on the main path):
//
//   g = dt(dt(x . Wg) * dt(sg)),   u = dt(dt(x . Wu) * dt(su))
//   h = dt(dt(silu_fp32(g)) * u)
//   out = dt(dt(h . Wd) * dt(sd))
//
// where every dot takes bf16 x times the int8 weight (both exact in bf16)
// and sums in fp32.  x is (R, K) with R <= 16; gu_q (K, 2I) int8 holds the
// gate columns [0, I) then the up columns [I, 2I); down_q is (I, K) int8; the
// scales are fp32 per output column.
//
// What bounds it on an H100: at R <= 16 it does 2R operations per weight
// byte, far below the ~295 at which the tensor cores would be the limit, so
// it is bound by the bytes of the int8 weights: 3 I K = 13.07 MB per layer of
// Qwen2.5-0.5B, 3.9 us at 3.35 TB/s.  The design before this one (three
// launches: gate/up + SwiGLU over 152 blocks, down partials, an ordered sum;
// every weight byte turned into a float by an I2F conversion, 16 a clock an
// SM) took 19.95 us a call at R = 1 on an H100 80GB HBM3 at 700.00 W.
//
// Design, the Pallas kernel's schedule in one launch, with the work of a
// column tile spread over a cluster of 8 blocks (thread block clusters):
//
// * Cluster c owns COLS = 128 intermediate columns [128c, 128c + 128); its
//   block of rank q owns K slice q of their gate and up rows (112 of K =
//   896 rows) and the 16 columns [128c + 16q, + 16) for SwiGLU and down.
//   38 clusters, 304 blocks at full width, all resident at once (three an
//   SM).  At the start every thread issues all of its block's 16-byte
//   cp.async copies: the K slice of x, its gate/up rows in STAGES = 4
//   commit groups, then its 16 rows of down_q; ~43 KB a block, ~130 KB an
//   SM in flight from the first cycle, and the down bytes land while the
//   gate/up sums run.  The whole tile fits in shared memory, so the ring of
//   stages never wraps.  A row of the cluster's 128 gate (or up) columns is
//   128 contiguous bytes, 8 lanes' copies: a block owning all K rows of 16
//   columns instead read 16-byte pieces of 2 x 896 rows, one cache line a
//   lane, and spent longer issuing them than the bytes take from HBM.
// * Products on the tensor cores: mma.sync.m16n8k16 bf16 with fp32
//   accumulation.  The weights are the M = 16 side (warp w's 16 of the 128
//   columns for gate/up, 16 output columns for down), x's rows (or h's) the
//   N = 8 side: one n-tile for R <= 8, two for R <= 16.  A lane's A fragment
//   needs two columns of four K rows, so fragment row m < 8 is column 2m of
//   the m-tile and m >= 8 column 2m - 15: one 16-bit shared load a row gives
//   both.  Shared rows are padded (gate/up 144 bytes, down K + 16, x K slice
//   + 8 bf16) so that the fragment loads are conflict-free.
// * int8 -> bf16 without I2F: bf16 has 7 stored mantissa bits, too few for a
//   byte above an offset, so each byte (xor 0x80) is put by `prmt` into the
//   low byte of the fp32 2^23 and the offset 2^23 + 128 is subtracted: the
//   exact integer in fp32, whose low 16 bits are zero, so the high halves of
//   two such floats, packed by one more `prmt`, are their exact bf16 pair.
// * Each warp writes its slice's gate/up fragments to shared memory; after a
//   cluster barrier, block q sums the 8 slices of its 16 columns in rank
//   order from its peers' shared memory (DSMEM), rounds g, u and h as above
//   and keeps h in shared memory (never in device memory).  Its warps then
//   take the 56 down m-tiles (one mma each, K = 16) and write the block's
//   fp32 partial (R, K) to shared memory.
// * The ordered down sum, in the same launch, without float atomics: after a
//   second cluster barrier, rank q sums column slice q of the cluster's 8
//   partials in rank order (DSMEM, float4) into the workspace (R, K) of its
//   cluster and arrives on counter q (kernels/arrivals.py; arrivals.cuh's
//   `arrive_last`).  The last of the 38 clusters to arrive on it sums slice q
//   of the cluster sums: runs of FINAL_RUN = 8 clusters, each run in order
//   by one thread (one batch of loads), then the runs in order, and applies
//   dt(sd).  The final sum is spread over 8 blocks and over a block's
//   threads; repeats are bit-equal (the order is `int8_mlp_tiled_plain`'s).
//   A block waits on the cluster barrier before it leaves, since its peers
//   read its shared memory.
// * Any I and any K that is a multiple of 4 (the sums move float4s): columns
//   and rows past the edge are zero (cp.async zero-fill, or byte copies where
//   a 16-byte copy does not line up).
//
// What the critical path is on the card (scripts/bench_torch_int8_vocoder.py
// times it; PERF.md has the numbers): the weight bytes, then three cluster
// barriers, the arrival (a fence and an atomic) and the final sum, which
// together take about as long again as the bytes at R = 1.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "arrivals.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 16;     // intermediate columns per block
constexpr int CLUSTER = 8;   // blocks per cluster
constexpr int STAGES = 4;    // commit groups of gate/up rows; down is one more
constexpr int COLS = CLUSTER * TILE;  // gate/up columns of a cluster
constexpr int GP = COLS + 16;  // gate/up row pitch in bytes: conflict-free fragment loads
constexpr int HP = TILE + 8;  // h row pitch in bf16: conflict-free fragment loads
static_assert(COLS / 16 == WARPS, "a warp owns one 16-column m-tile of the cluster's columns");
constexpr int FINAL_RUN = 8;  // cluster sums a thread adds in the final sum, one batch of loads

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// The two halves of a cluster barrier, with release/acquire ordering of
// shared memory across the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::); break;
  }
}

// Bytes i and j of w (each a signed byte xor 0x80) as an exact bf16 pair,
// byte i in the low half.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t w, int i, int j) {
  const float fi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i)) - 8388736.f;
  const float fj = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + j)) - 8388736.f;
  return __byte_perm(__float_as_uint(fi), __float_as_uint(fj), 0x7632);
}

// The m16n8k16 A fragment of lane (g, t) from int8 rows of `pitch` bytes:
// K rows 2t, 2t + 1, 2t + 8, 2t + 9, bytes 2g (fragment row g) and 2g + 1
// (fragment row g + 8) of each.
__device__ __forceinline__ void int8_fragment(const uint8_t* base, int pitch, int g, int t,
                                              uint32_t (&a)[4]) {
  const uint8_t* p = base + 2 * t * pitch + 2 * g;
  const uint32_t r0 = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t r1 = *reinterpret_cast<const uint16_t*>(p + pitch);
  const uint32_t r8 = *reinterpret_cast<const uint16_t*>(p + 8 * pitch);
  const uint32_t r9 = *reinterpret_cast<const uint16_t*>(p + 9 * pitch);
  const uint32_t lo = __byte_perm(r0, r1, 0x5410) ^ 0x80808080u;  // r0 c0, r0 c1, r1 c0, r1 c1
  const uint32_t hi = __byte_perm(r8, r9, 0x5410) ^ 0x80808080u;
  a[0] = bf16_pair(lo, 0, 2);
  a[1] = bf16_pair(lo, 1, 3);
  a[2] = bf16_pair(hi, 0, 2);
  a[3] = bf16_pair(hi, 1, 3);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory layout of one block.  Region A holds the block's gate/up
// bytes (its K slice of the cluster's 128 columns) and its K slice of x,
// then the warps' gate/up partials, then the block's down partial.
struct Layout {
  int ksteps, srows, xp, dp, pp;  // K steps of 16; rows of a K slice; x, down, partial pitches
  size_t xs, ds, hs, total;
  __host__ __device__ Layout(int K, int rp) {
    ksteps = (K + 15) / 16;
    srows = 16 * ((ksteps + CLUSTER - 1) / CLUSTER);
    xp = srows + 8;          // bf16: conflict-free B fragment loads
    dp = 16 * ksteps + 16;   // bytes: conflict-free A fragment loads, 16-byte rows
    pp = 16 * ksteps + 4;    // fp32
    xs = 2 * static_cast<size_t>(srows) * GP;
    size_t region = xs + static_cast<size_t>(rp) * xp * 2;
    const size_t gu_part = 2 * static_cast<size_t>(COLS) * rp * 4;
    const size_t part = static_cast<size_t>(rp) * pp * 4;
    region = region > gu_part ? region : gu_part;
    region = region > part ? region : part;
    ds = (region + 15) & ~static_cast<size_t>(15);
    hs = ds + static_cast<size_t>(TILE) * dp;
    total = hs + static_cast<size_t>(rp) * HP * 2;
  }
};

template <int NT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 3)
    int8_mlp_kernel(const __nv_bfloat16* __restrict__ x, int rows, int K,
                    const int8_t* __restrict__ gu_q, const float* __restrict__ gu_scale, int I,
                    const int8_t* __restrict__ down_q, const float* __restrict__ down_scale,
                    bool x_vec, bool gu_vec, bool down_vec, float* __restrict__ ws,
                    int* __restrict__ arrivals, __nv_bfloat16* __restrict__ out) {
  constexpr int RP = 8 * NT;  // rows of x the fragments cover
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(K, RP);
  uint8_t* gs = smem;                                             // [srows][GP] gate bytes
  uint8_t* us = smem + L.srows * GP;                              // [srows][GP] up bytes
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);  // [RP][xp]
  uint8_t* ds = smem + L.ds;                                      // [16][dp] down rows
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + L.hs);  // [RP][HP]
  float* gu_part = reinterpret_cast<float*>(smem);                // [2][COLS][RP], later
  float* part = reinterpret_cast<float*>(smem);                   // [RP][pp], later

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int cl = blockIdx.x / CLUSTER, ncl = gridDim.x / CLUSTER;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int col0 = cl * COLS;         // the cluster's first gate/up column
  const int k_first = q * L.srows;    // the first K row of this block's slice
  const int c0 = blockIdx.x * TILE;   // this block's h columns and down rows
  const long long ld = 2LL * I;
  const int slice_steps = L.srows / 16;
  const int per_stage = (slice_steps + STAGES - 1) / STAGES;

  // this block's K slice of x (commit group 0, with the first gate/up rows):
  // rows past `rows` and columns past K are zero
  for (int e = tid; e < RP * (L.srows / 8); e += THREADS) {
    const int r = e / (L.srows / 8), j = 8 * (e % (L.srows / 8)), col = k_first + j;
    __nv_bfloat16* dst = xs + r * L.xp + j;
    if (x_vec && r < rows && col + 8 <= K) {
      cp_async16(dst, x + static_cast<long long>(r) * K + col, 16);
    } else {
      for (int i = 0; i < 8; ++i)
        dst[i] = r < rows && col + i < K ? x[static_cast<long long>(r) * K + col + i]
                                         : __float2bfloat16_rn(0.f);
    }
  }
  // gate/up rows of the slice: a row of the cluster's 128 gate columns and
  // of its 128 up columns is 16 lanes' 16-byte copies
  for (int s = 0; s < STAGES; ++s) {
    const int r_lo = 16 * min(slice_steps, s * per_stage);
    const int r_hi = 16 * min(slice_steps, (s + 1) * per_stage);
    for (int e = tid; e < 16 * (r_hi - r_lo); e += THREADS) {
      const int row = r_lo + e / 16, up = (e / 8) % 2, j = 16 * (e % 8);
      const int k = k_first + row, col = col0 + j;
      uint8_t* dst = (up ? us : gs) + row * GP + j;
      const int8_t* src = gu_q + k * ld + (up ? I : 0) + col;
      const bool in = k < K && col < I;
      if (gu_vec) {
        cp_async16(dst, in ? src : gu_q, in ? 16 : 0);
      } else {
        for (int i = 0; i < 16; ++i)
          dst[i] = in && col + i < I ? static_cast<uint8_t>(src[i]) : 0;
      }
    }
    cp_async_commit();
  }
  // the block's 16 rows of down_q (the last commit group)
  for (int e = tid; e < TILE * L.ksteps; e += THREADS) {
    const int p = e / L.ksteps, col = 16 * (e % L.ksteps);
    uint8_t* dst = ds + p * L.dp + col;
    const int8_t* row = down_q + static_cast<long long>(c0 + p) * K;
    const bool in = c0 + p < I;
    if (down_vec) {
      cp_async16(dst, in ? row + col : down_q, in ? 16 : 0);
    } else {
      for (int i = 0; i < 16; ++i)
        dst[i] = in && col + i < K ? static_cast<uint8_t>(row[col + i]) : 0;
    }
  }
  cp_async_commit();

  // gate/up partials over the slice: warp w owns columns [16w, 16w + 16) of
  // the cluster's 128, stage by stage as the rows land
  float gacc[NT][4], uacc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) gacc[nt][j] = uacc[nt][j] = 0.f;
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    cp_async_wait(STAGES - s);  // stages 0..s are in
    __syncthreads();
    const int hi = min(slice_steps, (s + 1) * per_stage);
    for (int ks = s * per_stage; ks < hi; ++ks) {
      const int k0 = 16 * ks;
      uint32_t ag[4], au[4];
      int8_fragment(gs + k0 * GP + 16 * warp, GP, g, t, ag);
      int8_fragment(us + k0 * GP + 16 * warp, GP, g, t, au);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* xr = xs + (8 * nt + g) * L.xp + k0 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
        mma_bf16(gacc[nt], ag, b0, b1);
        mma_bf16(uacc[nt], au, b0, b1);
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();  // region A is done with; the down rows are in
  // fragment element j of n-tile nt: column 16 warp + 2g (j < 2) or + 1, row
  // 8 nt + 2t + (j & 1)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 16 * warp + 2 * g + (j >> 1), r = 8 * nt + 2 * t + (j & 1);
      gu_part[col * RP + r] = gacc[nt][j];
      gu_part[(COLS + col) * RP + r] = uacc[nt][j];
    }
  cluster.sync();

  // g, u and h of this block's 16 columns: the 8 slices summed in rank order
  for (int e = tid; e < TILE * RP; e += THREADS) {
    const int p = e / RP, r = e % RP, c = c0 + p;
    float gsum = 0.f, usum = 0.f;
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) {
      const float* peer = cluster.map_shared_rank(gu_part, j);
      gsum += peer[(TILE * q + p) * RP + r];
      usum += peer[(COLS + TILE * q + p) * RP + r];
    }
    float h = 0.f;
    if (c < I && r < rows) {
      const float gv = bf16_round(bf16_round(gsum) * bf16_round(gu_scale[c]));
      const float uv = bf16_round(bf16_round(usum) * bf16_round(gu_scale[I + c]));
      h = bf16_round(gv / (1.f + expf(-gv))) * uv;
    }
    hs[r * HP + p] = __float2bfloat16_rn(h);
  }
  cluster.sync();  // every peer has read this block's gate/up partials; h is in

  // down: this block's partial (RP, K) = h (RP, 16) . down rows (16, K)
  uint32_t hb[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const __nv_bfloat16* hr = hs + (8 * nt + g) * HP + 2 * t;
    hb[nt][0] = *reinterpret_cast<const uint32_t*>(hr);
    hb[nt][1] = *reinterpret_cast<const uint32_t*>(hr + 8);
  }
  for (int mt = warp; mt < L.ksteps; mt += WARPS) {
    uint32_t a[4];
    int8_fragment(ds + 16 * mt, L.dp, g, t, a);
    const int n = 16 * mt + 2 * g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, a, hb[nt][0], hb[nt][1]);
      const int r = 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(part + r * L.pp + n) = make_float2(d[0], d[2]);
      *reinterpret_cast<float2*>(part + (r + 1) * L.pp + n) = make_float2(d[1], d[3]);
    }
  }

  // the cluster's 8 down partials, summed in rank order, column slice q
  cluster.sync();
  const int slice = (((K + CLUSTER - 1) / CLUSTER) + 3) & ~3;
  const int n_lo = min(K, q * slice), width = min(K, n_lo + slice) - n_lo;
  const int groups = width / 4;  // float4 columns (K and the slices are multiples of 4)
  for (int e = tid; e < rows * groups; e += THREADS) {
    const int r = e / groups, n = n_lo + 4 * (e % groups);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < CLUSTER; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, j) + r * L.pp + n);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    *reinterpret_cast<float4*>(ws + (static_cast<long long>(cl) * rows + r) * K + n) = sum;
  }
  cluster_arrive();  // done reading the peers' partials; each block waits before it leaves

  // the last cluster to arrive on slice q sums the clusters: in runs of
  // FINAL_RUN clusters, each run in order (one batch of loads a thread), then
  // the runs in order; the run sums are staged where the down rows were
  if (arrivals::arrive_last(arrivals + q, ncl)) {
    const long long cl_stride = static_cast<long long>(rows) * K;
    const int runs = (ncl + FINAL_RUN - 1) / FINAL_RUN, per_row = groups * runs;
    float4* stage = reinterpret_cast<float4*>(ds);
    const int rows_chunk = max(1, static_cast<int>(L.hs - L.ds) / (16 * per_row));
    for (int r0 = 0; r0 < rows; r0 += rows_chunk) {
      const int nr = min(rows_chunk, rows - r0);
      for (int e = tid; e < nr * per_row; e += THREADS) {
        const int rr = e / per_row, run = (e % per_row) / groups, gi = e % groups;
        const float* src = ws + static_cast<long long>(r0 + rr) * K + n_lo + 4 * gi;
        float4 v[FINAL_RUN];
#pragma unroll
        for (int j = 0; j < FINAL_RUN; ++j) {
          const int c = run * FINAL_RUN + j;
          v[j] = c < ncl ? __ldcg(reinterpret_cast<const float4*>(src + c * cl_stride))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < FINAL_RUN; ++j)
          if (run * FINAL_RUN + j < ncl)
            acc.x += v[j].x, acc.y += v[j].y, acc.z += v[j].z, acc.w += v[j].w;
        stage[e] = acc;
      }
      __syncthreads();
      for (int e = tid; e < nr * groups; e += THREADS) {
        const int rr = e / groups, gi = e % groups, n = n_lo + 4 * gi;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int run = 0; run < runs; ++run) {
          const float4 v = stage[rr * per_row + run * groups + gi];
          acc[0] += v.x, acc[1] += v.y, acc[2] += v.z, acc[3] += v.w;
        }
        for (int i = 0; i < 4; ++i)
          out[static_cast<long long>(r0 + rr) * K + n + i] =
              __float2bfloat16_rn(bf16_round(acc[i]) * bf16_round(down_scale[n + i]));
      }
      __syncthreads();
    }
  }
  __syncthreads();
  cluster_wait();  // no block leaves while a peer may read its shared memory
}

template <int NT>
cudaError_t run(const __nv_bfloat16* x, const int8_t* gu_q, const float* gu_scale,
                const int8_t* down_q, const float* down_scale, float* ws, int* arrivals,
                __nv_bfloat16* out, int rows, int K, int I, cudaStream_t stream) {
  const Layout L(K, 8 * NT);
  cudaError_t err = cudaFuncSetAttribute(int8_mlp_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L.total));
  if (err != cudaSuccess) return err;
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
  const bool gu_vec = reinterpret_cast<uintptr_t>(gu_q) % 16 == 0 && I % 16 == 0;
  const bool down_vec = reinterpret_cast<uintptr_t>(down_q) % 16 == 0 && K % 16 == 0;
  const int tiles = (I + TILE - 1) / TILE;
  const int blocks = (tiles + CLUSTER - 1) / CLUSTER * CLUSTER;
  int8_mlp_kernel<NT><<<blocks, THREADS, L.total, stream>>>(
      x, rows, K, gu_q, gu_scale, I, down_q, down_scale, x_vec, gu_vec, down_vec, ws, arrivals,
      out);
  return cudaGetLastError();
}

}  // namespace

// x (rows, K) bf16, gu_q (K, 2I) int8, gu_scale (2I,) fp32, down_q (I, K)
// int8, down_scale (K,) fp32, all contiguous; workspace ws (ws_clusters,
// rows, K) fp32, where ws_clusters must be this launch's clusters,
// ceil(ceil(I / TILE) / CLUSTER); arrivals: n_counters zeroed int32 counters
// of this stream, at least CLUSTER, left at 0; out (rows, K) bf16.  One
// launch on `stream`; returns its cudaError_t, or cudaErrorInvalidValue
// without launching for rows outside 1..16, K not a multiple of 4, I > 16384,
// or a workspace or counter array of another size than the grid needs.
extern "C" int int8_mlp_matvec_bf16(const void* x, const void* gu_q, const void* gu_scale,
                                    const void* down_q, const void* down_scale, void* ws,
                                    int ws_clusters, void* arrivals, int n_counters, void* out,
                                    int rows, int K, int I, void* stream) {
  // the final sum stages a row's run sums where the 16 down rows were: at
  // most 16 runs of 8 clusters, I <= 16384
  if (rows < 1 || rows > 16 || K < 4 || K % 4 != 0 || I < 1 || I > 16 * FINAL_RUN * COLS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ws_clusters != ((I + TILE - 1) / TILE + CLUSTER - 1) / CLUSTER || n_counters < CLUSTER)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gq = static_cast<const int8_t*>(gu_q);
  const auto* gs = static_cast<const float*>(gu_scale);
  const auto* dq = static_cast<const int8_t*>(down_q);
  const auto* dsc = static_cast<const float*>(down_scale);
  auto* wsf = static_cast<float*>(ws);
  auto* arr = static_cast<int*>(arrivals);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = rows <= 8 ? run<1>(xb, gq, gs, dq, dsc, wsf, arr, ob, rows, K, I, st)
                                    : run<2>(xb, gq, gs, dq, dsc, wsf, arr, ob, rows, K, I, st);
  return static_cast<int>(err);
}
