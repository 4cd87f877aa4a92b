// Causal, left-pad-masked GQA prefill attention on the tensor cores.
//
// Replaces the Pallas kernel `flash_attention_prefill` (`_flash_kernel`) of
// sparktts_tpu/kernels/flash_attention.py.  Same function: out[b, h, t] is
// softmax over keys c with start[b] <= c <= t of (q[b, h, t] . k[b, h/group, c])
// * sm_scale, applied to v.  Query rows with no valid key (left-pad rows,
// t < start[b]) are written as zeros; callers never read them.
//
// Design: FlashAttention-2's layout with mma.sync.m16n8k16 (bf16 in, fp32
// accumulate).  One block of 4 warps per (64-row query tile, query head,
// batch row); each warp owns 16 query rows and keeps their Q fragments in
// registers for the whole kernel, loaded once with ldmatrix.  K and V stream
// through shared memory in 64-key x 64-dim bf16 tiles (8 KB each), copied
// with 16-byte cp.async into two buffers, so the next tile's copy overlaps
// this tile's products.  Shared rows are padded to 72 elements (144 bytes):
// the eight 16-byte rows that one ldmatrix phase reads fall in eight
// different bank quads, so ldmatrix (K) and ldmatrix.trans (V) are free of
// bank conflicts.  S = Q K^T stays in registers, where sm_scale, the mask
// (causal, start[b], keys past S) and the online softmax are applied; the
// four lanes that share a row reduce with two quad shuffles, and the row
// sum is kept per lane and reduced once at the end.  P is rounded to bf16
// and packed straight into the A fragments of the P V product, with no trip
// through shared memory.  KV tiles wholly above the causal diagonal or
// wholly before start[b] are never loaded; rows past T and keys past S are
// masked here (zero-filled copies), so any T and S work.  The KV head of
// query head h is h / group, read in place, never repeated.
//
// Numerics: P is rounded to bf16 before P V, as the LM's dense path
// (lm/qwen.py, probabilities cast to the cache dtype) and the JAX package's
// dense attention do; the Pallas kernel and the plain version keep P in
// fp32.  The difference is at most 2^-9 relative on each probability.
//
// What bounds it on an H100: at the clone prompt's bucket (T = 448, 14
// query heads) a call moves 1.8 MB and does 0.3 GFLOP, a bound of 0.55 us
// (bytes).  The time is latency: the 98 blocks (7 query tiles x 14 heads)
// fill 98 of 132 SMs, and the last query tile walks 7 KV tiles in a row.
// mma.sync is enough for that: each KV tile costs a warp 64 tensor-core
// instructions, and the double-buffered cp.async keeps the next tile's load
// off the critical path.  wgmma with TMA would pay off only at tiles large
// enough to be bound by the tensor cores.
//
// Measured (chip_smoke.py, H100 80GB HBM3, 700.00 W; device time in a CUDA
// graph): T = 448 from start 29, 11.87 us against 99.7 for the scalar-FMA
// design this replaces and 20.14 for SDPA; T = 64 from 20, 3.63 us against
// 16.9 and 12.48.  143 registers, 46,080 bytes of shared memory, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block: 16 per warp
constexpr int BK = 64;       // keys per KV tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = D + 8;   // padded shared row: 144 bytes
constexpr int CHUNKS = D / 8;  // 16-byte pieces of a row
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, t;  // element strides; the head-dim stride is 1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__global__ void __launch_bounds__(THREADS) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ start,
    __nv_bfloat16* __restrict__ out, int T, int S, int group, Strides qs, Strides ks,
    Strides vs, Strides os, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ][LDS];
  __shared__ __align__(16) __nv_bfloat16 Ks[2][BK][LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][BK][LDS];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;  // fragment row group, thread in group
  const int st = max(start[b], 0);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;
  __nv_bfloat16* ob = out + b * os.b + h * os.h;

  // KV tiles that can hold a valid key for some row of this query tile
  const int last_row = min(q0 + BQ, T) - 1;
  const int j_lo = st / BK;
  const int j_hi = min(last_row, S - 1) / BK;
  if (j_lo > j_hi) {  // no row of the tile has a valid key
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int t = q0 + i / D;
      if (t < T) ob[t * os.t + i % D] = __float2bfloat16(0.f);
    }
    return;
  }

  auto load_kv = [&](int j, int buf) {
    for (int c = tid; c < BK * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, col = (c % CHUNKS) * 8, key = j * BK + r;
      const bool in = key < S;
      const long long kr = in ? key : 0;
      cp_async16(&Ks[buf][r][col], kb + kr * ks.t + col, in ? 16 : 0);
      cp_async16(&Vs[buf][r][col], vb + kr * vs.t + col, in ? 16 : 0);
    }
  };
  for (int c = tid; c < BQ * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8, t = q0 + r;
    const bool in = t < T;
    cp_async16(&Qs[r][col], qb + static_cast<long long>(in ? t : 0) * qs.t + col, in ? 16 : 0);
  }
  load_kv(j_lo, 0);
  cp_async_commit();

  uint32_t qf[D / 16][4];  // this warp's 16 rows, four 16-dim A fragments
  float o[D / 8][4];       // output accumulator: 8 n-tiles of 8 dims
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, in log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sums
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int buf = (j - j_lo) & 1;
    if (j < j_hi) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_1();  // all but the newest group: tile j (and Q) have landed
    __syncthreads();
    if (j == j_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], &Qs[warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
    }

    // S = Q K^T for 64 keys: n-tile n holds keys 8n .. 8n + 7
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, &Ks[buf][np * 16 + (lane >> 4) * 8 + (lane & 7)]
                           [kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale and mask: element e of n-tile n is row (e < 2 ? row0 : row1),
    // key j BK + 8n + 2 tig + (e & 1)
    const int k0 = j * BK;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * tig + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = col <= row && col >= st && col < S;
        s[n][e] = ok ? s[n][e] * scale_log2 : -INFINITY;
      }
    }

    // online softmax, rows row0 and row1; the quad's four lanes share a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no valid key yet
      alpha[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
    }

    // P in bf16, packed as the A fragments of P V: keys 16 kk .. 16 kk + 15
    // are n-tiles 2 kk (fragment registers 0, 1) and 2 kk + 1 (2, 3)
    uint32_t pf[BK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - base[0]), p1 = exp2f(s[n][1] - base[0]);
      const float p2 = exp2f(s[n][2] - base[1]), p3 = exp2f(s[n][3] - base[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: V^T fragments by ldmatrix.trans of the [key][dim] tile
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &Vs[buf][kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                 [np * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * np], pf[kk], vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  // row sums over the quad; rows with no valid key (l == 0) stay zero
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 0.f : 1.f / l[r];
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = 8 * n + 2 * tig;
    if (row0 < T)
      *reinterpret_cast<uint32_t*>(ob + row0 * os.t + d) = pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (row1 < T)
      *reinterpret_cast<uint32_t*>(ob + row1 * os.t + d) = pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

}  // namespace

// q (B, Hq, T, 64), k/v (B, Hkv, S, 64), out (B, Hq, T, 64): bf16 with the
// given element strides (head dim contiguous; every base pointer 16-byte
// aligned and every stride a multiple of 8 elements, which the wrapper
// checks); start (B,) int32.
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
      sm_scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
