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
// contraction dim.  x is (B, in) with 1 <= B <= 32.
//
// What bounds it on an H100: at B <= 32 it does 4B operations per packed
// byte, far below the tensor cores' ~295 a byte, so it is bound by the bytes
// of the packed weights and their fp32 group scales: 7.92 MB per layer of
// Qwen2.5-0.5B (qkv, o, gate/up, down), 2.38 us at 3.35 TB/s.  A layer's four
// calls are small (0.4 to 4.4 MB), so each call's time is mostly latency:
// the launch (~1.1 us), one round trip to device memory with all of the
// call's bytes requested at once, the products on the SMs the call reaches,
// and the sum over the groups.  The design before this one (PR 6) unpacked
// on the CUDA cores, 4 rows a lane in flight through __ldg, on 18 and 14
// SMs for qkv and o: 22.77 us a layer at B = 1 against the library's 15.21.
//
// Design, one launch a call:
//
// * Products on the tensor cores: mma.sync.m16n8k16 bf16, fp32 accumulate.
//   The output columns are the M side and the weights the register operand
//   A; x's rows are the N side (n8 tiles: B = 1 pads N, never the weight
//   bytes).  A packed byte at (p, o) holds the k pair (2p, 2p+1) of column
//   o, which is what one A register holds: two consecutive k of one row.
//   Lane (g, t) reads one word, 4 consecutive columns, of packed rows 2t and
//   2t + 1 of each 8-row k step; byte 2i + h of its word is row g + 8h of
//   m-tile i, and the two rows are k slots (2t, 2t+1) and (2t+8, 2t+9): any
//   fixed assignment of k to slots is exact as long as x takes the same one,
//   and x's elements 4t .. 4t+3 of the step are then one 8-byte shared load.  A
//   byte becomes its bf16 pair with no I2F and no FMA: one `prmt` puts its
//   low nibble and (word >> 4)'s byte, the high nibble, under the halves,
//   one `lop3` masks them and lays 0x4300 (bf16 128) over them, flipping
//   the nibble's sign bit (128 + n + 8), and one bf16x2 `sub` takes 136
//   off: exactly n.  A chunk of k steps is loaded and converted into
//   registers of its own before its products.  mma.sync and not wgmma: the
//   call is bound by bytes and latency, and on an H100 80GB HBM3 (700 W)
//   one HMMA.16816 takes 33 cycles on a chain and ~10 cycles of a
//   sub-partition's tensor core, so the products of all 132 SMs need ~0.4
//   us even at B = 32 for gate/up; mma.sync takes x from registers (no
//   core-matrix layout in shared memory) and its fragment matches the
//   nibble layout.
// * A block owns 32 columns (a warp's 8 words a row; 64 or 128 columns, 8 or
//   16 bytes a lane, were never faster: fewer blocks, more products a warp)
//   and a run of groups, one warp a group (at most 16 warps; warp w takes
//   groups w, w + warps, ...).  Each group's k steps
//   go into an fp32 accumulator of their own, from 0; its partial times its
//   scales (rounded product) goes to shared memory, and the block adds the
//   groups in order, acc = acc + part * gscale[g, o], round by round of
//   `warps` groups.  A group that is not a multiple of 16 rows pads x with
//   zeros past its end and copies no weight bytes there.
// * Calls with many groups are split: runs of at most RUN_MAX = 12 groups
//   (fewer when x would not fit), one block of a thread block cluster each
//   (down at in = 4864: runs of 10, 10, 10 and 8 groups), because the
//   products and conversions of 38 groups on the 28 SMs of down's column
//   tiles take ~1.7 us a round.  The run sums are added in rank order
//   through distributed shared memory: after a cluster barrier (a
//   cluster-scope fence, not the GPU-wide one of cooperative_groups'
//   cluster.sync(), which cost ~1.3 us a call), rank r sums slice r of the
//   cluster's outputs over ranks 0, 1, ... in order and rounds to bf16.  So
//   the sum is the groups in order within a run and the runs in order, which
//   depends on the call's shape alone (`runs`, mirrored by
//   int4_matmul.group_split), and repeats are bit-equal; there is no
//   workspace, no counter and no atomic.
// * Copies are asynchronous: each warp streams its groups into a ring of up
//   to 4 stages in shared memory, a stage a group's packed rows and its
//   scales, as 16-byte cp.async pieces copied by the warp's lanes in turn
//   (four a lane for a group of 128), so a call's bytes are nearly all in
//   flight at once; x is staged once a block, by cp.async, in rows padded
//   so that the fragment loads do not conflict.
// * Any out: pieces past the edge are zero-filled, and rows that cannot take
//   an aligned copy (out not a multiple of 16) are copied byte by byte.
//   Groups of any even size.  A block stages B rows of its run's inputs
//   (at most 112 KB), so at B = 32 `in` may be at most ~14000 (eight runs
//   of ~1800 inputs); a larger call returns an error and the wrapper raises.
//
// Measured (scripts/bench_torch_paged_int4.py, H100 80GB HBM3, 700 W; the
// times and the ablations are in PERF.md, kernel table row 5 and the PR 20
// finding): a layer's four calls at B = 1 in ~19.8 us (library ~15.3), at
// B = 8 in ~23.4 (library ~22.2), at B = 32 in ~41.9 (library ~48.4).  At
// B = 1 the copies alone take ~12.4 us a layer (an empty launch 4.5): qkv
// and o reach 36 and 28 SMs, and their conversions and products add ~1 us a
// call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Bench builds (scripts/bench_torch_paged_int4.py) may change the runs or
// leave a part of the work out.
#ifndef INT4_RUN_MAX
#define INT4_RUN_MAX 12  // groups a run, at most
#endif
// INT4_ABLATE 1: no nibble conversion (raw words into the products); 2: no conversion
// and no products; 3: no weight or scale copies; 4: an empty kernel on the
// same grid; 5: the copies land, nothing else; 6: no sum over the groups
// and no output.  Wrong results, for timing.
#ifndef INT4_ABLATE
#define INT4_ABLATE 0
#endif

namespace {

constexpr int TC = 32;         // columns of a block: a lane copies 4 bytes of a row, 8 lanes a row
constexpr int MAX_SPLIT = 8;   // runs of a call: the blocks of a cluster
constexpr int MAX_WARPS = 16;  // group warps a block
constexpr int MAX_STAGES = 4;
constexpr int RUN_MAX = INT4_RUN_MAX;   // groups a run
constexpr int RUN_BUDGET = 112 * 1024;  // bytes of a run's staged x
constexpr size_t SMEM_LIMIT = 227 * 1024;

struct Args {
  const __nv_bfloat16* x;
  const int8_t* packed;
  const float* gscale;
  __nv_bfloat16* out;
  int B, in_dim, out_dim, groups, group;
  int seg, split;         // groups a run, runs (cluster size)
  int steps, kpad;        // k steps of 16 a group; a group's x elements, padded to 16 a step
  int stages;             // ring stages (one group each)
  int xpitch;             // bf16 elements of a staged x row
  int ring_warp, sums_off, part_off, x_off;  // bytes
  bool w_vec, s_vec, x_vec;
};

struct Plan {
  int nt, warps, seg, split, steps, kpad, stages, xpitch, col_blocks;
  int ring_warp, sums_off, part_off, x_off;
  size_t smem;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }
int align16(int v) { return (v + 15) & ~15; }

// The runs: the fewest (at most MAX_SPLIT) of at most RUN_MAX groups whose
// staged x fits RUN_BUDGET; mirrored by int4_matmul.group_split.
void runs(int B, int groups, int kpad, int* seg, int* split) {
  const int most = groups < MAX_SPLIT ? groups : MAX_SPLIT;
  int s = 1;
  while (s < most && (cdiv(groups, s) > RUN_MAX || B * cdiv(groups, s) * 2 * kpad > RUN_BUDGET))
    ++s;
  *seg = cdiv(groups, s);
  *split = cdiv(groups, *seg);
}

void lay_out(Plan& p, int B) {
  p.ring_warp = p.stages * (8 * p.steps * TC + 4 * TC);  // a stage: a group's rows, its scales
  p.sums_off = align16(p.warps * p.ring_warp);
  p.part_off = align16(p.sums_off + p.warps * B * (TC + 1) * 4);
  p.x_off = align16(p.part_off + B * TC * 4);
  p.smem = static_cast<size_t>(p.x_off) + static_cast<size_t>(B) * p.xpitch * 2;
}

// The launch's shape, from the call's shape alone.
Plan make_plan(int B, int in_dim, int out_dim, int groups) {
  Plan p{};
  const int group = in_dim / groups;
  p.nt = cdiv(B, 8);
  p.steps = cdiv(group / 2, 8);
  p.kpad = 16 * p.steps;
  runs(B, groups, p.kpad, &p.seg, &p.split);
  p.warps = p.seg < MAX_WARPS ? p.seg : MAX_WARPS;
  p.xpitch = (p.seg * p.kpad + 31) / 32 * 32 + 16;  // 16 or 48 mod 64: conflict-free rows
  p.col_blocks = cdiv(out_dim, TC);
  const int per_warp = cdiv(p.seg, p.warps);
  for (p.stages = per_warp < MAX_STAGES ? per_warp : MAX_STAGES;; --p.stages) {
    lay_out(p, B);
    if (p.smem <= SMEM_LIMIT || p.stages == 1) return p;
  }
}

// 16 bytes from global to shared memory, asynchronously; zero-filled, and
// nothing read, when `valid` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// A cluster barrier whose arrival publishes this block's shared-memory
// writes to the cluster (a cluster-scope fence, not cooperative_groups'
// GPU-wide one), and one that publishes nothing.
__device__ __forceinline__ void cluster_sync_shared() {
  asm volatile(
      "fence.acq_rel.cluster;\n"
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

// Byte j of w as the bf16 pair (low nibble, high nibble), both signed; v is
// w >> 4.  Exact: 0x4300 | (n ^ 8) is bf16 128 + n + 8, less 136.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, uint32_t v, int j) {
  const uint32_t t = __byte_perm(w, v, j | ((j + 4) << 8));
  uint32_t biased, r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(biased) : "r"(t), "r"(0x000F000Fu),
      "r"(0x43084308u));  // (t & 0x000F000F) ^ 0x43084308
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(biased), "r"(0x43084308u));
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (c, r) of a cluster of `split` blocks along y: columns [c TC,
// c TC + TC), groups [r seg, r seg + seg) of the call.  Warp w takes the
// run's groups w, w + warps, ...; lane (g, t) owns the block's columns
// [4 g, 4 g + 4): bytes 0 and 1 of its word are rows g and g + 8 of m-tile 0,
// bytes 2 and 3 those of m-tile 1.
template <int NT>
__global__ void __launch_bounds__(32 * MAX_WARPS) int4_mma_kernel(const Args a) {
#if INT4_ABLATE == 4
  return;
#endif
  constexpr int CH = NT > 2 ? 2 : 4;  // k steps whose operands are loaded and converted together
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int gid = lane >> 2, t = lane & 3;
  const int rank = blockIdx.y;
  const int g0 = rank * a.seg;
  const int ng = min(a.seg, a.groups - g0);
  const int nk = warp < ng ? (ng - warp + warps - 1) / warps : 0;  // this warp's groups
  const int half = a.group / 2;
  const int o0 = blockIdx.x * TC;
  const int out_dim = a.out_dim;
  const int rows = 8 * a.steps;                // packed rows of a stage (a group, padded)
  const int stage_bytes = rows * TC + TC * 4;  // the rows, then the group's TC scales
  unsigned char* ring = smem + warp * a.ring_warp;
  constexpr int SP = TC + 1;  // a row of sums, padded: fewer bank conflicts on the stores
  const int E = a.B * TC, SE = a.B * SP;
  float* sums = reinterpret_cast<float*>(smem + a.sums_off);  // (warps, B, SP): a round's groups
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + a.x_off);

  // x: rows 0 .. B-1, the run's groups, each padded with zeros to kpad
  if (a.x_vec) {
    const int per_g = a.group / 8, per_row = ng * per_g;
    for (int i = tid; i < a.B * per_row; i += blockDim.x) {
      const int n = i / per_row, gl = i % per_row / per_g, k8 = i % per_g;
      cp_async16(xs + n * a.xpitch + gl * a.kpad + 8 * k8,
                   a.x + static_cast<long long>(n) * a.in_dim + (g0 + gl) * a.group + 8 * k8,
                   true);
    }
    const int pad8 = (a.kpad - a.group) / 8, pads = a.B * ng * pad8;
    for (int i = tid; i < pads; i += blockDim.x) {
      const int n = i / (ng * pad8), gl = i / pad8 % ng, k8 = i % pad8;
      *reinterpret_cast<uint4*>(xs + n * a.xpitch + gl * a.kpad + a.group + 8 * k8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int per_row = ng * a.kpad;
    for (int i = tid; i < a.B * per_row; i += blockDim.x) {
      const int n = i / per_row, gl = i % per_row / a.kpad, k = i % a.kpad;
      xs[n * a.xpitch + gl * a.kpad + k] =
          k < a.group ? a.x[static_cast<long long>(n) * a.in_dim + (g0 + gl) * a.group + k]
                      : __float2bfloat16_rn(0.f);
    }
  }
  cp_async_commit();

  // this warp's k-th group into ring slot `slot`: its packed rows (TC bytes
  // each, 16-byte pieces copied by the warp's lanes in turn), then its scales
  auto issue = [&](int k, int slot) {
#if INT4_ABLATE == 3
    return;
#endif
    const int g = g0 + warp + k * warps;
    unsigned char* st = ring + slot * stage_bytes;
    float* sdst = reinterpret_cast<float*>(st + rows * TC);
    const int8_t* src = a.packed + static_cast<long long>(g) * half * out_dim + o0;
    const float* ssrc = a.gscale + static_cast<long long>(g) * out_dim + o0;
    if (a.w_vec) {  // a piece lies wholly inside or wholly past the edge
      constexpr int PR = TC / 16;
      for (int q = lane; q < half * PR; q += 32) {
        const int row = q / PR, c = 16 * (q % PR);
        const bool ok = o0 + c < out_dim;
        cp_async16(st + row * TC + c, ok ? src + static_cast<long long>(row) * out_dim + c
                                           : a.packed, ok);
      }
    } else {
      for (int i = lane; i < half * TC; i += 32) {
        const int row = i / TC, c = i % TC;
        st[row * TC + c] = o0 + c < out_dim
                               ? static_cast<unsigned char>(src[static_cast<long long>(row) *
                                                                    out_dim + c])
                               : 0;
      }
    }
    if (a.s_vec) {
      for (int q = lane; q < TC / 4; q += 32) {
        const bool ok = o0 + 4 * q < out_dim;
        cp_async16(sdst + 4 * q, ok ? ssrc + 4 * q : a.gscale, ok);
      }
    } else {
      for (int c = lane; c < TC; c += 32) sdst[c] = o0 + c < out_dim ? ssrc[c] : 0.f;
    }
  };
  for (int k = 0; k < a.stages; ++k) {
    if (k < nk) issue(k, k);
    cp_async_commit();
  }
  cp_async_wait(a.stages);  // x is in (the oldest group)
  __syncthreads();
#if INT4_ABLATE == 5
  cp_async_wait(0);
  return;
#endif

  // rounds of `warps` groups: warp w computes group k warps + w of the run,
  // then the block adds the round's groups in order to the run's sums
  float* part_s = reinterpret_cast<float*>(smem + a.part_off);  // (B, TC): the run's sums
  const int rounds = (ng + warps - 1) / warps;
  for (int k = 0; k < rounds; ++k) {
    if (k < nk) {
      cp_async_wait(a.stages - 1);  // group k is in
      __syncwarp();  // ... all of it: the warp's lanes copied it in turn
      const int slot = k % a.stages;
      const unsigned char* st = ring + slot * stage_bytes;
      const int gl = warp + k * warps;
      float part[NT][2][4];  // m-tiles 0 and 1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][i][e] = 0.f;
      for (int s0 = 0; s0 < a.steps; s0 += CH) {
        // the operands of CH k steps first, then their products
        uint32_t w[CH][2], b[CH][NT][2];  // a lane's word of rows 2t and 2t + 1; x
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const int s = s0 + c;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            w[c][r] = s < a.steps ? *reinterpret_cast<const uint32_t*>(
                                        st + (8 * s + 2 * t + r) * TC + 4 * gid)
                                  : 0u;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int n = 8 * nt + gid;
            const uint2 v = *reinterpret_cast<const uint2*>(
                xs + min(n, a.B - 1) * a.xpitch + gl * a.kpad + 16 * min(s, a.steps - 1) + 4 * t);
            const bool live = n < a.B && s < a.steps;
            b[c][nt][0] = live ? v.x : 0u, b[c][nt][1] = live ? v.y : 0u;
          }
        }
        // every fragment of the chunk in registers of its own, then the products
        // (an HMMA holds its source registers until it is done)
        uint32_t af[CH][2][4];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const uint32_t w0 = w[c][0], w1 = w[c][1], v0 = w0 >> 4, v1 = w1 >> 4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#if INT4_ABLATE == 1 || INT4_ABLATE == 2
            af[c][i][0] = w0 & 0x3F3F3F3Fu, af[c][i][1] = v0 & 0x3F3F3F3Fu;
            af[c][i][2] = w1 & 0x3F3F3F3Fu, af[c][i][3] = v1 & 0x3F3F3F3Fu;
#else
            af[c][i][0] = nibble_pair(w0, v0, 2 * i);
            af[c][i][1] = nibble_pair(w0, v0, 2 * i + 1);
            af[c][i][2] = nibble_pair(w1, v1, 2 * i);
            af[c][i][3] = nibble_pair(w1, v1, 2 * i + 1);
#endif
          }
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (s0 + c >= a.steps) break;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#if INT4_ABLATE == 2
            part[0][i][0] += __uint_as_float(af[c][i][0] ^ af[c][i][1] ^ af[c][i][2] ^
                                             af[c][i][3] ^ b[c][0][0]);
#else
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(part[nt][i], af[c][i], b[c][nt][0], b[c][nt][1]);
#endif
          }
        }
      }
      // the group's partial times its scales
      const float4 s4 = reinterpret_cast<const float4*>(st + rows * TC)[gid];
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
      float* dst = sums + warp * SE + 4 * gid;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = 8 * nt + 2 * t + e;
              if (n < a.B)
                dst[n * SP + 2 * i + h] = __fmul_rn(part[nt][i][2 * h + e], sc[2 * i + h]);
            }
      __syncwarp();  // every lane has read the stage before it is refilled
      if (k + a.stages < nk) issue(k + a.stages, slot);
      cp_async_commit();
    }
    __syncthreads();
#if INT4_ABLATE == 6
    continue;
#endif
    const int in_round = min(warps, ng - k * warps);
    const bool last = k + 1 == rounds;
    for (int e = tid; e < E; e += blockDim.x) {
      const int se = e / TC * SP + e % TC;
      float v[MAX_WARPS];  // the round's sums first, then their chain
#pragma unroll
      for (int w = 0; w < MAX_WARPS; ++w) v[w] = w < in_round ? sums[w * SE + se] : 0.f;
      float acc = k == 0 ? 0.f : part_s[e];
#pragma unroll
      for (int w = 0; w < MAX_WARPS; ++w)
        if (w < in_round) acc = __fadd_rn(acc, v[w]);
      if (last && a.split == 1) {
        const int o = o0 + e % TC;
        if (o < out_dim)
          a.out[static_cast<long long>(e / TC) * out_dim + o] = __float2bfloat16_rn(acc);
      } else {
        part_s[e] = acc;
      }
    }
    if (!last) __syncthreads();  // the round's sums are read before the next round writes them
  }
  if (a.split == 1) return;

  // rank r sums slice r of the cluster's (B, TC) run sums over the ranks in order
  cg::cluster_group cluster = cg::this_cluster();
  cluster_sync_shared();
  const float* peers[MAX_SPLIT];
#pragma unroll
  for (int q = 0; q < MAX_SPLIT; ++q)
    peers[q] = q < a.split ? cluster.map_shared_rank(part_s, q) : part_s;
  const int lo = static_cast<int>(static_cast<long long>(E) * rank / a.split);
  const int hi = static_cast<int>(static_cast<long long>(E) * (rank + 1) / a.split);
  for (int e = lo + tid; e < hi; e += blockDim.x) {
    const int n = e / TC, o = o0 + e % TC;
    if (o >= out_dim) continue;
    float v[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) v[q] = q < a.split ? peers[q][e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      if (q < a.split) sum = __fadd_rn(sum, v[q]);
    a.out[static_cast<long long>(n) * out_dim + o] = __float2bfloat16_rn(sum);
  }
  cluster_sync_relaxed();  // no block leaves while a peer reads it
}

template <int NT>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(int4_mma_kernel<NT>);
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.col_blocks, p.split, 1);
  cfg.blockDim = dim3(32 * p.warps, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int4_mma_kernel<NT>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_shape(int B, int in_dim, int out_dim, int groups) {
  return B >= 1 && B <= 32 && out_dim >= 1 && groups >= 1 && in_dim % groups == 0 &&
         (in_dim / groups) % 2 == 0;
}

}  // namespace


// The launch's plan for a call's shape, into plan[0 .. 7): n8 tiles, warps
// a block, groups a run, runs (cluster size), ring stages, column blocks,
// shared memory bytes a block.  Returns 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int int4_matvec_plan(int B, int in_dim, int out_dim, int groups, int* plan) {
  if (!valid_shape(B, in_dim, out_dim, groups)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, in_dim, out_dim, groups);
  const int fields[7] = {p.nt, p.warps, p.seg, p.split, p.stages, p.col_blocks,
                         static_cast<int>(p.smem)};
  for (int i = 0; i < 7; ++i) plan[i] = fields[i];
  return 0;
}

// x (B, in) bf16, packed (in/2, out) int8, gscale (groups, out) fp32, out
// (B, out) bf16, all contiguous.  One launch on `stream`; returns its
// cudaError_t, or cudaErrorInvalidValue without launching when B is outside
// 1..32, the groups do not split `in` into even sizes, or a block would need
// more shared memory than an SM has.
extern "C" int int4_matvec_bf16(const void* x, const void* packed, const void* gscale, void* out,
                                int B, int in_dim, int out_dim, int groups, void* stream) {
  if (!valid_shape(B, in_dim, out_dim, groups)) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(B, in_dim, out_dim, groups);
  if (p.smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.packed = static_cast<const int8_t*>(packed);
  a.gscale = static_cast<const float*>(gscale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B, a.in_dim = in_dim, a.out_dim = out_dim, a.groups = groups, a.group = in_dim / groups;
  a.seg = p.seg, a.split = p.split, a.steps = p.steps, a.kpad = p.kpad;
  a.stages = p.stages, a.xpitch = p.xpitch;
  a.ring_warp = p.ring_warp;
  a.sums_off = p.sums_off, a.part_off = p.part_off, a.x_off = p.x_off;
  a.w_vec = reinterpret_cast<uintptr_t>(packed) % 16 == 0 && out_dim % 16 == 0;
  a.s_vec = reinterpret_cast<uintptr_t>(gscale) % 16 == 0 && out_dim % 4 == 0;
  a.x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && in_dim % 8 == 0 && a.group % 8 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p.nt) {
    case 1: err = launch<1>(a, p, st); break;
    case 2: err = launch<2>(a, p, st); break;
    case 3: err = launch<3>(a, p, st); break;
    default: err = launch<4>(a, p, st); break;
  }
  return static_cast<int>(err);
}
