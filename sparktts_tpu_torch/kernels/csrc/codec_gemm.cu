// The codec's fp32 convolutions and matrix products, as one GEMM core.
//
// Replaces no Pallas kernel: the JAX package leaves these ops to XLA, which
// compiles one fixed algorithm per program at HIGHEST precision.  On the
// card the port would otherwise run them on cuDNN and cuBLAS, whose
// precision (the TF32 flags) and algorithm (chosen by shape and free
// workspace) are process-wide state.  This kernel has neither.
//
// One fp32 GEMM, out[m, n] = sum_k A[m, k] B[k, n], with A and B read
// through index maps, in three entry points:
//
//   conv1d            y[b, t, g Ng + n] = sum_tap sum_c
//                       x[b, t stride + tap dil - pad, g Cg + c] W[tap, c, g Ng + n]
//                     on channels-last x (any strides) and the stored WIO
//                     kernel (K, Cg, Cout); zero outside [0, T_in); groups
//                     are a grid axis; a linear is K = 1.
//   conv_transpose1d  groups = 1, torch semantics, by the phase mapping of
//                     the JAX package's `_conv_transpose1d_subpixel`: output
//                     o = s u + phi - p takes the stored (flipped) taps
//                     K - 1 - phi - s d from inputs x[u - d]; the phases are
//                     a grid axis, so a block's rows share their taps.
//   bmm               (G1, G2, M, K) x (G1, G2, K, N), each operand and the
//                     output given by strides.
//
// Epilogue: times the per-column scale (an int8 kernel's), then plus the
// bias, each where given.
//
// Invariant.  Each output element is a function of its own inputs and of
// the call's weight shape (K, N and the taps) only: never of M, B, T, the
// tile chosen, the grid, the stream or the allocator.  Its arithmetic is
// 3xTF32 on the tensor cores (a = a_hi + a_lo with a_hi = tf32(a), a_lo =
// tf32(a - a_hi), rounded to nearest, ties away; each k8 chunk adds lo.hi,
// hi.lo, hi.hi in that order to an fp32 accumulator; lo.lo, ~2^-22 of a
// product, is dropped).  The reduction k = 0 .. K_red - 1 (K_red = taps x
// Cg) is cut into segments of KSEG = 512 (a function of K_red alone): each
// segment is summed from zero over its chunks of 8 in increasing k, and the
// segments' sums are added in increasing order in fp32.  Rows past M,
// columns past N and k past K_red are zeros.  Whether a block folds all of
// its tile's segments itself or each segment has a block of its own and a
// second pass adds their partials (an fp32 workspace the wrapper
// allocates) changes no bit; neither do the tile or the grid, so all three
// follow the shape.  No atomics.  The kernel never reads PyTorch's TF32
// flags.  The segments also bound the tensor cores' truncated sums (they
// round the fp32 sum toward zero at each step, kernel 3's finding) to 64
// chunks.
//
// mma.sync and wgmma give the same bits: `codec_mma_probe` runs one 64 x
// 256 x 8 product chunk by chunk as above through `wgmma.mma_async`
// m64n8k8 and through `mma.sync` m16n8k8, and on an H100 the two are equal
// (tests/test_torch_cuda_kernels.py holds it).  Every tile here is `wgmma`;
// a `mma.sync` path would give the same bits.
//
// Design.  A block is one or two consumer warpgroups (64 rows each) and
// one producer warp, over a ring of STAGES = 4 raw fp32 stages of BK = 32 k
// in dynamic shared memory, with an `mbarrier` a stage for "landed" and
// one for "read".  The producer's lane 0 loads each stage's boxes with TMA
// (`cp.async.bulk.tensor`, tensor maps made by the launcher) wherever the
// copy engine takes the operand: A, a conv's channels within one tap of BM
// input rows (every stride-th row, a box per tap, padding zero-filled by
// the engine) or a bmm's rows, in 128-byte rows swizzled as TMA's 128-byte
// mode so the fragment loads are conflict-free; B, BK weight rows of BN
// columns.  Where it does not (wav2vec2's conv0 with Cin = 1, channels not
// a multiple of 32 across taps, strided or unaligned views, weight rows not
// a multiple of 4 wide as conv_out's and the mel basis's), the producer's
// 32 lanes copy with `cp.async` (16
// bytes where a row is contiguous and aligned, else 4; a row's and a tap's
// index math once a row a stage).  The consumers split each landed B tile
// once a block into hi and lo, written K-major (tf32 `wgmma` takes only
// K-major operands) in no-swizzle core matrices (8 columns x 4 k, 128
// bytes; descriptor: leading offset = the next 4 k, BN x 16 bytes; stride
// offset = the next 8 columns, 128 bytes); load and split their A
// fragments in registers (A from registers); and issue the stage's 12
// `wgmma`s.  The next stage is split while they run (two split buffers,
// two register sets).  Tiles: 128 x 64 (two warpgroups, one B split),
// 64 x 64, 64 x 32, 64 x 16 and 64 x 8, by shape (`plan`; wider tiles were
// never the fastest at the codec's calls).
//
// What bounds it on an H100: operations at the codec's large shapes (the
// vocoder's conv_in, 1024 -> 1536, k7, at 500 rows: 3 x 11 GFLOP of tf32
// products, 0.067 ms at 495 TFLOP/s, against 14 MB, 0.004 ms, at 3.35
// TB/s; the upsamplers and wav2vec2's linears alike).  The ring keeps the
// copies off the consumers, the tiles fill the 132 SMs, and a block a
// segment gives the outputs with few tiles (wav2vec2's 299-row linears, the
// positional conv) enough blocks.  What holds it below that bound is the
// consumers' work a stage: the hi/lo splits (two integer operations a
// rounding, not the quarter-rate conversion) and the products' chain on
// one accumulator.  Bytes bound the linears at one row and conv_out (N =
// 1): the 64 x 32 to 64 x 8 tiles, a block for every few columns, read each
// weight byte once; their rows past M cost tensor-core time (masked zeros)
// that the bytes hide.  Times on the card are in PERF.md
// (chip_smoke.py, scripts/bench_torch_codec_tiles.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;      // k a ring stage
constexpr int STAGES = 4;   // ring depth
constexpr int KSEG = 512;   // k a segment: summed from zero, segments added in order
constexpr int SMS = 132;    // H100 SXM streaming multiprocessors
constexpr int PL = 32;      // the producer's lanes: a warp

// Built with -DCODEC_ABLATE=n by scripts/bench_torch_codec_tiles.py --ablate
// (wrong results, times only): 1 no products, 2 no copies, 3 no splits.
#ifndef CODEC_ABLATE
#define CODEC_ABLATE 0
#endif

// Where A, B and the output live.  Conv: the grid's z is (batch, group,
// phase) [, segment]; a row m is an output position (or, transposed, the u
// of a phase).  Bmm: z is (g1, g2) [, segment].
struct Params {
  int mode;  // 0 conv, 1 bmm
  int M, N, Kred, zdim;
  // conv
  const float* x;
  long long sxb, sxt, sxc;
  int t_in, cg;
  int row_step, tap_step, off;  // input position = m row_step + j tap_step + off
  const float* w;
  int k_w, cout;
  int wtap_base, wtap_phase, wtap_step;  // stored tap = base + phase wtap_phase + j wtap_step
  float* y;
  int t_out, out_step, out_off;  // output position = m out_step + out_off + phase
  int groups, phases;
  const float* scale;
  const float* bias;
  // bmm
  const float* a;
  long long sa1, sa2, sam, sak;
  const float* b;
  long long sb1, sb2, sbk, sbn;
  float* c;
  long long sc1, sc2, scm, scn;
  int g2;
  // host only: the tensor maps' extents
  int cin, batch, g1;
  // plan
  int a_tma, b_tma;  // A, B by tensor-map boxes (else by the producer's cp.async)
  int b_kmajor;      // bmm B with unit k stride: boxes of BN columns x BK k, swizzled
  int a_vec, b_vec;  // cp.async by 16 bytes: A rows (along k), B rows (along n)
  int nseg, split;   // segments of Kred; 1: a block a segment, partials to ws
  float* ws;         // (nseg, zdim, M, N) partials when split
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// tf32(v), rounded to nearest with ties away from zero: `cvt.rna.tf32.f32`'s
// bits for every finite v, by two integer operations (sm_90 issues type
// conversions at a quarter of its integer rate: the CUDA C++ Programming
// Guide's throughput table)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// the barrier counts one arrival of this thread when its earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving a register's use across a wgmma wait
template <int L>
__device__ __forceinline__ void fence_regs(float (&r)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A no-swizzle K-major operand in shared memory: core matrices of 8 rows x
// 16 bytes; `lbo` bytes to the next 4 k, `sbo` bytes to the next 8 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// D (64 x N, fp32, in registers) += A (64 x 8, tf32 fragment in registers)
// B (8 x N, K-major tf32 in shared memory, by descriptor)
template <int N>
__device__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// the (z, m, n) output element, after the scale and the bias
__device__ __forceinline__ void store_out(const Params& p, int z, int m, int n, float r) {
  if (p.mode == 0) {
    const int phase = z % p.phases, grp = (z / p.phases) % p.groups;
    const int bat = z / (p.phases * p.groups);
    const int to = m * p.out_step + p.out_off + phase;
    if (to < 0 || to >= p.t_out) return;
    const int col = grp * p.N + n;
    if (p.scale) r *= p.scale[col];
    if (p.bias) r += p.bias[col];
    p.y[(static_cast<long long>(bat) * p.t_out + to) * p.cout + col] = r;
  } else {
    const int g1 = z / p.g2, g2 = z % p.g2;
    p.c[g1 * p.sc1 + g2 * p.sc2 + m * p.scm + n * p.scn] = r;
  }
}

// The block's slice: conv x at (batch, group's first channel), the group's
// weights and the phase's first stored tap; bmm a and b at (g1, g2).
struct Slice {
  const float* xa;
  const float* wb;
  int wtap0;
};

__device__ __forceinline__ Slice slice_of(const Params& p, int z) {
  Slice s;
  if (p.mode == 0) {
    const int phase = z % p.phases, grp = (z / p.phases) % p.groups;
    const int bat = z / (p.phases * p.groups);
    s.xa = p.x + bat * p.sxb + static_cast<long long>(grp) * p.cg * p.sxc;
    s.wb = p.w + static_cast<long long>(grp) * p.N;
    s.wtap0 = p.wtap_base + phase * p.wtap_phase;
  } else {
    const int g1 = z / p.g2, g2 = z % p.g2;
    s.xa = p.a + g1 * p.sa1 + g2 * p.sa2;
    s.wb = p.b + g1 * p.sb1 + g2 * p.sb2;
    s.wtap0 = 0;
  }
  return s;
}

// A stage's raw A: BM rows of BK k (128 bytes), each row's 16-byte chunks
// swizzled (chunk q of row r at q ^ (r % 8), TMA's 128-byte swizzle), so
// the consumers' fragment loads are conflict-free.
__device__ __forceinline__ int a_word(int r, int k) {
  return r * BK + ((((k >> 2) ^ r) & 7) << 2) + (k & 3);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one box of a rank-4 tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// The producer warpgroup's copies of one ring stage, k0 .. k0 + BK - 1,
// for an operand without a tensor map (`lane` 0 .. PL - 1): raw A
// (swizzled rows) and raw B (BK k rows of BN columns, N-major), each copy
// zero-filled past kend, outside the input, or at a tap outside the
// kernel.  Rows past M are not copied.
template <int BM, int BN>
__device__ __forceinline__ void produce_cp(const Params& p, const Slice& sl, int m0, int n0,
                                           int k0, int kend, float* ra, float* rb, int lane) {
  const int rows = min(BM, p.M - m0);
  const float* dummy_a = p.x ? p.x : p.a;
  if (!p.a_tma && p.a_vec) {  // a lane copies 4 k (one tap's channels) of every 4th row
    const int q = lane % 8, kk = k0 + 4 * q;
    const int valid = min(4, kend - kk);
    int base = 0, c = kk;
    if (p.mode == 0) {
      const int j = kk / p.cg;
      c = kk - j * p.cg;
      base = j * p.tap_step + p.off;
    }
    for (int r = lane / 8; r < rows; r += PL / 8) {
      const int m = m0 + r;
      const float* src;
      bool ok = valid > 0;
      if (p.mode == 0) {
        const int ti = m * p.row_step + base;
        ok = ok && ti >= 0 && ti < p.t_in;
        src = sl.xa + ti * p.sxt + c;
      } else {
        src = sl.xa + m * p.sam + kk;
      }
      cp16(smem_u32(ra + a_word(r, 4 * q)), ok ? src : dummy_a, ok ? 4 * valid : 0);
    }
  } else if (!p.a_tma) {  // a lane copies one k of every (PL / BK)th row
    const int kk = k0 + lane % BK;
    const bool kin = kk < kend;
    int base = 0, c = kk;
    if (p.mode == 0) {
      const int j = kk / p.cg;
      c = kk - j * p.cg;
      base = j * p.tap_step + p.off;
    }
    for (int r = lane / BK; r < rows; r += PL / BK) {
      const int m = m0 + r;
      const float* src;
      bool ok = kin;
      if (p.mode == 0) {
        const int ti = m * p.row_step + base;
        ok = ok && ti >= 0 && ti < p.t_in;
        src = sl.xa + ti * p.sxt + c * p.sxc;
      } else {
        src = sl.xa + m * p.sam + kk * p.sak;
      }
      cp4(smem_u32(ra + a_word(r, lane % BK)), ok ? src : dummy_a, ok ? 4 : 0);
    }
  }
  if (p.b_tma) return;
  const float* dummy = p.w ? p.w : p.b;
  if (p.b_vec) {  // a lane copies 4 columns of every (PL / (BN / 4))th k row
    constexpr int VPR = BN / 4, RPI = PL / VPR;
    const int v = lane % VPR, n = n0 + 4 * v, nvalid = min(4, p.N - n);
    if (nvalid <= 0) return;
    int kk = k0 + lane / VPR, j = 0, c = kk;
    if (p.mode == 0) {
      j = kk / p.cg;
      c = kk - j * p.cg;
    }
#pragma unroll 4
    for (int r = lane / VPR; r < BK; r += RPI, kk += RPI) {
      const float* src;
      bool ok = kk < kend;
      if (p.mode == 0) {
        const int tap = sl.wtap0 + j * p.wtap_step;
        ok = ok && tap >= 0 && tap < p.k_w;
        src = sl.wb + (static_cast<long long>(tap) * p.cg + c) * p.cout + n;
        c += RPI;
        while (c >= p.cg) c -= p.cg, ++j;
      } else {
        src = sl.wb + kk * p.sbk + n;
      }
      cp16(smem_u32(rb + r * BN + 4 * v), ok ? src : dummy, ok ? 4 * nvalid : 0);
    }
  } else {  // a lane copies every LN-th column of every (PL / LN)th k row
    constexpr int LN = BN < PL ? BN : PL, RPI = PL / LN;
    const int cc0 = lane % LN;
    int kk = k0 + lane / LN, j = 0, c = kk;
    if (p.mode == 0) {
      j = kk / p.cg;
      c = kk - j * p.cg;
    }
    for (int r = lane / LN; r < BK; r += RPI, kk += RPI) {
      bool ok = kk < kend;
      const float* row;
      long long sn;
      if (p.mode == 0) {
        const int tap = sl.wtap0 + j * p.wtap_step;
        ok = ok && tap >= 0 && tap < p.k_w;
        row = sl.wb + (static_cast<long long>(tap) * p.cg + c) * p.cout;
        sn = 1;
        c += RPI;
        while (c >= p.cg) c -= p.cg, ++j;
      } else {
        row = sl.wb + kk * p.sbk;
        sn = p.sbn;
      }
      for (int cc = cc0; cc < BN && n0 + cc < p.N; cc += LN)
        cp4(smem_u32(rb + r * BN + cc), ok ? row + (n0 + cc) * sn : dummy, ok ? 4 : 0);
    }
  }
}

// The producer's one lane: the stage's boxes of the operands with a tensor
// map (A: channels within one tap of BM rows, by the conv's row step; B:
// BK weight rows of BN columns), both landing on `bar`, past-the-end
// coordinates zero-filled by the copy engine.
template <int BM, int BN>
__device__ __forceinline__ void produce_tma(const Params& p, const CUtensorMap* ta,
                                            const CUtensorMap* tb, int z, int m0, int n0, int k0,
                                            float* ra, float* rb, uint64_t* bar) {
  const uint32_t bytes = (p.a_tma ? BM * BK * 4 : 0) + (p.b_tma ? BK * BN * 4 : 0);
  mbar_expect_tx(bar, bytes);
  if (p.mode == 0) {
    const int phase = z % p.phases, grp = (z / p.phases) % p.groups;
    const int bat = z / (p.phases * p.groups);
    const int j = k0 / p.cg, c0 = k0 - j * p.cg;
    if (p.a_tma)
      tma_load(smem_u32(ra), ta, grp * p.cg + c0, m0 * p.row_step + j * p.tap_step + p.off, bat,
               0, bar);
    const int tap = p.wtap_base + phase * p.wtap_phase + j * p.wtap_step;
    if (p.b_tma) tma_load(smem_u32(rb), tb, grp * p.N + n0, tap * p.cg + c0, 0, 0, bar);
  } else {
    const int g1 = z / p.g2, g2 = z % p.g2;
    if (p.a_tma) tma_load(smem_u32(ra), ta, k0, m0, g2, g1, bar);
    if (p.b_tma && p.b_kmajor)
      tma_load(smem_u32(rb), tb, k0, n0, g2, g1, bar);
    else if (p.b_tma)
      tma_load(smem_u32(rb), tb, n0, k0, g2, g1, bar);
  }
}

// All consumers: the landed raw B stage (N-major, or K-major in swizzled
// rows as A) -> hi and lo, K-major core matrices (word ((k / 4) (BN / 8) +
// n / 8) 32 + (n % 8) 4 + k % 4); columns past N are zeros.
template <int BN, int NCONS>
__device__ __forceinline__ void split_b(const Params& p, const float* rb, uint32_t* hi,
                                        uint32_t* lo, int n0, int ctid) {
#pragma unroll
  for (int idx = ctid; idx < (BK / 4) * BN; idx += NCONS) {
    const int n = idx % BN, kq = idx / BN;
    uint4 h, l;
    if (n0 + n < p.N) {
      float4 v;
      if (p.b_kmajor)
        v = *reinterpret_cast<const float4*>(rb + a_word(n, 4 * kq));
      else
        v = make_float4(rb[(4 * kq + 0) * BN + n], rb[(4 * kq + 1) * BN + n],
                        rb[(4 * kq + 2) * BN + n], rb[(4 * kq + 3) * BN + n]);
      split(v.x, h.x, l.x);
      split(v.y, h.y, l.y);
      split(v.z, h.z, l.z);
      split(v.w, h.w, l.w);
    } else {
      h = make_uint4(0, 0, 0, 0);
      l = h;
    }
    const int o = ((kq * (BN / 8) + n / 8) * 8 + n % 8) * 4;
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// A consumer thread's A fragments of one stage (rows r, r + 8; k t, t + 4
// of each chunk of 8), split in registers; rows past M are zeros.
__device__ __forceinline__ void load_a(const float* ra, int r, bool lo_ok, bool hi_ok, int t,
                                       uint32_t (&ah)[BK / 8][4], uint32_t (&al)[BK / 8][4]) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const int k = 8 * ks + t;
    split(lo_ok ? ra[a_word(r, k)] : 0.f, ah[ks][0], al[ks][0]);
    split(hi_ok ? ra[a_word(r + 8, k)] : 0.f, ah[ks][1], al[ks][1]);
    split(lo_ok ? ra[a_word(r, k + 4)] : 0.f, ah[ks][2], al[ks][2]);
    split(hi_ok ? ra[a_word(r + 8, k + 4)] : 0.f, ah[ks][3], al[ks][3]);
  }
}

// the stage's three products a k8 chunk: lo.hi, hi.lo, hi.hi
template <int BN>
__device__ __forceinline__ void issue(float (&acc)[BN / 2], const uint32_t (&ah)[BK / 8][4],
                                      const uint32_t (&al)[BK / 8][4], uint32_t hi, uint32_t lo) {
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    const uint32_t off = ks * BN * 32;  // two core matrices of 4 k for each 8 columns
    const uint64_t dh = smem_desc(hi + off, BN * 16, 128), dl = smem_desc(lo + off, BN * 16, 128);
    wgmma_tf32<BN>(acc, al[ks], dh);
    wgmma_tf32<BN>(acc, ah[ks], dl);
    wgmma_tf32<BN>(acc, ah[ks], dh);
  }
}

template <int WGS, int BN>
struct Tile {
  static constexpr int BM = 64 * WGS, NCONS = 128 * WGS, THREADS = NCONS + PL;
  static constexpr int A_WORDS = BM * BK, B_WORDS = BK * BN;
  // A ring (1024-byte aligned, for the swizzle), B ring, split B [2][hi, lo], barriers
  static constexpr int SMEM = (STAGES * (A_WORDS + B_WORDS) + 4 * B_WORDS) * 4 + 2 * STAGES * 8;
};

template <int WGS, int BN>
__global__ void __launch_bounds__(Tile<WGS, BN>::THREADS, 1)
    codec_gemm_kernel(const Params p, const __grid_constant__ CUtensorMap ta,
                      const __grid_constant__ CUtensorMap tb) {
  using T = Tile<WGS, BN>;
  constexpr int BM = T::BM, NCONS = T::NCONS;
  extern __shared__ __align__(1024) uint32_t smem[];
  float* ring_a = reinterpret_cast<float*>(smem);  // [STAGES][BM x BK]
  float* ring_b = ring_a + STAGES * T::A_WORDS;    // [STAGES][BK x BN]
  uint32_t* bsplit = smem + STAGES * (T::A_WORDS + T::B_WORDS);  // [2][hi, lo][BK x BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(bsplit + 4 * T::B_WORDS);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int z = blockIdx.z, seg0 = 0, seg1 = p.nseg;
  if (p.split) {
    seg0 = z % p.nseg;
    seg1 = seg0 + 1;
    z /= p.nseg;
  }
  const int kbeg = seg0 * KSEG, kend = min(p.Kred, seg1 * KSEG);
  const int nst = (kend - kbeg + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], PL + 1);  // the producer's lanes' copies, and its tensor-map boxes
      mbar_init(&empty[i], NCONS / 32);
    }
  }
  __syncthreads();

  if (warp >= NCONS / 32) {  // the producer
    const int plane = tid - NCONS;
    const Slice sl = slice_of(p, z);
    for (int s = 0; s < nst; ++s) {
      const int slot = s % STAGES;
      if (s >= STAGES) mbar_wait(&empty[slot], (s / STAGES - 1) & 1);
      float *ra = ring_a + slot * T::A_WORDS, *rb = ring_b + slot * T::B_WORDS;
      const int k0 = kbeg + s * BK;
      if (CODEC_ABLATE != 2) produce_cp<BM, BN>(p, sl, m0, n0, k0, kend, ra, rb, plane);
      cp_async_arrive(&full[slot]);
      if (plane == 0) {
        if (CODEC_ABLATE != 2)
          produce_tma<BM, BN>(p, &ta, &tb, z, m0, n0, k0, ra, rb, &full[slot]);
        else
          mbar_arrive(&full[slot]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers
  const int g = lane / 4, t = lane % 4;
  const int r = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this thread's first row in the tile
  const bool lo_ok = m0 + r < p.M, hi_ok = m0 + r + 8 < p.M;
  float acc[BN / 2], tot[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = tot[i] = 0.f;
  uint32_t ah0[BK / 8][4], al0[BK / 8][4], ah1[BK / 8][4], al1[BK / 8][4];

  auto prepare = [&](int s, uint32_t(&ah)[BK / 8][4], uint32_t(&al)[BK / 8][4], int buf) {
    const int slot = s % STAGES;
    mbar_wait(&full[slot], (s / STAGES) & 1);
    uint32_t* hi = bsplit + buf * 2 * T::B_WORDS;
    if (CODEC_ABLATE != 3) {
      split_b<BN, NCONS>(p, ring_b + slot * T::B_WORDS, hi, hi + T::B_WORDS, n0, tid);
      load_a(ring_a + slot * T::A_WORDS, r, lo_ok, hi_ok, t, ah, al);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    fence_proxy_async();  // the split tiles, written by this thread, to the tensor cores
  };
  bool first = true;
  auto step = [&](int s, const uint32_t(&ah)[BK / 8][4], const uint32_t(&al)[BK / 8][4],
                  int buf, uint32_t(&nah)[BK / 8][4], uint32_t(&nal)[BK / 8][4], int nbuf) {
    consumers_sync(NCONS);  // every consumer's split of stage s is written
    const uint32_t hi = smem_u32(bsplit + buf * 2 * T::B_WORDS);
    fence_regs(acc);
    wgmma_fence();
    if (CODEC_ABLATE != 1) issue<BN>(acc, ah, al, hi, hi + T::B_WORDS * 4);
    wgmma_commit();
    if (s + 1 < nst) prepare(s + 1, nah, nal, nbuf);  // while the products run
    wgmma_wait<0>();
    fence_regs(acc);
    if (((s + 1) * BK) % KSEG == 0 || s + 1 == nst) {  // a segment's sum is complete
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        tot[i] = first ? acc[i] : tot[i] + acc[i];
        acc[i] = 0.f;
      }
      first = false;
    }
  };

  prepare(0, ah0, al0, 0);
  for (int s = 0; s < nst; s += 2) {
    step(s, ah0, al0, 0, ah1, al1, 1);
    if (s + 1 < nst) step(s + 1, ah1, al1, 1, ah0, al0, 0);
  }

  // accumulator element 4j + v: row g (v < 2) or g + 8, column 8j + 2t + (v & 1)
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int m = m0 + r + 8 * (v >> 1), n = n0 + 8 * j + 2 * t + (v & 1);
      if (m >= p.M || n >= p.N) continue;
      if (p.split)
        p.ws[((static_cast<long long>(seg0) * p.zdim + z) * p.M + m) * p.N + n] = tot[4 * j + v];
      else
        store_out(p, z, m, n, tot[4 * j + v]);
    }
}

// The second pass: each element's segment partials added in increasing
// order, then the epilogue.
__global__ void __launch_bounds__(256) codec_fold_kernel(const Params p) {
  const long long total = static_cast<long long>(p.zdim) * p.M * p.N;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  float r = p.ws[e];
  for (int s = 1; s < p.nseg; ++s) r += p.ws[s * total + e];
  const int n = static_cast<int>(e % p.N);
  const int m = static_cast<int>((e / p.N) % p.M);
  store_out(p, static_cast<int>(e / (static_cast<long long>(p.M) * p.N)), m, n, r);
}

// the tiles, by index: (warpgroups, BN)
constexpr int NTILES = 5;
constexpr int TILE_WGS[NTILES] = {2, 1, 1, 1, 1};
constexpr int TILE_BN[NTILES] = {64, 64, 32, 16, 8};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A rank-4 fp32 tensor map (extents innermost first, strides in elements of
// dims 1..3); false where the copy engine cannot take it (then the
// producer's cp.async copies the operand).  A dim of extent 1 gets a valid
// stride whatever it was given (a broadcast batch dim has stride 0).
bool encode(CUtensorMap* map, const float* base, const long long (&dims)[4],
            const long long (&strides)[3], const unsigned (&box)[4], const unsigned (&step)[4],
            bool swizzle) {
  const EncodeTiled fn = encode_fn();
  if (!fn || (reinterpret_cast<uintptr_t>(base) & 15)) return false;
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], es[4];
  long long span = dims[0];
  for (int i = 0; i < 4; ++i) {
    if (dims[i] < 1 || dims[i] > (1LL << 32) || box[i] > 256) return false;
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = box[i];
    es[i] = step[i];
    if (i == 0) continue;
    const long long stride = dims[i] == 1 ? (span + 3) / 4 * 4 : strides[i - 1];
    if (stride < 1 || stride % 4 || stride * 4 >= (1LL << 40)) return false;
    st[i - 1] = static_cast<cuuint64_t>(stride) * 4;
    span = stride * dims[i];
  }
  // the last maps this thread made, by a hash of what they encode (a call's
  // weights, and often its activations, are where they were the last time)
  struct Entry {
    unsigned long long key[16];
    CUtensorMap map;
    bool valid;
  };
  static thread_local Entry cache[32];
  unsigned long long key[16] = {reinterpret_cast<uintptr_t>(base), swizzle};
  for (int i = 0; i < 4; ++i) key[2 + i] = d[i], key[6 + i] = (bx[i] << 8) | es[i];
  for (int i = 0; i < 3; ++i) key[10 + i] = st[i];
  unsigned long long h = 1469598103934665603ULL;
  for (unsigned long long k : key) h = (h ^ k) * 1099511628211ULL;
  Entry& e = cache[h % 32];
  bool hit = e.valid;
  for (int i = 0; hit && i < 16; ++i) hit = e.key[i] == key[i];
  if (hit) {
    *map = e.map;
    return true;
  }
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), d, st, bx, es,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  for (int i = 0; i < 16; ++i) e.key[i] = key[i];
  e.map = *map;
  e.valid = true;
  return true;
}

// A's map: a box of BK k by BM rows (every row_step-th input row).
bool map_a(const Params& p, int bm, CUtensorMap* map) {
  if (p.mode == 0)
    return bm * p.row_step <= 256 &&
           encode(map, p.x, {p.cin, p.t_in, p.batch, 1}, {p.sxt, p.sxb, 0},
                  {BK, static_cast<unsigned>(bm * p.row_step), 1, 1},
                  {1, static_cast<unsigned>(p.row_step), 1, 1}, true);
  return encode(map, p.a, {p.Kred, p.M, p.g2, p.g1}, {p.sam, p.sa2, p.sa1},
                {BK, static_cast<unsigned>(bm), 1, 1}, {1, 1, 1, 1}, true);
}

// B's map: a box of BN columns by BK k rows.
bool map_b(const Params& p, int bn, CUtensorMap* map) {
  if (p.mode == 0)
    return encode(map, p.w, {p.cout, static_cast<long long>(p.k_w) * p.cg, 1, 1},
                  {p.cout, 0, 0}, {static_cast<unsigned>(bn), BK, 1, 1}, {1, 1, 1, 1}, false);
  if (p.b_kmajor)
    return encode(map, p.b, {p.Kred, p.N, p.g2, p.g1}, {p.sbn, p.sb2, p.sb1},
                  {BK, static_cast<unsigned>(bn), 1, 1}, {1, 1, 1, 1}, true);
  return encode(map, p.b, {p.N, p.Kred, p.g2, p.g1}, {p.sbk, p.sb2, p.sb1},
                {static_cast<unsigned>(bn), BK, 1, 1}, {1, 1, 1, 1}, false);
}

template <int WGS, int BN>
int launch_tile(Params p, cudaStream_t stream) {
  using T = Tile<WGS, BN>;
  CUtensorMap ta{}, tb{};
  p.a_tma = p.a_tma && map_a(p, T::BM, &ta);
  p.b_tma = p.b_tma && map_b(p, BN, &tb);
  p.b_kmajor = p.b_kmajor && p.b_tma;  // without a map, the producer's 4-byte copies
  const long long gz = static_cast<long long>(p.zdim) * (p.split ? p.nseg : 1);
  const dim3 grid((p.M + T::BM - 1) / T::BM, (p.N + BN - 1) / BN, static_cast<unsigned>(gz));
  if (grid.y > 65535 || gz > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long attr_set = 0;  // a bit a card: its shared-memory limit raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !(attr_set >> dev & 1)) {
    err = cudaFuncSetAttribute(codec_gemm_kernel<WGS, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attr_set |= 1ULL << dev;
  }
  codec_gemm_kernel<WGS, BN><<<grid, T::THREADS, T::SMEM, stream>>>(p, ta, tb);
  err = cudaGetLastError();
  if (err != cudaSuccess || !p.split) return static_cast<int>(err);
  const long long total = gz / p.nseg * p.M * p.N;
  codec_fold_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

long long blocks(const Params& p, int tile, bool split) {
  const int bm = 64 * TILE_WGS[tile], bn = TILE_BN[tile];
  return static_cast<long long>((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn) * p.zdim *
         (split ? p.nseg : 1);
}

// The plan by shape (config < 0), or config = tile + NTILES split (the
// tests run every one: the bits are the same).  Measured on an H100 at the
// codec's calls (scripts/bench_torch_codec_tiles.py): from 128 x 64 (64 x
// 32 where N is an odd multiple of 32 or the tile has one row block; the
// narrowest at least N wide below 64), the first tile, narrowing, whose
// blocks give two SMs in three a block, each k segment a block of its own
// where the tile alone gives fewer than two blocks an SM and the partials
// take at most 32 MB; else the narrowest.
void plan(const Params& p, int config, int* tile, int* split) {
  *split = config / NTILES;
  *tile = config % NTILES;
  if (config >= 0) return;
  int t = 0;  // 128 x 64
  if (p.N < 64)
    for (t = 1; t + 1 < NTILES && TILE_BN[t + 1] >= p.N;) ++t;
  else if (p.N % 64 == 32 || p.M <= 64)
    t = 2;
  const bool fold_fits = 4LL * p.nseg * p.zdim * p.M * p.N <= (32LL << 20);
  for (;; ++t) {
    *tile = t;
    *split = p.nseg > 1 && fold_fits && blocks(p, t, false) < 2 * SMS;
    if (blocks(p, t, *split) * 3 >= 2 * SMS || t + 1 == NTILES) return;
  }
}

// Returns 0 or a CUDA error; -1 (nothing launched) when the plan needs a
// workspace larger than ws_bytes: *ws_need is then its size.
int launch(Params p, int config, void* ws, long long ws_bytes, long long* ws_need,
           cudaStream_t stream) {
  if (p.M < 1 || p.N < 1 || p.Kred < 1 || p.zdim < 1 || config >= 2 * NTILES)
    return static_cast<int>(cudaErrorInvalidValue);
  p.nseg = (p.Kred + KSEG - 1) / KSEG;
  int tile, split;
  plan(p, config, &tile, &split);
  p.split = split && p.nseg > 1;
  if (p.split) {
    const long long need = 4LL * p.nseg * p.zdim * p.M * p.N;
    if (ws_bytes < need || !ws) {
      *ws_need = need;
      return -1;
    }
    p.ws = static_cast<float*>(ws);
  }
  switch (tile) {
    case 0: return launch_tile<2, 64>(p, stream);
    case 1: return launch_tile<1, 64>(p, stream);
    case 2: return launch_tile<1, 32>(p, stream);
    case 3: return launch_tile<1, 16>(p, stream);
    default: return launch_tile<1, 8>(p, stream);
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The question whether mma.sync and wgmma give the same bits: one block of
// a warpgroup computes out = A (64 x K) B (K x 8), both row-major, by the
// 3xTF32 chunks above, once with wgmma m64n8k8 into out_wgmma and once
// with mma.sync m16n8k8 (a warp a 16-row slice) into out_mma.
__global__ void __launch_bounds__(128) mma_probe_kernel(const float* a, const float* b,
                                                        float* out_wgmma, float* out_mma,
                                                        int K) {
  __shared__ __align__(128) uint32_t bh[256 * 8], bl[256 * 8];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  for (int idx = tid; idx < K * 8; idx += 128) {  // B split into core matrices (BN = 8)
    const int k = idx / 8, n = idx % 8, o = ((k / 4) * 8 + n) * 4 + k % 4;
    split(b[idx], bh[o], bl[o]);
  }
  fence_proxy_async();
  __syncthreads();
  const int r = warp * 16 + g;
  float dw[4] = {0.f, 0.f, 0.f, 0.f}, dm[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4], bh0, bh1, bl0, bl1;
    split(a[r * K + k0 + t], ah[0], al[0]);
    split(a[(r + 8) * K + k0 + t], ah[1], al[1]);
    split(a[r * K + k0 + t + 4], ah[2], al[2]);
    split(a[(r + 8) * K + k0 + t + 4], ah[3], al[3]);
    const uint32_t off = k0 * 8 * 4;
    const uint64_t dh = smem_desc(smem_u32(bh) + off, 128, 128);
    const uint64_t dl = smem_desc(smem_u32(bl) + off, 128, 128);
    fence_regs(dw);
    wgmma_fence();
    wgmma_tf32<8>(dw, al, dh);
    wgmma_tf32<8>(dw, ah, dl);
    wgmma_tf32<8>(dw, ah, dh);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dw);
    split(b[(k0 + t) * 8 + g], bh0, bl0);
    split(b[(k0 + t + 4) * 8 + g], bh1, bl1);
    mma_tf32(dm, al, bh0, bh1);
    mma_tf32(dm, ah, bl0, bl1);
    mma_tf32(dm, ah, bh0, bh1);
  }
  for (int v = 0; v < 4; ++v) {
    const int o = (r + 8 * (v >> 1)) * 8 + 2 * t + (v & 1);
    out_wgmma[o] = dw[v];
    out_mma[o] = dm[v];
  }
}

}  // namespace

// x (B, T_in, groups Cg) fp32 with element strides (sxb, sxt, sxc); w (K, Cg,
// Cout) contiguous; y (B, T_out, Cout) contiguous; scale and bias (Cout,) or
// null.  T_out = (T_in + 2 pad - dil (K - 1) - 1) / stride + 1 is the
// caller's.  Cout must be a multiple of groups.  config < 0: the plan by
// shape; ws, ws_bytes, ws_need: the workspace protocol of `launch`.
extern "C" int codec_conv1d_f32(const void* x, long long sxb, long long sxt, long long sxc,
                                const void* w, const void* scale, const void* bias, void* y,
                                int B, int T_in, int Cin, int Cout, int K, int T_out, int stride,
                                int pad, int dil, int groups, int config, void* ws,
                                long long ws_bytes, long long* ws_need, void* stream) {
  if (groups < 1 || Cin % groups || Cout % groups || stride < 1 || dil < 1 ||
      static_cast<long long>(B) * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.mode = 0;
  p.cg = Cin / groups;
  p.M = T_out;
  p.N = Cout / groups;
  p.Kred = K * p.cg;
  p.zdim = B * groups;
  p.x = static_cast<const float*>(x);
  p.sxb = sxb, p.sxt = sxt, p.sxc = sxc;
  p.t_in = T_in;
  p.row_step = stride, p.tap_step = dil, p.off = -pad;
  p.w = static_cast<const float*>(w);
  p.k_w = K, p.cout = Cout;
  p.wtap_base = 0, p.wtap_phase = 0, p.wtap_step = 1;
  p.y = static_cast<float*>(y);
  p.t_out = T_out, p.out_step = 1, p.out_off = 0;
  p.groups = groups, p.phases = 1;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.cin = Cin, p.batch = B;
  p.a_vec = sxc == 1 && p.cg % 4 == 0 && sxt % 4 == 0 && sxb % 4 == 0 && aligned16(x);
  p.b_vec = Cout % 4 == 0 && p.N % 4 == 0 && aligned16(w);
  p.a_tma = sxc == 1 && (K == 1 || p.cg % BK == 0);  // a stage's k within one tap
  p.b_tma = Cout % 4 == 0;
  return launch(p, config, ws, ws_bytes, ws_need, static_cast<cudaStream_t>(stream));
}

// Torch-semantics ConvTranspose1d, groups = 1: x (B, T_in, Cin) with element
// strides; w the stored flipped forward kernel (K, Cin, Cout), contiguous;
// y (B, T_out, Cout) contiguous, T_out = (T_in - 1) s - 2 pad + K +
// output_padding (the caller's).
extern "C" int codec_conv_transpose1d_f32(const void* x, long long sxb, long long sxt,
                                          long long sxc, const void* w, const void* scale,
                                          const void* bias, void* y, int B, int T_in, int Cin,
                                          int Cout, int K, int T_out, int stride, int pad,
                                          int config, void* ws, long long ws_bytes,
                                          long long* ws_need, void* stream) {
  if (stride < 1 || pad < 0 || static_cast<long long>(B) * stride > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.mode = 0;
  p.cg = Cin;
  const int d_taps = (K + stride - 1) / stride;
  p.M = (T_out - 1 + pad) / stride + 1;  // u = 0 .. (T_out - 1 + pad) / s
  p.N = Cout;
  p.Kred = d_taps * Cin;
  p.zdim = B * stride;
  p.x = static_cast<const float*>(x);
  p.sxb = sxb, p.sxt = sxt, p.sxc = sxc;
  p.t_in = T_in;
  p.row_step = 1, p.tap_step = -1, p.off = 0;
  p.w = static_cast<const float*>(w);
  p.k_w = K, p.cout = Cout;
  p.wtap_base = K - 1, p.wtap_phase = -1, p.wtap_step = -stride;
  p.y = static_cast<float*>(y);
  p.t_out = T_out, p.out_step = stride, p.out_off = -pad;
  p.groups = 1, p.phases = stride;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.cin = Cin, p.batch = B;
  p.a_vec = sxc == 1 && Cin % 4 == 0 && sxt % 4 == 0 && sxb % 4 == 0 && aligned16(x);
  p.b_vec = Cout % 4 == 0 && aligned16(w);
  p.a_tma = sxc == 1 && Cin % BK == 0;  // a stage's k within one tap
  p.b_tma = Cout % 4 == 0 && Cin % BK == 0;
  return launch(p, config, ws, ws_bytes, ws_need, static_cast<cudaStream_t>(stream));
}

// c[g1, g2] = a[g1, g2] @ b[g1, g2]: a (G1, G2, M, K), b (G1, G2, K, N),
// c (G1, G2, M, N), each by element strides (batch 1, batch 2, row, column).
extern "C" int codec_bmm_f32(const void* a, long long sa1, long long sa2, long long sam,
                             long long sak, const void* b, long long sb1, long long sb2,
                             long long sbk, long long sbn, void* c, long long sc1, long long sc2,
                             long long scm, long long scn, int G1, int G2, int M, int K, int N,
                             int config, void* ws, long long ws_bytes, long long* ws_need,
                             void* stream) {
  if (G1 < 1 || G2 < 1 || static_cast<long long>(G1) * G2 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.mode = 1;
  p.M = M, p.N = N, p.Kred = K, p.zdim = G1 * G2;
  p.a = static_cast<const float*>(a);
  p.sa1 = sa1, p.sa2 = sa2, p.sam = sam, p.sak = sak;
  p.b = static_cast<const float*>(b);
  p.sb1 = sb1, p.sb2 = sb2, p.sbk = sbk, p.sbn = sbn;
  p.c = static_cast<float*>(c);
  p.sc1 = sc1, p.sc2 = sc2, p.scm = scm, p.scn = scn;
  p.g2 = G2;
  p.g1 = G1;
  p.a_vec = sak == 1 && sam % 4 == 0 && sa1 % 4 == 0 && sa2 % 4 == 0 && aligned16(a);
  p.b_vec = sbn == 1 && sbk % 4 == 0 && sb1 % 4 == 0 && sb2 % 4 == 0 && aligned16(b);
  p.a_tma = sak == 1;
  p.b_kmajor = sbk == 1 && sbn != 1;
  p.b_tma = sbn == 1 || p.b_kmajor;
  return launch(p, config, ws, ws_bytes, ws_need, static_cast<cudaStream_t>(stream));
}

// The plan's tile count: configs 0 .. 2 NTILES - 1 (tile + NTILES split).
extern "C" int codec_gemm_configs() { return 2 * NTILES; }

// a (64, K) and b (K, 8) row-major fp32, K a multiple of 8 up to 256:
// out_wgmma and out_mma (64, 8), the same 3xTF32 chunks by each instruction.
extern "C" int codec_mma_probe(const void* a, const void* b, void* out_wgmma, void* out_mma, int K,
                               void* stream) {
  if (K < 8 || K > 256 || K % 8) return static_cast<int>(cudaErrorInvalidValue);
  mma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out_wgmma),
      static_cast<float*>(out_mma), K);
  return static_cast<int>(cudaGetLastError());
}
