// The codec's fp32 convolutions and matrix products, as one GEMM core.
//
// Replaces no Pallas kernel: the JAX package leaves these ops to XLA, which
// compiles one fixed algorithm per program at HIGHEST precision.  On the
// card the port would otherwise run them on cuDNN and cuBLAS, whose
// precision (the TF32 flags) and algorithm (chosen by shape and free
// workspace) are process-wide state.  This kernel has neither: every output
// element is the same fixed sequence of operations on its own inputs,
// whatever the batch, the length, the tile, the grid or the caller's flags.
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
// Arithmetic: 3xTF32 on `mma.sync.m16n8k8`, as kernel 3 (vocoder_fusion.cu)
// does: each operand a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a -
// a_hi) (`cvt.rna`), each product as a_lo b_hi + a_hi b_lo + a_hi b_hi with
// fp32 accumulation (the dropped a_lo b_lo is ~2^-22 of the product).  The
// reduction runs over k in chunks of 8, in increasing k, each chunk's three
// products in that order: a fixed order for every element.  No split-K, no
// atomics, no workspace.  The kernel never reads PyTorch's TF32 flags.
//
// What bounds it on an H100: operations at the codec's large shapes (the
// vocoder's conv_in, 1024 -> 1536, k7, is 2 x 7168 x 1536 flops a row; at
// 500 rows, 3 x 11 GFLOP of tf32 products at 495 TFLOP/s is 0.067 ms
// against 14 MB, 0.004 ms, at 3.35 TB/s); bytes where N or K is small
// (conv_out's one channel).  This first design is simple and right first:
// blocks of 4 warps, k in chunks of 32.  The output tile is 64 x 64 (each
// warp 32 x 32: 2 x 4 mma tiles) where that gives the card half a block an
// SM, else 16 x 32 (the codec's linears at a few hundred rows or at one),
// and 128 x 8 for at most 8 columns (conv_out): no split of k, so a long k
// on a small output takes more, smaller tiles.  Each thread gathers its
// elements of A and B for the next chunk into registers while the current
// chunk's products run; a stored element is split once into hi and lo
// arrays in shared memory (row pitches of 36 words for A, 8 or 24 mod 32
// for B, so fragment loads are conflict-free).  Rows, columns and k past
// the ends are masked (zeros), so any shape works.  (Loading the chunks by
// cp.async and splitting each operand where its fragment is loaded instead
// gave the same bits, faster transposed convolutions and slower linears at
// a few hundred rows, which weigh more in a tokenize.)  Times on the card
// are in PERF.md (chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;
constexpr int THREADS = 128;  // 4 warps
constexpr int AP = BK + 4;    // A row pitch (words)
constexpr int SMS = 132;      // H100 SXM streaming multiprocessors

// Where A, B and the output live.  Conv: the grid's z is (batch, group,
// phase); a row m is an output position (or, transposed, the u of a phase).
// Bmm: z is (g1, g2).
struct Params {
  int mode;  // 0 conv, 1 bmm
  int M, N, Kred;
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
};

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t* hi, uint32_t* lo) {
  const uint32_t h = tf32(v);
  *hi = h;
  *lo = tf32(v - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The output tile: WN warps along the columns, 4 / WN along the rows, each
// warp MT m16 tiles by NT n8 tiles.  The tile's shape changes no bit of the
// result: every element is summed over the same k chunks in the same order.
template <int WN, int MT, int NT>
__global__ void __launch_bounds__(THREADS) codec_gemm_kernel(const Params p) {
  constexpr int BM = (4 / WN) * 16 * MT, BN = WN * 8 * NT;
  constexpr int BP = BN + (BN % 32 == 8 ? 16 : 8);  // B row pitch: 8 or 24 mod 32 words
  constexpr int A_PER = BM * BK / THREADS, B_PER = BK * BN / THREADS;  // a thread's gathers
  __shared__ uint32_t a_hi[BM * AP], a_lo[BM * AP];
  __shared__ uint32_t b_hi[BK * BP], b_lo[BK * BP];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / WN) * 16 * MT, wn = (warp % WN) * 8 * NT;

  // this block's slice of A, B and the output
  const float* xa = nullptr;  // conv: x at (batch, group's first channel)
  const float* wb = nullptr;  // conv: w at the group's first output column
  int phase = 0, grp = 0, bat = 0, wtap0 = 0;
  const float* ab = nullptr;
  const float* bb = nullptr;
  if (p.mode == 0) {
    phase = z % p.phases;
    grp = (z / p.phases) % p.groups;
    bat = z / (p.phases * p.groups);
    xa = p.x + bat * p.sxb + static_cast<long long>(grp) * p.cg * p.sxc;
    wb = p.w + static_cast<long long>(grp) * p.N;
    wtap0 = p.wtap_base + phase * p.wtap_phase;
  } else {
    const int g1 = z / p.g2, g2 = z % p.g2;
    ab = p.a + g1 * p.sa1 + g2 * p.sa2;
    bb = p.b + g1 * p.sb1 + g2 * p.sb2;
  }

  // a thread gathers A column (tid % BK) of rows tid / BK + 4 i, and B
  // column (tid % BN) of k rows tid / BN + (THREADS / BN) i
  const int a_col = tid % BK, a_row0 = tid / BK;
  const int b_col = tid % BN, b_row0 = tid / BN;
  float ra[A_PER], rb[B_PER];

  auto gather = [&](int k0) {
    const int ka = k0 + a_col;
    if (p.mode == 0) {
      const int j = ka / p.cg, c = ka - j * p.cg;
      const int base = j * p.tap_step + p.off;
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int m = m0 + a_row0 + i * (THREADS / BK);
        const int ti = m * p.row_step + base;
        ra[i] = (ka < p.Kred && m < p.M && ti >= 0 && ti < p.t_in)
                    ? xa[ti * p.sxt + c * p.sxc]
                    : 0.f;
      }
      const int n = n0 + b_col;
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int kb = k0 + b_row0 + i * (THREADS / BN);
        const int jb = kb / p.cg, cb = kb - jb * p.cg;
        const int tap = wtap0 + jb * p.wtap_step;
        rb[i] = (kb < p.Kred && n < p.N && tap >= 0 && tap < p.k_w)
                    ? wb[(static_cast<long long>(tap) * p.cg + cb) * p.cout + n]
                    : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < A_PER; ++i) {
        const int m = m0 + a_row0 + i * (THREADS / BK);
        ra[i] = (ka < p.Kred && m < p.M) ? ab[m * p.sam + ka * p.sak] : 0.f;
      }
      const int n = n0 + b_col;
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int kb = k0 + b_row0 + i * (THREADS / BN);
        rb[i] = (kb < p.Kred && n < p.N) ? bb[kb * p.sbk + n * p.sbn] : 0.f;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  gather(0);
  for (int k0 = 0; k0 < p.Kred; k0 += BK) {
    __syncthreads();  // the last chunk's fragments are read
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int o = (a_row0 + i * (THREADS / BK)) * AP + a_col;
      split(ra[i], a_hi + o, a_lo + o);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int o = (b_row0 + i * (THREADS / BN)) * BP + b_col;
      split(rb[i], b_hi + o, b_lo + o);
    }
    __syncthreads();
    if (k0 + BK < p.Kred) gather(k0 + BK);  // in flight while this chunk's products run

#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int o = (wm + 16 * i + g) * AP + 8 * ks + t;
        ah[i][0] = a_hi[o];
        ah[i][1] = a_hi[o + 8 * AP];
        ah[i][2] = a_hi[o + 4];
        ah[i][3] = a_hi[o + 8 * AP + 4];
        al[i][0] = a_lo[o];
        al[i][1] = a_lo[o + 8 * AP];
        al[i][2] = a_lo[o + 4];
        al[i][3] = a_lo[o + 8 * AP + 4];
      }
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int o = (8 * ks + t) * BP + wn + 8 * j + g;
        bh[j][0] = b_hi[o];
        bh[j][1] = b_hi[o + 4 * BP];
        bl[j][0] = b_lo[o];
        bl[j][1] = b_lo[o + 4 * BP];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
    }
  }

  // fragment element v: row g (v < 2) or g + 8, column 2t + (v & 1)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + wm + 16 * i + g + 8 * (v >> 1);
        const int n = n0 + wn + 8 * j + 2 * t + (v & 1);
        if (m >= p.M || n >= p.N) continue;
        float r = acc[i][j][v];
        if (p.mode == 0) {
          const int to = m * p.out_step + p.out_off + phase;
          if (to < 0 || to >= p.t_out) continue;
          const int col = grp * p.N + n;
          if (p.scale) r *= p.scale[col];
          if (p.bias) r += p.bias[col];
          p.y[(static_cast<long long>(bat) * p.t_out + to) * p.cout + col] = r;
        } else {
          const int g1 = z / p.g2, g2 = z % p.g2;
          p.c[g1 * p.sc1 + g2 * p.sc2 + m * p.scm + n * p.scn] = r;
        }
      }
}

template <int WN, int MT, int NT>
int launch_tile(const Params& p, int zdim, cudaStream_t stream) {
  constexpr int BM = (4 / WN) * 16 * MT, BN = WN * 8 * NT;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, zdim);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  codec_gemm_kernel<WN, MT, NT><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

long long blocks(const Params& p, int zdim, int bm, int bn) {
  return static_cast<long long>((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn) * zdim;
}

// The tile by shape: 128 x 8 for at most 8 columns; 64 x 64 where that
// gives half a block an SM or more; else 16 x 32 (measured on an H100 at the
// codec's shapes: 64 x 64 tiles at 30 to 48 blocks ran 1.4 to 2.4x slower
// than 16 x 32, and 32 x 64 or 16 x 64 tiles never beat both).
int launch(const Params& p, int zdim, cudaStream_t stream) {
  if (p.M < 1 || p.N < 1 || p.Kred < 1 || zdim < 1 || zdim > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (p.N <= 8) return launch_tile<1, 2, 1>(p, zdim, stream);
  if (blocks(p, zdim, 64, 64) >= SMS / 2) return launch_tile<2, 2, 4>(p, zdim, stream);
  return launch_tile<4, 1, 1>(p, zdim, stream);
}

}  // namespace

// x (B, T_in, groups Cg) fp32 with element strides (sxb, sxt, sxc); w (K, Cg,
// Cout) contiguous; y (B, T_out, Cout) contiguous; scale and bias (Cout,) or
// null.  T_out = (T_in + 2 pad - dil (K - 1) - 1) / stride + 1 is the
// caller's.  Cout must be a multiple of groups.
extern "C" int codec_conv1d_f32(const void* x, long long sxb, long long sxt, long long sxc,
                                const void* w, const void* scale, const void* bias, void* y,
                                int B, int T_in, int Cin, int Cout, int K, int T_out, int stride,
                                int pad, int dil, int groups, void* stream) {
  if (groups < 1 || Cin % groups || Cout % groups || stride < 1 || dil < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.mode = 0;
  p.cg = Cin / groups;
  p.M = T_out;
  p.N = Cout / groups;
  p.Kred = K * p.cg;
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
  return launch(p, B * groups, static_cast<cudaStream_t>(stream));
}

// Torch-semantics ConvTranspose1d, groups = 1: x (B, T_in, Cin) with element
// strides; w the stored flipped forward kernel (K, Cin, Cout), contiguous;
// y (B, T_out, Cout) contiguous, T_out = (T_in - 1) s - 2 pad + K +
// output_padding (the caller's).
extern "C" int codec_conv_transpose1d_f32(const void* x, long long sxb, long long sxt,
                                          long long sxc, const void* w, const void* scale,
                                          const void* bias, void* y, int B, int T_in, int Cin,
                                          int Cout, int K, int T_out, int stride, int pad,
                                          void* stream) {
  if (stride < 1 || pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.mode = 0;
  p.cg = Cin;
  const int d_taps = (K + stride - 1) / stride;
  p.M = (T_out - 1 + pad) / stride + 1;  // u = 0 .. (T_out - 1 + pad) / s
  p.N = Cout;
  p.Kred = d_taps * Cin;
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
  return launch(p, B * stride, static_cast<cudaStream_t>(stream));
}

// c[g1, g2] = a[g1, g2] @ b[g1, g2]: a (G1, G2, M, K), b (G1, G2, K, N),
// c (G1, G2, M, N), each by element strides (batch 1, batch 2, row, column).
extern "C" int codec_bmm_f32(const void* a, long long sa1, long long sa2, long long sam,
                             long long sak, const void* b, long long sb1, long long sb2,
                             long long sbk, long long sbn, void* c, long long sc1, long long sc2,
                             long long scm, long long scn, int G1, int G2, int M, int K, int N,
                             void* stream) {
  if (G1 < 1 || G2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.mode = 1;
  p.M = M, p.N = N, p.Kred = K;
  p.a = static_cast<const float*>(a);
  p.sa1 = sa1, p.sa2 = sa2, p.sam = sam, p.sak = sak;
  p.b = static_cast<const float*>(b);
  p.sb1 = sb1, p.sb2 = sb2, p.sbk = sbk, p.sbn = sbn;
  p.c = static_cast<float*>(c);
  p.sc1 = sc1, p.sc2 = sc2, p.scm = scm, p.scn = scn;
  p.g2 = G2;
  return launch(p, G1 * G2, static_cast<cudaStream_t>(stream));
}
