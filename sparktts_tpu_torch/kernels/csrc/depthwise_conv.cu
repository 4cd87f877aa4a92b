// The codec's depthwise (groups = channels) convolutions, in fp32.
//
// Replaces no Pallas kernel: the JAX package leaves these ops to XLA.  On
// the card the port would otherwise run them on cuDNN, whose algorithm is
// chosen by shape and whose precision follows a process-wide flag; this
// kernel computes every output element the same way wherever it lies.
//
//   forward     y[b, t, c] = sum_tap x[b, t stride + tap dil - pad, c] w[tap, 0, c]
//   transposed  torch-semantics ConvTranspose1d, groups = channels, by the
//               phase mapping of `codec_gemm.cu`: output o = s u + phi - p
//               takes the stored (flipped) taps K - 1 - phi - s d from
//               inputs x[u - d]
//
// on channels-last x (any element strides), the stored WIO kernel (K, 1, C)
// and zero padding; then times the per-channel scale (an int8 kernel's) and
// plus the bias, each where given.  The Vocos blocks' dwconv (k7, C = 384)
// is the one on the 0.5B path; the strided and transposed forms are the
// feat encoder's and the prenet's samplers at sample ratios above 1.
//
// Arithmetic: each output element is `fmaf` from 0 in increasing tap (or
// d) order, a tap outside the input skipped; then the scale and the bias.
// The layout changes no bit of it.
//
// Layout: a thread computes a strip of STRIP consecutive outputs of 4
// consecutive channels.  On the forward, stride-1, undilated path with K
// of 3, 5 or 7 (the Vocos dwconv) it loads the strip's STRIP + K - 1 input
// rows once into registers as float4s and holds the K taps' weights in
// registers; the other forms (strided, dilated, transposed, other K) read
// each tap's float4 where it is needed.  float4 loads need sxc = 1, C % 4 =
// 0 and 16-byte aligned rows; otherwise a thread's 4 channels are read one
// by one (the scalar path).  Threads run along channels, so a warp reads
// 512 contiguous bytes of an input row.  What bounds it on an H100: bytes
// (14 flops per 8 bytes of x in and y out at k7; the weights stay in
// registers), and at the codec's sizes (500 x 384) the launch and one
// load latency: each thread has its 10 row loads in flight at once, and the
// small blocks spread the 12,000 threads over the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int STRIP = 4;  // consecutive outputs a thread

struct Args {
  const float* x;
  long long sxb, sxt, sxc;
  const float* w;
  const float* scale;
  const float* bias;
  float* y;
  int T_in, C, K, T_out, stride, pad, dil, transposed;
};

__device__ __forceinline__ float4 load4(const float* p, long long sxc, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[sxc], p[2 * sxc], p[3 * sxc]);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& x, const float4& w) {
  acc.x = fmaf(x.x, w.x, acc.x);
  acc.y = fmaf(x.y, w.y, acc.y);
  acc.z = fmaf(x.z, w.z, acc.z);
  acc.w = fmaf(x.w, w.w, acc.w);
}

// channels c .. c + 3 (those below C) of output t: the scale, the bias, the store
__device__ __forceinline__ void store4(const Args& a, int b, int t, int c, float4 acc) {
  float v[4] = {acc.x, acc.y, acc.z, acc.w};
  float* out = a.y + (static_cast<long long>(b) * a.T_out + t) * a.C + c;
  const int n = min(4, a.C - c);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < n && a.scale) v[i] *= a.scale[c + i];
    if (i < n && a.bias) v[i] += a.bias[c + i];
  }
  if (n == 4 && a.C % 4 == 0) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  for (int i = 0; i < n; ++i) out[i] = v[i];
}

// the thread's 4 weights of one tap (zeros past C)
__device__ __forceinline__ float4 weights4(const Args& a, int tap, int c) {
  const float* w = a.w + static_cast<long long>(tap) * a.C + c;
  return make_float4(w[0], c + 1 < a.C ? w[1] : 0.f, c + 2 < a.C ? w[2] : 0.f,
                     c + 3 < a.C ? w[3] : 0.f);
}

// Forward, stride 1, no dilation, K taps: the strip's rows in registers.
template <int K>
__global__ void __launch_bounds__(THREADS) depthwise_rows_kernel(const Args a, int vec) {
  const int quads = (a.C + 3) / 4;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= static_cast<long long>(quads) * ((a.T_out + STRIP - 1) / STRIP)) return;
  const int c = static_cast<int>(e % quads) * 4, t0 = static_cast<int>(e / quads) * STRIP;
  float4 wr[K], xr[STRIP + K - 1];
  bool ok[STRIP + K - 1];
#pragma unroll
  for (int j = 0; j < K; ++j) wr[j] = weights4(a, j, c);
  const float* xc = a.x + b * a.sxb + c * a.sxc;
  const bool full = c + 4 <= a.C;
#pragma unroll
  for (int r = 0; r < STRIP + K - 1; ++r) {
    const int ti = t0 - a.pad + r;
    ok[r] = ti >= 0 && ti < a.T_in;
    xr[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok[r]) {
      const float* p = xc + ti * a.sxt;
      if (full)
        xr[r] = load4(p, a.sxc, vec);
      else
        xr[r] = make_float4(p[0], c + 1 < a.C ? p[a.sxc] : 0.f, c + 2 < a.C ? p[2 * a.sxc] : 0.f,
                            0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < STRIP; ++i) {
    if (t0 + i >= a.T_out) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (ok[i + j]) fma4(acc, xr[i + j], wr[j]);
    store4(a, b, t0 + i, c, acc);
  }
}

// Any form: each tap's input read where it is needed.
__global__ void __launch_bounds__(THREADS) depthwise_taps_kernel(const Args a, int vec) {
  const int quads = (a.C + 3) / 4;
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= static_cast<long long>(quads) * ((a.T_out + STRIP - 1) / STRIP)) return;
  const int c = static_cast<int>(e % quads) * 4, t0 = static_cast<int>(e / quads) * STRIP;
  const float* xc = a.x + b * a.sxb + c * a.sxc;
  const bool full = c + 4 <= a.C;
  auto input = [&](int ti) {
    const float* p = xc + ti * a.sxt;
    if (full) return load4(p, a.sxc, vec);
    return make_float4(p[0], c + 1 < a.C ? p[a.sxc] : 0.f, c + 2 < a.C ? p[2 * a.sxc] : 0.f,
                       0.f);
  };
  for (int i = 0; i < STRIP; ++i) {
    const int t = t0 + i;
    if (t >= a.T_out) return;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!a.transposed) {
      for (int tap = 0; tap < a.K; ++tap) {
        const int ti = t * a.stride + tap * a.dil - a.pad;
        if (ti >= 0 && ti < a.T_in) fma4(acc, input(ti), weights4(a, tap, c));
      }
    } else {
      const int u = (t + a.pad) / a.stride, phi = (t + a.pad) % a.stride;
      for (int d = 0;; ++d) {
        const int tap = a.K - 1 - phi - a.stride * d;
        if (tap < 0) break;
        const int ti = u - d;
        if (ti >= 0 && ti < a.T_in) fma4(acc, input(ti), weights4(a, tap, c));
      }
    }
    store4(a, b, t, c, acc);
  }
}

}  // namespace

// x (B, T_in, C) fp32 by element strides; w (K, 1, C) contiguous; scale and
// bias (C,) or null; y (B, T_out, C) contiguous.  Forward: T_out = (T_in +
// 2 pad - dil (K - 1) - 1) / stride + 1.  Transposed (dil ignored): T_out =
// (T_in - 1) stride - 2 pad + K + output_padding.  Both are the caller's.
extern "C" int depthwise_conv1d_f32(const void* x, long long sxb, long long sxt, long long sxc,
                                    const void* w, const void* scale, const void* bias, void* y,
                                    int B, int T_in, int C, int K, int T_out, int stride,
                                    int pad, int dil, int transposed, void* stream) {
  if (B < 1 || B > 65535 || T_in < 1 || C < 1 || K < 1 || T_out < 1 || stride < 1 ||
      dil < 1 || pad < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), sxb, sxt, sxc, static_cast<const float*>(w),
               static_cast<const float*>(scale), static_cast<const float*>(bias),
               static_cast<float*>(y), T_in, C, K, T_out, stride, pad, dil, transposed};
  const int vec = sxc == 1 && C % 4 == 0 && sxt % 4 == 0 && sxb % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long n = static_cast<long long>((C + 3) / 4) * ((T_out + STRIP - 1) / STRIP);
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS), B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rows = !transposed && stride == 1 && dil == 1;
  if (rows && K == 7)
    depthwise_rows_kernel<7><<<grid, THREADS, 0, s>>>(a, vec);
  else if (rows && K == 5)
    depthwise_rows_kernel<5><<<grid, THREADS, 0, s>>>(a, vec);
  else if (rows && K == 3)
    depthwise_rows_kernel<3><<<grid, THREADS, 0, s>>>(a, vec);
  else
    depthwise_taps_kernel<<<grid, THREADS, 0, s>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}
