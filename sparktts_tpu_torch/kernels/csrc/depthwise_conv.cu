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
// Arithmetic: one thread an output element, `fmaf` from 0 in increasing tap
// (or d) order; a tap outside the input is skipped.  What bounds it on an
// H100: bytes (14 flops per 8 bytes of x in and y out at k7; the weights stay
// in L1).  Threads run along channels, so a warp reads 128 contiguous bytes
// of each input row.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) depthwise_kernel(
    const float* __restrict__ x, long long sxb, long long sxt, long long sxc,
    const float* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ y, int T_in, int C, int K, int T_out,
    int stride, int pad, int dil, int transposed) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= static_cast<long long>(T_out) * C) return;
  const int t = static_cast<int>(e / C), c = static_cast<int>(e % C);
  const float* xc = x + b * sxb + c * sxc;
  float acc = 0.f;
  if (!transposed) {
    for (int tap = 0; tap < K; ++tap) {
      const int ti = t * stride + tap * dil - pad;
      if (ti >= 0 && ti < T_in) acc = fmaf(xc[ti * sxt], w[tap * C + c], acc);
    }
  } else {
    const int u = (t + pad) / stride, phi = (t + pad) % stride;
    for (int d = 0;; ++d) {
      const int tap = K - 1 - phi - stride * d;
      if (tap < 0) break;
      const int ti = u - d;
      if (ti >= 0 && ti < T_in) acc = fmaf(xc[ti * sxt], w[tap * C + c], acc);
    }
  }
  if (scale) acc *= scale[c];
  if (bias) acc += bias[c];
  y[(static_cast<long long>(b) * T_out + t) * C + c] = acc;
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
  const long long n = static_cast<long long>(T_out) * C;
  const dim3 grid(static_cast<unsigned>((n + THREADS - 1) / THREADS), B);
  depthwise_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), sxb, sxt, sxc, static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<float*>(y),
      T_in, C, K, T_out, stride, pad, dil, transposed);
  return static_cast<int>(cudaGetLastError());
}
