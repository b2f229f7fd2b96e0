// K3: the ResNet generator's residual block at inference, in bf16, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gandtr_tpu/ops/resblock_pallas.py::fused_resblock
// (its _kernel). Same function and rounding points as
// gandtr_tpu_torch/ops/resblock.py::fused_resblock_plain:
//
//   t1  = bf16(bf16(conv3x3(reflect1(x), w1)) + b1)        f32 accumulation
//   m1, v1 = mean, biased variance of t1 per (n, c), f32, two passes
//   a   = bf16(max((t1 - m1) * inv1, 0)),  inv1 = 1 / sqrt(v1 + eps)
//   t2  = bf16(bf16(conv3x3(reflect1(a), w2)) + b2)
//   out = bf16((t2 - m2) * inv2 + x)
//
// Layout: x, t1, t2, out are NHWC bf16; each weight is HWIO flattened to a
// (9*C, C) bf16 matrix, so row k = (ky*3 + kx)*C + ci.
//
// One block call is 9 launches on the caller's stream, none of which
// synchronises:
//   conv1, an implicit GEMM        M = N*H*W pixels, N = C_out, K = 9*C_in,
//                                  on the core shared with K2 (csrc/
//                                  conv3x3_igemm.cuh: bf16 wmma 16x16x16,
//                                  f32 accumulators). Its A loader is the
//                                  reflect pad, addressed while the A tile
//                                  loads (row -1 -> 1, row H -> H-2), never
//                                  materialised; its epilogue rounds to
//                                  bf16, then adds the bias as a bf16 add.
//   in_partial_kernel, in_finalize_kernel   (twice: mean, then variance)
//                                  deterministic statistics: a fixed
//                                  summation order, no float atomics.
//   conv2                          the same GEMM; its A loader applies the
//                                  normalize + ReLU + bf16 round to t1 at
//                                  the reflected coordinate, so `a` is
//                                  never written.
//   in_partial_kernel, in_finalize_kernel   (twice, on t2)
//   in_residual_kernel             out = bf16((t2 - m2) * inv2 + x).
//
// Bound: operations. At the served shape (8, 192, 256, 256) the two convs
// are 928 GFLOP, 0.94 ms at 989 TFLOP/s (dense bf16), against 0.12 ms for
// the 403 MB of x read and out written. This first design is a plain
// register-staged, double-buffered 128x128x32 tile GEMM on wmma, far from
// that bound; TMA + wgmma and keeping t1 / t2 out of device memory are
// left to the PRs that make it fast. The TPU design (one image's block in
// 16 MB of VMEM, resblock_pallas.py:109-160) does not carry over: one
// image's block is 25 MB in bf16 here, far beyond a CTA's 227 KB.
//
// Rounding: built without fast math and with --fmad=false; the elementwise
// steps use __fsub_rn / __fmul_rn / __fadd_rn, the statistics __fdiv_rn and
// __fsqrt_rn, and every bf16 round is round-to-nearest-even. All element
// offsets are 64-bit.
#include "conv3x3_igemm.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::load8f;
using conv3x3::pack8;
using conv3x3::THREADS;
using conv3x3::unpack8;

constexpr int BN = 128;        // output channels per CTA tile
constexpr int WM = 2, WN = 4;  // 8 warps: 2 (M) x 4 (N), 64x32 each

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// A operand: src at the reflected tap; with kNormA, bf16(max((src - mean) *
// inv, 0)) of it (conv2's input, so `a` is never written).
template <bool kNormA>
struct ReflectLoad {
  const bf16* src;
  const float* mean;
  const float* inv;
  int H, W, C;
  __device__ __forceinline__ uint4 operator()(int n, int y, int x, int ky, int kx,
                                              int ci) const {
    const int yy = reflect1(y + ky - 1, H), xx = reflect1(x + kx - 1, W);
    const int64_t off = (((int64_t)n * H + yy) * W + xx) * C + ci;
    uint4 v = *reinterpret_cast<const uint4*>(src + off);
    if (kNormA) {
      float f[8], mu[8], iv[8];
      unpack8(v, f);
      load8f(mean + (int64_t)n * C + ci, mu);
      load8f(inv + (int64_t)n * C + ci, iv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float r = __fmul_rn(__fsub_rn(f[e], mu[e]), iv[e]);
        f[e] = r < 0.0f ? 0.0f : r;  // ReLU; NaN stays NaN
      }
      v = pack8(f);
    }
    return v;
  }
};

// Epilogue: dst = bf16(bf16(acc) + b), the bias a bf16 add.
struct BiasBf16Store {
  const bf16* bias;
  bf16* dst;
  int C;
  __device__ __forceinline__ void operator()(const float* acc, int64_t m, int co) const {
    float f[8], bb[8];
    unpack8(*reinterpret_cast<const uint4*>(bias + co), bb);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      f[e] = __fadd_rn(__bfloat162float(__float2bfloat16_rn(acc[e])), bb[e]);
    *reinterpret_cast<uint4*>(dst + m * C + co) = pack8(f);
  }
};

template <bool kNormA>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_reflect_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wmat,
                       const bf16* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, bf16* __restrict__ dst,
                       int H, int W, int C, int64_t M) {
  conv3x3::igemm_tile<BN, WM, WN>(ReflectLoad<kNormA>{src, mean, inv, H, W, C}, wmat,
                                  BiasBf16Store{bias, dst, C}, H, W, C, M);
}

template <bool kNormA>
cudaError_t conv3x3_reflect(const bf16* src, const bf16* wmat, const bf16* bias,
                            const float* mean, const float* inv, bf16* dst, int H,
                            int W, int C, int64_t M, cudaStream_t s) {
  conv3x3_reflect_kernel<kNormA><<<conv3x3::grid<BN>(M, C), THREADS, 0, s>>>(
      src, wmat, bias, mean, inv, dst, H, W, C, M);
  return cudaGetLastError();
}

// Per-channel partial sums of one image over one chunk of its pixels:
// sum of t (mean == nullptr) or of (t - mean)^2. Fixed order: each thread
// walks its pixels in order, then the rows are added in order.
__global__ void __launch_bounds__(THREADS)
in_partial_kernel(const bf16* __restrict__ t, const float* __restrict__ mean,
                  float* __restrict__ partial, int HW, int C, int chunk) {
  __shared__ float red[2048];
  const int ch = blockIdx.x, n = blockIdx.y, nchunks = gridDim.x;
  const int L = C / 8;          // threads per pixel, 8 channels each
  const int R = THREADS / L;    // pixels in flight
  const int tid = threadIdx.x;
  const int lane = tid % L, row = tid / L;
  if (row < R) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float mu[8];
    if (mean) load8f(mean + (int64_t)n * C + lane * 8, mu);
    const int p1 = min(ch * chunk + chunk, HW);
    for (int p = ch * chunk + row; p < p1; p += R) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(t + ((int64_t)n * HW + p) * C + lane * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (mean) {
          const float d = __fsub_rn(f[e], mu[e]);
          acc[e] = __fadd_rn(acc[e], __fmul_rn(d, d));
        } else {
          acc[e] = __fadd_rn(acc[e], f[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[row * C + lane * 8 + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = __fadd_rn(s, red[r * C + c]);
    partial[((int64_t)n * nchunks + ch) * C + c] = s;
  }
}

// mean = sum / HW (inv_out == nullptr), or inv = 1 / sqrt(sum / HW + eps).
__global__ void in_finalize_kernel(const float* __restrict__ partial, int nchunks,
                                   int HW, int C, float eps, float* __restrict__ mean_out,
                                   float* __restrict__ inv_out) {
  const int n = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int ch = 0; ch < nchunks; ++ch)
      s = __fadd_rn(s, partial[((int64_t)n * nchunks + ch) * C + c]);
    const float q = __fdiv_rn(s, (float)HW);
    if (inv_out)
      inv_out[(int64_t)n * C + c] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(q, eps)));
    else
      mean_out[(int64_t)n * C + c] = q;
  }
}

__global__ void in_residual_kernel(const bf16* __restrict__ t2, const bf16* __restrict__ x,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ inv, bf16* __restrict__ out,
                                   int64_t nvec, int64_t HW, int C) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    const int64_t e0 = i * 8;
    const int64_t pix = e0 / C;
    const int c0 = (int)(e0 - pix * C);
    const int64_t nc = (pix / HW) * C + c0;
    float t[8], xv[8], mu[8], iv[8], o[8];
    unpack8(*reinterpret_cast<const uint4*>(t2 + e0), t);
    unpack8(*reinterpret_cast<const uint4*>(x + e0), xv);
    load8f(mean + nc, mu);
    load8f(inv + nc, iv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __fadd_rn(__fmul_rn(__fsub_rn(t[e], mu[e]), iv[e]), xv[e]);
    *reinterpret_cast<uint4*>(out + e0) = pack8(o);
  }
}

// Statistics of t (N, HW, C) into mean[N*C] and inv[N*C].
cudaError_t in_stats(const bf16* t, float* partial, float* mean, float* inv, int n,
                     int hw, int c, int chunk, float eps, cudaStream_t s) {
  const int nchunks = (hw + chunk - 1) / chunk;
  const dim3 grid(nchunks, n);
  in_partial_kernel<<<grid, THREADS, 0, s>>>(t, nullptr, partial, hw, c, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_finalize_kernel<<<n, THREADS, 0, s>>>(partial, nchunks, hw, c, eps, mean, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_partial_kernel<<<grid, THREADS, 0, s>>>(t, mean, partial, hw, c, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  in_finalize_kernel<<<n, THREADS, 0, s>>>(partial, nchunks, hw, c, eps, nullptr, inv);
  return cudaGetLastError();
}

}  // namespace

// One block call on `stream`; returns cudaGetLastError() as an int (0 on
// success). x, t1, t2, out: (n, h, w, c) bf16; w1, w2: (9c, c) bf16;
// b1, b2: (c,) bf16; partial: n * ceil(h*w / chunk) * c floats; stats:
// 4 * n * c floats (mean1, inv1, mean2, inv2). c % 16 == 0, c <= 2048.
extern "C" int resblock_launch(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* t1, void* t2,
                               void* out, void* partial, void* stats, int n, int h,
                               int w, int c, int chunk, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* t1b = static_cast<bf16*>(t1);
  bf16* t2b = static_cast<bf16*>(t2);
  float* part = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  const int64_t nc = (int64_t)n * c;
  float *mean1 = st, *inv1 = st + nc, *mean2 = st + 2 * nc, *inv2 = st + 3 * nc;
  const int64_t M = (int64_t)n * h * w;

  cudaError_t err = conv3x3_reflect<false>(xb, static_cast<const bf16*>(w1),
                                           static_cast<const bf16*>(b1), nullptr,
                                           nullptr, t1b, h, w, c, M, s);
  if (err != cudaSuccess) return (int)err;
  if ((err = in_stats(t1b, part, mean1, inv1, n, h * w, c, chunk, eps, s)) != cudaSuccess)
    return (int)err;
  if ((err = conv3x3_reflect<true>(t1b, static_cast<const bf16*>(w2),
                                   static_cast<const bf16*>(b2), mean1, inv1, t2b, h,
                                   w, c, M, s)) != cudaSuccess)
    return (int)err;
  if ((err = in_stats(t2b, part, mean2, inv2, n, h * w, c, chunk, eps, s)) != cudaSuccess)
    return (int)err;
  const int64_t nvec = M * c / 8;
  const int blocks = (int)((nvec + THREADS - 1) / THREADS < 132 * 16
                               ? (nvec + THREADS - 1) / THREADS : 132 * 16);
  in_residual_kernel<<<blocks, THREADS, 0, s>>>(t2b, xb, mean2, inv2,
                                                static_cast<bf16*>(out), nvec,
                                                (int64_t)h * w, c);
  return (int)cudaGetLastError();
}

extern "C" const char* resblock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
