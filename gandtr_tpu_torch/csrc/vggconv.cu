// K2: VGG16's 3x3 SAME convolution with C_in = C_out in {64, 128}, bf16
// operands and float32 accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel gandtr_tpu/ops/vggconv_pallas.py::conv3x3_same
// (its _kernel). Same function and rounding points as
// gandtr_tpu_torch/ops/vggconv.py::conv3x3_same_plain:
//
//   out = round_to_out(relu?(f32(conv3x3(zero_pad1(x), w)) + b))
//
// with x and w bf16, every product exact and summed in float32, the bias and
// the ReLU in float32, and one rounding to the output type (bf16, round to
// nearest even, or float32). The backward (ops/vggconv.py::Conv3x3Same) is
// PyTorch convolutions, as the TPU kernel's VJP is XLA convolutions.
//
// Layout: x, out NHWC; the weight is HWIO flattened to a (9*C, C) bf16
// matrix, row k = (ky*3 + kx)*C + ci; the bias float32 (C,).
//
// Design: one implicit GEMM, M = N*H*W pixels, N = C output channels,
// K = 9*C, on the core shared with K3 (csrc/conv3x3_igemm.cuh: bf16 wmma,
// float32 accumulators, a register-staged, double-buffered 128 x BN x 32
// tile pipeline). Its A loader here is the zero (SAME) pad: a tap outside
// the image loads zeros, never materialised. BN = C, so a C = 64 conv is a
// plain K = 576 GEMM. The TPU kernel's lane folding (pairs of 64-channel
// columns made into 128 lanes, block weights B1/B2) exists only because the
// MXU wants 128 lanes, and is not carried over.
//
// Bound: operations. At the fine-tune path's shapes, (7, 364, 364, 64) and
// (7, 182, 182, 128), each conv is 68.4 GFLOP, 0.069 ms at 989 TFLOP/s
// (dense bf16), against 0.071 and 0.036 ms for the bytes. This first design
// is far from it; TMA + wgmma are left to the PRs that make it fast.
//
// Rounding: built without fast math and with --fmad=false; the epilogue
// uses __fadd_rn, and every bf16 round is round-to-nearest-even. Element
// offsets are 64-bit.
#include "conv3x3_igemm.cuh"

namespace {

using conv3x3::bf16;

// A operand: x at the tap, zeros outside the image (SAME).
struct ZeroPadLoad {
  const bf16* x;
  int H, W, C;
  __device__ __forceinline__ uint4 operator()(int n, int y, int xq, int ky, int kx,
                                              int ci) const {
    const int yy = y + ky - 1, xx = xq + kx - 1;
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) return make_uint4(0, 0, 0, 0);
    return *reinterpret_cast<const uint4*>(x + (((int64_t)n * H + yy) * W + xx) * C + ci);
  }
};

__device__ __forceinline__ void store8(bf16* dst, const float* f) {
  *reinterpret_cast<uint4*>(dst) = conv3x3::pack8(f);
}

__device__ __forceinline__ void store8(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Epilogue: + bias in float32, the optional ReLU, one rounding to OutT.
template <bool kRelu, typename OutT>
struct BiasReluStore {
  const float* bias;
  OutT* out;
  int C;
  __device__ __forceinline__ void operator()(const float* acc, int64_t m, int co) const {
    float f[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = __fadd_rn(acc[e], bias[co + e]);
      f[e] = (kRelu && y < 0.0f) ? 0.0f : y;  // NaN stays NaN
    }
    store8(out + m * C + co, f);
  }
};

template <int BN, int WM, int WN, bool kRelu, typename OutT>
__global__ void __launch_bounds__(conv3x3::THREADS, 2)
conv3x3_same_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wmat,
                    const float* __restrict__ bias, OutT* __restrict__ out, int H,
                    int W, int C, int64_t M) {
  conv3x3::igemm_tile<BN, WM, WN>(ZeroPadLoad{x, H, W, C}, wmat,
                                  BiasReluStore<kRelu, OutT>{bias, out, C}, H, W, C, M);
}

template <int BN, int WM, int WN, bool kRelu, typename OutT>
cudaError_t launch_epi(const bf16* x, const bf16* w, const float* b, void* out,
                       int n, int h, int wd, int c, cudaStream_t s) {
  const int64_t M = (int64_t)n * h * wd;
  conv3x3_same_kernel<BN, WM, WN, kRelu, OutT>
      <<<conv3x3::grid<BN>(M, c), conv3x3::THREADS, 0, s>>>(
          x, w, b, static_cast<OutT*>(out), h, wd, c, M);
  return cudaGetLastError();
}

template <int BN, int WM, int WN, typename OutT>
cudaError_t launch_typed(const bf16* x, const bf16* w, const float* b, void* out,
                         int n, int h, int wd, int c, bool relu, cudaStream_t s) {
  return relu ? launch_epi<BN, WM, WN, true, OutT>(x, w, b, out, n, h, wd, c, s)
              : launch_epi<BN, WM, WN, false, OutT>(x, w, b, out, n, h, wd, c, s);
}

}  // namespace

// One convolution on `stream`; returns cudaGetLastError() as an int (0 on
// success, cudaErrorInvalidValue for a C other than 64 or 128). x: (n, h, w,
// c) bf16; wmat: (9c, c) bf16; bias: (c,) float32; out: (n, h, w, c) bf16
// (out_f32 == 0) or float32 (out_f32 == 1).
extern "C" int vggconv_launch(const void* x, const void* wmat, const void* bias,
                              void* out, int n, int h, int w, int c, int relu,
                              int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(wmat);
  const float* bb = static_cast<const float*>(bias);
  cudaError_t err;
  if (c == 64)
    err = out_f32 ? launch_typed<64, 4, 2, float>(xb, wb, bb, out, n, h, w, c, relu, s)
                  : launch_typed<64, 4, 2, bf16>(xb, wb, bb, out, n, h, w, c, relu, s);
  else if (c == 128)
    err = out_f32 ? launch_typed<128, 2, 4, float>(xb, wb, bb, out, n, h, w, c, relu, s)
                  : launch_typed<128, 2, 4, bf16>(xb, wb, bb, out, n, h, w, c, relu, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* vggconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
