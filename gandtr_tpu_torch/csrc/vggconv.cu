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
// Design: the implicit-GEMM core shared with K3 (csrc/conv3x3_igemm.cuh:
// warp-specialised, persistent, TMA for B, wgmma with A from registers),
// BN = C: 16 x 32-pixel tiles at C = 64, 8 x 32 at C = 128. Its halo policy
// here is one 4-D TMA box (C, W, H, N) of (TH+2) x (TW+2) pixels x 64
// channels at signed start (x0 - 1, y0 - 1): the box's zero fill outside the
// tensor is the SAME pad, so nothing addresses the pad by hand. The TPU
// kernel's lane folding (pairs of 64-channel columns made into 128 lanes)
// exists only because the MXU wants 128 lanes, and is not carried over.
//
// Bound: operations. At the fine-tune path's shapes, (7, 364, 364, 64) and
// (7, 182, 182, 128), each conv is 68.4 GFLOP, 0.069 ms at 989 TFLOP/s
// (dense bf16), against 0.071 and 0.036 ms for the bytes.
//
// Rounding: built without fast math and with --fmad=false; the epilogue
// uses __fadd_rn, and every bf16 round is round-to-nearest-even.
#include "conv3x3_igemm.cuh"

namespace {

using conv3x3::bf16;

// Halo: one TMA box; out-of-bounds pixels arrive as zeros (SAME).
struct TmaHalo {
  const CUtensorMap* map;
  static constexpr int THREADS = 1;
  template <class P>
  __device__ __forceinline__ void load(uint32_t dst, uint32_t full, int n, int y0, int x0,
                                       int c0, int) const {
    conv3x3::mbar_expect_tx(full, P::HALO_BYTES);
    conv3x3::tma_load_4d(dst, map, c0, x0 - 1, y0 - 1, n, full);
  }
};

__device__ __forceinline__ void store2(bf16* dst, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ void store2(float* dst, float2 v) {
  *reinterpret_cast<float2*>(dst) = v;
}

// Epilogue: + bias in float32, the optional ReLU, one rounding to OutT.
template <typename OutT>
struct BiasReluStore {
  const float* bias;
  OutT* out;
  int C, relu;
  static constexpr bool kStats = false;
  __device__ __forceinline__ float2 value(float a0, float a1, int co) const {
    const float2 b = *reinterpret_cast<const float2*>(bias + co);
    float y0 = __fadd_rn(a0, b.x), y1 = __fadd_rn(a1, b.y);
    if (relu) {  // NaN stays NaN
      y0 = y0 < 0.0f ? 0.0f : y0;
      y1 = y1 < 0.0f ? 0.0f : y1;
    }
    return make_float2(y0, y1);
  }
  __device__ __forceinline__ void store(int64_t pix, int co, float2 v) const {
    store2(out + pix * C + co, v);
  }
};

template <int BN, typename OutT>
__global__ void __launch_bounds__(conv3x3::THREADS, 1)
conv3x3_same_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                    OutT* __restrict__ out, int relu, const conv3x3::Geom g) {
  conv3x3::conv_tiles<BN>(TmaHalo{&xmap}, &wmap, BiasReluStore<OutT>{bias, out, g.C, relu}, g);
}

template <int BN, typename OutT>
cudaError_t launch_typed(const bf16* x, const bf16* w, const float* b, void* out, int n,
                         int h, int wd, int relu, cudaStream_t s) {
  const conv3x3::Geom g = conv3x3::geometry<BN>(n, h, wd, BN);
  CUtensorMap xmap, wmap;
  cudaError_t err = conv3x3::encode_halo_map<BN>(&xmap, x, n, h, wd, BN);
  if (err == cudaSuccess) err = conv3x3::encode_weight_map(&wmap, w, BN);
  if (err != cudaSuccess) return err;
  return conv3x3::launch<BN, conv3x3_same_kernel<BN, OutT>>(g, s, xmap, wmap, b,
                                                             static_cast<OutT*>(out), relu, g);
}

}  // namespace

// One convolution on `stream`; returns a cudaError_t as an int (0 on
// success, cudaErrorInvalidValue for a C other than 64 or 128). x: (n, h, w,
// c) bf16; wmat: (9c, c) bf16; bias: (c,) float32; out: (n, h, w, c) bf16
// (out_f32 == 0) or float32 (out_f32 == 1). All 16-byte aligned.
extern "C" int vggconv_launch(const void* x, const void* wmat, const void* bias,
                              void* out, int n, int h, int w, int c, int relu,
                              int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(wmat);
  const float* bb = static_cast<const float*>(bias);
  cudaError_t err;
  if (c == 64)
    err = out_f32 ? launch_typed<64, float>(xb, wb, bb, out, n, h, w, relu, s)
                  : launch_typed<64, bf16>(xb, wb, bb, out, n, h, w, relu, s);
  else if (c == 128)
    err = out_f32 ? launch_typed<128, float>(xb, wb, bb, out, n, h, w, relu, s)
                  : launch_typed<128, bf16>(xb, wb, bb, out, n, h, w, relu, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* vggconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
