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
// One block call is 5 launches on the caller's stream, none of which
// synchronises:
//   conv1                 the implicit-GEMM core shared with K2 (csrc/
//                         conv3x3_igemm.cuh: warp-specialised, persistent,
//                         TMA for B, wgmma with A from registers; at C = 256
//                         two 128-channel tiles of 8 x 32 pixels). Its
//                         halo policy loads the (TH+2) x (TW+2) x 64-channel
//                         halo by cp.async from 96 producer threads at
//                         reflected addresses (row -1 -> 1, row H -> H-2; the
//                         reflect pad is no TMA fill mode), one 16-byte copy
//                         per halo pixel and chunk, not per tap. Its epilogue rounds to
//                         bf16, adds the bias as a bf16 add, stores t1 and
//                         writes each tile's per-channel count, mean and sum
//                         of squared deviations of the bf16 t1.
//   in_finalize_kernel    combines the tiles of each (n, c) in tile order by
//                         Chan's formula: mean1, inv1 = 1 / sqrt(var + eps).
//   conv2                 the same core on t1; its halo policy applies the
//                         normalize + ReLU + bf16 round once per halo element,
//                         in shared memory after the copies land (the
//                         consumers read A with ldmatrix, a generic-proxy
//                         read, so no proxy fence is needed), so `a` is never
//                         written.
//   in_finalize_kernel    on t2's tile statistics.
//   in_residual_kernel    out = bf16((t2 - m2) * inv2 + x).
//
// Bound: operations. At the served shape (8, 192, 256, 256) the two convs
// are 928 GFLOP, 0.94 ms at 989 TFLOP/s (dense bf16), against 0.12 ms for
// the 403 MB of x read and out written. t1 and t2 still round-trip device
// memory (0.4 GB each way): the TPU design (one image's block in 16 MB of
// VMEM, resblock_pallas.py:109-160) does not carry over, one image's block
// being 25 MB in bf16 here, far beyond a CTA's 227 KB.
//
// Rounding: built without fast math and with --fmad=false; the elementwise
// steps use __fsub_rn / __fmul_rn / __fadd_rn, the statistics __fdiv_rn and
// __fsqrt_rn, and every bf16 round is round-to-nearest-even. The statistics
// differ from the plain version's two passes only in summation order. All
// element offsets are 64-bit.
#include "conv3x3_igemm.cuh"

namespace {

using conv3x3::bf16;
using conv3x3::load8f;
using conv3x3::pack8;
using conv3x3::unpack8;

constexpr int EW_THREADS = 256;  // the elementwise kernels

__device__ __forceinline__ int reflect1(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return i < 0 ? 0 : (i >= n ? n - 1 : i);  // halo beyond a ragged tile edge
}

// Halo: src at reflected coordinates, by cp.async (16 bytes a copy, all of a
// thread's copies in flight at once); with kNormA, bf16(max((src - mean) *
// inv, 0)) of it (conv2's input), applied in shared memory once the copies
// have landed. Thread tid moves the chunk j = tid % 8 (channels c0 + 8j ..)
// of every 12th halo pixel; chunks at or beyond C are zeros.
template <bool kNormA>
struct ReflectHalo {
  const bf16* src;
  const float* mean;
  const float* inv;
  int H, W, C;
  static constexpr int THREADS = 96;
  template <class P>
  __device__ __forceinline__ void load(uint32_t dst, uint32_t full, int n, int y0, int x0,
                                       int c0, int tid) const {
    constexpr int STEP = THREADS / 8;
    const int j = tid & 7, ch = c0 + 8 * j;
    const bool live = ch < C;
    const bf16* img = src + (int64_t)n * H * W * C + (live ? ch : 0);
    for (int p = tid >> 3; p < P::HALO_PIX; p += STEP) {
      const int hy = p / P::HALO_W, hx = p - hy * P::HALO_W;
      const int yy = reflect1(y0 - 1 + hy, H), xx = reflect1(x0 - 1 + hx, W);
      conv3x3::cp_async16(dst + p * 128 + ((j ^ (p & 7)) << 4),
                          img + ((int64_t)yy * W + xx) * C, live);
    }
    if (!kNormA) {
      conv3x3::cp_async_arrive(full);
      return;
    }
    conv3x3::cp_async_wait_all();
    if (live) {
      float mu[8], iv[8];
      load8f(mean + (int64_t)n * C + ch, mu);
      load8f(inv + (int64_t)n * C + ch, iv);
      for (int p = tid >> 3; p < P::HALO_PIX; p += STEP) {
        const uint32_t a = dst + p * 128 + ((j ^ (p & 7)) << 4);
        float f[8];
        unpack8(conv3x3::ld_shared16(a), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float r = __fmul_rn(__fsub_rn(f[e], mu[e]), iv[e]);
          f[e] = r < 0.0f ? 0.0f : r;  // ReLU; NaN stays NaN
        }
        conv3x3::st_shared16(a, pack8(f));
      }
    }
    conv3x3::mbar_arrive(full);
  }
};

// Epilogue: dst = bf16(bf16(acc) + b), the bias a bf16 add; the core adds
// the tile statistics of those values.
struct BiasBf16Stats {
  const bf16* bias;
  bf16* dst;
  float* partial;
  int C;
  static constexpr bool kStats = true;
  __device__ __forceinline__ float2 value(float a0, float a1, int co) const {
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + co));
    const float r0 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(a0)), b.x);
    const float r1 = __fadd_rn(__bfloat162float(__float2bfloat16_rn(a1)), b.y);
    return make_float2(__bfloat162float(__float2bfloat16_rn(r0)),
                       __bfloat162float(__float2bfloat16_rn(r1)));
  }
  __device__ __forceinline__ void store(int64_t pix, int co, float2 v) const {
    *reinterpret_cast<__nv_bfloat162*>(dst + pix * C + co) = __floats2bfloat162_rn(v.x, v.y);
  }
};

template <int BN, bool kNormA>
__global__ void __launch_bounds__(conv3x3::THREADS, 1)
conv3x3_reflect_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ src,
                       const bf16* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, bf16* __restrict__ dst,
                       float* __restrict__ partial, const conv3x3::Geom g) {
  conv3x3::conv_tiles<BN>(ReflectHalo<kNormA>{src, mean, inv, g.H, g.W, g.C}, &wmap,
                          BiasBf16Stats{bias, dst, partial, g.C}, g);
}

// Merges (nb, mb, m2b) into (na, ma, m2): Chan's parallel formula.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.0f) return;
  const float nab = __fadd_rn(na, nb);
  const float d = __fsub_rn(mb, ma);
  ma = __fadd_rn(ma, __fmul_rn(d, __fdiv_rn(nb, nab)));
  m2 = __fadd_rn(__fadd_rn(m2, m2b),
                 __fmul_rn(__fmul_rn(d, d), __fdiv_rn(__fmul_rn(na, nb), nab)));
  na = nab;
}

constexpr int FIN_CH = 16, FIN_SEG = 16;  // a finalize CTA: 16 channels x 16 tile runs

// Per (n, c): the tiles' (count, mean, M2) combined by Chan's formula in a
// fixed order (16 runs of consecutive tiles, each in tile order, then the
// runs in order); mean_out = mean, inv_out = 1 / sqrt(M2 / count + eps).
__global__ void __launch_bounds__(FIN_CH* FIN_SEG)
in_finalize_kernel(const float* __restrict__ partial, int tiles, int C, float eps,
                   float* __restrict__ mean_out, float* __restrict__ inv_out) {
  __shared__ float run[3][FIN_SEG][FIN_CH];
  const int cl = threadIdx.x % FIN_CH, seg = threadIdx.x / FIN_CH;
  const int n = blockIdx.y, c = blockIdx.x * FIN_CH + cl;
  const int per = (tiles + FIN_SEG - 1) / FIN_SEG;
  const int t1 = min(tiles, (seg + 1) * per);
  float na = 0.0f, ma = 0.0f, m2 = 0.0f;
  if (c < C) {
    const float* p = partial + (int64_t)n * tiles * 3 * C + c;
    for (int t = seg * per; t < t1; ++t) {
      const float* q = p + (int64_t)t * 3 * C;
      chan_merge(na, ma, m2, q[0], q[C], q[2 * C]);
    }
  }
  run[0][seg][cl] = na, run[1][seg][cl] = ma, run[2][seg][cl] = m2;
  __syncthreads();
  if (seg != 0 || c >= C) return;
  for (int r = 1; r < FIN_SEG; ++r) chan_merge(na, ma, m2, run[0][r][cl], run[1][r][cl], run[2][r][cl]);
  mean_out[(int64_t)n * C + c] = ma;
  inv_out[(int64_t)n * C + c] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(__fdiv_rn(m2, na), eps)));
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

template <int BN>
cudaError_t block(const bf16* x, const bf16* w1, const bf16* b1, const bf16* w2,
                  const bf16* b2, bf16* t1, bf16* t2, bf16* out, float* partial, float* st,
                  int n, int h, int w, int c, int tiles, float eps, cudaStream_t s) {
  const conv3x3::Geom g = conv3x3::geometry<BN>(n, h, w, c);
  if (g.tiles_y * g.tiles_x != tiles) return cudaErrorInvalidValue;  // the wrapper's plan
  const int64_t nc = (int64_t)n * c;
  float *mean1 = st, *inv1 = st + nc, *mean2 = st + 2 * nc, *inv2 = st + 3 * nc;
  CUtensorMap wmap1, wmap2;
  cudaError_t err = conv3x3::encode_weight_map(&wmap1, w1, c);
  if (err == cudaSuccess) err = conv3x3::encode_weight_map(&wmap2, w2, c);
  if (err != cudaSuccess) return err;
  const dim3 fin((c + FIN_CH - 1) / FIN_CH, n);

  err = conv3x3::launch<BN, conv3x3_reflect_kernel<BN, false>>(
      g, s, wmap1, x, b1, (const float*)nullptr, (const float*)nullptr, t1, partial, g);
  if (err != cudaSuccess) return err;
  in_finalize_kernel<<<fin, FIN_CH * FIN_SEG, 0, s>>>(partial, tiles, c, eps, mean1, inv1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = conv3x3::launch<BN, conv3x3_reflect_kernel<BN, true>>(
      g, s, wmap2, (const bf16*)t1, b2, (const float*)mean1, (const float*)inv1, t2, partial, g);
  if (err != cudaSuccess) return err;
  in_finalize_kernel<<<fin, FIN_CH * FIN_SEG, 0, s>>>(partial, tiles, c, eps, mean2, inv2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t nvec = (int64_t)n * h * w * c / 8;
  const int64_t want = (nvec + EW_THREADS - 1) / EW_THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  in_residual_kernel<<<blocks, EW_THREADS, 0, s>>>(t2, x, mean2, inv2, out, nvec,
                                                   (int64_t)h * w, c);
  return cudaGetLastError();
}

}  // namespace

// One block call on `stream`; returns a cudaError_t as an int (0 on
// success). x, t1, t2, out: (n, h, w, c) bf16; w1, w2: (9c, c) bf16;
// b1, b2: (c,) bf16; partial: n * tiles * 3 * c floats, tiles the output
// tiles of an image in the core's plan for this c (checked: a mismatch
// returns cudaErrorInvalidValue); stats: 4 * n * c floats (mean1, inv1,
// mean2, inv2). c % 16 == 0, c <= 2048; all 16-byte aligned.
extern "C" int resblock_launch(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* t1, void* t2,
                               void* out, void* partial, void* stats, int n, int h,
                               int w, int c, int tiles, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *xb = static_cast<const bf16*>(x), *w1b = static_cast<const bf16*>(w1),
             *b1b = static_cast<const bf16*>(b1), *w2b = static_cast<const bf16*>(w2),
             *b2b = static_cast<const bf16*>(b2);
  bf16 *t1b = static_cast<bf16*>(t1), *t2b = static_cast<bf16*>(t2),
       *ob = static_cast<bf16*>(out);
  float *pb = static_cast<float*>(partial), *sb = static_cast<float*>(stats);
  cudaError_t err;
  if (c % 16 || c > 2048 || h < 2 || w < 2 || n < 1)
    err = cudaErrorInvalidValue;
  else if (c <= 64)
    err = block<64>(xb, w1b, b1b, w2b, b2b, t1b, t2b, ob, pb, sb, n, h, w, c, tiles, eps, s);
  else
    err = block<128>(xb, w1b, b1b, w2b, b2b, t1b, t2b, ob, pb, sb, n, h, w, c, tiles, eps, s);
  return (int)err;
}

extern "C" const char* resblock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
