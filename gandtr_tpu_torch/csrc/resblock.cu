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
//   conv3x3_reflect_kernel<false>  conv1 as an implicit GEMM: M = N*H*W
//                                  pixels, N = C_out, K = 9*C_in. The
//                                  reflect pad is addressed while the A tile
//                                  loads (row -1 -> 1, row H -> H-2), never
//                                  materialised. bf16 tensor cores (wmma
//                                  16x16x16) with f32 accumulators; the
//                                  epilogue rounds to bf16, then adds the
//                                  bias as a bf16 add.
//   in_partial_kernel, in_finalize_kernel   (twice: mean, then variance)
//                                  deterministic statistics: a fixed
//                                  summation order, no float atomics.
//   conv3x3_reflect_kernel<true>   conv2; its A-tile load applies the
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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BM = 128;        // pixels per CTA tile
constexpr int BN = 128;        // output channels per CTA tile
constexpr int BK = 32;         // K per pipeline step
constexpr int A_LD = BK + 8;   // padded smem rows: conflict-free ldmatrix
constexpr int B_LD = BN + 8;
constexpr int THREADS = 256;   // 8 warps: 2 (M) x 4 (N), 64x32 each
constexpr int SMEM_BYTES = (2 * BM * A_LD + 2 * BK * B_LD) * 2;
static_assert(SMEM_BYTES >= 8 * 256 * 4, "epilogue scratch must fit");

__device__ __forceinline__ int reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// One output tile of a reflect-padded 3x3 conv, C_in = C_out = C.
// kNormA: the A operand is bf16(max((src - mean) * inv, 0)) of `src`.
template <bool kNormA>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_reflect_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wmat,
                       const bf16* __restrict__ bias, const float* __restrict__ mean,
                       const float* __restrict__ inv, bf16* __restrict__ dst,
                       int H, int W, int C, int64_t M) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);   // [2][BM][A_LD]
  bf16* Bs = As + 2 * BM * A_LD;              // [2][BK][B_LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;
  const int KT = (K + BK - 1) / BK;

  // A loader: rows r and r + 64, the 8-wide k chunk j of each k step
  const int a_row = tid >> 2, a_j = tid & 3;
  int a_n[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int64_t m = m0 + a_row + s * 64;
    a_ok[s] = m < M;
    const int64_t mm = a_ok[s] ? m : 0;
    const int64_t hw = (int64_t)H * W;
    a_n[s] = (int)(mm / hw);
    const int64_t r = mm - (int64_t)a_n[s] * hw;
    a_y[s] = (int)(r / W);
    a_x[s] = (int)(r - (int64_t)a_y[s] * W);
  }
  // B loader: k rows v >> 4, output-channel chunk (v & 15) * 8, v = tid, tid + 256
  uint4 ra[2], rb[2];

  auto load_tiles = [&](int kt) {
    const int k0 = kt * BK + a_j * 8;
    if (k0 < K) {
      const int tap = k0 / C, ci = k0 - tap * C;
      const int ky = tap / 3, kx = tap - 3 * ky;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (a_ok[s]) {
          const int yy = reflect1(a_y[s] + ky - 1, H);
          const int xx = reflect1(a_x[s] + kx - 1, W);
          const int64_t off = (((int64_t)a_n[s] * H + yy) * W + xx) * C + ci;
          v = *reinterpret_cast<const uint4*>(src + off);
          if (kNormA) {
            float f[8], mu[8], iv[8];
            unpack8(v, f);
            load8f(mean + (int64_t)a_n[s] * C + ci, mu);
            load8f(inv + (int64_t)a_n[s] * C + ci, iv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float y = __fmul_rn(__fsub_rn(f[e], mu[e]), iv[e]);
              f[e] = y < 0.0f ? 0.0f : y;  // ReLU; NaN stays NaN
            }
            v = pack8(f);
          }
        }
        ra[s] = v;
      }
    } else {
      ra[0] = ra[1] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * THREADS;
      const int k = kt * BK + (v >> 4);
      const int co = n0 + (v & 15) * 8;
      rb[s] = (k < K && co < C)
                  ? *reinterpret_cast<const uint4*>(wmat + (int64_t)k * C + co)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_tiles = [&](int buf) {
    bf16* a = As + buf * BM * A_LD;
    bf16* b = Bs + buf * BK * B_LD;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      *reinterpret_cast<uint4*>(a + (a_row + s * 64) * A_LD + a_j * 8) = ra[s];
      const int v = tid + s * THREADS;
      *reinterpret_cast<uint4*>(b + (v >> 4) * B_LD + (v & 15) * 8) = rb[s];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) load_tiles(kt + 1);  // in flight during the MMAs
    const bf16* a = As + cur * BM * A_LD;
    const bf16* b = Bs + cur * BK * B_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], b + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if (kt + 1 < KT) store_tiles(cur ^ 1);
    __syncthreads();
  }

  // epilogue: one 16x16 fragment at a time through this warp's scratch
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm * 64 + i * 16 + er;
      const int co = n0 + wn * 32 + j * 16 + ec;
      if (m < M && co < C) {
        float f[8], bb[8];
        unpack8(*reinterpret_cast<const uint4*>(bias + co), bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float r = __bfloat162float(__float2bfloat16_rn(scratch[er * 16 + ec + e]));
          f[e] = __fadd_rn(r, bb[e]);
        }
        *reinterpret_cast<uint4*>(dst + m * C + co) = pack8(f);
      }
      __syncwarp();
    }
  }
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
  const dim3 grid((unsigned)((M + BM - 1) / BM), (c + BN - 1) / BN);

  conv3x3_reflect_kernel<false><<<grid, THREADS, 0, s>>>(
      xb, static_cast<const bf16*>(w1), static_cast<const bf16*>(b1), nullptr, nullptr,
      t1b, h, w, c, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = in_stats(t1b, part, mean1, inv1, n, h * w, c, chunk, eps, s)) != cudaSuccess)
    return (int)err;
  conv3x3_reflect_kernel<true><<<grid, THREADS, 0, s>>>(
      t1b, static_cast<const bf16*>(w2), static_cast<const bf16*>(b2), mean1, inv1, t2b,
      h, w, c, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
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
