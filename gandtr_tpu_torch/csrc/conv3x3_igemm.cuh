// The 3x3 implicit-GEMM convolution core shared by K2 (csrc/vggconv.cu) and
// K3 (csrc/resblock.cu), for Hopper (sm_90a).
//
// One CTA computes a BM x BN output tile of out[m, co] = sum_k A[m, k] *
// Wmat[k, co], with M = N*H*W pixels, C_in = C_out = C, K = 9*C and row
// k = (ky*3 + kx)*C + ci of the HWIO weight flattened to a (9*C, C) bf16
// matrix. bf16 tensor cores (wmma 16x16x16) with float32 accumulators; a
// register-staged, double-buffered BM x BN x BK tile pipeline: the next
// k step's global loads are in flight while the current one's MMAs run.
//
// The two kernels differ only at the edges, which are policies:
//
//   ALoad  `uint4 operator()(n, y, x, ky, kx, ci)`: 8 bf16 input channels
//          ci..ci+7 of the tap (ky, kx) of output pixel (n, y, x). The pad
//          rule (zero SAME, reflect) and any transform of the input (K3's
//          normalize + ReLU of conv2's operand) live here, so the halo is
//          addressed while the A tile loads and never materialised.
//   Epi    `void operator()(f, m, co)`: the 8 float32 sums f of pixel m,
//          channels co..co+7 (bias, ReLU, rounding, the store).
//
// Everything else (tiling, staging, the MMA loop and the epilogue's
// per-warp scratch) is here, once. Element offsets are 64-bit.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace conv3x3 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // pixels per CTA tile
constexpr int BK = 32;        // K per pipeline step
constexpr int A_LD = BK + 8;  // padded smem rows: conflict-free ldmatrix
constexpr int THREADS = 256;  // 8 warps

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

// The grid: ceil(M / BM) pixel tiles x ceil(C / BN) channel tiles.
template <int BN>
inline dim3 grid(int64_t M, int C) {
  return dim3((unsigned)((M + BM - 1) / BM), (C + BN - 1) / BN);
}

// One BM x BN output tile: the body of each .cu file's own kernel of
// THREADS threads with __launch_bounds__(THREADS, 2), which builds the
// policies from its __restrict__ pointer parameters. The 8 warps split the
// tile WM (pixels) x WN (channels), each warp FM x FN fragments of 16x16.
template <int BN, int WM, int WN, class ALoad, class Epi>
__device__ __forceinline__ void igemm_tile(const ALoad& aload,
                                           const bf16* __restrict__ wmat,
                                           const Epi& epi, int H, int W, int C,
                                           int64_t M) {
  using namespace nvcuda;
  constexpr int B_LD = BN + 8;
  constexpr int FM = BM / WM / 16;
  constexpr int FN = BN / WN / 16;
  constexpr int B_VECS = BK * BN / 8 / THREADS;  // uint4 per thread per step
  constexpr int SMEM = (2 * BM * A_LD + 2 * BK * B_LD) * 2;
  static_assert(WM * WN == THREADS / 32, "8 warps");
  static_assert(SMEM >= 8 * 256 * 4, "epilogue scratch must fit");
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][A_LD]
  bf16* Bs = As + 2 * BM * A_LD;             // [2][BK][B_LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
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
  uint4 ra[2], rb[B_VECS];
  // this thread's k = tap * C + ci of the next A load, advanced by BK per
  // load (load_tiles runs once per k step, in order): no division by C
  int ld_tap = 0, ld_ci = a_j * 8;
  while (ld_ci >= C) ld_ci -= C, ++ld_tap;

  auto load_tiles = [&](int kt) {
    if (ld_tap < 9) {
      const int ky = ld_tap / 3, kx = ld_tap - 3 * ky;
#pragma unroll
      for (int s = 0; s < 2; ++s)
        ra[s] = a_ok[s] ? aload(a_n[s], a_y[s], a_x[s], ky, kx, ld_ci)
                        : make_uint4(0, 0, 0, 0);
    } else {
      ra[0] = ra[1] = make_uint4(0, 0, 0, 0);
    }
    ld_ci += BK;
    while (ld_ci >= C) ld_ci -= C, ++ld_tap;
#pragma unroll
    for (int s = 0; s < B_VECS; ++s) {
      const int v = tid + s * THREADS;
      const int k = kt * BK + v / (BN / 8);
      const int co = n0 + (v % (BN / 8)) * 8;
      rb[s] = (k < K && co < C)
                  ? *reinterpret_cast<const uint4*>(wmat + (int64_t)k * C + co)
                  : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_tiles = [&](int buf) {
    bf16* a = As + buf * BM * A_LD;
    bf16* b = Bs + buf * BK * B_LD;
#pragma unroll
    for (int s = 0; s < 2; ++s)
      *reinterpret_cast<uint4*>(a + (a_row + s * 64) * A_LD + a_j * 8) = ra[s];
#pragma unroll
    for (int s = 0; s < B_VECS; ++s) {
      const int v = tid + s * THREADS;
      *reinterpret_cast<uint4*>(b + (v / (BN / 8)) * B_LD + (v % (BN / 8)) * 8) = rb[s];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(af[i], a + (wm * FM * 16 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(bfr[j], b + kk * B_LD + wn * FN * 16 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    if (kt + 1 < KT) store_tiles(cur ^ 1);
    __syncthreads();
  }

  // epilogue: one 16x16 fragment at a time through this warp's scratch
  float* scratch = reinterpret_cast<float*>(smem) + warp * 256;
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm * FM * 16 + i * 16 + er;
      const int co = n0 + wn * FN * 16 + j * 16 + ec;
      if (m < M && co < C) epi(scratch + er * 16 + ec, m, co);
      __syncwarp();
    }
  }
}

}  // namespace conv3x3
