// The 3x3 implicit-GEMM convolution core shared by K2 (csrc/vggconv.cu) and
// K3 (csrc/resblock.cu), for Hopper (sm_90a): TMA, mbarriers and wgmma.
//
// out[p, co] = sum over taps (ky, kx) and input channels ci of
// in[p + (ky - 1, kx - 1), ci] * Wmat[(ky*3 + kx)*C + ci, co], C_in = C_out =
// C, Wmat the HWIO weight flattened to a (9*C, C) bf16 matrix (as given: no
// re-layout), float32 sums of exact bf16 products.
//
// Tiles. A CTA's output tile is TH x TW pixels of one image (never two; the
// ragged right and bottom edges are masked) by BN output channels:
//
//   BN = 128: 8 x 32 pixels    BN = 64: 16 x 32
//
// so that each consumer warpgroup's accumulators are 128 float32 registers
// a thread (MSUB = 256 / BN wgmma m64 sub-tiles of n = BN). More than 128
// channels take several channel tiles: a CTA's weight traffic from L2
// (9*C*BN*2 bytes a tile) then falls with the tile's pixels rising, which
// measured faster on the H100 than BN = 256 with half the pixels (the A
// halo, read once per channel tile, is the smaller stream). The K loop runs
// over 64-channel chunks of the input (one 128-byte swizzle row a pixel) and,
// inside each, the 9 taps. A chunk's (TH+2) x (TW+2) halo is brought into
// shared memory once and all 9 taps read it there; the input is read about
// (TH+2)(TW+2) / (TH*TW) times (1.33x at 8 x 32) instead of once per tap.
//
// Roles (warp specialisation, 3 warpgroups, one CTA an SM, persistent over
// tiles so that the next tile's loads overlap this one's MMAs and epilogue):
//
//   warpgroup 2, the producer (setmaxnreg down to 72 registers):
//     thread 0      keeps TMA loads of B in flight: for each (tile, chunk,
//                   tap) the 64 x BN block of Wmat, rows tap*C + chunk*64..,
//                   columns co0.. (64-column boxes, 128-byte swizzle), into a
//                   ring of B_STAGES stages with full / empty mbarriers. The
//                   rows are K and the columns N, so B is MN-major: wgmma reads
//                   it with its transpose bit.
//     warps 1..3    fill the halo ring (HALO_SLOTS slots) through the Halo
//                   policy: K2 by one 4-D TMA box whose zero fill at signed
//                   coordinates is the SAME pad, K3 by cp.async from 96
//                   threads at reflected addresses (with conv2's normalize +
//                   ReLU + bf16 round applied once per halo element).
//   warpgroups 0, 1, the consumers (setmaxnreg up to 216):
//     operand A from registers: ldmatrix.x4 at the tap-shifted halo row of
//     each of the warp's 16 pixels (any pixel may start a row, which the
//     descriptor form of A could not do without base offsets), then
//     wgmma.mma_async m64nBNk16 with B from shared memory. Two A register
//     sets alternate, so one group's ldmatrix runs under the previous
//     group's MMAs (wgmma.wait_group 1). Each chunk ends with a full
//     wait before its B stage and halo slot go back to the producer: three
//     A register sets (wait_group 2), or releasing them one group later
//     across chunks, both spilled under the 216-register cap and ran slower
//     on the H100.
//
// Halo layout (both policies): pixel p = hy*(TW+2) + hx of the slot holds its
// 64 channels in 128 bytes, 16-byte chunk j at chunk j ^ (p & 7): the TMA
// 128-byte swizzle, which the manual fill repeats, and which keeps each
// ldmatrix phase (8 consecutive pixels) free of bank conflicts.
//
// Epilogue, from the wgmma accumulator layout (thread t of a warpgroup holds
// rows 16*(t/32) + (t%32)/4 + {0, 8}, columns 8j + 2*(t%4) + {0, 1}) through
// the Epi policy: `float2 value(a0, a1, co)` maps two sums to the stored
// values (bias, ReLU, rounding), `store(pixel, co, v)` writes them. With
// Epi::kStats, each tile also writes per-channel (count, mean, M2) of the
// values over its valid pixels to Epi::partial[(n*tiles + tile)*3 + {0,1,2},
// co] (a fixed-order reduction: shuffles, then the 8 consumer warps in
// order), for a finalize kernel to combine by Chan's formula.
//
// Deterministic: no split K, no atomics; every sum has one fixed order.
// Element offsets are 64-bit.
#pragma once
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from
                   // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv3x3 {

using bf16 = __nv_bfloat16;

constexpr int KC = 64;               // input channels per K chunk
constexpr int CONSUMERS = 2;         // consumer warpgroups
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int B_STAGES = 4;  // measured: 8 stages ran 2-9% slower on the H100
constexpr int PRODUCER_REGS = 72;    // 128 * 72 + 256 * 216 <= 65536
constexpr int CONSUMER_REGS = 216;

template <int BN>
struct Plan {
  static_assert(BN == 64 || BN == 128, "wgmma n");
  static constexpr int MSUB = 256 / BN;  // m64 sub-tiles per consumer warpgroup
  static constexpr int PIX = 64 * MSUB * CONSUMERS;
  static constexpr int TW = 32;
  static constexpr int TH = PIX / TW;
  static constexpr int HALO_W = TW + 2;
  static constexpr int HALO_PIX = (TH + 2) * HALO_W;
  static constexpr int HALO_BYTES = HALO_PIX * 128;
  static constexpr int HALO_SLOT = (HALO_BYTES + 1023) / 1024 * 1024;
  static constexpr int HALO_SLOTS = 2;
  static constexpr int B_BYTES = BN * KC * 2;
  static constexpr int RED_FLOATS = CONSUMER_WARPS * BN + BN;
  static constexpr int BAR_BYTES = 8 * 2 * (B_STAGES + HALO_SLOTS);
  static constexpr int SMEM = 1024 + HALO_SLOTS * HALO_SLOT + B_STAGES * B_BYTES +
                              RED_FLOATS * 4 + BAR_BYTES;
  static_assert(SMEM <= 232448, "shared memory");
};

// The problem and its tiling, passed to the kernel by value.
struct Geom {
  int N, H, W, C;
  int tiles_y, tiles_x, co_tiles, nchunks;
  int total;  // N * tiles_y * tiles_x * co_tiles; tile t = ((n*ty + y)*tx + x)*ct + c
};

template <int BN>
inline Geom geometry(int n, int h, int w, int c) {
  using P = Plan<BN>;
  Geom g;
  g.N = n, g.H = h, g.W = w, g.C = c;
  g.tiles_y = (h + P::TH - 1) / P::TH;
  g.tiles_x = (w + P::TW - 1) / P::TW;
  g.co_tiles = (c + BN - 1) / BN;
  g.nchunks = (c + KC - 1) / KC;
  g.total = n * g.tiles_y * g.tiles_x * g.co_tiles;
  return g;
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle, zero fill out of bounds. dims and
// box innermost first; strides in bytes of dims 1.. .
inline cudaError_t encode_bf16(CUtensorMap* map, const void* base, int rank,
                               const cuuint64_t* dims, const cuuint64_t* strides,
                               const cuuint32_t* box) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Wmat (9*C, C) as a (tap, ci, co) tensor: boxes of 64 ci rows x 64 co.
inline cudaError_t encode_weight_map(CUtensorMap* map, const bf16* wmat, int c) {
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)c, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)c * 2, (cuuint64_t)c * c * 2};
  const cuuint32_t box[3] = {64, KC, 1};
  return encode_bf16(map, wmat, 3, dims, strides, box);
}

// x (N, H, W, C) with a (TH+2) x (TW+2) x 64-channel box.
template <int BN>
inline cudaError_t encode_halo_map(CUtensorMap* map, const bf16* x, int n, int h, int w,
                                   int c) {
  using P = Plan<BN>;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {KC, P::TW + 2, P::TH + 2, 1};
  return encode_bf16(map, x, 4, dims, strides, box);
}

// Launch `kernel` on a persistent grid (one CTA an SM, at most one a tile),
// opting in to the plan's dynamic shared memory first. The SM count and the
// opt-in are kept per device.
template <int BN, auto kernel, typename... Args>
inline cudaError_t launch(const Geom& g, cudaStream_t s, Args... args) {
  static int sms[64];
  static bool opted[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Plan<BN>::SMEM);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  const int blocks = g.total < sms[dev] ? g.total : sms[dev];
  if (blocks == 0) return cudaSuccess;
  kernel<<<blocks, THREADS, Plan<BN>::SMEM, s>>>(args...);
  return cudaGetLastError();
}

// -------------------------------------------------------------- device side

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, asynchronously; zeros where !valid (src unread).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Arrives on the barrier once this thread's cp.async copies have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// The consumer warpgroups only (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * CONSUMERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B descriptor: MN-major (transposed), 128-byte swizzle; 64-column atoms
// 8192 bytes apart (64 K rows of 128 bytes: LBO), 8-row K groups 1024
// bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[0 .. N/2) += A (registers, m64k16) * B (descriptor, k16 x N, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------------- core

template <int BN, class Halo, class Epi>
__device__ __forceinline__ void conv_tiles(const Halo& halo, const CUtensorMap* wmap,
                                           const Epi& epi, const Geom& g) {
  using P = Plan<BN>;
  constexpr int MSUB = P::MSUB;
  constexpr int TW = P::TW, TH = P::TH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t halo0 = smem_u32(base);
  const uint32_t b0 = halo0 + P::HALO_SLOTS * P::HALO_SLOT;
  float* red = reinterpret_cast<float*>(base + P::HALO_SLOTS * P::HALO_SLOT +
                                        B_STAGES * P::B_BYTES);  // [8][BN]
  float* tmean = red + CONSUMER_WARPS * BN;                      // [BN]
  const uint32_t bars = smem_u32(tmean + BN);
  const uint32_t full_b = bars, empty_b = bars + 8 * B_STAGES;
  const uint32_t full_h = bars + 16 * B_STAGES, empty_h = full_h + 8 * P::HALO_SLOTS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < P::HALO_SLOTS; ++s) {
      mbar_init(full_h + 8 * s, Halo::THREADS);
      mbar_init(empty_h + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ------------------------------------------------ producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ptid = threadIdx.x - 128 * CONSUMERS;
    if (ptid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
        const int co0 = (t % g.co_tiles) * BN;
        for (int c = 0; c < g.nchunks; ++c) {
          for (int tap = 0; tap < 9; ++tap) {
            mbar_wait(empty_b + 8 * stage, phase ^ 1);
            mbar_expect_tx(full_b + 8 * stage, P::B_BYTES);
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              tma_load_3d(b0 + stage * P::B_BYTES + b * 8192, wmap, co0 + 64 * b, c * KC, tap,
                          full_b + 8 * stage);
            if (++stage == B_STAGES) stage = 0, phase ^= 1;
          }
        }
      }
    } else if (ptid >= 32 && ptid - 32 < Halo::THREADS) {
      const int htid = ptid - 32;
      int slot = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
        int r = t / g.co_tiles;
        const int tx = r % g.tiles_x;
        r /= g.tiles_x;
        const int ty = r % g.tiles_y, n = r / g.tiles_y;
        for (int c = 0; c < g.nchunks; ++c) {
          mbar_wait(empty_h + 8 * slot, phase ^ 1);
          halo.template load<P>(halo0 + slot * P::HALO_SLOT, full_h + 8 * slot, n, ty * TH,
                                tx * TW, c * KC, htid);
          if (++slot == P::HALO_SLOTS) slot = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------- consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int khalf = lane >> 4;
    // this lane's ldmatrix row in each sub-tile: tile pixel q, halo pixel
    // (q / TW, q % TW) before the tap's shift
    int hp0[MSUB];
#pragma unroll
    for (int ms = 0; ms < MSUB; ++ms) {
      const int q = (wg * MSUB + ms) * 64 + w * 16 + (lane & 15);
      hp0[ms] = (q / TW) * P::HALO_W + q % TW;
    }
    float acc[MSUB][BN / 2];
    uint32_t afr[2][4][4];
    int bstage = 0, hslot = 0;
    uint32_t bphase = 0, hphase = 0;
    for (int t = blockIdx.x; t < g.total; t += gridDim.x) {
      const int ct = t % g.co_tiles;
      int r = t / g.co_tiles;
      const int tx = r % g.tiles_x;
      r /= g.tiles_x;
      const int ty = r % g.tiles_y, n = r / g.tiles_y;
#pragma unroll
      for (int ms = 0; ms < MSUB; ++ms) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[ms][i] = 0.0f;
        fence_acc<BN / 2>(acc[ms]);
      }
      for (int c = 0; c < g.nchunks; ++c) {
        mbar_wait(full_h + 8 * hslot, hphase);
        const uint32_t hb = halo0 + hslot * P::HALO_SLOT;
        int prev = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(full_b + 8 * bstage, bphase);
          const uint64_t db = desc_b(b0 + bstage * P::B_BYTES);
#pragma unroll
          for (int ms = 0; ms < MSUB; ++ms) {
            uint32_t(&a)[4][4] = afr[(tap * MSUB + ms) & 1];
            const int hp = hp0[ms] + (tap / 3) * P::HALO_W + tap % 3;
            const uint32_t row = hb + hp * 128;
            const int sw = hp & 7;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              ldmatrix_x4(a[kk], row + ((((kk << 1) | khalf) ^ sw) << 4));
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs<BN>(acc[ms], a[kk], db + (uint64_t)(kk * (2048 >> 4)));
            wgmma_commit();
            wgmma_wait<1>();  // the group before this one is done
            if (ms == 0 && tap > 0 && lane == 0) mbar_arrive(empty_b + 8 * prev);
          }
          prev = bstage;
          if (++bstage == B_STAGES) bstage = 0, bphase ^= 1;
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(empty_b + 8 * prev);
          mbar_arrive(empty_h + 8 * hslot);
        }
        if (++hslot == P::HALO_SLOTS) hslot = 0, hphase ^= 1;
      }
#pragma unroll
      for (int ms = 0; ms < MSUB; ++ms) fence_acc<BN / 2>(acc[ms]);

      // ------------------------------------------------------ epilogue
      const int y0 = ty * TH, x0 = tx * TW, co0 = ct * BN;
      bool valid[MSUB][2];
#pragma unroll
      for (int ms = 0; ms < MSUB; ++ms) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = (wg * MSUB + ms) * 64 + w * 16 + (lane >> 2) + 8 * i;
          const int y = y0 + q / TW, x = x0 + q % TW;
          valid[ms][i] = y < g.H && x < g.W;
          const int64_t pix = ((int64_t)n * g.H + y) * g.W + x;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = co0 + 8 * j + 2 * (lane & 3);
            float* d = &acc[ms][4 * j + 2 * i];
            const float2 v = co < g.C ? epi.value(d[0], d[1], co) : make_float2(0.0f, 0.0f);
            d[0] = v.x;
            d[1] = v.y;
            if (valid[ms][i] && co < g.C) epi.store(pix, co, v);
          }
        }
      }
      if constexpr (Epi::kStats) {
        // per-channel count, mean and sum of squared deviations about the
        // mean of the tile's valid pixels, in a fixed order
        const int cw = wg * 4 + w, ctid = threadIdx.x;
        const int hh = g.H - y0 < TH ? g.H - y0 : TH, ww = g.W - x0 < TW ? g.W - x0 : TW;
        const float cnt = (float)(hh * ww);
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * (lane & 3) + e;
              const float m = pass ? tmean[col] : 0.0f;
              float s = 0.0f;
#pragma unroll
              for (int ms = 0; ms < MSUB; ++ms)
#pragma unroll
                for (int i = 0; i < 2; ++i)
                  if (valid[ms][i]) {
                    const float dv = __fsub_rn(acc[ms][4 * j + 2 * i + e], m);
                    s = __fadd_rn(s, pass ? __fmul_rn(dv, dv) : dv);
                  }
              s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
              s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 8));
              s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 16));
              if (lane < 4) red[cw * BN + col] = s;
            }
          }
          consumers_sync();
          if (ctid < BN) {
            float tot = 0.0f;
#pragma unroll
            for (int k = 0; k < CONSUMER_WARPS; ++k) tot = __fadd_rn(tot, red[k * BN + ctid]);
            if (pass == 0) {
              tmean[ctid] = __fdiv_rn(tot, cnt);
            } else if (co0 + ctid < g.C) {
              float* p = epi.partial +
                         ((int64_t)(n * g.tiles_y + ty) * g.tiles_x + tx) * 3 * g.C + co0 + ctid;
              p[0] = cnt;
              p[g.C] = tmean[ctid];
              p[2 * g.C] = tot;
            }
          }
          consumers_sync();
        }
      }
    }
  }
}

}  // namespace conv3x3
