// K4: masked CLAHE on a padded bucket of uint8 images, for Hopper (sm_90a).
//
// Replaces the TPU kernel gandtr_tpu/ops/clahe_pallas.py::
// masked_interp_pallas (its _masked_interp_kernel, with _coords_dyn and
// _div_f32_correct_kernel) and the XLA LUT build before it
// (gandtr_tpu/ops/clahe.py::clahe_u8_masked). Same function as
// gandtr_tpu_torch/ops/clahe.py::clahe_u8_masked_plain: cv2's CLAHE of each
// image's valid top-left (h, w) rectangle, as cv2 computes it on the exact
// (h, w) image; the band outside the rectangle is written 0.
//
// Each image's (h, w) is read from an int32 (N, 2) tensor on the device, and
// every kernel derives the image's geometry from it; nothing goes through
// the host, so a batch of images of different sizes is one launch pair:
//   clahe_masked_lut_kernel     one CTA per (tile, image): cv2's pad rule
//                               (a full extra tile on an axis that already
//                               divides when the other does not), tile
//                               sizes, climit = int(f32(clip) * area / 256),
//                               lut_scale = 255 / area correctly rounded;
//                               a 256-bin shared-memory histogram over the
//                               tile of the padded rectangle, read at
//                               reflect-101 coordinates about the valid
//                               boundary; clip, redistribute, scan, round
//                               half to even -> uint8 LUTs (N, ty*tx, 256).
//   clahe_masked_interp_kernel  one thread per pixel of the bucket: cv2's
//                               coordinate chain pos * (1 / tile) - 0.5
//                               with the reciprocal correctly rounded,
//                               floor, clamp; 4 LUT reads; the bilinear
//                               lerp in single-rounded f32 products and
//                               sums; band pixels -> 0.
//
// The TPU kernel looks each pixel up in all 64 LUTs with a one-hot matmul
// and picks the 4 corners with one-hot sums, because the TPU has no vector
// gather; here each thread reads its 4 LUT entries directly.
//
// Bound: memory, and far below it launches. At (7, 364, 364) the function
// reads 0.93 MB and writes 0.93 MB, 0.6 us at 3.35 TB/s; the two launches
// cost more than that, which is why a whole batch is one pair.
//
// Exactness: built without fast math and with --fmad=false; the coordinate
// chain and the lerp use __fmul_rn / __fadd_rn / __fsub_rn, divisions
// __fdiv_rn, and rintf rounds half to even.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Geometry {
  int tile_h, tile_w, area;
};

__device__ __forceinline__ Geometry geometry(int h, int w, int ty, int tx) {
  const bool both = (h % ty == 0) && (w % tx == 0);
  Geometry g;
  g.tile_h = (h + (both ? 0 : ty - h % ty)) / ty;
  g.tile_w = (w + (both ? 0 : tx - w % tx)) / tx;
  g.area = g.tile_h * g.tile_w;
  return g;
}

// one bounce of reflect-101 about the valid size s, clamped into the buffer
__device__ __forceinline__ int reflect_clamp(int i, int s, int n) {
  const int r = i < s ? i : 2 * s - 2 - i;
  return min(max(r, 0), n - 1);
}

__global__ void clahe_masked_lut_kernel(const uint8_t* __restrict__ img,
                                        const int* __restrict__ hw,
                                        uint8_t* __restrict__ luts, int H,
                                        int W, int ty, int tx,
                                        float clip_limit) {
  __shared__ int hist[256];
  __shared__ int clipped;
  __shared__ int warp_sums[8];
  const int b = threadIdx.x;  // one thread per bin; blockDim.x == 256
  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int T = gridDim.x;
  const int h = hw[2 * n], w = hw[2 * n + 1];
  const Geometry g = geometry(h, w, ty, tx);
  hist[b] = 0;
  if (b == 0) clipped = 0;
  __syncthreads();

  const uint8_t* src = img + (size_t)n * H * W;
  const int y0 = (tile / tx) * g.tile_h;
  const int x0 = (tile % tx) * g.tile_w;
  for (int i = b; i < g.area; i += 256) {
    const int y = reflect_clamp(y0 + i / g.tile_w, h, H);
    const int x = reflect_clamp(x0 + i % g.tile_w, w, W);
    atomicAdd(&hist[src[(size_t)y * W + x]], 1);
  }
  __syncthreads();

  const float areaf = (float)g.area;
  int climit = g.area;
  if (clip_limit > 0.0f) {
    climit = (int)__fdiv_rn(__fmul_rn(clip_limit, areaf), 256.0f);
    climit = max(climit, 1);
  }
  int v = hist[b];
  const int excess = v > climit ? v - climit : 0;
  if (excess) atomicAdd(&clipped, excess);
  __syncthreads();
  const int redist = clipped / 256;
  const int residual = clipped - redist * 256;
  v = min(v, climit) + redist;
  const int step = max(256 / max(residual, 1), 1);
  if (b % step == 0 && b / step < residual) v += 1;

  // inclusive scan over 256 bins: within each warp, then across the 8 warps
  const int lane = b & 31, warp = b >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, s);
    if (lane >= s) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  for (int k = 0; k < warp; ++k) v += warp_sums[k];

  const float lut_scale = __fdiv_rn(255.0f, areaf);
  const float r = rintf(__fmul_rn((float)v, lut_scale));
  luts[((size_t)n * T + tile) * 256 + b] = (uint8_t)fminf(fmaxf(r, 0.0f), 255.0f);
}

// cv2's coordinate chain along one axis with a runtime tile size
__device__ __forceinline__ void axis_coords(int pos, int tsize, int count,
                                            int* i1, int* i2, float* a) {
  const float inv = __fdiv_rn(1.0f, (float)tsize);
  const float f = __fsub_rn(__fmul_rn((float)pos, inv), 0.5f);
  const float fl = floorf(f);
  *a = __fsub_rn(f, fl);
  const int i = (int)fl;
  *i1 = min(max(i, 0), count - 1);
  *i2 = min(max(i + 1, 0), count - 1);
}

__global__ void clahe_masked_interp_kernel(const uint8_t* __restrict__ img,
                                           const int* __restrict__ hw,
                                           const uint8_t* __restrict__ luts,
                                           uint8_t* __restrict__ out, int H,
                                           int W, int ty, int tx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= W || y >= H) return;
  const size_t pix = ((size_t)n * H + y) * W + x;
  const int h = hw[2 * n], w = hw[2 * n + 1];
  if (y >= h || x >= w) {
    out[pix] = 0;
    return;
  }
  const Geometry g = geometry(h, w, ty, tx);
  int y1, y2, x1, x2;
  float ya, xa;
  axis_coords(y, g.tile_h, ty, &y1, &y2, &ya);
  axis_coords(x, g.tile_w, tx, &x1, &x2, &xa);

  const uint8_t* lut = luts + (size_t)n * ty * tx * 256 + img[pix];
  const float l11 = lut[(y1 * tx + x1) * 256];
  const float l12 = lut[(y1 * tx + x2) * 256];
  const float l21 = lut[(y2 * tx + x1) * 256];
  const float l22 = lut[(y2 * tx + x2) * 256];
  const float omx = __fsub_rn(1.0f, xa), omy = __fsub_rn(1.0f, ya);
  const float top = __fadd_rn(__fmul_rn(l11, omx), __fmul_rn(l12, xa));
  const float bot = __fadd_rn(__fmul_rn(l21, omx), __fmul_rn(l22, xa));
  const float res = rintf(__fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, ya)));
  out[pix] = (uint8_t)fminf(fmaxf(res, 0.0f), 255.0f);
}

}  // namespace

// Launches both kernels on `stream` and returns cudaGetLastError() as an int
// (0 on success). img, out: (n, h, w) uint8; hw: (n, 2) int32 valid sizes on
// the device; luts: (n, ty*tx, 256) uint8 scratch.
extern "C" int clahe_masked_launch(const uint8_t* img, const int* hw,
                                   uint8_t* luts, uint8_t* out, int n, int h,
                                   int w, int ty, int tx, float clip_limit,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  clahe_masked_lut_kernel<<<dim3(ty * tx, n), 256, 0, s>>>(img, hw, luts, h, w, ty,
                                                          tx, clip_limit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  clahe_masked_interp_kernel<<<grid, block, 0, s>>>(img, hw, luts, out, h, w, ty, tx);
  return (int)cudaGetLastError();
}

extern "C" const char* clahe_masked_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
