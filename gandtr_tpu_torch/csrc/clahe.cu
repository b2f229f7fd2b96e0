// K1: static CLAHE on a batch of uint8 images, for Hopper (sm_90a).
//
// Replaces the TPU kernel gandtr_tpu/ops/clahe_pallas.py::clahe_u8_pallas
// (its two pallas_calls: _lut_kernel and _interp_kernel). Same function as
// gandtr_tpu_torch/ops/clahe.py::clahe_u8_plain, bit-exact vs cv2.
//
// Two kernels, each launched ONCE for a whole batch (N, H, W):
//   clahe_lut_kernel     one CTA per (tile, image): 256-bin histogram with
//                        shared-memory atomics over the tile's pixels, the
//                        BORDER_REFLECT_101 pad addressed in place (never
//                        materialised), clip + redistribute, 256-wide
//                        inclusive scan, * lut_scale, round-half-even ->
//                        uint8 LUTs (N, ty*tx, 256).
//   clahe_interp_kernel  one thread per output pixel: cv2's float32
//                        coordinate chain, 4 LUT reads, bilinear lerp,
//                        round-half-even, clamp to uint8.
//
// Bound: memory. The function reads each image once and writes it once
// (the LUT kernel and the interpolation each read it, so the kernels move
// about 3 bytes a pixel): at 1024x768 that is about 2.4 MB an image, under
// a microsecond at 3.35 TB/s. At that size launches dominate, so the design
// launches one kernel pair for a whole batch -- not one per image and not
// one per band of tiles, as the TPU path does (clahe_pallas.py:213-236,
// a pallas_call per band, looped on the host).
//
// Exactness: build without fast math and with --fmad=false; the coordinate
// chain and the lerp use __fmul_rn / __fadd_rn / __fsub_rn anyway, because
// FMA contraction flips round-half-even ties. rintf rounds half to even.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__global__ void clahe_lut_kernel(const uint8_t* __restrict__ img,
                                 uint8_t* __restrict__ luts, int H, int W,
                                 int tx, int tile_h, int tile_w, int climit,
                                 float lut_scale) {
  __shared__ int hist[256];
  __shared__ int clipped;
  __shared__ int warp_sums[8];
  const int b = threadIdx.x;  // one thread per bin; blockDim.x == 256
  const int tile = blockIdx.x;
  const int n = blockIdx.y;
  const int T = gridDim.x;
  hist[b] = 0;
  if (b == 0) clipped = 0;
  __syncthreads();

  const uint8_t* src = img + (size_t)n * H * W;
  const int y0 = (tile / tx) * tile_h;
  const int x0 = (tile % tx) * tile_w;
  const int area = tile_h * tile_w;
  for (int i = b; i < area; i += 256) {
    const int y = reflect101(y0 + i / tile_w, H);
    const int x = reflect101(x0 + i % tile_w, W);
    atomicAdd(&hist[src[(size_t)y * W + x]], 1);
  }
  __syncthreads();

  int h = hist[b];
  const int excess = h > climit ? h - climit : 0;
  if (excess) atomicAdd(&clipped, excess);
  __syncthreads();
  const int redist = clipped / 256;
  const int residual = clipped - redist * 256;
  h = min(h, climit) + redist;
  int step = 256 / max(residual, 1);
  step = max(step, 1);
  if (b % step == 0 && b / step < residual) h += 1;

  // inclusive scan over 256 bins: within each warp, then across the 8 warps
  const int lane = b & 31, warp = b >> 5;
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, h, s);
    if (lane >= s) h += v;
  }
  if (lane == 31) warp_sums[warp] = h;
  __syncthreads();
  for (int w = 0; w < warp; ++w) h += warp_sums[w];

  const float v = rintf(__fmul_rn((float)h, lut_scale));
  luts[((size_t)n * T + tile) * 256 + b] =
      (uint8_t)fminf(fmaxf(v, 0.0f), 255.0f);
}

// cv2's coordinate chain along one axis: f = pos * (1/ts) - 0.5, i1 =
// floor(f), a = f - i1, both indices clipped to [0, count).
__device__ __forceinline__ void axis_coords(int pos, float inv, int count,
                                            int* i1, int* i2, float* a) {
  const float f = __fsub_rn(__fmul_rn((float)pos, inv), 0.5f);
  const float fl = floorf(f);
  *a = __fsub_rn(f, fl);
  const int i = (int)fl;
  *i1 = min(max(i, 0), count - 1);
  *i2 = min(max(i + 1, 0), count - 1);
}

__global__ void clahe_interp_kernel(const uint8_t* __restrict__ img,
                                    const uint8_t* __restrict__ luts,
                                    uint8_t* __restrict__ out, int H, int W,
                                    int ty, int tx, int tile_h, int tile_w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int n = blockIdx.z;
  if (x >= W || y >= H) return;
  int y1, y2, x1, x2;
  float ya, xa;
  axis_coords(y, __fdiv_rn(1.0f, (float)tile_h), ty, &y1, &y2, &ya);
  axis_coords(x, __fdiv_rn(1.0f, (float)tile_w), tx, &x1, &x2, &xa);

  const size_t pix = ((size_t)n * H + y) * W + x;
  const int v = img[pix];
  const uint8_t* lut = luts + (size_t)n * ty * tx * 256 + v;
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
// (0 on success). img, out: (n, h, w) uint8; luts: (n, ty*tx, 256) uint8.
extern "C" int clahe_u8_launch(const uint8_t* img, uint8_t* luts,
                               uint8_t* out, int n, int h, int w, int ty,
                               int tx, int tile_h, int tile_w, int climit,
                               float lut_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  clahe_lut_kernel<<<dim3(ty * tx, n), 256, 0, s>>>(
      img, luts, h, w, tx, tile_h, tile_w, climit, lut_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y, n);
  clahe_interp_kernel<<<grid, block, 0, s>>>(img, luts, out, h, w, ty, tx,
                                             tile_h, tile_w);
  return (int)cudaGetLastError();
}

extern "C" const char* clahe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
