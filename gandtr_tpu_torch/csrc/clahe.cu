// K1 and K4: CLAHE on a batch of uint8 images in one launch, for Hopper
// (sm_90a). One kernel serves both sites.
//
// Replaces the TPU kernels gandtr_tpu/ops/clahe_pallas.py::clahe_u8_pallas
// (K1: _lut_kernel and _interp_kernel) and ::masked_interp_pallas (K4:
// _masked_interp_kernel with _coords_dyn and _div_f32_correct_kernel),
// together with the XLA LUT build in front of K4 (gandtr_tpu/ops/clahe.py::
// clahe_u8_masked). Same functions as gandtr_tpu_torch/ops/clahe.py::
// clahe_u8_plain (static mode, `hw` null: every image is the whole buffer,
// cv2's full BORDER_REFLECT_101 pad) and ::clahe_u8_masked_plain (masked
// mode: each image's valid top-left (h, w) read from an int32 (N, 2) tensor
// on the device, one bounce of reflect-101 about it, clamped into the
// buffer, the band outside it written 0). Both are bit-exact vs cv2.
//
// Geometry, as cv2: the image is padded right and bottom so that its sides
// divide the tile grid (a full extra tile on an axis that already divides
// when the other does not); tile sizes tile_h, tile_w; climit from the clip
// limit and the tile area; LUT = round-half-even(cdf * (255 / area)) after
// clipping and redistributing the histogram. A pixel at (y, x) blends the
// LUTs of the tiles at the clamped raw indices floor(y / tile_h - 0.5) and
// +1 (and the same along x) in cv2's float32 coordinate chain.
//
// One CTA per interpolation cell of an image: a cell is the set of pixels
// that share the raw index pair (a, b), a in {-1, ..., ty - 1} and b in
// {-1, ..., tx - 1}, so the grid is ((ty + 1) * (tx + 1), N). The raw index
// never decreases along an axis, so a cell is a rectangle of rows
// [first(a), first(a + 1)) and columns [first(b), first(b + 1)), found by the
// same float32 chain (`first_at_least`); the cells partition the valid
// rectangle exactly. Each CTA builds the at most 4 LUTs its cell reads (1
// or 2 at the clamped edges) in shared memory -- histograms by shared-memory
// atomics over the tiles' pixels, the pad addressed in place -- and then
// interpolates its cell from them, one 32-bit word of shared memory a
// pixel for its 4 corners. A tile's histogram is thus built by up
// to 4 CTAs, from L2 for all but the first; the LUT is integer arithmetic,
// so the copies are bit-identical. In exchange there is no LUT tensor in
// device memory, no second launch and no communication between CTAs. The
// band of a masked image is split evenly among the image's CTAs.
//
// Loads and stores move 16 bytes a thread where the row width and the
// pointers allow it (4 or 1 otherwise): a chunk of V bytes aligned in the
// row is loaded whole; a chunk that straddles a cell's edge stores byte by
// byte.
//
// Bound: memory, and at the main path's sizes the launch. The function
// reads each image once and writes it once: at (8, 768, 1024) 12.6 MB, 3.8
// us at 3.35 TB/s; at the fine-tune's (7, 364, 364) 1.9 MB, 0.6 us.
//
// Exactness: built without fast math and with --fmad=false; the coordinate
// chain and the lerp use __fmul_rn / __fadd_rn / __fsub_rn, divisions
// __fdiv_rn (static mode's clip limit in double, as the host computes it),
// and rintf rounds half to even.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // histogram chunks a thread loads before counting
// CTAs resident on an SM (registers capped to fit): 5 x 132 SMs hold the
// 648 CTAs of K1's (8, 768, 1024) batch and the 567 of K4's (7, 364, 364)
// bucket in one wave
constexpr int kCtasPerSm = 5;

template <int V> struct Chunk;
template <> struct Chunk<16> { using T = uint4; };
template <> struct Chunk<4> { using T = uint32_t; };
template <> struct Chunk<1> { using T = uint8_t; };

template <int V> union Bytes {
  typename Chunk<V>::T v;
  uint8_t b[V];
};

// One axis of an image's tile geometry.
struct Axis {
  int valid;   // the image's size along the axis (h or w)
  int tsize;   // tile size after cv2's pad
  float inv;   // 1 / tsize, correctly rounded
};

__device__ __forceinline__ Axis make_axis(int valid, int count, bool both) {
  Axis ax;
  ax.valid = valid;
  ax.tsize = (valid + (both ? 0 : count - valid % count)) / count;
  ax.inv = __fdiv_rn(1.0f, (float)ax.tsize);
  return ax;
}

// cv2's coordinate chain: f = pos * (1 / tsize) - 0.5, each step rounded
__device__ __forceinline__ float coord(int pos, float inv) {
  return __fsub_rn(__fmul_rn((float)pos, inv), 0.5f);
}

// The first position in [0, valid] whose raw index floor(coord) is >= k
// (valid when there is none). Starts at about (k + 0.5) * tsize and steps
// to the exact run boundary of the float32 chain.
__device__ int first_at_least(int k, const Axis& ax) {
  int p = min(max(k * ax.tsize + (ax.tsize + 1) / 2, 0), ax.valid);
  while (p > 0 && (int)floorf(coord(p - 1, ax.inv)) >= k) --p;
  while (p < ax.valid && (int)floorf(coord(p, ax.inv)) < k) ++p;
  return p;
}

// The buffer row (or column) that padded position i >= 0 reads.
__device__ __forceinline__ int source_index(int i, int valid, int n,
                                            bool masked) {
  if (masked) {  // one bounce of reflect-101 about the valid size, clamped
    const int r = i < valid ? i : 2 * valid - 2 - i;
    return min(max(r, 0), n - 1);
  }
  if (i < n) return i;  // cv2's BORDER_REFLECT_101 (valid == n)
  if (n == 1) return 0;
  const int period = 2 * n - 2;
  i %= period;
  return i >= n ? period - i : i;
}

// Byte k of q as a float, exactly: 2^23 + byte, as bits, minus 2^23.
__device__ __forceinline__ float byte_f(uint32_t q, int k) {
  return __fsub_rn(__int_as_float(__byte_perm(q, 0x4B000000u, 0x7540 | k)),
                   8388608.0f);
}

// Zero [p, p + len) with the whole CTA: 16-byte stores where aligned.
__device__ void zero_span(uint8_t* p, size_t len) {
  const uintptr_t s = (uintptr_t)p, e = s + len;
  const uintptr_t up = (s + 15) & ~(uintptr_t)15, down = e & ~(uintptr_t)15;
  const uintptr_t a0 = up < e ? up : e, a1 = down > a0 ? down : a0;
  for (uintptr_t q = s + threadIdx.x; q < a0; q += kThreads)
    *(uint8_t*)q = 0;
  for (uintptr_t q = a0 + 16 * threadIdx.x; q < a1; q += 16 * kThreads)
    *(uint4*)q = make_uint4(0, 0, 0, 0);
  for (uintptr_t q = a1 + threadIdx.x; q < e; q += kThreads)
    *(uint8_t*)q = 0;
}

template <int V>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
clahe_kernel(const uint8_t* __restrict__ img, const int* __restrict__ hw,
             uint8_t* __restrict__ out, int H, int W, int ty, int tx,
             double clip_limit) {
  __shared__ int hist[4][256];
  __shared__ uint32_t lut4[256];  // bin -> its 4 corner LUT bytes
  __shared__ int clipped[4];
  __shared__ int warp_sums[4][kThreads / 32];

  const int tid = threadIdx.x;
  const int n = blockIdx.y;
  const int cell = blockIdx.x, ncells = gridDim.x;
  const int a = cell / (tx + 1) - 1, b = cell % (tx + 1) - 1;
  const bool masked = hw != nullptr;
  const int h = masked ? min(hw[2 * n], H) : H;
  const int w = masked ? min(hw[2 * n + 1], W) : W;
  const uint8_t* src = img + (size_t)n * H * W;
  uint8_t* dst = out + (size_t)n * H * W;

  if (masked) {
    // the band: rows [h, H) are one span, cut evenly among the CTAs; the
    // columns [w, W) of row y < h go to CTA y % ncells
    const size_t band = (size_t)(H - max(h, 0)) * W;
    const size_t lo = band * cell / ncells, hi = band * (cell + 1) / ncells;
    zero_span(dst + (size_t)max(h, 0) * W + lo, hi - lo);
    if (w < W)
      for (int y = cell; y < h; y += ncells)
        zero_span(dst + (size_t)y * W + max(w, 0), W - max(w, 0));
  }
  if (h <= 0 || w <= 0) return;

  const bool both = (h % ty == 0) && (w % tx == 0);
  const Axis ay = make_axis(h, ty, both), ax = make_axis(w, tx, both);
  const int y_lo = first_at_least(a, ay), y_hi = first_at_least(a + 1, ay);
  const int x_lo = first_at_least(b, ax), x_hi = first_at_least(b + 1, ax);
  if (y_lo >= y_hi || x_lo >= x_hi) return;  // an empty cell (uniform)

  // the tiles the cell reads: rows ty0..ty1 and columns tx0..tx1 of tiles
  const int ty0 = min(max(a, 0), ty - 1), ty1 = min(max(a + 1, 0), ty - 1);
  const int tx0 = min(max(b, 0), tx - 1), tx1 = min(max(b + 1, 0), tx - 1);
  const int th = ay.tsize, tw = ax.tsize, area = th * tw;

  for (int i = tid; i < 4 * 256; i += kThreads) (&hist[0][0])[i] = 0;
  if (tid < 4) clipped[tid] = 0;
  __syncthreads();

  // histograms over the tiles' union in padded coordinates: local tile
  // (row >= ysplit ? 2 : 0) + (column >= xsplit ? 1 : 0)
  const int Y0 = ty0 * th, rows = (ty1 - ty0 + 1) * th, ysplit = Y0 + th;
  const int X0 = tx0 * tw, X1 = (tx1 + 1) * tw, xsplit = X0 + tw;
  // columns [X0, Xd) are read in place, V at a time; [Xd, X1) lie past the
  // valid width and are read by reflection, one at a time
  const int Xd = max(X0, min(X1, w));
  const int c0 = X0 & ~(V - 1);
  const int nch = Xd > X0 ? (Xd - c0 + V - 1) / V : 0;
  // kLoads chunks a thread in flight before their atomics
  for (int t0 = tid; t0 < rows * nch; t0 += kLoads * kThreads) {
    Bytes<V> v[kLoads];
    int x[kLoads], tyl[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int t = t0 + u * kThreads;
      const int r = t / nch, py = Y0 + r;
      x[u] = c0 + (t - r * nch) * V;
      tyl[u] = py >= ysplit ? 2 : 0;
      if (t < rows * nch)
        v[u].v = *(const typename Chunk<V>::T*)(
            src + (size_t)source_index(py, h, H, masked) * W + x[u]);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (t0 + u * kThreads < rows * nch) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (x[u] + k >= X0 && x[u] + k < Xd)
            atomicAdd(&hist[tyl[u] + (x[u] + k >= xsplit)][v[u].b[k]], 1);
      }
    }
  }
  const int nref = X1 - Xd;
  for (int t = tid; t < rows * nref; t += kThreads) {
    const int r = t / nref, px = Xd + (t - r * nref);
    const int py = Y0 + r;
    const uint8_t v = src[(size_t)source_index(py, h, H, masked) * W +
                          source_index(px, w, W, masked)];
    atomicAdd(&hist[(py >= ysplit ? 2 : 0) + (px >= xsplit)][v], 1);
  }
  __syncthreads();

  // clip, redistribute, scan and scale each tile's histogram: thread = bin
  int climit = area;
  if (clip_limit > 0.0) {
    climit = masked ? (int)__fdiv_rn(__fmul_rn((float)clip_limit,
                                               (float)area), 256.0f)
                    : (int)__ddiv_rn(__dmul_rn(clip_limit, (double)area),
                                     256.0);
    climit = max(climit, 1);
  }
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = hist[k][tid];
    const int excess = v[k] > climit ? v[k] - climit : 0;
    if (excess) atomicAdd(&clipped[k], excess);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int redist = clipped[k] / 256;
    const int residual = clipped[k] - redist * 256;
    v[k] = min(v[k], climit) + redist;
    const int step = max(256 / max(residual, 1), 1);
    if (tid % step == 0 && tid / step < residual) v[k] += 1;
    // inclusive scan over 256 bins: within each warp, then across warps
    for (int s = 1; s < 32; s <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v[k], s);
      if (lane >= s) v[k] += u;
    }
    if (lane == 31) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  const float lut_scale = __fdiv_rn(255.0f, (float)area);
  uint32_t l[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (int i = 0; i < warp; ++i) v[k] += warp_sums[k][i];
    l[k] = (uint32_t)fminf(
        fmaxf(rintf(__fmul_rn((float)v[k], lut_scale)), 0.0f), 255.0f);
  }
  // the cell's 4 corners are the same local tiles for all of its pixels:
  // (y1, x1), (y1, x2), (y2, x1), (y2, x2), one byte each, so a pixel reads
  // one word of shared memory
  const bool two_x = tx1 != tx0, two_y = ty1 != ty0;
  const uint32_t l12 = two_x ? l[1] : l[0];
  const uint32_t l21 = two_y ? l[2] : l[0];
  const uint32_t l22 = two_y ? (two_x ? l[3] : l[2]) : l12;
  lut4[tid] = l[0] | l12 << 8 | l21 << 16 | l22 << 24;
  __syncthreads();

  // interpolate the cell; only the weights vary from pixel to pixel
  const int i0 = x_lo & ~(V - 1), inch = (x_hi - i0 + V - 1) / V;
  for (int t = tid; t < (y_hi - y_lo) * inch; t += kThreads) {
    const int r = t / inch, x = i0 + (t - r * inch) * V;
    const int y = y_lo + r;
    const float fy = coord(y, ay.inv);
    const float wy = __fsub_rn(fy, floorf(fy)), omy = __fsub_rn(1.0f, wy);
    const size_t row = (size_t)y * W;
    Bytes<V> in, res;
    in.v = *(const typename Chunk<V>::T*)(src + row + x);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float fx = coord(x + k, ax.inv);
      const float wx = __fsub_rn(fx, floorf(fx)), omx = __fsub_rn(1.0f, wx);
      const uint32_t q = lut4[in.b[k]];
      const float top = __fadd_rn(__fmul_rn(byte_f(q, 0), omx),
                                  __fmul_rn(byte_f(q, 1), wx));
      const float bot = __fadd_rn(__fmul_rn(byte_f(q, 2), omx),
                                  __fmul_rn(byte_f(q, 3), wx));
      const float o = rintf(__fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy)));
      res.b[k] = (uint8_t)fminf(fmaxf(o, 0.0f), 255.0f);
    }
    if (x >= x_lo && x + V <= x_hi) {
      *(typename Chunk<V>::T*)(dst + row + x) = res.v;
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (x + k >= x_lo && x + k < x_hi) dst[row + x + k] = res.b[k];
    }
  }
}

template <int V>
int launch(const uint8_t* img, const int* hw, uint8_t* out, int n, int h,
           int w, int ty, int tx, double clip_limit, cudaStream_t s) {
  clahe_kernel<V><<<dim3((ty + 1) * (tx + 1), n), kThreads, 0, s>>>(
      img, hw, out, h, w, ty, tx, clip_limit);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel once on `stream` and returns cudaGetLastError() as an
// int (0 on success). img, out: (n, h, w) uint8; hw: (n, 2) int32 valid
// sizes on the device (masked mode, band written 0) or null (static mode).
extern "C" int clahe_launch(const uint8_t* img, const int* hw, uint8_t* out,
                            int n, int h, int w, int ty, int tx,
                            double clip_limit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)img | (uintptr_t)out;
  if (w % 16 == 0 && ptrs % 16 == 0)
    return launch<16>(img, hw, out, n, h, w, ty, tx, clip_limit, s);
  if (w % 4 == 0 && ptrs % 4 == 0)
    return launch<4>(img, hw, out, n, h, w, ty, tx, clip_limit, s);
  return launch<1>(img, hw, out, n, h, w, ty, tx, clip_limit, s);
}

extern "C" const char* clahe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
