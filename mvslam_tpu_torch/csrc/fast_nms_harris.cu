// Fused dense ORB corner front for a whole scale pyramid in one launch,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel mvslam_tpu/ops/features_pallas.py::
// fast_nms_harris_rank (pl.pallas_call in that function), which the JAX
// package calls once per pyramid level. Output, per level: the rank map of
// features.orb_detect,
//   rank = where(suppress_border(nms3x3(fast(img))) > 0, harris(img), -inf)
// with FAST-9/16 max-margin score, strict 3x3 NMS, Harris det - k tr^2 from
// separable Sobel [1,2,1]/8 x [-1,0,1] and 7x7 box sums of Ix^2, Iy^2, IxIy.
//
// What bounds it on an H100. The tracker's frame is 288x384 with 8 levels
// at scale 1.2: 342,528 pixels. One float32 read and one write per pixel is
// 2.74 MB, 0.82 us at the card's 3.35 TB/s. The arithmetic, counted on the
// bench frame: 60 operations at every pixel (the 4-pixel test, Sobel and
// its products, NMS), 224 at the 23% of pixels that pass the test (the arc
// search), 155 at the 1.3% that are corners (the box sums): 39 MFLOP, 0.58
// us at the 67 TFLOP/s float32 rate. So the least the card could take is
// under 1 us, by bytes, and both are small beside what launches cost: an
// empty grid of this size replays in 1.6 us, a device copy of the same
// bytes in 1.9 us, and one launch per level (8 grids, the last five of 78
// to 12 blocks on 132 SMs) took 44 us. The design:
//
// - One launch for the pyramid. The levels stay the separate tensors the
//   resize produced; a table of their pointers, shapes, output offsets and
//   tile prefixes travels by value as a __grid_constant__ kernel parameter
//   (no host-to-device copy, nothing to synchronise, capturable in a CUDA
//   graph). The grid is one-dimensional over the 32x16 tiles of all levels,
//   largest level first (706 blocks for 288x384); a block scans the <= 16
//   tile prefixes for its level. All maps go to one output buffer, each
//   level dense at its offset.
// - 128 threads a block, so that all 706 blocks are resident at once (6 a
//   SM, with 18.6 KB of shared memory each): one wave, no tail.
// - Every intermediate stays in shared memory: a block loads its
//   (tile + 8)^2 image slab once, clamp-to-edge (the halo of the chain's
//   reach: FAST ring 3 + NMS 1, Sobel 1 + box 3), with 16-byte loads where
//   the level's rows are 16-byte aligned and the slab lies inside the row;
//   only the rank reaches device memory.
// - FAST in two steps. A 9-long arc of the 16-ring always covers at least
//   two of the four compass pixels (ring indices 0, 4, 8, 12), so a pixel
//   with fewer than two positive bright margins and fewer than two positive
//   dark margins among those four scores exactly 0. Every thread runs that
//   4-pixel test and appends the survivors to a list in shared memory; the
//   threads then share the list, so the ~220-operation arc search runs on
//   dense warps over the candidates alone, not on diverged warps over
//   every pixel.
// - Box sums by a warp to a corner. Corners are ~6 a block; summed in
//   place, one lane of a warp would walk 147 taps while 31 wait. The
//   corners go to a second list, and 21 lanes each sum one 7-tap row of
//   one product; the rows are then added in order, each row's taps left
//   to right, as a single thread would.
//
// PERF.md holds the times of this design and of the alternatives that were
// measured against it and lost (the arc search at every pixel or rejected
// in place, in-place box sums, ballot-aggregated list appends, scalar
// loads, other thread counts and tiles).
//
// Parity: FAST margins are computed as (ring - center) - t and
// (center - ring) - t, and the score is a pure min/max of those values, so
// the corner set is bit-exact against the plain composition wherever the
// plain version's boundary fill cannot reach (>= 4 px from the image edge,
// inside the border suppression). Harris values differ from it only by
// summation order (direct 7-tap row sums, then the 7 rows, against cumsum
// differences).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfast_nms_harris.so fast_nms_harris.cu
// Entry point: mvslam_fast_nms_harris_rank_pyramid (plain C, loaded with
// ctypes); it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 128;                // a block: all 706 resident
constexpr int TILE_W = 32;                  // output tile
constexpr int TILE_H = 16;
constexpr int HALO = 4;
constexpr int SLAB_W = TILE_W + 2 * HALO;   // image slab
constexpr int SLAB_H = TILE_H + 2 * HALO;
constexpr int SCORE_W = TILE_W + 2;         // FAST score, NMS reach 1
constexpr int SCORE_H = TILE_H + 2;
constexpr int GRAD_W = TILE_W + 6;          // gradient products, box reach 3
constexpr int GRAD_H = TILE_H + 6;
static_assert(TILE_W % 4 == 0, "16-byte slab rows");
static_assert(THREADS % 32 == 0, "whole warps: the shuffles name all lanes");
static_assert(SCORE_H * SCORE_W <= 65535, "candidate indices are 16-bit");

struct LevelTable {
  const float* img[MAX_LEVELS];
  float* out;
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int out_offset[MAX_LEVELS];   // pixels into out
  int tile_first[MAX_LEVELS];   // first block of the level
  int num_levels;
  float threshold;
  float k;
  int border;
};

// FAST-9/16 Bresenham circle, circular order (dx, dy); called with unrolled
// constant j, so the offsets fold into the shared-memory addresses
__device__ constexpr int ring_dx(int j) {
  const int t[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  return t[j];
}
__device__ constexpr int ring_dy(int j) {
  const int t[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return t[j];
}

// best over the 16 circular 9-long arcs of the arc's minimum margin
__device__ __forceinline__ float best_arc9(const float (&m)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) m2[i] = fminf(m[i], m[(i + 1) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m4[i] = fminf(m2[i], m2[(i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 16; ++i) m8[i] = fminf(m4[i], m4[(i + 4) & 15]);
  float best = fminf(m8[0], m[8]);
#pragma unroll
  for (int i = 1; i < 16; ++i) best = fmaxf(best, fminf(m8[i], m[(i + 8) & 15]));
  return best;
}

// max-margin FAST score of the slab pixel (cy, cx): the best arc of the
// bright margins (ring - c) - t or of the dark ones (c - ring) - t, or 0
__device__ __forceinline__ float fast_score_at(const float (&s_img)[SLAB_H][SLAB_W],
                                               int cy, int cx, float threshold) {
  const float c = s_img[cy][cx];
  float bright[16], dark[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float r = s_img[cy + ring_dy(j)][cx + ring_dx(j)];
    bright[j] = (r - c) - threshold;
    dark[j] = (c - r) - threshold;
  }
  return fmaxf(fmaxf(best_arc9(bright), best_arc9(dark)), 0.0f);
}

// false only where the score is exactly 0: fewer than two of the four
// compass ring pixels are brighter than c + t, and fewer than two darker
// than c - t, so no 9-long arc can have a positive minimum margin
__device__ __forceinline__ bool compass_test(const float (&s_img)[SLAB_H][SLAB_W],
                                             int cy, int cx, float threshold) {
  const float c = s_img[cy][cx];
  int bright = 0, dark = 0;
#pragma unroll
  for (int j = 0; j < 16; j += 4) {
    const float r = s_img[cy + ring_dy(j)][cx + ring_dx(j)];
    bright += ((r - c) - threshold) > 0.0f;
    dark += ((c - r) - threshold) > 0.0f;
  }
  return bright >= 2 || dark >= 2;
}

// strict 3x3 NMS of a positive score at the output pixel (oy, ox)
__device__ __forceinline__ bool is_corner(const float (&s_score)[SCORE_H][SCORE_W],
                                          int oy, int ox) {
  const float sc = s_score[oy + 1][ox + 1];
  float nbr = -CUDART_INF_F;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      if (dx != 0 || dy != 0) nbr = fmaxf(nbr, s_score[oy + 1 + dy][ox + 1 + dx]);
  return sc >= nbr && sc > 0.0f;
}

__global__ void __launch_bounds__(THREADS)
fast_nms_harris_pyramid_kernel(const __grid_constant__ LevelTable tab) {
  __shared__ __align__(16) float s_img[SLAB_H][SLAB_W];
  __shared__ float s_score[SCORE_H][SCORE_W];
  __shared__ float s_xx[GRAD_H][GRAD_W];
  __shared__ float s_yy[GRAD_H][GRAD_W];
  __shared__ float s_xy[GRAD_H][GRAD_W];
  __shared__ unsigned short s_cand[SCORE_H * SCORE_W];   // passed the compass test
  __shared__ unsigned short s_corner[TILE_H * TILE_W];   // survived NMS and border
  __shared__ int s_num_cand, s_num_corner;

  const int tid = threadIdx.x;

  // 0. which level, which tile of it
  int level = 0;
  while (level + 1 < tab.num_levels &&
         static_cast<int>(blockIdx.x) >= tab.tile_first[level + 1])
    ++level;
  const float* __restrict__ img = tab.img[level];
  float* __restrict__ out = tab.out + tab.out_offset[level];
  const int h = tab.h[level], w = tab.w[level];
  const float threshold = tab.threshold;
  const int tile = static_cast<int>(blockIdx.x) - tab.tile_first[level];
  const int tiles_x = (w + TILE_W - 1) / TILE_W;
  const int x0 = (tile % tiles_x) * TILE_W;
  const int y0 = (tile / tiles_x) * TILE_H;

  if (tid == 0) s_num_cand = s_num_corner = 0;

  // 1. image slab, clamp-to-edge: s_img[sy][sx] = img(y0-4+sy, x0-4+sx)
  const bool vec = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(img) % 16 == 0) &&
                   x0 >= HALO && x0 + TILE_W + HALO <= w;
  if (vec) {
    constexpr int QUADS = SLAB_W / 4;
    for (int i = tid; i < SLAB_H * QUADS; i += THREADS) {
      const int sy = i / QUADS, q = i % QUADS;
      const int gy = min(max(y0 - HALO + sy, 0), h - 1);
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 img + static_cast<size_t>(gy) * w + (x0 - HALO)) + q);
      *reinterpret_cast<float4*>(&s_img[sy][4 * q]) = v;
    }
  } else {
    for (int i = tid; i < SLAB_H * SLAB_W; i += THREADS) {
      const int sy = i / SLAB_W, sx = i % SLAB_W;
      const int gy = min(max(y0 - HALO + sy, 0), h - 1);
      const int gx = min(max(x0 - HALO + sx, 0), w - 1);
      s_img[sy][sx] = img[static_cast<size_t>(gy) * w + gx];
    }
  }
  __syncthreads();

  // 2. FAST, first step, at (y0-1+fy, x0-1+fx); slab center (fy+3, fx+3):
  //    score 0 everywhere, the compass test's survivors to the list
  for (int i = tid; i < SCORE_H * SCORE_W; i += THREADS) {
    const int fy = i / SCORE_W, fx = i % SCORE_W;
    s_score[fy][fx] = 0.0f;
    if (compass_test(s_img, fy + 3, fx + 3, threshold))
      s_cand[atomicAdd(&s_num_cand, 1)] = static_cast<unsigned short>(i);
  }

  // 3. Sobel gradient products at (y0-3+gy, x0-3+gx); slab (gy+1, gx+1).
  //    Ix = smooth_y [1,2,1]/8 then diff_x; Iy = diff_y then smooth_x,
  //    in the plain version's add order.
  for (int i = tid; i < GRAD_H * GRAD_W; i += THREADS) {
    const int gy = i / GRAD_W, gx = i % GRAD_W;
    const int sy = gy + 1, sx = gx + 1;
    const float a_l = (s_img[sy][sx - 1] * 0.25f + 0.125f * s_img[sy - 1][sx - 1])
                      + 0.125f * s_img[sy + 1][sx - 1];
    const float a_r = (s_img[sy][sx + 1] * 0.25f + 0.125f * s_img[sy - 1][sx + 1])
                      + 0.125f * s_img[sy + 1][sx + 1];
    const float ix = -a_l + a_r;
    const float d_l = -s_img[sy - 1][sx - 1] + s_img[sy + 1][sx - 1];
    const float d_c = -s_img[sy - 1][sx] + s_img[sy + 1][sx];
    const float d_r = -s_img[sy - 1][sx + 1] + s_img[sy + 1][sx + 1];
    const float iy = (d_c * 0.25f + 0.125f * d_l) + 0.125f * d_r;
    s_xx[gy][gx] = ix * ix;
    s_yy[gy][gx] = iy * iy;
    s_xy[gy][gx] = ix * iy;
  }
  __syncthreads();

  //    FAST, second step: the arc search, shared out over the list
  const int num_cand = s_num_cand;
  for (int j = tid; j < num_cand; j += THREADS) {
    const int i = s_cand[j];
    const int fy = i / SCORE_W, fx = i % SCORE_W;
    s_score[fy][fx] = fast_score_at(s_img, fy + 3, fx + 3, threshold);
  }
  __syncthreads();

  // 4. per output pixel: strict NMS and border test; -inf where they
  //    fail, the survivors to the corner list
  const int border = tab.border;
  for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
    const int oy = i / TILE_W, ox = i % TILE_W;
    const int y = y0 + oy, x = x0 + ox;
    if (y >= h || x >= w) continue;
    const bool keep = is_corner(s_score, oy, ox) && y >= border &&
                      y < h - border && x >= border && x < w - border;
    if (keep)
      s_corner[atomicAdd(&s_num_corner, 1)] = static_cast<unsigned short>(i);
    else
      out[static_cast<size_t>(y) * w + x] = -CUDART_INF_F;
  }
  __syncthreads();

  // 5. 7x7 box sums and Harris, a warp to a corner: lanes 0-20 each sum
  //    one 7-tap row of one of the three products, then the rows are added
  //    in order
  const int num_corner = s_num_corner;
  const int lane = tid & 31;
  for (int c = tid >> 5; c < num_corner; c += THREADS / 32) {
    const int i = s_corner[c];
    const int oy = i / TILE_W, ox = i % TILE_W;
    float row = 0.0f;
    if (lane < 21) {
      const float (*g)[GRAD_W] = lane < 7 ? s_xx : lane < 14 ? s_yy : s_xy;
      const int dy = lane % 7;
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) row += g[oy + dy][ox + dx];
    }
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      sxx += __shfl_sync(0xffffffffu, row, dy);
      syy += __shfl_sync(0xffffffffu, row, 7 + dy);
      sxy += __shfl_sync(0xffffffffu, row, 14 + dy);
    }
    if (lane == 0) {
      const float det = sxx * syy - sxy * sxy;
      const float tr = sxx + syy;
      out[static_cast<size_t>(y0 + oy) * w + (x0 + ox)] = det - tab.k * tr * tr;
    }
  }
}

}  // namespace

// One launch for num_levels (<= 16) levels. imgs[l] is a dense (h[l], w[l])
// float32 image on the device; its map is written dense at out +
// out_offset[l]. tile_first[l] is the number of 32x16 tiles of the levels
// before l, total_tiles that of all levels. All arrays are host arrays.
extern "C" int mvslam_fast_nms_harris_rank_pyramid(
    int num_levels, const void* const* imgs, float* out, const int* h,
    const int* w, const int* out_offset, const int* tile_first,
    int total_tiles, float threshold, float k, int border, void* stream) {
  if (num_levels < 1 || num_levels > MAX_LEVELS || total_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelTable tab;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    const int s = l < num_levels ? l : num_levels - 1;
    tab.img[l] = static_cast<const float*>(imgs[s]);
    tab.h[l] = h[s];
    tab.w[l] = w[s];
    tab.out_offset[l] = out_offset[s];
    tab.tile_first[l] = l < num_levels ? tile_first[l] : total_tiles;
  }
  tab.out = out;
  tab.num_levels = num_levels;
  tab.threshold = threshold;
  tab.k = k;
  tab.border = border;
  fast_nms_harris_pyramid_kernel<<<total_tiles, THREADS, 0,
                                   static_cast<cudaStream_t>(stream)>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mvslam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
