// Fused dense ORB corner front for one pyramid level, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mvslam_tpu/ops/features_pallas.py::
// fast_nms_harris_rank. Output: the rank map of features.orb_detect,
//   rank = where(suppress_border(nms3x3(fast(img))) > 0, harris(img), -inf)
// with FAST-9/16 max-margin score, strict 3x3 NMS, Harris det - k tr^2 from
// separable Sobel [1,2,1]/8 x [-1,0,1] and 7x7 box sums of Ix^2, Iy^2, IxIy.
//
// What bounds it on an H100: one read of the level and one write of the
// map (8 bytes/pixel) against ~150 flops/pixel -- far below the card's
// ~20 flops/byte balance point, so at pyramid-level sizes (<= 480x640) it
// is memory- and launch-latency bound. The design keeps every
// intermediate (FAST score, gradient products) in shared memory: each
// block loads its (tile + 8)^2 image slab once (clamp-to-edge, the halo of
// the chain's reach: FAST ring 3 + NMS 1, Sobel 1 + box 3), and only the
// final rank value reaches device memory.
//
// Parity: FAST margins are computed as (ring - center) - t and
// (center - ring) - t, and the score is a pure min/max of those values, so
// the corner set is bit-exact against the plain composition wherever the
// plain version's boundary fill cannot reach (>= 4 px from the image edge,
// inside the border suppression). Harris values differ only by summation
// order (direct 7-tap sums vs cumsum differences).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libfast_nms_harris.so fast_nms_harris.cu
// Entry point: mvslam_fast_nms_harris_rank (plain C, loaded with ctypes);
// it returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 4;
constexpr int SLAB_W = TILE_W + 2 * HALO;   // image slab
constexpr int SLAB_H = TILE_H + 2 * HALO;
constexpr int SCORE_W = TILE_W + 2;         // FAST score, NMS reach 1
constexpr int SCORE_H = TILE_H + 2;
constexpr int GRAD_W = TILE_W + 6;          // gradient products, box reach 3
constexpr int GRAD_H = TILE_H + 6;

// FAST-9/16 Bresenham circle, circular order (dx, dy)
__constant__ int kCircleDx[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                                  -3, -3, -2, -1, 0, 1, 2, 3};
__constant__ int kCircleDy[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

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

__global__ void __launch_bounds__(256)
fast_nms_harris_kernel(const float* __restrict__ img, float* __restrict__ out,
                       int h, int w, float threshold, float k, int border) {
  __shared__ float s_img[SLAB_H][SLAB_W];
  __shared__ float s_score[SCORE_H][SCORE_W];
  __shared__ float s_xx[GRAD_H][GRAD_W];
  __shared__ float s_yy[GRAD_H][GRAD_W];
  __shared__ float s_xy[GRAD_H][GRAD_W];

  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // 1. image slab, clamp-to-edge: s_img[sy][sx] = img(y0-4+sy, x0-4+sx)
  for (int i = tid; i < SLAB_H * SLAB_W; i += nthreads) {
    const int sy = i / SLAB_W, sx = i % SLAB_W;
    const int gy = min(max(y0 - HALO + sy, 0), h - 1);
    const int gx = min(max(x0 - HALO + sx, 0), w - 1);
    s_img[sy][sx] = img[gy * w + gx];
  }
  __syncthreads();

  // 2. FAST score at (y0-1+fy, x0-1+fx); slab center (fy+3, fx+3)
  for (int i = tid; i < SCORE_H * SCORE_W; i += nthreads) {
    const int fy = i / SCORE_W, fx = i % SCORE_W;
    const int cy = fy + 3, cx = fx + 3;
    const float c = s_img[cy][cx];
    float bright[16], dark[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float r = s_img[cy + kCircleDy[j]][cx + kCircleDx[j]];
      bright[j] = (r - c) - threshold;
      dark[j] = (c - r) - threshold;
    }
    const float score = fmaxf(best_arc9(bright), best_arc9(dark));
    s_score[fy][fx] = fmaxf(score, 0.0f);
  }

  // 3. Sobel gradient products at (y0-3+gy, x0-3+gx); slab (gy+1, gx+1).
  //    Ix = smooth_y [1,2,1]/8 then diff_x; Iy = diff_y then smooth_x,
  //    in the plain version's add order.
  for (int i = tid; i < GRAD_H * GRAD_W; i += nthreads) {
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

  // 4. per output pixel: strict NMS, border test, 7x7 box sums, Harris
  for (int i = tid; i < TILE_H * TILE_W; i += nthreads) {
    const int oy = i / TILE_W, ox = i % TILE_W;
    const int y = y0 + oy, x = x0 + ox;
    if (y >= h || x >= w) continue;
    const float sc = s_score[oy + 1][ox + 1];
    float nbr = -CUDART_INF_F;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        if (dx != 0 || dy != 0) nbr = fmaxf(nbr, s_score[oy + 1 + dy][ox + 1 + dx]);
    const bool corner = sc >= nbr && sc > 0.0f;
    const bool inside = y >= border && y < h - border && x >= border && x < w - border;
    float rank = -CUDART_INF_F;
    if (corner && inside) {
      float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        float rxx = 0.0f, ryy = 0.0f, rxy = 0.0f;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          rxx += s_xx[oy + dy][ox + dx];
          ryy += s_yy[oy + dy][ox + dx];
          rxy += s_xy[oy + dy][ox + dx];
        }
        sxx += rxx;
        syy += ryy;
        sxy += rxy;
      }
      const float det = sxx * syy - sxy * sxy;
      const float tr = sxx + syy;
      rank = det - k * tr * tr;
    }
    out[y * w + x] = rank;
  }
}

}  // namespace

extern "C" int mvslam_fast_nms_harris_rank(const float* img, float* out,
                                           int h, int w, float threshold,
                                           float k, int border,
                                           void* stream) {
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
  fast_nms_harris_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, h, w, threshold, k, border);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mvslam_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
