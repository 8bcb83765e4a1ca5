// The two-frame Levenberg-Marquardt bundle adjustment of ops/ba.py::ba_solve
// in one launch, hand-written for Hopper (sm_90a): K2.
//
// Replaces no TPU kernel. The JAX package leaves this solve to XLA
// (mvslam_tpu/ops/ba.py, a while_loop of batched einsums); the port ran it
// as the plain ops/ba.py loop, ~440 PyTorch ops an iteration and ~4,400 a
// solve, replayed as CUDA graph nodes of ~1.5 us each whatever their
// arithmetic. It does what that loop does for two poses, no covariances and
// no process group: the initial cost, then up to max_iterations iterations
// that build the normal equations (weights, the optional Huber IRLS scaling,
// pose and point priors), eliminate the points with closed-form 3x3
// inverses, factor the damped 12x12 reduced camera system by Cholesky (NaN
// where it is not positive definite, then the jittered re-solve
// eps * (1 + max|diag S|) where the plain solve is not finite), recover the
// point steps, retract with SE3.exp and compose, evaluate the new cost
// (Huber rho where set) and apply the loop's accept, lambda, convergence
// and freeze-once-done rules; then, where asked, each point's information
// (Hpp plus its prior, with no Huber scaling) at the result.
//
// What bounds it on an H100. One iteration is ~1,000 float32 operations a
// point: at 2,048 points ~2 MFLOP, ~20 MFLOP a 10-iteration solve, 0.3 us at
// the card's 67 TFLOP/s; it reads ~190 KB once, 0.06 us at 3.35 TB/s. So
// neither bounds it: the solve is a chain of ten dependent steps, each a
// reduction over the points, a 12x12 factorisation and a cost, and it is
// bound by the latency of that chain. The design:
//
// - One thread a point, 256 points a block, and the blocks of one launch
//   form one thread-block cluster (one block up to 256 points, 8 at 2,048):
//   a point's per-iteration chain runs on as many SMs as there are blocks.
// - A point's data and state stay in registers for the whole solve; the
//   poses, priors and the solve's scalars in shared memory. Nothing goes to
//   device memory between iterations; the inputs are read once, the
//   outputs written once.
// - The reduced camera system is 78 upper-triangle entries plus 12 of the
//   right-hand side. Each thread writes its point's 90 terms as one row in
//   shared memory; 180 threads sum the block's rows by columns in a fixed
//   order; after one cluster barrier every block sums the blocks' column
//   sums, read through distributed shared memory, in rank order. The two
//   costs go through warp shuffles, then the block's warps, then the
//   blocks, the same way. No atomics: every order is fixed, so two calls
//   give the same bits, and every block holds the same sums.
// - Every block then solves the same 12x12 system with one warp (a lane a
//   row: a right-looking Cholesky whose pivots and columns pass by
//   shuffles, then the two triangular solves) and decides the same step, so
//   no second barrier is needed to share the result. Two cluster barriers
//   an iteration; the loop ends at the first iteration that converges,
//   where the plain loop freezes every value.
// - Float32 throughout, as the plain loop: the same iterations, priors and
//   Huber terms. Sums are taken in another order than PyTorch's kernels, so
//   results differ from the plain loop's on the card by rounding.
//
// PERF.md holds its times beside the plain loop's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libba_two_frame.so ba_two_frame.cu
// Entry point: mvslam_ba_two_frame (plain C, loaded with ctypes); it
// returns the launch's error code.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;                 // points a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BLOCKS = 8;                // the portable cluster size
constexpr int CAPACITY = THREADS * MAX_BLOCKS;
constexpr int NTRI = 78;                     // upper triangle of 12x12
constexpr int NSYS = NTRI + 12;              // ... and the right-hand side
constexpr int ROW = NSYS + 1;                // odd stride: no bank conflicts
constexpr int ROWS_BYTES = THREADS * ROW * sizeof(float);
constexpr float EPS = 1.1920928955078125e-7f;          // float32 eps
constexpr float SAFE_Z = 1e3f * EPS;                    // ba._projection_residuals
constexpr float TINY = 1.0842021724855044e-19f;         // sqrt(float32 tiny)
constexpr unsigned FULL = 0xffffffffu;
static_assert(2 * NSYS <= THREADS, "two threads a column sum the rows");

struct Problem {
  const float* R0;            // (2, 3, 3) camera-to-world
  const float* t0;            // (2, 3)
  const float* X0;            // (P, 3)
  const float* obs;           // (2, P, 2)
  const unsigned char* mask;  // (2, P) bool
  const float* weight;        // (2, P)
  const float* prior_R;       // (2, 3, 3)
  const float* prior_t;       // (2, 3)
  const float* prior_info;    // (2, 6, 6)
  const float* point_prior;   // (P, 3)
  const float* point_info;    // (P, 3, 3)
  float* out_R;
  float* out_t;
  float* out_X;
  float* out_error;
  int* out_iterations;
  unsigned char* out_converged;
  float* out_point_info;      // (P, 3, 3) or null
  int P;
  int max_iterations;
  float lambda_init, lambda_up, lambda_down, lambda_min, lambda_max;
  float rel_decrease, abs_decrease;
  int huber;
  float huber_delta;
  float taylor2;              // config.taylor_threshold(float32) ** 2
  float cos_taylor;           // cos(config.taylor_threshold(float32))
};

struct Shared {
  float R[2][9], t[2][3];     // the poses the iteration starts from
  float nR[2][9], nt[2][3];   // the candidate poses
  float pR[2][9], pt[2][3];   // the pose priors
  float pinfo[2][36];
  float rp[2][6], nrp[2][6];  // prior residuals at the poses, the candidate
  float cterm[2], ncterm[2];  // rp . info rp at the poses, the candidate
  float half[2][NSYS];
  float part[NSYS];           // this block's sums (the cluster reads them)
  float sys[NSYS];            // the cluster's sums
  float warp_sum[WARPS][2];
  float cpart[2];             // this block's cost sums (the cluster reads them)
  float delta[12];
  float L[144];
  float cost, lam;
  int it, take, done;
};

// The cluster's primitives, written in PTX (cooperative_groups.h doubles
// the build's time): this block's rank, the barrier of all the cluster's
// threads (release / acquire: shared memory written before it is seen by
// every block after it), and a load from block ``rank``'s copy of this
// block's shared variable ``p``.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ float cluster_load(const float* p, int rank) {
  const unsigned local =
      static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// torch's NaN-propagating max and clamps
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x > hi ? hi : x;
}

// index of entry (i, j), i <= j, of the 12x12 system's upper triangle
__host__ __device__ constexpr int tri(int i, int j) {
  return i * 12 - i * (i - 1) / 2 + (j - i);
}

__device__ __forceinline__ void mat3mul(const float* A, const float* B,
                                        float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                     A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void skew(const float* w, float* K) {
  K[0] = 0.f;   K[1] = -w[2]; K[2] = w[1];
  K[3] = w[2];  K[4] = 0.f;   K[5] = -w[0];
  K[6] = -w[1]; K[7] = w[0];  K[8] = 0.f;
}

// math/lie.py: SE3.exp, translation-first
__device__ void se3_exp(const float* xi, float taylor2, float* R,
                        float* t) {
  const float* u = xi;
  const float* w = xi + 3;
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < taylor2;
  const float st2 = small ? 1.f : theta2;
  const float st = sqrtf(st2);
  const float A = small ? 1.f - theta2 / 6.f : sinf(st) / st;
  const float B = small ? 0.5f - theta2 / 24.f : (1.f - cosf(st)) / st2;
  const float C = small ? 1.f / 6.f - theta2 / 120.f : (1.f - A) / st2;
  float K[9], K2[9], V[9];
  skew(w, K);
  mat3mul(K, K, K2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float e = (k % 4 == 0) ? 1.f : 0.f;
    R[k] = e + A * K[k] + B * K2[k];
    V[k] = e + B * K[k] + C * K2[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = V[3 * i] * u[0] + V[3 * i + 1] * u[1] + V[3 * i + 2] * u[2];
}

// math/lie.py: SE3.log (so3_log inside), translation-first
__device__ void se3_log(const float* R, const float* t, float taylor2,
                        float cos_taylor, float* xi) {
  const float trace = R[0] + R[4] + R[8];
  const float c = clamp_max(clamp_min(0.5f * (trace - 1.f), -1.f), 1.f);
  const float v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const bool small_r = c > cos_taylor;
  const float t2s = 0.25f * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  const float theta = acosf(small_r ? 0.f : c);
  float s = sinf(theta);
  if (fabsf(s) < EPS) s = EPS;
  const float a = small_r ? (1.f + t2s / 6.f) * 0.5f : 0.5f * theta / s;
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = v[i] * a;
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < taylor2;
  const float st2 = small ? 1.f : theta2;
  const float st = sqrtf(st2);
  const float A = sinf(st) / st;
  const float B = (1.f - cosf(st)) / st2;
  const float G = small ? 1.f / 12.f + theta2 / 720.f
                        : (1.f - 0.5f * A / B) / st2;
  float K[9], K2[9];
  skew(w, K);
  mat3mul(K, K, K2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = (i == j) ? 1.f : 0.f;
      acc += (e - 0.5f * K[3 * i + j] + G * K2[3 * i + j]) * t[j];
    }
    xi[i] = acc;
    xi[3 + i] = w[i];
  }
}

// ops/ba._prior_residuals for one pose, ln(prior^-1 . T) into rp; returns
// rp . info rp (two threads run it: kept out of line)
__device__ __noinline__ float prior_term(const float* R, const float* t, const float* pR,
                            const float* pt, const float* info, float taylor2,
                            float cos_taylor, float* rp) {
  float RT[9], Rr[9], tr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) RT[3 * i + j] = pR[3 * j + i];
  mat3mul(RT, R, Rr);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ti = -(RT[3 * i] * pt[0] + RT[3 * i + 1] * pt[1] +
                       RT[3 * i + 2] * pt[2]);
    tr[i] = (RT[3 * i] * t[0] + RT[3 * i + 1] * t[1] + RT[3 * i + 2] * t[2])
            + ti;
  }
  se3_log(Rr, tr, taylor2, cos_taylor, rp);
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) v += info[6 * i + j] * rp[j];
    c += rp[i] * v;
  }
  return c;
}

// ops/ba._projection_residuals for one observation: the point in the
// camera (R^T (X - t)) and the safe depth
__device__ __forceinline__ void to_camera(const float* R, const float* t,
                                          const float* X, float* Xc,
                                          float* sz) {
  const float d0 = X[0] - t[0], d1 = X[1] - t[1], d2 = X[2] - t[2];
  Xc[0] = R[0] * d0 + R[3] * d1 + R[6] * d2;
  Xc[1] = R[1] * d0 + R[4] * d1 + R[7] * d2;
  Xc[2] = R[2] * d0 + R[5] * d1 + R[8] * d2;
  *sz = fabsf(Xc[2]) < SAFE_Z ? SAFE_Z : Xc[2];
}

// the weighted residual of one observation (no Huber scaling)
__device__ __forceinline__ void residual(const float* R, const float* t,
                                         const float* X, const float* o,
                                         float w, float* r) {
  float Xc[3], sz;
  to_camera(R, t, X, Xc, &sz);
  r[0] = (Xc[0] / sz - o[0]) * w;
  r[1] = (Xc[1] / sz - o[1]) * w;
}

// the weighted (and, with huber, IRLS-scaled) residual r (2) and Jacobian
// blocks Jc (2x6, pose tangent [u, w] on the right), Jp (2x3)
__device__ __forceinline__ void linearize(const float* R, const float* t,
                                          const float* X, const float* o,
                                          float w, bool huber, float delta,
                                          float* r, float (*Jc)[6],
                                          float (*Jp)[3]) {
  float Xc[3], sz;
  to_camera(R, t, X, Xc, &sz);
  r[0] = (Xc[0] / sz - o[0]) * w;
  r[1] = (Xc[1] / sz - o[1]) * w;
  const float iz = 1.f / sz;
  // dproj = [[iz, 0, a2], [0, iz, b2]]
  const float a2 = -Xc[0] * iz * iz;
  const float b2 = -Xc[1] * iz * iz;
  Jc[0][0] = -iz; Jc[0][1] = -0.f; Jc[0][2] = -a2;
  Jc[1][0] = -0.f; Jc[1][1] = -iz; Jc[1][2] = -b2;
  // dproj @ skew(Xc)
  Jc[0][3] = -(a2 * Xc[1]);
  Jc[0][4] = -(iz * Xc[2]) + a2 * Xc[0];
  Jc[0][5] = iz * Xc[1];
  Jc[1][3] = iz * Xc[2] - b2 * Xc[1];
  Jc[1][4] = b2 * Xc[0];
  Jc[1][5] = -(iz * Xc[0]);
  // dproj @ R^T
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    Jp[0][c] = iz * R[3 * c] + a2 * R[3 * c + 2];
    Jp[1][c] = iz * R[3 * c + 1] + b2 * R[3 * c + 2];
  }
  // (J w) wr, as the plain body scales: by the weight, then by the
  // Huber IRLS weight (1 without Huber)
  float wr = 1.f;
  if (huber) {
    const float nrm = sqrtf(r[0] * r[0] + r[1] * r[1]);
    wr = sqrtf(clamp_max(delta / clamp_min(nrm, TINY), 1.f));
    r[0] *= wr;
    r[1] *= wr;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int c = 0; c < 6; ++c) Jc[k][c] = Jc[k][c] * w * wr;
#pragma unroll
    for (int c = 0; c < 3; ++c) Jp[k][c] = Jp[k][c] * w * wr;
  }
}

// linalg.inv3x3: adjugate over determinant
__device__ __forceinline__ void inv3x3(const float* A, float* out) {
  const float a = A[0], b = A[1], c = A[2];
  const float d = A[3], e = A[4], f = A[5];
  const float g = A[6], h = A[7], i = A[8];
  const float co00 = e * i - f * h, co01 = c * h - b * i, co02 = b * f - c * e;
  const float co10 = f * g - d * i, co11 = a * i - c * g, co12 = c * d - a * f;
  const float co20 = d * h - e * g, co21 = b * g - a * h, co22 = a * e - b * d;
  const float det = a * co00 + b * co10 + c * co20;
  out[0] = co00 / det; out[1] = co01 / det; out[2] = co02 / det;
  out[3] = co10 / det; out[4] = co11 / det; out[5] = co12 / det;
  out[6] = co20 / det; out[7] = co21 / det; out[8] = co22 / det;
}

// this point's two cost sums at poses (R, t): the observations' (squared
// norms, or Huber rho) and rx . info rx of its prior
__device__ __forceinline__ void point_cost(const Shared& s, bool candidate,
                                           const Problem& pb, const float* X,
                                           const float (*ob)[2],
                                           const float* w, const float* xp,
                                           const float* info, float* c_obs,
                                           float* c_pt) {
  float acc = 0.f;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    float r[2];
    residual(candidate ? s.nR[f] : s.R[f], candidate ? s.nt[f] : s.t[f], X,
             ob[f], w[f], r);
    const float r2 = r[0] * r[0] + r[1] * r[1];
    if (pb.huber) {
      const float nrm = sqrtf(r2);
      const float d = pb.huber_delta;
      acc += nrm <= d ? 0.5f * nrm * nrm : d * (nrm - 0.5f * d);
    } else {
      acc += r2;
    }
  }
  float rx[3], c = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) rx[i] = X[i] - xp[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c += rx[i] * (info[3 * i] * rx[0] + info[3 * i + 1] * rx[1] +
                  info[3 * i + 2] * rx[2]);
  *c_obs = acc;
  *c_pt = c;
}

// the block's two cost sums into s.cpart (warp shuffles, then the warps in
// order); ends with the block's threads past a barrier
__device__ void block_cost(Shared& s, float a, float b, int tid) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(FULL, a, off);
    b += __shfl_down_sync(FULL, b, off);
  }
  if ((tid & 31) == 0) {
    s.warp_sum[tid >> 5][0] = a;
    s.warp_sum[tid >> 5][1] = b;
  }
  __syncthreads();
  if (tid == 0) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      x += s.warp_sum[k][0];
      y += s.warp_sum[k][1];
    }
    s.cpart[0] = x;
    s.cpart[1] = y;
  }
}

// the cluster's sum of entry k of ``local`` over its blocks, in rank order
__device__ __forceinline__ float cluster_sum(const float* local, int k,
                                             int nblocks) {
  float v[MAX_BLOCKS];
#pragma unroll
  for (int r = 0; r < MAX_BLOCKS; ++r)
    v[r] = r < nblocks ? cluster_load(local + k, r) : 0.f;
  float acc = v[0];
#pragma unroll
  for (int r = 1; r < MAX_BLOCKS; ++r)
    if (r < nblocks) acc += v[r];
  return acc;
}

// the total cost from the cluster's sums and the pose prior terms
__device__ __forceinline__ float total_cost(const Shared& s,
                                            const Problem& pb,
                                            const float* cterm,
                                            int nblocks) {
  const float obs = cluster_sum(s.cpart, 0, nblocks);
  const float pts = cluster_sum(s.cpart, 1, nblocks);
  const float c_obs = pb.huber ? obs : 0.5f * obs;
  return (c_obs + 0.5f * pts) + 0.5f * (cterm[0] + cterm[1]);
}

// entry (i, j) of the damped reduced camera system, lower triangle read as
// the factorisation reads it
__device__ __forceinline__ float sys_entry(const Shared& s, int i, int j,
                                           float lam) {
  float v = s.sys[i <= j ? tri(i, j) : tri(j, i)];
  if (i / 6 == j / 6) v += s.pinfo[i / 6][(i % 6) * 6 + j % 6];
  if (i == j) v += lam;
  return v;
}

// Cholesky solve of the 12x12 system by one warp, lane i holding row i (a,
// its right-hand side b; lanes past 11 shadow row 11 and are not read);
// NaN where a pivot is not positive (linalg._cholesky's NaN fill)
__device__ float cholesky_solve(float* a, float b, int i, float* sL) {
  bool ok = true;
  float l[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float d = __shfl_sync(FULL, a[j], j);
    ok = ok && d > 0.f;
    const float ljj = sqrtf(d);
    float lij = (i == j) ? ljj : a[j] / ljj;
    if (i < j) lij = 0.f;
    l[j] = lij;
#pragma unroll
    for (int k = j + 1; k < 12; ++k) {
      const float lkj = __shfl_sync(FULL, lij, k);
      if (i >= k) a[k] -= lij * lkj;
    }
  }
  float y = b;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float yj = __shfl_sync(FULL, y / l[j], j);
    if (i == j) y = yj;
    else if (i > j) y -= l[j] * yj;
  }
  const int lane = threadIdx.x & 31;
  if (lane < 12) {
#pragma unroll
    for (int k = 0; k < 12; ++k) sL[12 * lane + k] = l[k];
  }
  __syncwarp();
  float x = y;
#pragma unroll
  for (int j = 11; j >= 0; --j) {
    const float xj = __shfl_sync(FULL, x / l[j], j);
    if (i == j) x = xj;
    else if (i < j) x -= sL[12 * j + i] * xj;
  }
  __syncwarp();
  return ok ? x : CUDART_NAN_F;
}

// ba._schur_solve's camera step, by warp 0, into s.delta
__device__ void solve_cameras(Shared& s, float lam) {
  const int lane = threadIdx.x & 31;
  const int i = lane < 12 ? lane : 11;
  float a[12];
  const float* info = s.pinfo[i / 6] + (i % 6) * 6;
  const float* rp = s.rp[i / 6];
  float prior = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) prior += info[j] * rp[j];
  const float b = s.sys[NTRI + i] - prior;
  float m = fabsf(sys_entry(s, i, i, lam));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(FULL, m, off));
  const float jitter = EPS * (1.f + m);
  // the plain solve, then where it is not finite the jittered one
  float x;
#pragma unroll 1
  for (int attempt = 0; attempt < 2; ++attempt) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      a[j] = sys_entry(s, i, j, lam);
      if (attempt == 1 && j == i) a[j] += jitter;
    }
    x = cholesky_solve(a, b, i, s.L);
    if (__all_sync(FULL, lane >= 12 || isfinite(x))) break;
  }
  if (lane < 12) s.delta[lane] = x;
}

__global__ void __launch_bounds__(THREADS, 1)
    ba_two_frame_kernel(const __grid_constant__ Problem pb) {
  extern __shared__ float rows[];   // THREADS x ROW: each point's terms
  __shared__ Shared s;
  const int rank = cluster_rank();
  const int nblocks = static_cast<int>(gridDim.x);
  const int tid = threadIdx.x;
  const int p = rank * THREADS + tid;
  const bool valid = p < pb.P;
  const int n_here = min(THREADS, pb.P - rank * THREADS);
  const int P = pb.P;

  // this point's data, in registers for the whole solve
  float X[3] = {0.f, 0.f, 0.f}, xp[3] = {0.f, 0.f, 0.f}, info[9];
  float ob[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, w[2] = {0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 9; ++k) info[k] = 0.f;
  if (valid) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      X[k] = pb.X0[3 * p + k];
      xp[k] = pb.point_prior[3 * p + k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) info[k] = pb.point_info[9 * p + k];
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      ob[f][0] = pb.obs[2 * (f * P + p)];
      ob[f][1] = pb.obs[2 * (f * P + p) + 1];
      w[f] = pb.mask[f * P + p] ? pb.weight[f * P + p] : 0.f;
    }
  }
  if (tid < 18) {
    s.R[tid / 9][tid % 9] = pb.R0[tid];
    s.pR[tid / 9][tid % 9] = pb.prior_R[tid];
  }
  if (tid < 6) {
    s.t[tid / 3][tid % 3] = pb.t0[tid];
    s.pt[tid / 3][tid % 3] = pb.prior_t[tid];
  }
  if (tid < 72) s.pinfo[tid / 36][tid % 36] = pb.prior_info[tid];
  __syncthreads();

  // the initial cost
  if (tid < 2)
    s.cterm[tid] = prior_term(s.R[tid], s.t[tid], s.pR[tid], s.pt[tid],
                              s.pinfo[tid], pb.taylor2, pb.cos_taylor,
                              s.rp[tid]);
  {
    float co = 0.f, cp = 0.f;
    if (valid) point_cost(s, false, pb, X, ob, w, xp, info, &co, &cp);
    block_cost(s, co, cp, tid);
  }
  cluster_sync();
  if (tid == 0) {
    s.cost = total_cost(s, pb, s.cterm, nblocks);
    s.lam = pb.lambda_init;
    s.it = 0;
    s.done = 0;
  }
  __syncthreads();

  for (int iter = 0; iter < pb.max_iterations; ++iter) {
    const float lam = s.lam;
    // the normal equations at this point, its Schur terms into its row
    float Hinv[9], Hcp[2][6][3], bp[3];
    if (valid) {
      float r[2][2], Jc[2][2][6], Jp[2][2][3];
#pragma unroll
      for (int f = 0; f < 2; ++f)
        linearize(s.R[f], s.t[f], X, ob[f], w[f], pb.huber, pb.huber_delta,
                  r[f], Jc[f], Jp[f]);
      float H[9], rx[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) rx[k] = X[k] - xp[k];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < 2; ++f)
            acc += Jp[f][0][a] * Jp[f][0][b] + Jp[f][1][a] * Jp[f][1][b];
          H[3 * a + b] = acc + info[3 * a + b] + (a == b ? lam : 0.f);
        }
        float g = 0.f;
#pragma unroll
        for (int f = 0; f < 2; ++f)
          g += Jp[f][0][a] * r[f][0] + Jp[f][1][a] * r[f][1];
        bp[a] = -g - (info[3 * a] * rx[0] + info[3 * a + 1] * rx[1] +
                      info[3 * a + 2] * rx[2]);
      }
      inv3x3(H, Hinv);
      float W[2][6][3];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b)
            Hcp[f][a][b] = Jc[f][0][a] * Jp[f][0][b] + Jc[f][1][a] * Jp[f][1][b];
#pragma unroll
          for (int m = 0; m < 3; ++m)
            W[f][a][m] = Hcp[f][a][0] * Hinv[m] + Hcp[f][a][1] * Hinv[3 + m] +
                         Hcp[f][a][2] * Hinv[6 + m];
        }
      float* row = rows + tid * ROW;
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int f = i / 6, a = i % 6;
#pragma unroll
        for (int j = i; j < 12; ++j) {
          const int g = j / 6, b = j % 6;
          float v = -(W[f][a][0] * Hcp[g][b][0] + W[f][a][1] * Hcp[g][b][1] +
                      W[f][a][2] * Hcp[g][b][2]);
          if (f == g)
            v += Jc[f][0][a] * Jc[f][0][b] + Jc[f][1][a] * Jc[f][1][b];
          row[tri(i, j)] = v;
        }
        row[NTRI + i] = -(Jc[f][0][a] * r[f][0] + Jc[f][1][a] * r[f][1]) -
                        (W[f][a][0] * bp[0] + W[f][a][1] * bp[1] +
                         W[f][a][2] * bp[2]);
      }
    }
    __syncthreads();
    // the block's sums by columns, two threads a column, in row order
    if (tid < 2 * NSYS) {
      const int c = tid % NSYS, h = tid / NSYS;
      const int mid = (n_here + 1) / 2;
      const int q0 = h ? mid : 0, q1 = h ? n_here : mid;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      int q = q0;
      for (; q + 4 <= q1; q += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] += rows[(q + u) * ROW + c];
      }
      if (q < q1) acc[0] += rows[q * ROW + c];
      if (q + 1 < q1) acc[1] += rows[(q + 1) * ROW + c];
      if (q + 2 < q1) acc[2] += rows[(q + 2) * ROW + c];
      s.half[h][c] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();
    if (tid < NSYS) s.part[tid] = s.half[0][tid] + s.half[1][tid];
    cluster_sync();
    if (tid < NSYS) s.sys[tid] = cluster_sum(s.part, tid, nblocks);
    __syncthreads();
    // the camera step, the candidate poses and their prior terms
    if (tid < 32) {
      solve_cameras(s, lam);
      __syncwarp();
      if (tid < 2) {
        float dR[9], dt[3], Rn[9];
        se3_exp(s.delta + 6 * tid, pb.taylor2, dR, dt);
        mat3mul(s.R[tid], dR, Rn);
#pragma unroll
        for (int k = 0; k < 9; ++k) s.nR[tid][k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          s.nt[tid][k] = (s.R[tid][3 * k] * dt[0] + s.R[tid][3 * k + 1] * dt[1] +
                          s.R[tid][3 * k + 2] * dt[2]) + s.t[tid][k];
        s.ncterm[tid] = prior_term(s.nR[tid], s.nt[tid], s.pR[tid], s.pt[tid],
                                   s.pinfo[tid], pb.taylor2, pb.cos_taylor,
                                   s.nrp[tid]);
      }
    }
    __syncthreads();
    // this point's step and the cost at the candidate
    float Xn[3] = {X[0], X[1], X[2]};
    {
      float co = 0.f, cp = 0.f;
      if (valid) {
        float rhs[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int i = 0; i < 6; ++i) acc += Hcp[f][i][j] * s.delta[6 * f + i];
          rhs[j] = bp[j] - acc;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i)
          Xn[i] = X[i] + (Hinv[3 * i] * rhs[0] + Hinv[3 * i + 1] * rhs[1] +
                          Hinv[3 * i + 2] * rhs[2]);
        point_cost(s, true, pb, Xn, ob, w, xp, info, &co, &cp);
      }
      block_cost(s, co, cp, tid);
    }
    cluster_sync();
    // ba_solve's accept, lambda and convergence rules, one thread a block
    if (tid == 0) {
      const float cost = s.cost;
      const float new_cost = total_cost(s, pb, s.ncterm, nblocks);
      const bool finite = isfinite(new_cost);
      const bool accept = finite && new_cost < cost;
      const float stepped = accept ? lam * pb.lambda_down : lam * pb.lambda_up;
      const float new_lam = clamp_max(clamp_min(stepped, pb.lambda_min),
                                      pb.lambda_max);
      const float thresh = nanmax(nanmax(pb.rel_decrease * cost,
                                         pb.abs_decrease),
                                  10.f * EPS * (1.f + cost));
      bool converged = finite && fabsf(cost - new_cost) < thresh;
      converged = converged || (!accept && new_lam >= pb.lambda_max);
      if (accept) {
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
          for (int k = 0; k < 9; ++k) s.R[f][k] = s.nR[f][k];
#pragma unroll
          for (int k = 0; k < 3; ++k) s.t[f][k] = s.nt[f][k];
#pragma unroll
          for (int k = 0; k < 6; ++k) s.rp[f][k] = s.nrp[f][k];
          s.cterm[f] = s.ncterm[f];
        }
        s.cost = new_cost;
      }
      s.take = accept;
      s.lam = new_lam;
      s.it += 1;
      s.done = converged;
    }
    __syncthreads();
    if (s.take) {
#pragma unroll
      for (int k = 0; k < 3; ++k) X[k] = Xn[k];
    }
    // every value is frozen from here on in the plain loop
    if (s.done) break;
  }

  if (valid) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pb.out_X[3 * p + k] = X[k];
    if (pb.out_point_info != nullptr) {
      // ba._normal_equations' Hpp at the result, with no Huber scaling
      float r[2], Jc[2][6], Jp[2][2][3];
#pragma unroll
      for (int f = 0; f < 2; ++f)
        linearize(s.R[f], s.t[f], X, ob[f], w[f], false, 0.f, r, Jc, Jp[f]);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < 2; ++f)
            acc += Jp[f][0][a] * Jp[f][0][b] + Jp[f][1][a] * Jp[f][1][b];
          pb.out_point_info[9 * p + 3 * a + b] = acc + info[3 * a + b];
        }
    }
  }
  if (rank == 0) {
    if (tid < 18) pb.out_R[tid] = s.R[tid / 9][tid % 9];
    if (tid < 6) pb.out_t[tid] = s.t[tid / 3][tid % 3];
    if (tid == 0) {
      *pb.out_error = s.cost;
      *pb.out_iterations = s.it;
      *pb.out_converged = s.done ? 1 : 0;
    }
  }
  // no block leaves while another may still read its shared memory
  cluster_sync();
}

}  // namespace

extern "C" int mvslam_ba_two_frame_capacity() { return CAPACITY; }

extern "C" int mvslam_ba_two_frame(
    int P, int max_iterations, const void* R0, const void* t0,
    const void* X0, const void* obs, const void* mask, const void* weight,
    const void* prior_R, const void* prior_t, const void* prior_info,
    const void* point_prior, const void* point_info, void* out_R,
    void* out_t, void* out_X, void* out_error, void* out_iterations,
    void* out_converged, void* out_point_info, float lambda_init,
    float lambda_up, float lambda_down, float lambda_min, float lambda_max,
    float rel_decrease, float abs_decrease, int huber, float huber_delta,
    float taylor2, float cos_taylor, void* stream) {
  if (P < 1 || P > CAPACITY || max_iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem pb;
  pb.R0 = static_cast<const float*>(R0);
  pb.t0 = static_cast<const float*>(t0);
  pb.X0 = static_cast<const float*>(X0);
  pb.obs = static_cast<const float*>(obs);
  pb.mask = static_cast<const unsigned char*>(mask);
  pb.weight = static_cast<const float*>(weight);
  pb.prior_R = static_cast<const float*>(prior_R);
  pb.prior_t = static_cast<const float*>(prior_t);
  pb.prior_info = static_cast<const float*>(prior_info);
  pb.point_prior = static_cast<const float*>(point_prior);
  pb.point_info = static_cast<const float*>(point_info);
  pb.out_R = static_cast<float*>(out_R);
  pb.out_t = static_cast<float*>(out_t);
  pb.out_X = static_cast<float*>(out_X);
  pb.out_error = static_cast<float*>(out_error);
  pb.out_iterations = static_cast<int*>(out_iterations);
  pb.out_converged = static_cast<unsigned char*>(out_converged);
  pb.out_point_info = static_cast<float*>(out_point_info);
  pb.P = P;
  pb.max_iterations = max_iterations;
  pb.lambda_init = lambda_init;
  pb.lambda_up = lambda_up;
  pb.lambda_down = lambda_down;
  pb.lambda_min = lambda_min;
  pb.lambda_max = lambda_max;
  pb.rel_decrease = rel_decrease;
  pb.abs_decrease = abs_decrease;
  pb.huber = huber;
  pb.huber_delta = huber_delta;
  pb.taylor2 = taylor2;
  pb.cos_taylor = cos_taylor;
  // more than the default 48 KB of dynamic shared memory (set on every
  // call: a host-side attribute, allowed while a stream is captured)
  cudaError_t err = cudaFuncSetAttribute(
      ba_two_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ROWS_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblocks = (P + THREADS - 1) / THREADS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = ROWS_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nblocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ba_two_frame_kernel, pb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mvslam_ba_two_frame_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
