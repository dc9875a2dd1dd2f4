// Hand-written Hopper (sm_90a) kernels for the bundle-adjustment hot path.
//
// Each entry point replaces one Pallas TPU kernel family of
// ccm_slam_tpu/ops/pallas_kernels.py (the JAX reference):
//
//   ccm_reproj_cost    <- fused_reproj_cost    (_reproj_cost_kernel)
//   ccm_normal_blocks  <- fused_normal_blocks  (_normal_blocks_kernel)
//   ccm_schur_off      <- make_schur_ops.off   (_schur_matvec_kernel)
//   ccm_schur_rhs      <- make_schur_ops.rhs   (_schur_rhs_kernel)
//   ccm_schur_wtv      <- make_schur_ops.wtv   (_schur_wtv_kernel)
//   ccm_cam_broadcast  <- cam_broadcast        (_cam_broadcast_kernel)
//   ccm_cam_reduce     <- cam_reduce           (_cam_reduce_kernel)
//
// make_schur_matvec's pallas_call runs the same kernel body as
// make_schur_ops.off (_schur_matvec_kernel), so ccm_schur_off carries both.
//
// What bounds them on an H100: bytes.  Every kernel does a few hundred flops
// per observation at most, against 24-170 bytes moved, so all sit far below
// the card's ~20 flop/byte fp32 ridge.  At the server-GBA shapes (C=128
// cameras, P=32768 landmarks, K=8 slots: E=262144 observations) one call
// moves 5-25 MB, which is 1.5-7.6 us at 3.35 TB/s -- below the cost of a
// launch.  So launch overhead and the solver's per-CG-step host sync, not
// bandwidth, are expected to set the pace; the kernels are kept simple and
// right first.
//
// What the design does about it:
//  * One pass per observation: residual, robust weight, Jacobians and block
//    products stay in registers; only the products leave the SM.
//  * No float atomics anywhere, so every sum is taken in a fixed order and
//    results repeat bit for bit run to run (LM's accept test
//    `cost_new < cost` must not flip between runs):
//      - per-landmark sums (V, g_p, the point side of off, wtv): one thread
//        per landmark loops over its K contiguous slots;
//      - per-camera sums (U, g_c, the camera side of off, rhs): a camera CSR
//        (observations stably sorted by camera, built once per solve since
//        cam_idx is constant across LM and CG iterations).  The per-
//        observation pass writes its row straight into the observation's
//        sorted slot `pos[e]`, so one segment kernel reads each camera's rows
//        contiguously and sums them in a fixed order;
//      - the cost: per-block tree sums, then one block sums the partials in
//        a fixed order.
//  * The TPU layout tricks (factored hi/lo one-hot, k-major lane packing,
//    (8,128) output blocks, the K<=16 cap) are not carried over: on Hopper
//    a thread gathers its camera's 12 floats directly (L1/L2 resident: the
//    camera table is 6 KB at C=128).
//
// Interface: plain C, every pointer a device pointer into a contiguous
// tensor allocated by the caller (outputs and scratch included), bool masks
// as one byte each, cam_idx int32.  Work is enqueued on `stream`; nothing is
// synchronised.  Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // per-landmark kernels and the partial sum
constexpr int kSegThreads = 512;
constexpr int kRowF = 42;       // per-observation U (36) + g_c (6) row

__device__ __forceinline__ int clamp_cam(int c, int C) {
  return c < 0 ? 0 : (c >= C ? C - 1 : c);
}

// NaN-preserving clamps (jnp.clip semantics): a NaN chi2 must stay NaN so
// that a non-finite trial step is rejected by the finite test.
__device__ __forceinline__ float clip_lo(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float huber_rho(float chi2, float delta) {
  const float d2 = delta * delta;
  return chi2 <= d2 ? chi2 : 2.0f * delta * sqrtf(clip_lo(chi2, 0.0f)) - d2;
}

__device__ __forceinline__ float huber_weight(float chi2, float delta) {
  const float d2 = delta * delta;
  return chi2 <= d2 ? 1.0f : delta / sqrtf(clip_lo(chi2, 1e-12f));
}

__device__ __forceinline__ float z_safe(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

// Tree sum over a block of power-of-two size; every thread gets the total.
__device__ float block_sum(float v, float* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  const float total = sh[0];
  __syncthreads();
  return total;
}

// Residual of one observation (solvers/reproj.project_residual).
struct Obs {
  float x, y, z;   // camera-frame point
  float r0, r1;    // pixel residual
  float chi2;      // information-weighted squared error (0 when invalid)
  float w;         // Huber IRLS weight times information (0 when invalid)
  float rho;       // Huber cost
};

__device__ __forceinline__ Obs observe(const float* __restrict__ R,
                                       const float* __restrict__ t, int c,
                                       float X0, float X1, float X2, bool point_ok,
                                       int e, const float* __restrict__ uv,
                                       const float* __restrict__ sigma2,
                                       const uint8_t* __restrict__ obs_valid,
                                       const float* __restrict__ intr, float delta) {
  const float* Rc = R + 9 * c;
  const float* tc = t + 3 * c;
  Obs o;
  o.x = Rc[0] * X0 + Rc[1] * X1 + Rc[2] * X2 + tc[0];
  o.y = Rc[3] * X0 + Rc[4] * X1 + Rc[5] * X2 + tc[1];
  o.z = Rc[6] * X0 + Rc[7] * X1 + Rc[8] * X2 + tc[2];
  const float zs = z_safe(o.z);
  o.r0 = (intr[0] * o.x / zs + intr[2]) - uv[2 * e];
  o.r1 = (intr[1] * o.y / zs + intr[3]) - uv[2 * e + 1];
  const bool valid = obs_valid[e] && point_ok && (o.z > 1e-6f);
  const float w_conf = valid ? 1.0f / sigma2[e] : 0.0f;
  o.chi2 = w_conf * (o.r0 * o.r0 + o.r1 * o.r1);
  o.w = w_conf * huber_weight(o.chi2, delta);
  o.rho = huber_rho(o.chi2, delta);
  return o;
}

// ---------------------------------------------------------------------------
// Cost: one thread per landmark over its K slots, block tree sum -> partials.
// ---------------------------------------------------------------------------
__global__ void reproj_cost_kernel(const float* __restrict__ R, const float* __restrict__ t,
                                   const float* __restrict__ X,
                                   const uint8_t* __restrict__ point_valid,
                                   const int* __restrict__ cam_idx,
                                   const float* __restrict__ uv,
                                   const float* __restrict__ sigma2,
                                   const uint8_t* __restrict__ obs_valid,
                                   const float* __restrict__ intr, int C, int P, int K,
                                   float delta, float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  if (p < P) {
    const float X0 = X[3 * p], X1 = X[3 * p + 1], X2 = X[3 * p + 2];
    const bool point_ok = point_valid[p];
    for (int k = 0; k < K; ++k) {
      const int e = p * K + k;
      const int c = clamp_cam(cam_idx[e], C);
      acc += observe(R, t, c, X0, X1, X2, point_ok, e, uv, sigma2, obs_valid, intr, delta).rho;
    }
  }
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Fixed-order sum of n partials into out[0] (one block).
__global__ void sum_partials_kernel(const float* __restrict__ partials, int n,
                                    float* __restrict__ out) {
  __shared__ float sh[kThreads];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) out[0] = s;
}

// ---------------------------------------------------------------------------
// Camera segment sum: out[c, f] = sum over sorted slots j in
// [offsets[c], offsets[c+1]) of rows[j, f].  Block (FX, NY): x walks the
// columns (a warp reads contiguous floats), y strides over the camera's rows;
// the NY partials are tree-summed in shared memory.  One block per camera.
// ---------------------------------------------------------------------------
__global__ void seg_sum_kernel(const float* __restrict__ rows, const int* __restrict__ offsets,
                               int F, float* __restrict__ out) {
  __shared__ float sh[kSegThreads];
  const int c = blockIdx.x;
  const int beg = offsets[c], end = offsets[c + 1];
  const int FX = blockDim.x, NY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int f0 = 0; f0 < F; f0 += FX) {
    const int f = f0 + tx;
    float acc = 0.0f;
    if (f < F) {
      for (int j = beg + ty; j < end; j += NY) acc += rows[(size_t)j * F + f];
    }
    sh[ty * FX + tx] = acc;
    __syncthreads();
    for (int s = NY / 2; s > 0; s >>= 1) {
      if (ty < s) sh[ty * FX + tx] += sh[(ty + s) * FX + tx];
      __syncthreads();
    }
    if (ty == 0 && f < F) out[(size_t)c * F + f] = sh[tx];
    __syncthreads();
  }
}

void launch_seg_sum(const float* rows, const int* offsets, int C, int F, float* out,
                    cudaStream_t stream) {
  if (C <= 0) return;
  const int FX = F <= 8 ? 8 : (F <= 16 ? 16 : 32);
  const dim3 block(FX, kSegThreads / FX);
  seg_sum_kernel<<<C, block, 0, stream>>>(rows, offsets, F, out);
}

int n_blocks(int n) { return (n + kThreads - 1) / kThreads; }

// ---------------------------------------------------------------------------
// Normal equations: one thread per landmark.  Per observation: residual ->
// Huber weight -> closed-form pose and point Jacobians (zeroed for w = 0;
// pose part zeroed for fixed cameras) -> W_e = w Jc^T Jp, and the row
// (w Jc^T Jc, -w Jc^T r) written to the observation's camera-sorted slot.
// V and g_p accumulate over the K slots in registers.
// ---------------------------------------------------------------------------
__global__ void normal_blocks_kernel(const float* __restrict__ R, const float* __restrict__ t,
                                     const float* __restrict__ X,
                                     const uint8_t* __restrict__ point_valid,
                                     const int* __restrict__ cam_idx,
                                     const float* __restrict__ uv,
                                     const float* __restrict__ sigma2,
                                     const uint8_t* __restrict__ obs_valid,
                                     const uint8_t* __restrict__ cam_fixed,
                                     const float* __restrict__ intr, int C, int P, int K,
                                     float delta, const int* __restrict__ pos,
                                     float* __restrict__ W, float* __restrict__ V,
                                     float* __restrict__ g_p, float* __restrict__ rows,
                                     float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float cost = 0.0f;
  if (p < P) {
    const float fx = intr[0], fy = intr[1];
    const float X0 = X[3 * p], X1 = X[3 * p + 1], X2 = X[3 * p + 2];
    const bool point_ok = point_valid[p];
    float Vp[9];
    float gp[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) Vp[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) gp[i] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int e = p * K + k;
      const int c = clamp_cam(cam_idx[e], C);
      const Obs o = observe(R, t, c, X0, X1, X2, point_ok, e, uv, sigma2, obs_valid, intr, delta);
      cost += o.rho;
      const float* Rc = R + 9 * c;
      const float iz = 1.0f / z_safe(o.z);
      const float iz2 = iz * iz;
      const float a = fx * iz, b = -fx * o.x * iz2;
      const float cc = fy * iz, d = -fy * o.y * iz2;
      const float gate = o.w > 0.0f ? 1.0f : 0.0f;
      const float pose_gate = gate * (cam_fixed[c] ? 0.0f : 1.0f);
      float Jc0[6] = {a, 0.0f, b, b * o.y, a * o.z - b * o.x, -a * o.y};
      float Jc1[6] = {0.0f, cc, d, -cc * o.z + d * o.y, -d * o.x, cc * o.x};
      float Jp0[3], Jp1[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        Jp0[i] = (a * Rc[i] + b * Rc[6 + i]) * gate;
        Jp1[i] = (cc * Rc[3 + i] + d * Rc[6 + i]) * gate;
      }
      float wJc0[6], wJc1[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        Jc0[i] *= pose_gate;
        Jc1[i] *= pose_gate;
        wJc0[i] = Jc0[i] * o.w;
        wJc1[i] = Jc1[i] * o.w;
      }
      float* We = W + (size_t)e * 18;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) We[3 * i + j] = wJc0[i] * Jp0[j] + wJc1[i] * Jp1[j];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float wJp0 = Jp0[i] * o.w, wJp1 = Jp1[i] * o.w;
#pragma unroll
        for (int j = 0; j < 3; ++j) Vp[3 * i + j] += wJp0 * Jp0[j] + wJp1 * Jp1[j];
        gp[i] += -(wJp0 * o.r0 + wJp1 * o.r1);
      }
      float* row = rows + (size_t)pos[e] * kRowF;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) row[6 * i + j] = wJc0[i] * Jc0[j] + wJc1[i] * Jc1[j];
        row[36 + i] = -(wJc0[i] * o.r0 + wJc1[i] * o.r1);
      }
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) V[9 * p + i] = Vp[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) g_p[3 * p + i] = gp[i];
  }
  const float s = block_sum(cost, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// Schur operators over W [P,K,6,3] (row-major: W_e[i][j] at e*18 + 3i + j).
// ---------------------------------------------------------------------------

// off, point side: y2_p = Vinv_p sum_k W_pk^T v[ci_pk]; then the
// per-observation W_pk y2_p goes to its camera-sorted slot.
__global__ void schur_off_kernel(const float* __restrict__ v, const float* __restrict__ W,
                                 const float* __restrict__ Vinv, const int* __restrict__ cam_idx,
                                 const int* __restrict__ pos, int C, int P, int K,
                                 float* __restrict__ rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float y1[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < K; ++k) {
    const int e = p * K + k;
    const float* vc = v + 6 * clamp_cam(cam_idx[e], C);
    const float* We = W + (size_t)e * 18;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) s += We[3 * i + j] * vc[i];
      y1[j] += s;
    }
  }
  const float* Vi = Vinv + 9 * p;
  float y2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) y2[i] = Vi[3 * i] * y1[0] + Vi[3 * i + 1] * y1[1] + Vi[3 * i + 2] * y1[2];
  for (int k = 0; k < K; ++k) {
    const int e = p * K + k;
    const float* We = W + (size_t)e * 18;
    float* row = rows + (size_t)pos[e] * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) row[i] = We[3 * i] * y2[0] + We[3 * i + 1] * y2[1] + We[3 * i + 2] * y2[2];
  }
}

// rhs, per observation: W_pk q_p to its camera-sorted slot.
__global__ void schur_rhs_kernel(const float* __restrict__ q, const float* __restrict__ W,
                                 const int* __restrict__ pos, int P, int K,
                                 float* __restrict__ rows) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const float q0 = q[3 * p], q1 = q[3 * p + 1], q2 = q[3 * p + 2];
  for (int k = 0; k < K; ++k) {
    const int e = p * K + k;
    const float* We = W + (size_t)e * 18;
    float* row = rows + (size_t)pos[e] * 6;
#pragma unroll
    for (int i = 0; i < 6; ++i) row[i] = We[3 * i] * q0 + We[3 * i + 1] * q1 + We[3 * i + 2] * q2;
  }
}

// wtv, per landmark: sum_k W_pk^T v[ci_pk].
__global__ void schur_wtv_kernel(const float* __restrict__ v, const float* __restrict__ W,
                                 const int* __restrict__ cam_idx, int C, int P, int K,
                                 float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float y[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < K; ++k) {
    const int e = p * K + k;
    const float* vc = v + 6 * clamp_cam(cam_idx[e], C);
    const float* We = W + (size_t)e * 18;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 6; ++i) s += We[3 * i + j] * vc[i];
      y[j] += s;
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) out[3 * p + j] = y[j];
}

// ---------------------------------------------------------------------------
// Camera -> observation broadcast: out[e, f] = v[ci[e], f], 0 out of range.
// ---------------------------------------------------------------------------
__global__ void cam_broadcast_kernel(const float* __restrict__ v, const int* __restrict__ ci,
                                     int C, int F, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long e = i / F;
  const int f = (int)(i - e * F);
  const int c = ci[e];
  out[i] = (c >= 0 && c < C) ? v[(size_t)c * F + f] : 0.0f;
}

// ---------------------------------------------------------------------------
// Observation -> camera segment sum with drops: each kept row y[e] goes to
// its camera-sorted slot pos[e]; rows whose camera id was outside [0, C) sit
// in a trailing drop bucket (slots >= offsets[C]) and are never written or
// summed.  seg_sum_kernel then sums each camera's slots in a fixed order.
// ---------------------------------------------------------------------------
__global__ void scatter_rows_kernel(const float* __restrict__ y, const int* __restrict__ pos,
                                    const int* __restrict__ offsets, int C, int F, long long n,
                                    float* __restrict__ rows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long e = i / F;
  const int f = (int)(i - e * F);
  const int j = pos[e];
  if (j < offsets[C]) rows[(size_t)j * F + f] = y[i];
}

}  // namespace

extern "C" {

const char* ccm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// partials: [max(1, ceil(P/256))] scratch; out: [1].
int ccm_reproj_cost(const float* R, const float* t, const float* X, const uint8_t* point_valid,
                    const int* cam_idx, const float* uv, const float* sigma2,
                    const uint8_t* obs_valid, const float* intr, int C, int P, int K,
                    float delta, float* partials, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n_blocks(P);
  if (nb > 0)
    reproj_cost_kernel<<<nb, kThreads, 0, s>>>(R, t, X, point_valid, cam_idx, uv, sigma2,
                                               obs_valid, intr, C, P, K, delta, partials);
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, nb, out);
  return (int)cudaGetLastError();
}

// W [P,K,6,3], V [P,3,3], g_p [P,3], UG [C,42] (U row-major then g_c);
// rows [P*K,42] and partials scratch; cost [1].
int ccm_normal_blocks(const float* R, const float* t, const float* X,
                      const uint8_t* point_valid, const int* cam_idx, const float* uv,
                      const float* sigma2, const uint8_t* obs_valid, const uint8_t* cam_fixed,
                      const float* intr, int C, int P, int K, float delta, const int* pos,
                      const int* offsets, float* W, float* V, float* g_p, float* UG,
                      float* rows, float* partials, float* cost, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n_blocks(P);
  if (nb > 0)
    normal_blocks_kernel<<<nb, kThreads, 0, s>>>(R, t, X, point_valid, cam_idx, uv, sigma2,
                                                 obs_valid, cam_fixed, intr, C, P, K, delta,
                                                 pos, W, V, g_p, rows, partials);
  launch_seg_sum(rows, offsets, C, kRowF, UG, s);
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, nb, cost);
  return (int)cudaGetLastError();
}

// out [C,6]; rows [P*K,6] scratch.
int ccm_schur_off(const float* v, const float* W, const float* Vinv, const int* cam_idx,
                  const int* pos, const int* offsets, int C, int P, int K, float* rows,
                  float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n_blocks(P);
  if (nb > 0) schur_off_kernel<<<nb, kThreads, 0, s>>>(v, W, Vinv, cam_idx, pos, C, P, K, rows);
  launch_seg_sum(rows, offsets, C, 6, out, s);
  return (int)cudaGetLastError();
}

// out [C,6]; rows [P*K,6] scratch.
int ccm_schur_rhs(const float* q, const float* W, const int* pos, const int* offsets, int C,
                  int P, int K, float* rows, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n_blocks(P);
  if (nb > 0) schur_rhs_kernel<<<nb, kThreads, 0, s>>>(q, W, pos, P, K, rows);
  launch_seg_sum(rows, offsets, C, 6, out, s);
  return (int)cudaGetLastError();
}

// out [P,3].
int ccm_schur_wtv(const float* v, const float* W, const int* cam_idx, int C, int P, int K,
                  float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = n_blocks(P);
  if (nb > 0) schur_wtv_kernel<<<nb, kThreads, 0, s>>>(v, W, cam_idx, C, P, K, out);
  return (int)cudaGetLastError();
}

// out [E,F].
int ccm_cam_broadcast(const float* v, const int* ci, int C, int F, int E, float* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)E * F;
  if (n > 0) {
    const long long nb = (n + kThreads - 1) / kThreads;
    cam_broadcast_kernel<<<(unsigned)nb, kThreads, 0, s>>>(v, ci, C, F, n, out);
  }
  return (int)cudaGetLastError();
}

// out [C,F]; rows [E,F] scratch; pos [E], offsets [C+1] (offsets[C] = rows kept).
int ccm_cam_reduce(const float* y, const int* pos, const int* offsets, int C, int F, int E,
                   float* rows, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)E * F;
  if (n > 0) {
    const long long nb = (n + kThreads - 1) / kThreads;
    scatter_rows_kernel<<<(unsigned)nb, kThreads, 0, s>>>(y, pos, offsets, C, F, n, rows);
  }
  launch_seg_sum(rows, offsets, C, F, out, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
