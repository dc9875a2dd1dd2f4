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
// moves 5-25 MB, which is 1.5-7.6 us at 3.35 TB/s, near the cost of a
// launch; at the client's local-BA shape (C=40, P=4096, K=16) far less.
//
// No float atomics anywhere, so every sum is taken in a fixed order and
// results repeat bit for bit run to run (LM's accept test
// `cost_new < cost` must not flip between runs):
//  - per-landmark sums (V, g_p, the point side of off, wtv) run over each
//    landmark's K contiguous slots in slot order;
//  - per-camera sums go through a camera CSR (observations stably sorted
//    by camera, built once per solve since cam_idx is constant across LM
//    and CG iterations): camera c owns sorted slots offsets[c]..offsets[c+1]
//    and `order[j]` is the observation in slot j.  normal_blocks' camera
//    side, the camera side of off and rhs, and cam_reduce read the slots
//    through `order`, one block per chunk of `chunk` slots, and add each
//    camera's chunk sums in a fixed order;
//  - costs: per-block tree sums, then one block sums the partials in order.
//
// The per-observation kernels (normal_blocks' point kernel, the Schur point
// kernel of off, rhs and wtv, reproj_cost) share one layout: one thread per
// OBSERVATION in blocks of floor(256/K) whole landmarks (or one landmark in
// a power-of-two block above K=256), so a landmark never straddles two
// blocks and even local BA's 65,536 observations fill the card.
//
// normal_blocks (three kernels: point, camera, finish).  Its byte bound is
// 0.0076 ms at the server-GBA shape and 0.0018 ms at the local-BA shape;
// it runs in ~0.033 and ~0.014 ms (H100 80GB HBM3, 700 W, chip_smoke.py):
//  * point kernel: W is staged as the block's [obs,18] tile in shared
//    memory and written out contiguously; V, g_p and the cost go through
//    shared memory and one thread per (landmark, entry) sums its K slots in
//    slot order.  Bound by the bytes it moves (~54% of the HBM rate at
//    E=262144).
//  * camera kernel: one block per chunk (each camera's CSR segment cut into
//    pieces of `chunk` slots, so a camera with many observations -- local
//    BA's padding slots all clamp to camera 0 -- still gets many blocks)
//    walks its sorted slots through `order` and recomputes what the camera
//    side needs (camera pose, X[p], uv, sigma2, flags: ~30 B per
//    observation, L2-resident after the point kernel), so no [E,42] row
//    scratch is written and read back.  Each thread sums its slots' U
//    (upper triangle, 21) and g_c (6) in slot order; warp shuffle trees and
//    an in-order sum over warps combine them.  Bound by the latency of the
//    gathers through `order`.  The finish kernel adds each camera's chunk
//    rows in chunk order and sums the point kernel's cost partials.
//
// schur_off (three kernels: point, chunk, combine; make_schur_matvec runs
// the same).  Its byte bound (W, Vinv, ids, v and the output, each once)
// is 0.0063 ms at the server-GBA shape, 0.0092 ms at the client's
// initialization BA (C=160, P=24,576, K=16) and 0.0252 ms at the stress
// shape (C=1024, P=131,072, K=8); it runs in ~0.019, ~0.026 and ~0.080 ms
// (H100 80GB HBM3, 700 W, tools/time_ba_kernels.py):
//  * point kernel: the block's W tile is loaded once, coalesced, into shared
//    memory and serves both W^T v and W y2, so W crosses HBM once; y3_e =
//    W_e y2_p is written per observation, in observation order, through a
//    shared tile.  Bound by the bytes it moves (~2.1-2.6 TB/s).
//  * chunk kernel: cam_reduce's, one block per chunk of a camera's CSR
//    segment, gathers y3[order[j]] (24 B rows at random, from L2 at the
//    bench shape, from HBM at the stress shape, where the point kernel's
//    75 MB of W evict them): bound by that gather.
//  * combine kernel: one block per camera adds its chunk sums, so the
//    initialization BA's camera 0 (nearly all 393,216 slots: 768 chunks)
//    costs each thread three rows.
//
// schur_rhs (the same three kernels, the point kernel writing y3_e = W_e
// q_p) and schur_wtv (the point kernel alone, up to off's y1_p).  Their
// byte bounds (W, ids, the input and the output, each once) are 0.0061 ms
// at the server-GBA shape, 0.0090 ms at the initialization BA and 0.0243
// ms at the stress shape.  rhs runs in ~0.017, ~0.022 and ~0.067 ms, wtv in
// ~0.007, ~0.010 and ~0.039 ms (H100 80GB HBM3, 700 W,
// tools/time_ba_kernels.py):
//  * rhs: the point kernel moves W in and y3 out at ~3.0 TB/s (8.4 us at
//    the server-GBA shape); the rest is off's camera side, bound by the
//    chunk kernel's gather of y3 through `order` (6.9 us there).  Camera 0
//    of the initialization BA is spread over its 768 chunks like any other
//    camera's slots.
//  * wtv: one pass over W, bound by the bytes it moves (1.1-1.6x the
//    bound); its landmark sums take the slot order of off's y1_p.
//
// reproj_cost (two kernels: cost, sum of partials).  Its byte bound is
// 0.0015 ms at the server-GBA shape and 0.0003 ms at local BA's; it runs in
// ~0.008 and ~0.005 ms, where one thread per landmark (16 blocks at local
// BA, a serial chain of 16 observations each) took 0.009 and 0.014.  Each
// thread reads its observation coalesced and gathers its camera through
// L1; the block partials and the final pass are normal_blocks' own, so the
// two costs agree bit for bit.  Bound by the per-observation work (21-24 ps
// an observation at the server-GBA and stress shapes; a camera table
// staged in shared memory measured slower) and, at local BA, by two
// launches' latency.
//
// cam_reduce (two kernels: chunk sums, then their combination).  Its byte
// bound at E=1,048,576, C=1024, F=6 is 0.0088 ms; it runs in ~0.023 ms,
// ahead of index_add_ (~0.046 ms, float atomics).  One block per chunk of a
// camera's segment gathers y[order[j]] for its slots in ascending j --
// lanes cover consecutive columns of consecutive rows, so a warp reads
// whole F-wide rows -- and a fixed tree combines the rows' column sums; no
// scratch but one F-float row per chunk.  Rows whose id is outside [0, C)
// sit in the CSR's drop bucket (slots >= offsets[C]) and are never read.
//
// cam_broadcast (one kernel).  A copy: each observation's F floats from
// its camera's row, zeros for ids outside [0, C).  Bound by the bytes it
// moves (ci in, out out: 0.0041 ms at the server-GBA shape, 0.0088 ms at
// the stress shape with F=6, 0.0163 with F=12).  One thread per 16-byte
// piece of out, F a template parameter (12 and 6; any other F takes a
// one-float-per-thread kernel), v gathered through the read-only path:
// 1.0-1.3x the bound warm and 1.3-1.7x with L2 flushed before each call
// (2.1x and 2.5x at local BA, launch-bound), where one thread per float
// with a 64-bit division took 2.3-3.5x (H100 80GB HBM3, 700 W,
// tools/time_ba_kernels.py).  Staging v in shared memory (every block loads
// all C F floats) measured slower, streaming stores no faster cold.
//
// The TPU layout tricks (factored hi/lo one-hot, k-major lane packing,
// (8,128) output blocks, the K<=16 cap) are not carried over: on Hopper a
// thread gathers its camera's 12 floats directly (L1/L2 resident: the
// camera table is 6 KB at C=128).
//
// Interface: plain C, every pointer a device pointer into a contiguous
// tensor allocated by the caller (outputs and scratch included), bool masks
// as one byte each, cam_idx int32.  Work is enqueued on `stream`; nothing is
// synchronised.  Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // per-landmark kernels, partial sums, camera-major kernels
constexpr int kMaxThreads = 1024;  // per-observation blocks: point_layout's largest
constexpr int kRowF = 42;       // a camera's U (36) + g_c (6) row
constexpr int kWStride = 19;    // shared W tile row: 18 floats, odd stride (no bank conflicts)
constexpr int kVStride = 13;    // shared V (9) | g_p (3) | rho row
constexpr int kYStride = 7;     // shared y1 (3) or y3 (6) row of schur_off, odd stride
constexpr int kCamAcc = 27;     // U upper triangle (21) + g_c (6)

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

// Rc, tc: the observing camera's rotation (9 floats, row-major) and translation.
__device__ __forceinline__ Obs observe(const float* Rc, const float* tc, float X0, float X1,
                                       float X2, bool point_ok, int e,
                                       const float* __restrict__ uv,
                                       const float* __restrict__ sigma2,
                                       const uint8_t* __restrict__ obs_valid,
                                       const float* __restrict__ intr, float delta) {
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

// Closed-form pose and point Jacobians of one observation
// (solvers/reproj.pose_point_jacobians), gated as the reference gates them:
// zero where w <= 0, and the pose rows also zero for a fixed camera.
__device__ __forceinline__ void jacobians(const float* __restrict__ Rc, const Obs& o, float fx,
                                          float fy, bool cam_fixed, float Jc0[6], float Jc1[6],
                                          float Jp0[3], float Jp1[3]) {
  const float iz = 1.0f / z_safe(o.z);
  const float iz2 = iz * iz;
  const float a = fx * iz, b = -fx * o.x * iz2;
  const float cc = fy * iz, d = -fy * o.y * iz2;
  const float gate = o.w > 0.0f ? 1.0f : 0.0f;
  const float pose_gate = gate * (cam_fixed ? 0.0f : 1.0f);
  const float j0[6] = {a, 0.0f, b, b * o.y, a * o.z - b * o.x, -a * o.y};
  const float j1[6] = {0.0f, cc, d, -cc * o.z + d * o.y, -d * o.x, cc * o.x};
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    Jc0[i] = j0[i] * pose_gate;
    Jc1[i] = j1[i] * pose_gate;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Jp0[i] = (a * Rc[i] + b * Rc[6 + i]) * gate;
    Jp1[i] = (cc * Rc[3 + i] + d * Rc[6 + i]) * gate;
  }
}

// ---------------------------------------------------------------------------
// Cost: one thread per observation in blocks of L whole landmarks (thread
// l*K + k is slot k of the block's landmark l: normal_blocks' point
// layout), block tree sum -> one partial per block.
// ---------------------------------------------------------------------------
__global__ void reproj_cost_kernel(const float* __restrict__ R, const float* __restrict__ t,
                                   const float* __restrict__ X,
                                   const uint8_t* __restrict__ point_valid,
                                   const int* __restrict__ cam_idx,
                                   const float* __restrict__ uv,
                                   const float* __restrict__ sigma2,
                                   const uint8_t* __restrict__ obs_valid,
                                   const float* __restrict__ intr, int C, int P, int K, int L,
                                   float delta, float* __restrict__ partials) {
  __shared__ float sh[kMaxThreads];
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * L;
  const int l = tid / K;
  float rho = 0.0f;
  if (l < min(L, P - p0)) {
    const int p = p0 + l;
    const int e = p * K + (tid - l * K);
    const int c = clamp_cam(cam_idx[e], C);
    rho = observe(R + 9 * c, t + 3 * c, X[3 * p], X[3 * p + 1], X[3 * p + 2], point_valid[p], e,
                  uv, sigma2, obs_valid, intr, delta).rho;
  }
  const float s = block_sum(rho, sh);
  if (tid == 0) partials[blockIdx.x] = s;
}

// Fixed-order sum of n partials into out[0] (one block of kThreads).
__global__ void sum_partials_kernel(const float* __restrict__ partials, int n,
                                    float* __restrict__ out) {
  __shared__ float sh[kThreads];
  float acc = 0.0f;
  int i = threadIdx.x;
  for (; i + 7 * kThreads < n; i += 8 * kThreads) {  // eight loads in flight, added in order
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = partials[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += x[u];
  }
  for (; i < n; i += kThreads) acc += partials[i];
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) out[0] = s;
}

// ---------------------------------------------------------------------------
// Normal equations, point side: one thread per observation.  A block of
// blockDim threads holds L = blockDim / K whole landmarks (thread l*K + k is
// slot k of the block's landmark l).  Per observation: residual -> Huber
// weight -> Jacobians -> W_e = w Jc^T Jp (staged in shared memory, then
// written out contiguously), V_e = w Jp^T Jp, g_p,e = -w Jp^T r and rho
// (staged; one thread per (landmark, entry) sums its K slots in order).
// ---------------------------------------------------------------------------
__global__ void normal_blocks_point_kernel(const float* __restrict__ R,
                                           const float* __restrict__ t,
                                           const float* __restrict__ X,
                                           const uint8_t* __restrict__ point_valid,
                                           const int* __restrict__ cam_idx,
                                           const float* __restrict__ uv,
                                           const float* __restrict__ sigma2,
                                           const uint8_t* __restrict__ obs_valid,
                                           const uint8_t* __restrict__ cam_fixed,
                                           const float* __restrict__ intr, int C, int P, int K,
                                           int L, float delta, float* __restrict__ W,
                                           float* __restrict__ V, float* __restrict__ g_p,
                                           float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* shW = smem;                            // [blockDim][kWStride]
  float* shV = smem + blockDim.x * kWStride;    // [blockDim][kVStride]
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * L;
  const int nl = min(L, P - p0);                // landmarks in this block
  const int l = tid / K;
  float rho = 0.0f;
  if (l < nl) {
    const int p = p0 + l;
    const int e = p * K + (tid - l * K);
    const int c = clamp_cam(cam_idx[e], C);
    const Obs o = observe(R + 9 * c, t + 3 * c, X[3 * p], X[3 * p + 1], X[3 * p + 2],
                          point_valid[p], e, uv, sigma2, obs_valid, intr, delta);
    rho = o.rho;
    float Jc0[6], Jc1[6], Jp0[3], Jp1[3];
    jacobians(R + 9 * c, o, intr[0], intr[1], cam_fixed[c], Jc0, Jc1, Jp0, Jp1);
    float* w_row = shW + tid * kWStride;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float wJc0 = Jc0[i] * o.w, wJc1 = Jc1[i] * o.w;
#pragma unroll
      for (int j = 0; j < 3; ++j) w_row[3 * i + j] = wJc0 * Jp0[j] + wJc1 * Jp1[j];
    }
    float* v_row = shV + tid * kVStride;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float wJp0 = Jp0[i] * o.w, wJp1 = Jp1[i] * o.w;
#pragma unroll
      for (int j = 0; j < 3; ++j) v_row[3 * i + j] = wJp0 * Jp0[j] + wJp1 * Jp1[j];
      v_row[9 + i] = -(wJp0 * o.r0 + wJp1 * o.r1);
    }
  }
  __syncthreads();
  const int n_obs = max(nl, 0) * K;
  float* Wb = W + (size_t)p0 * K * 18;
  for (int q = tid; q < n_obs * 18; q += blockDim.x) {
    const int i = q / 18;
    Wb[q] = shW[i * kWStride + (q - i * 18)];
  }
  for (int q = tid; q < nl * 12; q += blockDim.x) {
    const int ll = q / 12, i = q - ll * 12;
    const float* src = shV + ll * K * kVStride + i;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) s += src[k * kVStride];
    if (i < 9)
      V[(size_t)(p0 + ll) * 9 + i] = s;
    else
      g_p[(size_t)(p0 + ll) * 3 + (i - 9)] = s;
  }
  __syncthreads();  // the W tile is free again: block_sum's scratch
  const float s = block_sum(rho, shW);
  if (tid == 0) partials[blockIdx.x] = s;
}

// Fixed-order shuffle tree over a warp; lane 0 gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Chunk b of the camera CSR: each camera's segment is cut into pieces of
// `chunk` slots, camera c owning chunks[c]..chunks[c+1].  Returns false past
// the last chunk; else the camera and the chunk's slots [lo, hi).
__device__ __forceinline__ bool chunk_slots(const int* __restrict__ offsets,
                                            const int* __restrict__ chunks, int C, int chunk,
                                            int b, int* cam, int* lo, int* hi) {
  if (b >= chunks[C]) return false;
  int a = 0, z = C;  // chunks[a] <= b < chunks[z]: the last camera starting at or before b
  while (z - a > 1) {
    const int m = (a + z) >> 1;
    if (chunks[m] <= b) a = m; else z = m;
  }
  *cam = a;
  *lo = offsets[a] + (b - chunks[a]) * chunk;
  *hi = min(*lo + chunk, offsets[a + 1]);
  return true;
}

// ---------------------------------------------------------------------------
// Normal equations, camera side: block b walks chunk b's sorted slots j of
// its camera c (thread tid takes j = lo + tid, lo + tid + blockDim, ...),
// recomputes each observation order[j] from the camera pose and the point,
// and sums w Jc^T Jc (upper triangle) and -w Jc^T r in slot order.  Fixed
// cameras get exact zeros.  out: one 42-float row per chunk (U row-major,
// then g_c).
// ---------------------------------------------------------------------------
__global__ void normal_blocks_camera_kernel(const float* __restrict__ R,
                                            const float* __restrict__ t,
                                            const float* __restrict__ X,
                                            const uint8_t* __restrict__ point_valid,
                                            const float* __restrict__ uv,
                                            const float* __restrict__ sigma2,
                                            const uint8_t* __restrict__ obs_valid,
                                            const uint8_t* __restrict__ cam_fixed,
                                            const float* __restrict__ intr, int K, float delta,
                                            const int* __restrict__ order,
                                            const int* __restrict__ offsets,
                                            const int* __restrict__ chunks, int C, int chunk,
                                            float* __restrict__ out) {
  __shared__ float sh[kCamAcc][kThreads / 32];
  int c, lo, hi;
  if (!chunk_slots(offsets, chunks, C, chunk, blockIdx.x, &c, &lo, &hi)) return;
  float acc[kCamAcc];
#pragma unroll
  for (int q = 0; q < kCamAcc; ++q) acc[q] = 0.0f;
  if (!cam_fixed[c]) {
    for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      const int e = order[j];
      const int p = e / K;
      const Obs o = observe(R + 9 * c, t + 3 * c, X[3 * p], X[3 * p + 1], X[3 * p + 2],
                            point_valid[p], e, uv, sigma2, obs_valid, intr, delta);
      float Jc0[6], Jc1[6], Jp0[3], Jp1[3];
      jacobians(R + 9 * c, o, intr[0], intr[1], false, Jc0, Jc1, Jp0, Jp1);
      int q = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float wJc0 = Jc0[i] * o.w, wJc1 = Jc1[i] * o.w;
#pragma unroll
        for (int k = i; k < 6; ++k) acc[q++] += wJc0 * Jc0[k] + wJc1 * Jc1[k];
        acc[21 + i] += -(wJc0 * o.r0 + wJc1 * o.r1);
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kCamAcc; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) sh[q][warp] = v;
  }
  __syncthreads();
  const int f = threadIdx.x;
  if (f < kRowF) {
    int q;
    if (f < 36) {
      const int i = min(f / 6, f % 6), k = max(f / 6, f % 6);
      q = i * 6 - i * (i - 1) / 2 + (k - i);  // upper-triangle index of (i, k)
    } else {
      q = 21 + (f - 36);
    }
    float v = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += sh[q][w];
    out[(size_t)blockIdx.x * kRowF + f] = v;
  }
}

// The last block sums the point kernel's n cost partials in order; the
// others add each camera's chunk rows in chunk order.
__global__ void normal_blocks_finish_kernel(const float* __restrict__ cam_part,
                                            const int* __restrict__ chunks, int C,
                                            const float* __restrict__ partials, int n,
                                            float* __restrict__ UG, float* __restrict__ cost) {
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ float sh[kThreads];
    float acc = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
    const float s = block_sum(acc, sh);
    if (threadIdx.x == 0) cost[0] = s;
    return;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * kRowF) return;
  const int c = i / kRowF, f = i - c * kRowF;
  float v = 0.0f;
  for (int b = chunks[c]; b < chunks[c + 1]; ++b) v += cam_part[(size_t)b * kRowF + f];
  UG[i] = v;
}

// ---------------------------------------------------------------------------
// Schur operators over W [P,K,6,3] (row-major: W_e[i][j] at e*18 + 3i + j).
// ---------------------------------------------------------------------------

// What the point kernel computes (schur_point_kernel's template argument).
enum SchurStage { kOff, kRhs, kWtv };

// The Schur operators' point side: one thread per observation in blocks of
// L whole landmarks (thread l*K + k is slot k of the block's landmark l).
// The block's [obs,18] W tile is staged in shared memory with coalesced
// loads, so W is read from HBM once per call.
//  kOff: y1_e = W_e^T v[ci_e] per observation; y1_p = sum_k y1_pk in slot
//        order, one thread per (landmark, component); y2_p = Vinv_p y1_p
//        and y3_e = W_e y2_p per observation, staged and written to out
//        [E,6] in observation order.
//  kRhs: y3_e = W_e q_p (x = q [P,3]) per observation, written as kOff's.
//  kWtv: kOff's y1_p (the same products, summed in the same order), written
//        to out [P,3] coalesced.
template <int kStage>
__global__ void schur_point_kernel(const float* __restrict__ x, const float* __restrict__ W,
                                   const float* __restrict__ Vinv,
                                   const int* __restrict__ cam_idx, int C, int P, int K, int L,
                                   float* __restrict__ out) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* shW = smem;                  // [T][kWStride]: the W tile
  float* shY = smem + T * kWStride;   // [T][kYStride]: y1_e, later y3_e
  float* shS = shY + T * kYStride;    // [L][3]: y1_p
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * L;
  const int nl = min(L, P - p0);      // landmarks in this block
  const int n_obs = nl * K;
  const size_t base = (size_t)p0 * K;  // the block's first observation
  const float* Wb = W + base * 18;
#pragma unroll
  for (int r = 0; r < 18; ++r) {  // n_obs <= T, so 18 rounds cover the tile
    const int q = r * T + tid;
    if (q < n_obs * 18) {
      const int i = q / 18;
      shW[i * kWStride + (q - i * 18)] = Wb[q];
    }
  }
  __syncthreads();
  const bool live = tid < n_obs;
  const int l = tid / K;
  const float* w = shW + tid * kWStride;
  float* y = shY + tid * kYStride;
  float y2[3] = {0.0f, 0.0f, 0.0f};
  if (kStage == kRhs) {
    if (live) {
#pragma unroll
      for (int i = 0; i < 3; ++i) y2[i] = x[3 * (size_t)(p0 + l) + i];
    }
  } else {
    if (live) {
      const float* vc = x + 6 * clamp_cam(cam_idx[base + tid], C);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < 6; ++i) s += w[3 * i + j] * vc[i];
        y[j] = s;
      }
    }
    __syncthreads();
    for (int q = tid; q < nl * 3; q += T) {
      const int ll = q / 3;
      const float* src = shY + ll * K * kYStride + (q - ll * 3);
      float s = 0.0f;
      for (int k = 0; k < K; ++k) s += src[k * kYStride];
      if (kStage == kWtv)
        out[(size_t)p0 * 3 + q] = s;
      else
        shS[q] = s;
    }
    if (kStage == kWtv) return;
    __syncthreads();  // shY is free again: it stages y3
    if (live) {
      const float* Vi = Vinv + 9 * (size_t)(p0 + l);
      const float* y1 = shS + 3 * l;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        y2[i] = Vi[3 * i] * y1[0] + Vi[3 * i + 1] * y1[1] + Vi[3 * i + 2] * y1[2];
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 6; ++i) y[i] = w[3 * i] * y2[0] + w[3 * i + 1] * y2[1] + w[3 * i + 2] * y2[2];
  }
  __syncthreads();
  float* yb = out + base * 6;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const int q = r * T + tid;
    if (q < n_obs * 6) {
      const int i = q / 6;
      yb[q] = shY[i * kYStride + (q - i * 6)];
    }
  }
}

// ---------------------------------------------------------------------------
// Camera -> observation broadcast: out[e, :] = v[ci[e], :], 0 out of range.
// One thread per 16-byte piece of out (float index j = 4 i), so a warp
// stores 512 contiguous bytes.  F is a template parameter (e = j / F is a
// multiply and a shift).  F % 4 == 0 (12: R | t): the piece lies in one
// row and is one float4 gather.  Even F (6: a CG vector): two 8-byte
// halves, each inside one row (a pair of observations is three pieces).
// cam_broadcast_any_kernel: any other F, one thread per float.
// ---------------------------------------------------------------------------
template <int F>
__device__ __forceinline__ float2 broadcast_half(const float* __restrict__ v,
                                                 const int* __restrict__ ci, int C, unsigned j) {
  const unsigned e = j / F, f = j - e * F;
  const int c = __ldg(ci + e);
  if (c < 0 || c >= C) return make_float2(0.0f, 0.0f);
  return __ldg(reinterpret_cast<const float2*>(v + (size_t)c * F + f));
}

template <int F>
__global__ void cam_broadcast_kernel(const float* __restrict__ v, const int* __restrict__ ci,
                                     int C, unsigned n, float* __restrict__ out) {
  static_assert(F % 2 == 0, "even F only");
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned j = 4 * i;
  if (j >= n) return;
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (F % 4 == 0) {
    const unsigned e = j / F, f = j - e * F;
    const int c = __ldg(ci + e);
    if (c >= 0 && c < C) x = __ldg(reinterpret_cast<const float4*>(v + (size_t)c * F + f));
  } else {
    const float2 lo = broadcast_half<F>(v, ci, C, j);
    if (j + 2 >= n) {  // n = E F is even: the last piece may be half
      reinterpret_cast<float2*>(out)[2 * i] = lo;
      return;
    }
    const float2 hi = broadcast_half<F>(v, ci, C, j + 2);
    x = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  reinterpret_cast<float4*>(out)[i] = x;
}

__global__ void cam_broadcast_any_kernel(const float* __restrict__ v,
                                         const int* __restrict__ ci, int C, int F, unsigned n,
                                         float* __restrict__ out) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned e = i / (unsigned)F;
  const int c = __ldg(ci + e);
  out[i] = (c >= 0 && c < C) ? __ldg(v + (size_t)c * F + (i - e * F)) : 0.0f;
}

// ---------------------------------------------------------------------------
// Observation -> camera sums with drops, in one pass: block b sums
// y[order[j]] over chunk b's sorted slots of its camera in ascending j.
// Thread tid covers column f0 + tid % FC of rows tid / FC, + R, + 2R, ...
// (FC = min(F, blockDim) columns, R = blockDim / FC rows per pass: a warp
// reads whole F-wide rows); a fixed tree then adds the R row partials of
// each column.  Rows whose camera id was outside [0, C) sit in the CSR's
// drop bucket (slots >= offsets[C]) and are never read.  out: one F-float
// row per chunk.
// ---------------------------------------------------------------------------
__global__ void cam_reduce_kernel(const float* __restrict__ y, const int* __restrict__ order,
                                  const int* __restrict__ offsets,
                                  const int* __restrict__ chunks, int C, int chunk, int F,
                                  float* __restrict__ out) {
  __shared__ float sh[kThreads];
  int c, lo, hi;
  if (!chunk_slots(offsets, chunks, C, chunk, blockIdx.x, &c, &lo, &hi)) return;
  const int tid = threadIdx.x;
  const int FC = min(F, (int)blockDim.x);
  const int R = blockDim.x / FC;
  const int r = tid / FC, fl = tid - r * FC;
  int half = 1;
  while (2 * half < R) half *= 2;  // the tree's first stride: R <= 2 * half
  for (int f0 = 0; f0 < F; f0 += FC) {
    const int f = f0 + fl;
    float acc = 0.0f;
    if (r < R && f < F) {
#pragma unroll 4
      for (int j = lo + r; j < hi; j += R) acc += y[(size_t)order[j] * F + f];
    }
    sh[tid] = acc;
    __syncthreads();
    for (int h = half; h > 0; h >>= 1) {
      if (r < h && r + h < R) sh[tid] += sh[tid + h * FC];
      __syncthreads();
    }
    if (r == 0 && f < F) out[(size_t)blockIdx.x * F + f] = sh[fl];
    __syncthreads();
  }
}

// out[c, f] = sum of camera c's chunk rows part[b, f], in chunk order.
__global__ void cam_reduce_combine_kernel(const float* __restrict__ part,
                                          const int* __restrict__ chunks, int C, int F,
                                          float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)C * F) return;
  const int c = (int)(i / F);
  const int f = (int)(i - (long long)c * F);
  float v = 0.0f;
  for (int b = chunks[c]; b < chunks[c + 1]; ++b) v += part[(size_t)b * F + f];
  out[i] = v;
}

// The camera side of off and rhs: out[c] = the sum of camera c's chunk rows
// part[b] (6 floats, from cam_reduce_kernel over y3), one block per camera:
// thread tid adds chunks chunks[c] + tid, + blockDim, ... in order; a
// shuffle tree per warp and an in-order sum over warps combine them.  A
// camera of hundreds of chunks (the initialization BA's padding slots all
// sit on camera 0) costs each thread a few rows, where one thread per
// (camera, column), as in cam_reduce_combine_kernel, walks them all.
__global__ void schur_off_combine_kernel(const float* __restrict__ part,
                                         const int* __restrict__ chunks,
                                         float* __restrict__ out) {
  __shared__ float sh[6][kThreads / 32];
  const int c = blockIdx.x;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int b = chunks[c] + threadIdx.x; b < chunks[c + 1]; b += blockDim.x) {
#pragma unroll
    for (int f = 0; f < 6; ++f) acc[f] += part[(size_t)b * 6 + f];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const float v = warp_sum(acc[f]);
    if (lane == 0) sh[f][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += sh[threadIdx.x][w];
    out[(size_t)c * 6 + threadIdx.x] = v;
  }
}

// Grid of the camera-major kernels: sum over cameras of ceil(len / chunk)
// is at most E / chunk + C; blocks past the last chunk return at once.
unsigned chunk_grid(long long E, int C, int chunk) { return (unsigned)(E / chunk + C); }

// schur_point_kernel<kStage> over ceil(P/L) blocks of `threads` (a power of
// two >= L*K) with L landmarks each; shared memory opted in above 48 KB.
template <int kStage>
cudaError_t launch_schur_point(const float* x, const float* W, const float* Vinv,
                               const int* cam_idx, int C, int P, int K, int threads, int L,
                               float* out, cudaStream_t s) {
  const int nb = P > 0 ? (P + L - 1) / L : 0;
  if (nb == 0) return cudaSuccess;
  const size_t smem = ((size_t)threads * (kWStride + kYStride) + 3 * L) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        schur_point_kernel<kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  schur_point_kernel<kStage><<<nb, threads, smem, s>>>(x, W, Vinv, cam_idx, C, P, K, L, out);
  return cudaSuccess;
}

// Camera sums of y3 [E,6] through the camera CSR (order [E], offsets [C+1],
// chunks [C+1]): cam_reduce's chunk kernel into part [E/chunk + C, 6]
// scratch, then one block per camera over its chunk sums into out [C,6].
void launch_cam_sums(const float* y3, const int* order, const int* offsets, const int* chunks,
                     int C, long long E, int chunk, float* part, float* out, cudaStream_t s) {
  cam_reduce_kernel<<<chunk_grid(E, C, chunk), kThreads, 0, s>>>(y3, order, offsets, chunks, C,
                                                                chunk, 6, part);
  schur_off_combine_kernel<<<C, kThreads, 0, s>>>(part, chunks, out);
}

template <int F>
void launch_broadcast(const float* v, const int* ci, int C, unsigned n, float* out,
                      cudaStream_t s) {
  const unsigned pieces = (n + 3) / 4;
  cam_broadcast_kernel<F><<<(pieces + kThreads - 1) / kThreads, kThreads, 0, s>>>(v, ci, C, n,
                                                                                 out);
}

}  // namespace

extern "C" {

const char* ccm_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Blocks of `threads` (a power of two >= L*K) with L landmarks each;
// partials: [max(1, ceil(P/L))] scratch; out: [1].
int ccm_reproj_cost(const float* R, const float* t, const float* X, const uint8_t* point_valid,
                    const int* cam_idx, const float* uv, const float* sigma2,
                    const uint8_t* obs_valid, const float* intr, int C, int P, int K,
                    int threads, int L, float delta, float* partials, float* out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int nb = P > 0 ? (P + L - 1) / L : 0;
  if (nb > 0)
    reproj_cost_kernel<<<nb, threads, 0, s>>>(R, t, X, point_valid, cam_idx, uv, sigma2,
                                              obs_valid, intr, C, P, K, L, delta, partials);
  sum_partials_kernel<<<1, kThreads, 0, s>>>(partials, nb, out);
  return (int)cudaGetLastError();
}

// W [P,K,6,3], V [P,3,3], g_p [P,3], UG [C,42] (U row-major then g_c), cost [1].
// The point kernel runs ceil(P/L) blocks of `threads` (a power of two >= L*K)
// with L landmarks each; partials [ceil(P/L)] scratch.  The camera kernel
// runs one block per chunk of the camera CSR (order [E], offsets [C+1],
// chunks [C+1]), its rows in cam_part [P*K/chunk + C, 42] scratch; the
// finish kernel adds them per camera and sums the cost partials.
int ccm_normal_blocks(const float* R, const float* t, const float* X,
                      const uint8_t* point_valid, const int* cam_idx, const float* uv,
                      const float* sigma2, const uint8_t* obs_valid, const uint8_t* cam_fixed,
                      const float* intr, int C, int P, int K, int threads, int L, int chunk,
                      float delta, const int* order, const int* offsets, const int* chunks,
                      float* W, float* V, float* g_p, float* UG, float* cam_part,
                      float* partials, float* cost, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = P > 0 ? (P + L - 1) / L : 0;
  if (nb > 0) {
    const size_t smem = (size_t)threads * (kWStride + kVStride) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          normal_blocks_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    normal_blocks_point_kernel<<<nb, threads, smem, s>>>(R, t, X, point_valid, cam_idx, uv,
                                                          sigma2, obs_valid, cam_fixed, intr, C,
                                                          P, K, L, delta, W, V, g_p, partials);
  }
  normal_blocks_camera_kernel<<<chunk_grid((long long)P * K, C, chunk), kThreads, 0, s>>>(
      R, t, X, point_valid, uv, sigma2, obs_valid, cam_fixed, intr, K, delta, order, offsets,
      chunks, C, chunk, cam_part);
  normal_blocks_finish_kernel<<<(C * kRowF + kThreads - 1) / kThreads + 1, kThreads, 0, s>>>(
      cam_part, chunks, C, partials, nb, UG, cost);
  return (int)cudaGetLastError();
}

// The Schur operators over W [P,K,6,3] (the point kernel: ceil(P/L) blocks
// of `threads`, a power of two >= L*K, with L landmarks each).  off and rhs
// write per-observation rows to y3 [P*K,6] scratch and sum them through
// the camera CSR (order [E], offsets [C+1], chunks [C+1]) chunk by chunk
// into part [P*K/chunk + C, 6] scratch, then per camera into out [C,6].
int ccm_schur_off(const float* v, const float* W, const float* Vinv, const int* cam_idx,
                  const int* order, const int* offsets, const int* chunks, int C, int P, int K,
                  int threads, int L, int chunk, float* y3, float* part, float* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      launch_schur_point<kOff>(v, W, Vinv, cam_idx, C, P, K, threads, L, y3, s);
  if (err != cudaSuccess) return (int)err;
  launch_cam_sums(y3, order, offsets, chunks, C, (long long)P * K, chunk, part, out, s);
  return (int)cudaGetLastError();
}

int ccm_schur_rhs(const float* q, const float* W, const int* order, const int* offsets,
                  const int* chunks, int C, int P, int K, int threads, int L, int chunk,
                  float* y3, float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      launch_schur_point<kRhs>(q, W, nullptr, nullptr, C, P, K, threads, L, y3, s);
  if (err != cudaSuccess) return (int)err;
  launch_cam_sums(y3, order, offsets, chunks, C, (long long)P * K, chunk, part, out, s);
  return (int)cudaGetLastError();
}

// out [P,3].
int ccm_schur_wtv(const float* v, const float* W, const int* cam_idx, int C, int P, int K,
                  int threads, int L, float* out, void* stream) {
  const cudaError_t err = launch_schur_point<kWtv>(v, W, nullptr, cam_idx, C, P, K, threads, L,
                                                   out, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// out [E,F]; E F < 2^32.  F = 12 and F = 6 take 16-byte pieces when v and
// out are 16-byte aligned; any other F, or a table off that alignment, one
// float per thread.
int ccm_cam_broadcast(const float* v, const int* ci, int C, int F, int E, float* out,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E < 0 || F < 0) return (int)cudaErrorInvalidValue;
  const unsigned long long n = (unsigned long long)E * F;
  if (n == 0) return (int)cudaGetLastError();
  if (n > 0xFFFFFFF0ull) return (int)cudaErrorInvalidValue;
  const bool vec = (uintptr_t)v % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec && F == 12)
    launch_broadcast<12>(v, ci, C, (unsigned)n, out, s);
  else if (vec && F == 6)
    launch_broadcast<6>(v, ci, C, (unsigned)n, out, s);
  else
    cam_broadcast_any_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        v, ci, C, F, (unsigned)n, out);
  return (int)cudaGetLastError();
}

// out [C,F]; order [E], offsets [C+1] and chunks [C+1] of the drop-bucket
// CSR (offsets[C] = rows kept); part [E/chunk + C, F] scratch.
int ccm_cam_reduce(const float* y, const int* order, const int* offsets, const int* chunks,
                   int C, int F, int E, int chunk, float* part, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 0 || F <= 0) return (int)cudaGetLastError();
  cam_reduce_kernel<<<chunk_grid(E, C, chunk), kThreads, 0, s>>>(y, order, offsets, chunks, C,
                                                                chunk, F, part);
  const long long n = (long long)C * F;
  cam_reduce_combine_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, chunks, C, F, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
