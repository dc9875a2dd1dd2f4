// Masked 256-bit Hamming best-2 for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel ``hamming_top2`` of
// ccm_slam_tpu/ops/pallas_kernels.py (pallas_call :121, body ``_kernel``
// :54).  For each query descriptor: the best and second-best Hamming
// distance over the valid targets and the index of the best.  Semantics are
// the TPU kernel's and its reference ``hamming_top2_reference`` (:153):
//
//   * the best index is the LOWEST target index reaching the best distance;
//   * second = the smallest distance over every other target (equal to best
//     when the minimum occurs twice); BIG when there is no other valid one;
//   * invalid targets never win; invalid queries return idx 0, BIG, BIG;
//     with no valid target, idx 0 and BIG.
//
// Layout: descriptors as 8 x uint32 words (the uint8 [N,32] rows viewed as
// words); distance = sum of __popc over 8 XORs, exact in integers.  The
// TPU's bit-unpacked bf16 matmul and its (8,128) output blocks are MXU/VMEM
// artifacts and are not copied.
//
// Bound: at Q=1024, T=16384 the work is 134 M popcounts over 0.56 MB of
// descriptors, so the integer pipes (popc, 16 per clock per SM) bound it,
// not memory.  Design: one thread per query holds the query's 8 words in
// registers; each block takes 128 queries and one slice of the targets,
// staged through shared memory in tiles that every thread of a warp reads
// at the same address (a broadcast).  Splitting the targets across blocks
// fills the card at Q=1024 (8 x 32 = 256 blocks on 132 SMs); a second
// kernel merges the per-slice top-2 in slice order, so the result is
// deterministic and needs no atomics.  A strictly-less update in ascending
// target order keeps the lowest index on ties.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 1 << 30;   // the reference's clip value for "none"
constexpr int kThreads = 128;   // queries per block
constexpr int kTile = 256;      // targets staged per shared-memory tile

__global__ void top2_partial_kernel(const uint32_t* __restrict__ q,
                                    const uint32_t* __restrict__ t,
                                    const uint8_t* __restrict__ tv,
                                    int Q, int T, int chunk,
                                    int* __restrict__ part_best,
                                    int* __restrict__ part_idx,
                                    int* __restrict__ part_sec) {
  __shared__ uint32_t sh_t[kTile * 8];
  __shared__ uint8_t sh_v[kTile];

  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int s = blockIdx.y;
  const int t_begin = s * chunk;
  const int t_end = min(T, t_begin + chunk);

  uint32_t w[8];
  const bool q_in = qi < Q;
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = q_in ? q[(size_t)qi * 8 + k] : 0u;

  int best = kBig, sec = kBig, idx = 0;
  for (int base = t_begin; base < t_end; base += kTile) {
    const int n = min(kTile, t_end - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n * 8; k += kThreads) sh_t[k] = t[(size_t)base * 8 + k];
    for (int k = threadIdx.x; k < n; k += kThreads) sh_v[k] = tv[base + k];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!sh_v[j]) continue;
      const uint32_t* tw = sh_t + j * 8;
      int d = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) d += __popc(w[k] ^ tw[k]);
      if (d < best) {
        sec = best;
        best = d;
        idx = base + j;
      } else if (d < sec) {
        sec = d;
      }
    }
  }
  if (q_in) {
    const size_t o = (size_t)s * Q + qi;
    part_best[o] = best;
    part_idx[o] = idx;
    part_sec[o] = sec;
  }
}

__global__ void top2_merge_kernel(const uint8_t* __restrict__ qv, int Q, int S,
                                  const int* __restrict__ part_best,
                                  const int* __restrict__ part_idx,
                                  const int* __restrict__ part_sec,
                                  int* __restrict__ out_idx,
                                  int* __restrict__ out_best,
                                  int* __restrict__ out_sec) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Q) return;
  int best = kBig, sec = kBig, idx = 0;
  // slices in ascending target order: a later slice wins only when strictly
  // better, so the lowest index of the minimum survives
  for (int s = 0; s < S; ++s) {
    const size_t o = (size_t)s * Q + qi;
    const int b = part_best[o];
    if (b < best) {
      sec = min(best, part_sec[o]);
      best = b;
      idx = part_idx[o];
    } else {
      sec = min(sec, b);
    }
  }
  if (!qv[qi]) {
    best = kBig;
    sec = kBig;
    idx = 0;
  }
  out_idx[qi] = idx;
  out_best[qi] = best;
  out_sec[qi] = sec;
}

}  // namespace

extern "C" {

const char* ccm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [Q,8] u32, qv [Q] u8, t [T,8] u32, tv [T] u8; S slices of ``chunk``
// targets (S * chunk >= T); scratch part_* [S,Q]; outputs idx/best/sec [Q].
int ccm_hamming_top2(const void* q, const void* qv, const void* t, const void* tv, int Q,
                     int T, int S, int chunk, void* part_best, void* part_idx,
                     void* part_sec, void* idx, void* best, void* sec,
                     cudaStream_t stream) {
  if (Q <= 0 || T <= 0 || S <= 0 || chunk <= 0 || (long long)S * chunk < T)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Q + kThreads - 1) / kThreads, S);
  top2_partial_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t),
      static_cast<const uint8_t*>(tv), Q, T, chunk,
      static_cast<int*>(part_best), static_cast<int*>(part_idx), static_cast<int*>(part_sec));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  top2_merge_kernel<<<(Q + 255) / 256, 256, 0, stream>>>(
      static_cast<const uint8_t*>(qv), Q, S, static_cast<const int*>(part_best),
      static_cast<const int*>(part_idx), static_cast<const int*>(part_sec),
      static_cast<int*>(idx), static_cast<int*>(best), static_cast<int*>(sec));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
