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
// Distances on the tensor cores, bits kept packed.  The TPU kernel unpacks
// the bits to +-1 bf16 for its matrix unit; Hopper's tensor cores take the
// bits as they are: ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.
// and.popc`` gives popc(q & t) for a 16 x 8 tile of (query, target) pairs
// over 256 bits, one descriptor, and d = popc(q) + popc(t) - 2 popc(q & t)
// is exact in integers.  The descriptors stay [N,32] bytes viewed as 8
// words; lane (g, tig) of a warp feeds words 2 tig and 2 tig + 1 of rows g
// and g + 8 (A) and of column g (B) -- the instruction only needs A and B
// to agree on which word stands for which 32 bits of k, and this mapping
// gives each lane one 8-byte piece of each descriptor it reads.  A second
// instruction with A all ones gives popc(t) of the lane's two C columns.
//
// Top-2 in packed keys: a (target, query row) pair becomes the 32-bit key
// ((popc(t) + 256 - 2 popc(q & t)) << 21) | j, j the target's index in its
// slice; popc(q) is the same for every target of a row, so keys order like
// (distance, index), and the lowest index wins a tie by construction.  An
// invalid target (or a padding column past T) takes popc(t) = 1024, whose
// keys sit above every valid one.  The running best-2 per row is then
//   second = min(second, max(best, k));  best = min(best, k)
// -- integer min and max, in any order with the same result, so nothing
// depends on which warp, lane or block saw a target first.
//
// Layout: a block is 8 warps on one group of 32 queries (two 16-row tiles,
// their A fragments kept in registers); the warps take the 8-target tiles
// of the block's slice in turn.  The 4 lanes of a query row merge by
// shuffles, the 8 warps through shared memory (as 64-bit keys (d << 32) |
// global index), and the 8 blocks of a thread-block cluster -- the 8
// slices of the targets -- through distributed shared memory: one launch,
// no scratch, no atomics, bit-identical on a rerun.  1,024 queries are 32
// groups x 8 slices = 256 blocks, enough for 132 SMs at 1,024 targets.
//
// Bound: the 1-bit MMA rate (tools/mma_b1_rate.py measures 0.61
// instructions per clock per SM, 2.0e13 pairs/s: 0.0006 ms at 1,024 x
// 16,384) or the bytes.  The kernel takes 0.0047, 0.0137 and 0.0183 ms at
// 1,024 x 1,024, 16,384 and 24,576 (H100 80GB HBM3, 700 W,
// tools/time_ba_kernels.py; the popcount kernel before it 0.044, 0.057,
// 0.070).  What holds it is not the tensor cores: per pair the epilogue
// does a shift, a subtract and three min/max on the integer pipes, per
// 8-target tile each lane loads 8 bytes of descriptor and 2 validity
// bytes, and at 1,024 x 1,024 a fixed ~4 us (launch, the first loads, the
// cluster merge).  16 or 4 warps per block and a three-way-min epilogue
// measured slower.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 30;        // the reference's clip value for "none"
constexpr int kWarps = 8;            // warps per block
constexpr int kRows = 32;            // queries per block: two 16-row tiles
constexpr int kSlices = 8;           // blocks per cluster: slices of the targets
constexpr int kIdxBits = 21;         // a key's slice-local target index
constexpr int kMaxChunk = (1 << kIdxBits) - 8;
constexpr int kInvalidPopc = 1024;   // popc(t) of an invalid target
constexpr unsigned kValidField = 512;  // key >> kIdxBits of a valid pair is <= this
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0),
        "r"(0));
}

// best-2 of unique keys: push one key, or merge another best-2 (ob <= os;
// the second smallest of the union is min(second, os, max(best, ob)))
__device__ __forceinline__ void push(unsigned& best, unsigned& second, unsigned k) {
  second = min(second, max(best, k));
  best = min(best, k);
}

template <typename K>
__device__ __forceinline__ void merge(K& best, K& second, K ob, K os) {
  second = min(min(second, os), max(best, ob));
  best = min(best, ob);
}

// A slice key of a row whose query has popcount pq -> (d << 32) | index.
__device__ __forceinline__ unsigned long long global_key(unsigned k, int pq, int t_begin) {
  const unsigned field = k >> kIdxBits;
  if (field > kValidField) return kNone;
  const unsigned d = field - 256u + (unsigned)pq;
  return ((unsigned long long)d << 32) | (unsigned)(t_begin + (int)(k & ((1u << kIdxBits) - 1)));
}

__global__ void __cluster_dims__(1, kSlices, 1) __launch_bounds__(kWarps * 32)
    top2_kernel(const uint32_t* __restrict__ q, const uint8_t* __restrict__ qv,
                const uint32_t* __restrict__ t, const uint8_t* __restrict__ tv, int Q, int T,
                int chunk, int* __restrict__ out_idx, int* __restrict__ out_best,
                int* __restrict__ out_sec) {
  __shared__ unsigned long long sh_warp[kWarps][kRows][2];
  __shared__ unsigned long long sh_block[kRows][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kRows;
  const int t_begin = blockIdx.y * chunk;
  const int t_end = min(T, t_begin + chunk);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + 7) / 8 : 0;

  // A fragments of rows g and g + 8 of both tiles, and their popcounts
  uint32_t a[2][4];
  int pq[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + m * 16 + h * 8 + g;
      const uint32_t* src = q + (size_t)row * 8 + 2 * tig;
      const uint32_t w0 = row < Q ? __ldg(src) : 0u, w1 = row < Q ? __ldg(src + 1) : 0u;
      a[m][h] = w0;
      a[m][h + 2] = w1;
      int p = __popc(w0) + __popc(w1);
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      pq[m][h] = p;
    }
  }

  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
  unsigned best[2][2], second[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) best[m][h] = second[m][h] = ~0u;

#pragma unroll 4
  for (int n = warp; n < n_tiles; n += kWarps) {
    const int col = t_begin + n * 8 + g;  // this lane's B column
    const uint32_t* src = t + (size_t)col * 8 + 2 * tig;
    const uint32_t b0 = col < t_end ? __ldg(src) : 0u, b1 = col < t_end ? __ldg(src + 1) : 0u;
    const int j = n * 8 + 2 * tig;        // this lane's C columns j, j + 1 (slice-local)
    const bool v0 = t_begin + j < t_end && __ldg(tv + t_begin + j);
    const bool v1 = t_begin + j + 1 < t_end && __ldg(tv + t_begin + j + 1);
    int pt[4];
    mma_and_popc(pt, ones, b0, b1);
    const unsigned k0 = ((unsigned)((v0 ? pt[0] : kInvalidPopc) + 256) << kIdxBits) | j;
    const unsigned k1 = ((unsigned)((v1 ? pt[1] : kInvalidPopc) + 256) << kIdxBits) | (j + 1);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      int acc[4];
      mma_and_popc(acc, a[m], b0, b1);
      push(best[m][0], second[m][0], k0 - ((unsigned)acc[0] << (kIdxBits + 1)));
      push(best[m][0], second[m][0], k1 - ((unsigned)acc[1] << (kIdxBits + 1)));
      push(best[m][1], second[m][1], k0 - ((unsigned)acc[2] << (kIdxBits + 1)));
      push(best[m][1], second[m][1], k1 - ((unsigned)acc[3] << (kIdxBits + 1)));
    }
  }

  // the 4 lanes of a row, then the 8 warps, then the 8 blocks of the cluster
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        merge(best[m][h], second[m][h], __shfl_xor_sync(0xffffffffu, best[m][h], o),
              __shfl_xor_sync(0xffffffffu, second[m][h], o));
      if (tig == 0) {
        const int row = m * 16 + h * 8 + g;
        sh_warp[warp][row][0] = global_key(best[m][h], pq[m][h], t_begin);
        sh_warp[warp][row][1] = global_key(second[m][h], pq[m][h], t_begin);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    unsigned long long b = kNone, s = kNone;
    for (int w = 0; w < kWarps; ++w) merge(b, s, sh_warp[w][threadIdx.x][0], sh_warp[w][threadIdx.x][1]);
    sh_block[threadIdx.x][0] = b;
    sh_block[threadIdx.x][1] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x < kRows) {
    unsigned long long b = kNone, s = kNone;
    for (int r = 0; r < kSlices; ++r) {
      const unsigned long long* other = cluster.map_shared_rank(&sh_block[threadIdx.x][0], r);
      merge(b, s, other[0], other[1]);
    }
    const int qi = q0 + threadIdx.x;
    if (qi < Q) {
      const bool ok = qv[qi] != 0;
      out_idx[qi] = ok && b != kNone ? (int)(unsigned)b : 0;
      out_best[qi] = ok && b != kNone ? (int)(b >> 32) : kBig;
      out_sec[qi] = ok && s != kNone ? (int)(s >> 32) : kBig;
    }
  }
  cluster.sync();  // the other blocks' shared memory stays until rank 0 has read it
}

}  // namespace

extern "C" {

const char* ccm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [Q,8] u32, qv [Q] u8, t [T,8] u32, tv [T] u8; kSlices slices of
// ``chunk`` targets (a multiple of 8, kSlices * chunk >= T); outputs
// idx/best/sec [Q].
int ccm_hamming_top2(const void* q, const void* qv, const void* t, const void* tv, int Q,
                     int T, int chunk, void* idx, void* best, void* sec, cudaStream_t stream) {
  if (Q <= 0 || T <= 0 || chunk <= 0 || chunk % 8 != 0 || chunk > kMaxChunk ||
      (long long)kSlices * chunk < T)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((Q + kRows - 1) / kRows, kSlices);
  top2_kernel<<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint8_t*>(qv),
      static_cast<const uint32_t*>(t), static_cast<const uint8_t*>(tv), Q, T, chunk,
      static_cast<int*>(idx), static_cast<int*>(best), static_cast<int*>(sec));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
