// Probe of the tensor cores' 1-bit product on sm_90a, plain C interface.
//
// ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`` computes,
// for a 16 x 8 tile of (row, column) pairs, popc(a_row & b_col) over 256
// bits and adds it to a 32-bit sum.  ``hamming_top2``'s kernel
// (ccm_slam_tpu_torch/csrc/hamming_kernels.cu) builds its distances on it,
// so its bound is the rate of this instruction on the card:
//
//   ccm_mma_b1_tile   one warp, one instruction, with the fragment mapping
//                     the kernel uses (lane (g, tig) holds words 2 tig and
//                     2 tig + 1 of rows g and g + 8, and of column g): the
//                     tile out, to be checked against popcounts on the host;
//   ccm_mma_b1_loop   ``blocks`` blocks of 8 warps, each warp running
//                     ``iters`` rounds of kChains independent instructions
//                     (a chain adds into its own sum, so every instruction
//                     is kept); the caller times the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a [16, 8] words, b [8, 8] words (8 columns of 256 bits); d [16, 8].
__global__ void tile_kernel(const uint32_t* a, const uint32_t* b, int* d) {
  const int lane = threadIdx.x, g = lane >> 2, tig = lane & 3;
  const uint32_t frag[4] = {a[g * 8 + 2 * tig], a[(g + 8) * 8 + 2 * tig],
                            a[g * 8 + 2 * tig + 1], a[(g + 8) * 8 + 2 * tig + 1]};
  int acc[4] = {0, 0, 0, 0};
  mma_b1(acc, frag, b[g * 8 + 2 * tig], b[g * 8 + 2 * tig + 1]);
  d[g * 8 + 2 * tig] = acc[0];
  d[g * 8 + 2 * tig + 1] = acc[1];
  d[(g + 8) * 8 + 2 * tig] = acc[2];
  d[(g + 8) * 8 + 2 * tig + 1] = acc[3];
}

__global__ void loop_kernel(int iters, int* out) {
  const uint32_t seed = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t a[4] = {seed * 2654435761u, seed ^ 0x9e3779b9u, ~seed, seed << 7};
  uint32_t b0 = seed * 40503u, b1 = ~b0;
  int acc[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma_b1(acc[c], a, b0 + c, b1 ^ c);
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[seed] = s;
}

}  // namespace

extern "C" {

int ccm_mma_b1_tile(const void* a, const void* b, void* d, cudaStream_t stream) {
  tile_kernel<<<1, 32, 0, stream>>>(static_cast<const uint32_t*>(a),
                                    static_cast<const uint32_t*>(b), static_cast<int*>(d));
  return static_cast<int>(cudaGetLastError());
}

// out [blocks * 256] ints; instructions run: blocks * 8 warps * iters * kChains.
int ccm_mma_b1_loop(int blocks, int iters, void* out, cudaStream_t stream) {
  loop_kernel<<<blocks, 256, 0, stream>>>(iters, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

int ccm_mma_b1_chains() { return kChains; }

}  // extern "C"
