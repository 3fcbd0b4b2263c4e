// All-pairs Hamming distance over packed LSH codes (WPFed Eq. 6) for
// Hopper (sm_90a).
//
// Replaces repro/kernels/hamming.py:hamming_all_pairs (_hamming_kernel):
// out[i, j] = sum_k popc(a[i, k] ^ b[j, k]) for a (M, W) and b (N, W)
// uint32 codes, out (M, N) int32. The TPU wrapper pads the word axis to
// 128 lanes and M, N to its tile grid; none of that carries over: any M,
// N and W are taken as they are.
//
// Bound on the H100: the M*N*4 output bytes (1.07 GB at M=N=16,384, about
// 0.32 ms), against about 3*M*N*W integer operations (XOR, popcount, add).
// Each block computes a TILE x TILE output tile: both tiles' codes are
// staged in shared memory WC words at a time (so W is unbounded), each
// thread computes TILE / ROWS outputs of one column, and a warp's 32
// threads store 32 consecutive int32 of one output row (coalesced).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;   // output rows and columns per block
constexpr int ROWS = 8;    // thread rows per block: TILE x ROWS threads
constexpr int WC = 32;     // code words staged per step

__global__ void __launch_bounds__(TILE * ROWS)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int m, int n, int w, int* __restrict__ out) {
  // a_s is read as a broadcast (one row per warp); b_s is read down a
  // column by 32 lanes, padded by one word so they hit distinct banks.
  __shared__ uint32_t a_s[TILE][WC];
  __shared__ uint32_t b_s[TILE][WC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int tid = ty * TILE + tx;
  int acc[TILE / ROWS];
#pragma unroll
  for (int r = 0; r < TILE / ROWS; ++r) acc[r] = 0;

  for (int k0 = 0; k0 < w; k0 += WC) {
    const int kw = min(WC, w - k0);
    __syncthreads();
    for (int e = tid; e < TILE * WC; e += TILE * ROWS) {
      const int r = e / WC, q = e % WC;
      const bool ok = q < kw;
      a_s[r][q] = (ok && i0 + r < m) ? a[(size_t)(i0 + r) * w + k0 + q] : 0u;
      b_s[r][q] = (ok && j0 + r < n) ? b[(size_t)(j0 + r) * w + k0 + q] : 0u;
    }
    __syncthreads();
    for (int q = 0; q < kw; ++q) {
      const uint32_t bv = b_s[tx][q];
#pragma unroll
      for (int r = 0; r < TILE / ROWS; ++r)
        acc[r] += __popc(a_s[ty + r * ROWS][q] ^ bv);
    }
  }
  const int j = j0 + tx;
  if (j >= n) return;
#pragma unroll
  for (int r = 0; r < TILE / ROWS; ++r) {
    const int i = i0 + ty + r * ROWS;
    if (i < m) out[(size_t)i * n + j] = acc[r];
  }
}

}  // namespace

// a: (m, w) and b: (n, w) uint32 bit patterns, out: (m, n) int32; m, n,
// w >= 1. Returns cudaGetLastError() after launching.
extern "C" int hamming_all_pairs(const void* a, const void* b, int m, int n,
                                 int w, int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  dim3 block(TILE, ROWS);
  hamming_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), m, n,
      w, out);
  return (int)cudaGetLastError();
}
