// All-pairs Hamming distance over packed LSH codes (WPFed Eq. 6) for
// Hopper (sm_90a).
//
// Replaces repro/kernels/hamming.py:hamming_all_pairs (_hamming_kernel):
// out[i, j] = sum_k popc(a[i, k] ^ b[j, k]) for a (M, W) and b (N, W)
// uint32 codes, out (M, N) int32. The TPU wrapper pads the word axis to
// 128 lanes and M, N to its tile grid; none of that carries over: any M,
// N and W are taken as they are.
//
// Bound on the H100 (SXM, 700 W): the M*N*4 output bytes (1.07 GB at
// M = N = 16,384, 0.32 ms) against M*N*W popcounts, which run at 16 per
// SM per clock on compute capability 9.0 (the CUDA programming guide's
// throughput table): 2.1e9 of them at M = 16,384, W = 8, about 0.5 ms.
//
// Two paths, picked by M*N in the C entry point (`hamming_path`):
// - small (M*N <= SMALL_MAX_OUTPUTS, the federation's M = 10): one thread
//   per output reads its two codes as uint4 (scalar words when W or the
//   base is not 16-byte aligned) and keeps XOR + popcount in registers;
//   no shared memory, no barrier.
// - tiled: a 64 x 64 output tile per block of 16 x 16 threads, each
//   thread a 4 x 4 register tile (rows 4 ty .., columns 4 tx ..). Both
//   tiles' codes are staged WC words at a time, word-major (a_s[q][row]),
//   so a thread reads its 4 rows and 4 columns of one word as two uint4
//   (a broadcast and consecutive 16-byte slots); staging covers only the
//   live rows and words (kw) and reads uint4 where aligned. Each thread
//   stores int4 rows (scalar ints at a ragged or unaligned edge).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SMALL_MAX_OUTPUTS = 4096;
constexpr int SMALL_THREADS = 128;
constexpr int TILE = 64;  // output rows and columns per block
constexpr int TT = 16;    // threads per block side: TT x TT threads
constexpr int WC = 32;    // code words staged per step

__device__ __forceinline__ int popc4(uint4 x, uint4 y) {
  return __popc(x.x ^ y.x) + __popc(x.y ^ y.y) + __popc(x.z ^ y.z) +
         __popc(x.w ^ y.w);
}

template <bool VEC>
__global__ void __launch_bounds__(SMALL_THREADS)
    hamming_small_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b, int m, int n, int w,
                         int* __restrict__ out) {
  const int idx = blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (idx >= m * n) return;
  const uint32_t* ra = a + (size_t)(idx / n) * w;
  const uint32_t* rb = b + (size_t)(idx % n) * w;
  int acc = 0;
  if (VEC) {
    for (int q = 0; q < w; q += 4)
      acc += popc4(__ldg(reinterpret_cast<const uint4*>(ra + q)),
                   __ldg(reinterpret_cast<const uint4*>(rb + q)));
  } else {
    for (int q = 0; q < w; ++q) acc += __popc(__ldg(ra + q) ^ __ldg(rb + q));
  }
  out[idx] = acc;
}

// the live rows [r0, min(r0 + TILE, rows)) of codes (rows, w), words
// [k0, k0 + kw), into dst[q][row]: words past kw are never read, and
// rows past `rows` are left alone (their outputs are never stored)
template <bool VEC>
__device__ __forceinline__ void stage(uint32_t (*dst)[TILE],
                                      const uint32_t* __restrict__ src,
                                      int rows, int r0, int w, int k0,
                                      int kw, int tid) {
  const int live = min(TILE, rows - r0);
  if (VEC) {  // w % 4 == 0, so kw % 4 == 0 as well
    for (int e = tid; e < live * (kw / 4); e += TT * TT) {
      const int r = e % live, q4 = e / live;
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * w + k0 + 4 * q4));
      dst[4 * q4][r] = x.x;
      dst[4 * q4 + 1][r] = x.y;
      dst[4 * q4 + 2][r] = x.z;
      dst[4 * q4 + 3][r] = x.w;
    }
  } else {
    for (int e = tid; e < live * kw; e += TT * TT) {
      const int r = e % live, q = e / live;
      dst[q][r] = __ldg(src + (size_t)(r0 + r) * w + k0 + q);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(TT* TT)
    hamming_tiled_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ b, int m, int n, int w,
                         int* __restrict__ out) {
  __shared__ __align__(16) uint32_t a_s[WC][TILE];
  __shared__ __align__(16) uint32_t b_s[WC][TILE];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TT + tx;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  int acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int k0 = 0; k0 < w; k0 += WC) {
    const int kw = min(WC, w - k0);
    __syncthreads();  // the last step's reads are done
    stage<VEC>(a_s, a, m, i0, w, k0, kw, tid);
    stage<VEC>(b_s, b, n, j0, w, k0, kw, tid);
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kw; ++q) {
      const uint4 ra = *reinterpret_cast<const uint4*>(&a_s[q][4 * ty]);
      const uint4 rb = *reinterpret_cast<const uint4*>(&b_s[q][4 * tx]);
      const uint32_t av[4] = {ra.x, ra.y, ra.z, ra.w};
      const uint32_t bv[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += __popc(av[r] ^ bv[c]);
    }
  }

  const int j = j0 + 4 * tx;
  if (j >= n) return;
  const bool vec_out = (n % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= m) break;
    int* row = out + (size_t)i * n;
    if (vec_out) {  // n % 4 == 0 and j < n: all four columns are live
      *reinterpret_cast<int4*>(row + j) =
          make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c < n) row[j + c] = acc[r][c];
    }
  }
}

}  // namespace

// The path a launch takes: 0 = small, 1 = tiled.
extern "C" int hamming_path(int m, int n) {
  return (long long)m * n <= SMALL_MAX_OUTPUTS ? 0 : 1;
}

// a: (m, w) and b: (n, w) uint32 bit patterns, out: (m, n) int32; m, n,
// w >= 1. Returns cudaGetLastError() after launching.
extern "C" int hamming_all_pairs(const void* a, const void* b, int m, int n,
                                 int w, int* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (hamming_path(m, n) == 0) {
    const int blocks = (m * n + SMALL_THREADS - 1) / SMALL_THREADS;
    if (vec)
      hamming_small_kernel<true><<<blocks, SMALL_THREADS, 0, s>>>(
          pa, pb, m, n, w, out);
    else
      hamming_small_kernel<false><<<blocks, SMALL_THREADS, 0, s>>>(
          pa, pb, m, n, w, out);
  } else {
    dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
    dim3 block(TT, TT);
    if (vec)
      hamming_tiled_kernel<true><<<grid, block, 0, s>>>(pa, pb, m, n, w, out);
    else
      hamming_tiled_kernel<false><<<grid, block, 0, s>>>(pa, pb, m, n, w,
                                                         out);
  }
  return (int)cudaGetLastError();
}
