// Fused peer selection (WPFed Eq. 6-8 + top-N) for Hopper (sm_90a).
//
// Replaces repro/kernels/selection.py:fused_select (_select_kernel). Per
// client row i: Hamming distances d_ij to every code by XOR + __popc over
// the W packed words (exact integers, as the TPU kernel's +-1 Gram is),
// weights w_ij = s_j * LUT[d_ij] with the Table-3 switches, self and
// out-of-range columns at -inf, then the top N weights by repeated
// first-max knockout: the largest weight, ties to the smallest id, as
// jax.lax.top_k breaks them. The LUT is the (W*32+1)-entry table
// exp(-gamma * d / bits) built once by the wrapper and shared with the
// plain version, so weights are identical to it bit for bit; the kernel
// calls no exp of its own.
//
// Bound on the H100: it reads M*W*4 bytes of codes and M*4 of scores and
// does M*M*W XOR+popcount pairs; at the main path's M=10, W=8 both are far
// below a microsecond and the time is launch latency. At M ~ 10^3 the
// M*M*W integer operations and the N block-wide reductions per row
// dominate. One block per row keeps the row's M weights in shared memory
// (M*5 bytes), so no (M, M) array reaches device memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NONE = 0x7fffffff;  // "no candidate" index

// (v1, i1) ranks before (v2, i2): larger weight, then smaller id.
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  if (i1 == NONE) return false;
  if (i2 == NONE) return true;
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__global__ void __launch_bounds__(THREADS)
fused_select_kernel(const uint32_t* __restrict__ codes,
                    const float* __restrict__ scores,
                    const float* __restrict__ lut, int m, int w, int nsel,
                    int use_lsh, int use_rank, int* __restrict__ ids_out,
                    float* __restrict__ w_out) {
  extern __shared__ float wrow[];                       // m weights
  unsigned char* taken = reinterpret_cast<unsigned char*>(wrow + m);
  __shared__ float red_v[THREADS / 32];
  __shared__ int red_i[THREADS / 32];

  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* a = codes + (size_t)i * w;

  for (int j = threadIdx.x; j < m; j += THREADS) {
    float v;
    if (j == i) {
      v = -INFINITY;
    } else {
      v = use_rank ? scores[j] : 1.0f;
      if (use_lsh) {
        const uint32_t* b = codes + (size_t)j * w;
        int d = 0;
        for (int k = 0; k < w; ++k) d += __popc(a[k] ^ b[k]);
        v = v * lut[d];
      }
    }
    wrow[j] = v;
    taken[j] = 0;
  }
  __syncthreads();

  for (int t = 0; t < nsel; ++t) {
    float bv = -INFINITY;
    int bi = NONE;
    for (int j = threadIdx.x; j < m; j += THREADS) {
      if (!taken[j] && before(wrow[j], j, bv, bi)) {
        bv = wrow[j];
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 1; k < THREADS / 32; ++k) {
        if (before(red_v[k], red_i[k], bv, bi)) {
          bv = red_v[k];
          bi = red_i[k];
        }
      }
      ids_out[(size_t)i * nsel + t] = bi;
      w_out[(size_t)i * nsel + t] = bv;
      if (bi != NONE) taken[bi] = 1;
    }
    __syncthreads();
  }
}

}  // namespace

// codes: (m, w) uint32 bit patterns; scores: (m,) f32; lut: (w*32+1,) f32;
// ids_out: (m, nsel) int32; w_out: (m, nsel) f32; 1 <= nsel <= m - 1.
// Returns cudaGetLastError() after launching.
extern "C" int fused_select(const void* codes, const float* scores,
                            const float* lut, int m, int w, int nsel,
                            int use_lsh, int use_rank, int* ids_out,
                            float* w_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)m * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_select_kernel<<<m, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(codes), scores, lut, m, w, nsel, use_lsh,
      use_rank, ids_out, w_out);
  return (int)cudaGetLastError();
}
