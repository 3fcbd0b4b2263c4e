// Batched and single-client LSH projection (WPFed Eq. 5) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/lsh_projection.py:lsh_project_sums_batched
// (_lsh_batched_kernel): sums[m, j] = sum_p x[m, p] * R[p, j], with R the
// +-1 Rademacher matrix that is never stored: R[p, j] depends only on
// (p, j, seed) through the uint32 hash of rademacher_block, so each thread
// regenerates its entries in registers.
//
// Bound on the H100: M*P*4 bytes of x over 3.35 TB/s, or 2*M*P*bits f32
// operations over the 67 TFLOP/s of the f32 pipes, plus ~8 integer
// operations of hash per (p, j) that all M rows share. At M=10, P=421,888,
// bits=256 the f32 operations dominate (about 32 us) over the bytes
// (about 5 us). The design therefore spends nothing on R's bytes and
// shares each hash across TM client rows held in registers; the sums stay
// strict f32 FMAs (no TF32, no tensor cores), because a rounding change
// near zero flips a code bit.
//
// Grid: (P / CHUNK, ceil(M / TM), ceil(bits / TB)). Block (s, t, z) sums
// the CHUNK parameters of split s for rows [t*TM, t*TM+TM) and bits
// [z*TB, z*TB+TB), one thread per bit, and writes its partial sums to
// partial[s, m, j]. A second kernel adds the splits in a fixed order, so
// the result is the same from run to run (atomics would add in a varying
// order and could flip near-zero sums, and with them code bits).
//
// The single-client entry point (lsh_project_sums) replaces
// repro/kernels/lsh_projection.py:lsh_project_sums (_lsh_kernel): the same
// kernel with TM = 1, so no thread carries 15 dead rows. Its grid is
// (P / CHUNK, 1, bits / TB), 206 blocks at P=421,888. Each thread adds
// its split's products in the order the batched kernel does, and the
// splits are reduced in the same order, so its sums equal the batched
// kernel's row bit for bit. Unshared, the hash now costs about 8 integer
// operations per multiply-add: at P=421,888, bits=256 its bound is the
// hash's 0.86 G integer operations, about 52 us, against 3.2 us for the
// 2*P*bits f32 operations alone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t K1 = 2654435761u;
constexpr uint32_t K2 = 40503u;
constexpr uint32_t K3 = 2246822519u;
constexpr int CHUNK = 2048;  // parameters per split (P is padded to it)
constexpr int SUB = 256;     // parameters staged in shared memory at once
constexpr int TM = 16;       // client rows per block (batched)
constexpr int TB = 256;      // bits per block = threads per block

__device__ __forceinline__ float rademacher(uint32_t p, uint32_t cj) {
  // rademacher_block: h = (i*K1) ^ ((j*K2) + seed*K3); cj holds the
  // right-hand operand, which depends on the bit alone.
  uint32_t h = (p * K1) ^ cj;
  h ^= h >> 15;
  h *= K3;
  h ^= h >> 13;
  return ((h >> 9) & 1u) ? -1.0f : 1.0f;
}

template <int RM>  // client rows per block
__global__ void __launch_bounds__(TB)
lsh_partial_kernel(const float* __restrict__ x, int m, long long p_total,
                   int bits, uint32_t seed, float* __restrict__ partial) {
  __shared__ __align__(16) float xs[SUB][RM];
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * RM;
  const int j = blockIdx.z * TB + threadIdx.x;
  const uint32_t cj = (uint32_t)j * K2 + seed * K3;
  const long long p_begin = (long long)split * CHUNK;

  float acc[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) acc[t] = 0.0f;

  for (int s = 0; s < CHUNK; s += SUB) {
    __syncthreads();
    // stage x[m0:m0+RM, p_begin+s : +SUB] as xs[pp][t]; reads run along p
    for (int idx = threadIdx.x; idx < SUB * RM; idx += TB) {
      const int t = idx / SUB, pp = idx % SUB;
      const int row = m0 + t;
      xs[pp][t] = row < m ? x[(long long)row * p_total + p_begin + s + pp]
                          : 0.0f;
    }
    __syncthreads();
    if (j < bits) {
      for (int pp = 0; pp < SUB; ++pp) {
        const float r = rademacher((uint32_t)(p_begin + s + pp), cj);
        if constexpr (RM % 4 == 0) {
          const float4* xv = reinterpret_cast<const float4*>(xs[pp]);
#pragma unroll
          for (int q = 0; q < RM / 4; ++q) {
            const float4 v = xv[q];
            acc[4 * q + 0] = fmaf(r, v.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(r, v.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(r, v.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(r, v.w, acc[4 * q + 3]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < RM; ++t) acc[t] = fmaf(r, xs[pp][t], acc[t]);
        }
      }
    }
  }
  if (j < bits) {
#pragma unroll
    for (int t = 0; t < RM; ++t) {
      if (m0 + t < m)
        partial[((long long)split * m + m0 + t) * bits + j] = acc[t];
    }
  }
}

__global__ void lsh_reduce_kernel(const float* __restrict__ partial,
                                  int splits, int m, int bits,
                                  float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)m * bits;
  if (idx >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s += partial[(long long)k * n + idx];
  out[idx] = s;
}

template <int RM>
int launch(const float* x, int m, long long p, int bits, unsigned int seed,
           float* partial, float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const int splits = (int)(p / CHUNK);
  dim3 grid(splits, (m + RM - 1) / RM, (bits + TB - 1) / TB);
  lsh_partial_kernel<RM><<<grid, TB, 0, st>>>(x, m, p, bits, seed, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)m * bits;
  const int threads = 256;
  lsh_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                      st>>>(partial, splits, m, bits, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (m, p) f32 contiguous, p % 2048 == 0; partial: (p/2048, m, bits) f32
// scratch; out: (m, bits) f32. Returns cudaGetLastError() after launching.
extern "C" int lsh_project_sums_batched(const float* x, int m, long long p,
                                        int bits, unsigned int seed,
                                        float* partial, float* out,
                                        int device, void* stream) {
  return launch<TM>(x, m, p, bits, seed, partial, out, device, stream);
}

// One client: x: (p,) f32, p % 2048 == 0; partial: (p/2048, bits) f32
// scratch; out: (bits,) f32. Returns cudaGetLastError() after launching.
extern "C" int lsh_project_sums(const float* x, long long p, int bits,
                                unsigned int seed, float* partial, float* out,
                                int device, void* stream) {
  return launch<1>(x, 1, p, bits, seed, partial, out, device, stream);
}
