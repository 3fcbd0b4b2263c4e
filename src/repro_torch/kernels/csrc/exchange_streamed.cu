// Streamed all-in-one exchange (WPFed Eq. 3 + §3.5 + the distillation
// target) for Hopper (sm_90a).
//
// Replaces repro/kernels/exchange.py:fused_exchange_streamed
// (_streamed_stats_kernel and _target_kernel). Same contract as
// csrc/exchange.cu, but no block ever holds a whole C row or a whole
// client, so neither C nor N nor R is bounded by shared memory. The TPU
// kernel carries its online statistics across a sequential (R, C) grid
// in VMEM scratch; here three launches on one stream:
//   1. exchange_stats_kernel, one block per (client, neighbour, R block of
//      BR rows), one warp per (n, r) row: the warp walks C in strided
//      chunks, lanes along C (coalesced), with the online max and sum-exp
//      of the neighbour row and of the own row, the label logit, and the
//      §3.5 KL cross term b = sum_c exp(x_own - m_own) * (x_own - x_nb),
//      rescaled flash-style whenever a running max moves. Lanes merge by
//      shuffles; a lane that saw no column (C < 32) holds max -inf and
//      sums 0, and the merge of two -inf maxima is guarded, since
//      exp(-inf - (-inf)) is NaN. It writes the row's NLL
//      lse_nb - x_nb[y] and KL b / a_own - lse_own + lse_nb to (M, N, R)
//      scratch. M*N*ceil(R/BR) blocks fill the card even at M=8.
//   2. exchange_mask_kernel, one block per client: the means over R in a
//      fixed order (l_ij and the KL mean), the §3.5 upper-half mask in the
//      stable counting-rank form rank(n) = #{k: kl_k < kl_n} +
//      #{k < n: kl_k == kl_n} (or valid = sel without verification), and
//      the number of valid neighbours.
//   3. exchange_target_kernel, a grid over (client, tiles of R*C): target =
//      sum_n valid_n * nb[n] / max(count, 1), coalesced along C.
// No atomics: results are the same from run to run. The formulas are
// those of ref.streamed_exchange_ref; the sums run in another order, so
// they agree with it, and with ref.all_in_one_exchange_ref, to f32
// rounding.
//
// Bound on the H100: bytes, one read of the (M, N, R, C) neighbour and
// (M, R, C) own logits and one write of the (M, R, C) target. The kernel
// reads the neighbour logits twice (passes 1 and 3) and the own logits N
// times (once per neighbour row in pass 1, from L2 after the first).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BR = 8;                    // R rows per stats block
constexpr int STATS_THREADS = BR * 32;   // one warp per row
constexpr int MASK_THREADS = 256;
constexpr int TARGET_THREADS = 256;

// Merge the running (max, sum-exp) pair (m2, a2) into (m, a); `b`, a sum
// scaled like `a`, follows. Two empty pairs (max -inf) stay empty.
__device__ __forceinline__ void merge(float& m, float& a, float& b, float m2,
                                      float a2, float b2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;            // both empty: a = b = 0
  const float s1 = expf(m - mx), s2 = expf(m2 - mx);
  a = a * s1 + a2 * s2;
  b = b * s1 + b2 * s2;
  m = mx;
}

__global__ void __launch_bounds__(STATS_THREADS)
exchange_stats_kernel(const float* __restrict__ own,
                      const float* __restrict__ nb,
                      const int* __restrict__ y, int n, int r, int c,
                      int nrb, int lsh_verification,
                      float* __restrict__ nll_out,
                      float* __restrict__ kl_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long in = blockIdx.x / nrb;  // i * n + nn
  const int rr = (int)(blockIdx.x % nrb) * BR + warp;
  if (rr >= r) return;                    // the whole warp; no block sync
  const long long i = in / n;
  const float* x = nb + ((size_t)in * r + rr) * c;
  const float* o = own + ((size_t)i * r + rr) * c;
  const int label = y[(size_t)i * r + rr];

  float mn = -INFINITY, an = 0.0f, g = 0.0f;
  float mo = -INFINITY, ao = 0.0f, bx = 0.0f;
  for (int cc = lane; cc < c; cc += 32) {
    const float xn = x[cc];
    if (xn > mn) {
      an *= expf(mn - xn);
      mn = xn;
    }
    an += expf(xn - mn);
    if (cc == label) g = xn;
    if (lsh_verification) {
      const float xo = o[cc];
      if (xo > mo) {
        const float co = expf(mo - xo);
        ao *= co;
        bx *= co;
        mo = xo;
      }
      const float po = expf(xo - mo);
      ao += po;
      bx += po * (xo - xn);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    float unused = 0.0f;
    const float mn2 = __shfl_xor_sync(0xffffffffu, mn, off);
    const float an2 = __shfl_xor_sync(0xffffffffu, an, off);
    merge(mn, an, unused, mn2, an2, 0.0f);
    g += __shfl_xor_sync(0xffffffffu, g, off);  // one lane holds x[y]
    if (lsh_verification) {
      const float mo2 = __shfl_xor_sync(0xffffffffu, mo, off);
      const float ao2 = __shfl_xor_sync(0xffffffffu, ao, off);
      const float bx2 = __shfl_xor_sync(0xffffffffu, bx, off);
      merge(mo, ao, bx, mo2, ao2, bx2);
    }
  }
  if (lane == 0) {
    const size_t row = (size_t)in * r + rr;
    const float lse_nb = mn + logf(an);
    nll_out[row] = lse_nb - g;
    if (lsh_verification) {
      const float lse_own = mo + logf(ao);
      kl_out[row] = bx / ao - lse_own + lse_nb;
    }
  }
}

// kl_mean is written and read back by the same block, so it is neither
// const nor __restrict__ (no read-only-cache loads).
__global__ void __launch_bounds__(MASK_THREADS)
exchange_mask_kernel(const float* __restrict__ nll,
                     const float* __restrict__ kl,
                     const int* __restrict__ sel, int n, int r,
                     int lsh_verification, float* __restrict__ l_out,
                     float* kl_mean, int* __restrict__ valid_out,
                     int* __restrict__ count_out) {
  __shared__ int warp_count[MASK_THREADS / 32];
  const size_t i = blockIdx.x;
  const int* sel_i = sel + i * n;
  float* klm = kl_mean + i * n;
  for (int nn = threadIdx.x; nn < n; nn += MASK_THREADS) {
    const size_t row = (i * n + nn) * r;
    float sl = 0.0f, sk = 0.0f;
    for (int rr = 0; rr < r; ++rr) {
      sl += nll[row + rr];
      if (lsh_verification) sk += kl[row + rr];
    }
    l_out[i * n + nn] = sl / (float)r;
    klm[nn] = sk / (float)r;
  }
  __syncthreads();
  int n_valid = 0;
  if (lsh_verification)
    for (int k = 0; k < n; ++k) n_valid += sel_i[k] != 0;
  const int keep = (n_valid + 1) / 2;
  int local = 0;
  for (int nn = threadIdx.x; nn < n; nn += MASK_THREADS) {
    const bool selected = sel_i[nn] != 0;
    bool v = selected;
    if (lsh_verification) {
      const float kn = selected ? klm[nn] : INFINITY;
      int rank = 0;
      for (int k = 0; k < n; ++k) {
        const float kk = sel_i[k] != 0 ? klm[k] : INFINITY;
        rank += (kk < kn) || (kk == kn && k < nn);
      }
      v = selected && rank < keep;
    }
    valid_out[i * n + nn] = v;
    local += v;
  }
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_xor_sync(0xffffffffu, local, off);
  if ((threadIdx.x & 31) == 0) warp_count[threadIdx.x >> 5] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < MASK_THREADS / 32; ++k) total += warp_count[k];
    count_out[i] = total;
  }
}

__global__ void __launch_bounds__(TARGET_THREADS)
exchange_target_kernel(const float* __restrict__ nb,
                       const int* __restrict__ valid,
                       const int* __restrict__ count, int n, long long rc,
                       long long tiles, float* __restrict__ target_out) {
  const long long i = blockIdx.x / tiles;
  const long long e = (blockIdx.x % tiles) * TARGET_THREADS + threadIdx.x;
  if (e >= rc) return;
  const int* valid_i = valid + i * n;
  const float* nb_i = nb + (size_t)i * n * rc + e;
  float acc = 0.0f;
  for (int nn = 0; nn < n; ++nn)
    if (valid_i[nn]) acc += nb_i[(size_t)nn * rc];
  target_out[(size_t)i * rc + e] = acc / fmaxf((float)count[i], 1.0f);
}

}  // namespace

// own: (m, r, c) f32; nb: (m, n, r, c) f32; y: (m, r) int32 labels;
// sel: (m, n) int32 0/1; scratch nll_s, kl_s (m, n, r) f32 and klm_s
// (m, n) f32; outputs l_out (m, n) f32, valid_out (m, n) int32,
// target_out (m, r, c) f32, count_out (m,) int32 (valid neighbours).
// m, n, r, c >= 1. Returns the first launch error, or cudaGetLastError()
// after the three launches.
extern "C" int fused_exchange_streamed(
    const float* own, const float* nb, const int* y, const int* sel, int m,
    int n, int r, int c, int lsh_verification, float* nll_s, float* kl_s,
    float* klm_s, float* l_out, int* valid_out, float* target_out,
    int* count_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int nrb = (r + BR - 1) / BR;
  exchange_stats_kernel<<<(unsigned)((long long)m * n * nrb), STATS_THREADS,
                          0, s>>>(own, nb, y, n, r, c, nrb,
                                  lsh_verification, nll_s, kl_s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  exchange_mask_kernel<<<m, MASK_THREADS, 0, s>>>(
      nll_s, kl_s, sel, n, r, lsh_verification, l_out, klm_s, valid_out,
      count_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long rc = (long long)r * c;
  const long long tiles = (rc + TARGET_THREADS - 1) / TARGET_THREADS;
  exchange_target_kernel<<<(unsigned)(m * tiles), TARGET_THREADS, 0, s>>>(
      nb, valid_out, count_out, n, rc, tiles, target_out);
  return (int)cudaGetLastError();
}
