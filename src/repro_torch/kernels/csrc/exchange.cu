// Fused all-in-one exchange (WPFed Eq. 3 + §3.5 + the distillation
// target) for Hopper (sm_90a).
//
// Replaces repro/kernels/exchange.py:fused_exchange (_exchange_kernel).
// One block per client i, in one launch:
//   1. the log-softmax statistics (max, log-sum-exp) of each own row r;
//   2. for each neighbour row (n, r): the shared neighbour log-softmax,
//      the Eq. 3 label NLL -logp_nb[y], and the §3.5 row KL
//      sum_c p_own * (logp_own - logp_nb);
//   3. l_ij and the KL as means over r (fixed order), then the §3.5
//      upper-half mask in the stable counting-rank form
//      rank(n) = #{k: kl_k < kl_n} + #{k < n: kl_k == kl_n}, or
//      valid = sel when lsh_verification is off;
//   4. target = sum_n valid_n * nb[n] / max(sum valid, 1), has_target.
// Each formula is the one of ref.all_in_one_exchange_ref, so the results
// agree with it to f32 rounding of the sums and the transcendentals.
//
// Bound on the H100: bytes. It must read the (M, N, R, C) neighbour
// logits and the (M, R, C) own logits and write the (M, R, C) target:
// at the main path's M=10, N=9, R=64, C=10 that is about 0.3 MB, well
// under a microsecond at 3.35 TB/s, so the time is launch latency and the
// short per-client block. The design reads each neighbour row with one
// warp (lanes along C, coalesced) and keeps every per-row statistic in
// shared memory, so nothing but the four outputs is written. With one
// block per client the card is far from full at small M; a split over
// (n, r) rows across blocks is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
fused_exchange_kernel(const float* __restrict__ own,
                      const float* __restrict__ nb,
                      const int* __restrict__ y, const int* __restrict__ sel,
                      int n, int r, int c, int lsh_verification,
                      float* __restrict__ l_out, int* __restrict__ valid_out,
                      float* __restrict__ target_out,
                      int* __restrict__ has_out) {
  extern __shared__ float sm[];
  float* own_max = sm;              // r
  float* own_lse = own_max + r;     // r: log sum exp(o - max)
  float* nll = own_lse + r;         // n * r
  float* klr = nll + n * r;         // n * r
  float* kl_mean = klr + n * r;     // n
  int* valid_s = reinterpret_cast<int*>(kl_mean + n);  // n

  const int i = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = THREADS / 32;
  const float* own_i = own + (size_t)i * r * c;
  const float* nb_i = nb + (size_t)i * n * r * c;

  // 1. own-row log-softmax statistics
  if (lsh_verification) {
    for (int row = warp; row < r; row += nwarps) {
      const float* o = own_i + (size_t)row * c;
      float mx = -INFINITY;
      for (int cc = lane; cc < c; cc += 32) mx = fmaxf(mx, o[cc]);
      mx = warp_max(mx);
      float s = 0.0f;
      for (int cc = lane; cc < c; cc += 32) s += expf(o[cc] - mx);
      s = warp_sum(s);
      if (lane == 0) {
        own_max[row] = mx;
        own_lse[row] = logf(s);
      }
    }
  }
  __syncthreads();

  // 2. one warp per neighbour row (n, r)
  for (int row = warp; row < n * r; row += nwarps) {
    const int rr = row % r;
    const float* x = nb_i + (size_t)row * c;
    float mx = -INFINITY;
    for (int cc = lane; cc < c; cc += 32) mx = fmaxf(mx, x[cc]);
    mx = warp_max(mx);
    float s = 0.0f;
    for (int cc = lane; cc < c; cc += 32) s += expf(x[cc] - mx);
    const float ls = logf(warp_sum(s));
    if (lane == 0) {
      int label = y[(size_t)i * r + rr];
      label = label < 0 ? 0 : (label >= c ? c - 1 : label);  // stay in row
      nll[row] = -((x[label] - mx) - ls);
    }
    if (lsh_verification) {
      const float* o = own_i + (size_t)rr * c;
      const float om = own_max[rr], ol = own_lse[rr];
      float acc = 0.0f;
      for (int cc = lane; cc < c; cc += 32) {
        const float lpo = (o[cc] - om) - ol;
        const float lpn = (x[cc] - mx) - ls;
        acc += expf(lpo) * (lpo - lpn);
      }
      acc = warp_sum(acc);
      if (lane == 0) klr[row] = acc;
    }
  }
  __syncthreads();

  // 3. means over r, then the §3.5 mask
  if (threadIdx.x < n) {
    const int nn = threadIdx.x;
    float sl = 0.0f, sk = 0.0f;
    for (int rr = 0; rr < r; ++rr) {
      sl += nll[nn * r + rr];
      sk += klr[nn * r + rr];
    }
    l_out[(size_t)i * n + nn] = sl / (float)r;
    kl_mean[nn] = sk / (float)r;
  }
  __syncthreads();
  if (threadIdx.x < n) {
    const int nn = threadIdx.x;
    const int* sel_i = sel + (size_t)i * n;
    const bool selected = sel_i[nn] != 0;
    bool v = selected;
    if (lsh_verification) {
      int n_valid = 0;
      for (int k = 0; k < n; ++k) n_valid += sel_i[k] != 0;
      const int keep = (n_valid + 1) / 2;
      const float kn = selected ? kl_mean[nn] : INFINITY;
      int rank = 0;
      for (int k = 0; k < n; ++k) {
        const float kk = sel_i[k] != 0 ? kl_mean[k] : INFINITY;
        rank += (kk < kn) || (kk == kn && k < nn);
      }
      v = selected && rank < keep;
    }
    valid_s[nn] = v;
    valid_out[(size_t)i * n + nn] = v;
  }
  __syncthreads();

  // 4. masked distillation-target mean
  int count = 0;
  for (int k = 0; k < n; ++k) count += valid_s[k];
  const float denom = fmaxf((float)count, 1.0f);
  for (int e = threadIdx.x; e < r * c; e += THREADS) {
    float acc = 0.0f;
    for (int nn = 0; nn < n; ++nn)
      if (valid_s[nn]) acc += nb_i[(size_t)nn * r * c + e];
    target_out[(size_t)i * r * c + e] = acc / denom;
  }
  if (threadIdx.x == 0) has_out[i] = count > 0;
}

}  // namespace

// own: (m, r, c) f32; nb: (m, n, r, c) f32; y: (m, r) int32 labels;
// sel: (m, n) int32 0/1; outputs l_out (m, n) f32, valid_out (m, n) int32,
// target_out (m, r, c) f32, has_out (m,) int32; n <= 512.
// Returns cudaGetLastError() after launching.
extern "C" int fused_exchange(const float* own, const float* nb,
                              const int* y, const int* sel, int m, int n,
                              int r, int c, int lsh_verification,
                              float* l_out, int* valid_out,
                              float* target_out, int* has_out, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(2 * r + 2 * n * r + 2 * n) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_exchange_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_exchange_kernel<<<m, THREADS, smem, (cudaStream_t)stream>>>(
      own, nb, y, sel, n, r, c, lsh_verification, l_out, valid_out,
      target_out, has_out);
  return (int)cudaGetLastError();
}
