// Streamed all-in-one exchange (WPFed Eq. 3 + §3.5 + the distillation
// target) for Hopper (sm_90a).
//
// Replaces repro/kernels/exchange.py:fused_exchange_streamed
// (_streamed_stats_kernel and _target_kernel). Same contract as
// csrc/exchange.cu, but no block ever holds a whole C row or a whole
// client, so neither C nor N nor R is bounded by shared memory. The TPU
// kernel carries online statistics across a sequential (R, C) grid in
// VMEM scratch; blocks here run in no order, so each writes partial
// statistics of its piece and a later launch merges them in a fixed
// order. Two to four launches on one stream (`exchange.streamed_plan`):
//   1. exchange_stats_kernel: one warp per (client, group of rows, C
//      chunk, group of neighbours). A row takes L lanes (a power of two,
//      L * E >= C for short rows: 4 lanes of 4 columns at C=10, 8 rows a
//      warp), a chunk is L * E columns (E = 16 from C = 512 on: 512-column
//      chunks, 16-byte loads where C % 4 == 0). The warp loads its
//      own-logit chunk once and keeps it in registers with
//      p = exp(x_own - m_own), m_own the chunk's maximum, then streams
//      its neighbours' chunks against it, the next one's loads issued
//      before this one is reduced. For each it takes the chunk maximum
//      first, then one expf per element (no rescaling as a maximum
//      moves): the partials (max, sum-exp, the §3.5 KL cross term
//      b = sum p * (x_own - x_nb) on m_own's scale, the label logit) go
//      to (M, N, R, chunks) scratch, and (m_own, sum p) to (M, R, chunks).
//      The neighbours are split over warps only while (client, rows,
//      chunk) warps leave the card short (9 groups of one at the main
//      shape, 720 warps); then each group re-reads the own chunk, from
//      L2. At C=100,352 one group: the own logits are read once, by
//      50,176 warps, not 2,048 warps each walking a row.
//   2. exchange_merge_kernel, only for rows of 16 chunks or more (C >=
//      8,192): one warp per (client, neighbour, r) row, lanes over its
//      chunks, into per-row NLL and KL.
//   3. exchange_mask_kernel, one block per client: each (n, r) row's
//      chunks merged in chunk order (flash-style: maxima first, then the
//      rescaled sums; or read from launch 2) into the row's NLL
//      lse_nb - x_nb[y] and KL b / a_own - lse_own + lse_nb; the means
//      over R in a fixed order (one warp per neighbour, lanes strided
//      over r, a shuffle tree); the §3.5 upper-half mask in the stable
//      counting-rank form rank(n) = #{k: kl_k < kl_n} + #{k < n: kl_k ==
//      kl_n} (or valid = sel without verification); the number of valid
//      neighbours; and, where R*C <= 4,096 (the main shape), the target.
//      It stays a launch of its own: folding it into launch 1 takes a
//      per-client arrival counter, zeroed before every call (one more
//      launch) or kept across calls.
//   4. exchange_target_kernel, where R*C > 4,096: a grid over (client,
//      tiles of 4,096 R*C elements): target = sum_n valid_n * nb[n] /
//      max(count, 1), the valid neighbours listed in n order first, then
//      read 16 bytes a load (R*C % 4 == 0), four float4s a thread and
//      four neighbours' loads in flight.
// No atomics, and every sum runs in one fixed order: results are the
// same from run to run. The formulas are those of
// ref.streamed_exchange_ref; the sums run in another order, so they
// agree with it, and with ref.all_in_one_exchange_ref, to f32 rounding.
//
// Bound on the H100: bytes, one read of the (M, N, R, C) neighbour and
// (M, R, C) own logits and one write of the (M, R, C) target. Launch 1
// reads the own logits once and the neighbour logits once; the target
// reads the valid neighbours' logits a second time. Two reads of the
// neighbour logits are the floor of any design that has the mask
// between the statistics and the target, where a client's logits do
// not fit on chip (8 MB per client at C=100,352, N=8, R=32): 0.55 ms
// there against the one-read bound of 0.307 ms (all neighbours valid;
// only the valid ones are read again here).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int STATS_THREADS = 128;       // four warps, four units
constexpr int MASK_THREADS = 256;
constexpr int TARGET_THREADS = 256;
constexpr int VPT = 4;                   // target float4s per thread
constexpr int TILE = 4 * VPT * TARGET_THREADS;  // target elements a block
constexpr int LIST = 1024;               // valid ids listed at a time
constexpr int FUSED_RC = TILE;           // targets the mask launch writes
constexpr int MERGE_CHUNKS = 16;         // chunks from which rows merge
                                         // in a launch of their own
static_assert(MASK_THREADS == TARGET_THREADS, "target_tile's block");

__device__ __forceinline__ float group_max(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The E columns of one lane in a chunk starting at col0: float4 groups
// j, j + L, ... when VEC, else single columns j, j + L, ...
template <int E, bool VEC>
__device__ __forceinline__ int column(int col0, int j, int lanes, int e) {
  return VEC ? col0 + 4 * (j + lanes * (e / 4)) + (e % 4)
             : col0 + j + lanes * e;
}

template <int E, bool VEC>
__device__ __forceinline__ void load_chunk(float (&v)[E], const float* row,
                                           int col0, int j, int lanes,
                                           int c) {
  if (VEC) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const int col = column<E, VEC>(col0, j, lanes, e);
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (col < c) x = *reinterpret_cast<const float4*>(row + col);
      v[e] = x.x;
      v[e + 1] = x.y;
      v[e + 2] = x.z;
      v[e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int col = column<E, VEC>(col0, j, lanes, e);
      v[e] = col < c ? row[col] : 0.0f;
    }
  }
}

template <int E, bool VEC>
__global__ void __launch_bounds__(STATS_THREADS)
exchange_stats_kernel(const float* __restrict__ own,
                      const float* __restrict__ nb,
                      const int* __restrict__ y, int n, int r, int c,
                      int lanes, int chunks, int row_groups, int groups,
                      int per_group, long long units, int lsh_verification,
                      float4* __restrict__ part,
                      float2* __restrict__ own_part) {
  const int lane = threadIdx.x & 31;
  const long long u =
      (long long)blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5);
  if (u >= units) return;                 // the whole warp; no block sync
  const int k = (int)(u % chunks);
  long long t = u / chunks;
  const int group = (int)(t % groups);
  t /= groups;
  const int rg = (int)(t % row_groups);
  const long long i = t / row_groups;
  const int n0 = group * per_group, n1 = min(n, n0 + per_group);
  const int sub = lane / lanes, j = lane % lanes;
  const int rr = rg * (32 / lanes) + sub;
  const bool active = rr < r;
  const int rs = active ? rr : 0;
  const int col0 = k * lanes * E;
  bool ok[E];
#pragma unroll
  for (int e = 0; e < E; ++e) ok[e] = column<E, VEC>(col0, j, lanes, e) < c;

  // the own chunk, once: p = exp(x_own - m_own) on the chunk's maximum
  float xo[E], p[E];
  if (lsh_verification) {
    load_chunk<E, VEC>(xo, own + ((size_t)i * r + rs) * c, col0, j, lanes,
                       c);
    float mo = -INFINITY;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e]) mo = fmaxf(mo, xo[e]);
    mo = group_max(mo, lanes);
    float ao = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      p[e] = ok[e] ? expf(xo[e] - mo) : 0.0f;
      ao += p[e];
    }
    ao = group_sum(ao, lanes);
    if (active && j == 0 && group == 0)
      own_part[((size_t)i * r + rr) * chunks + k] = make_float2(mo, ao);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) xo[e] = p[e] = 0.0f;
  }
  const int label = y[(size_t)i * r + rs];

  // the N neighbour chunks against it, the next one's loads in flight
  const size_t nb_row = (size_t)r * c;
  const float* x0 = nb + ((size_t)i * n * r + rs) * c;
  float xn[E], nx[E];
  load_chunk<E, VEC>(xn, x0 + (size_t)n0 * nb_row, col0, j, lanes, c);
  for (int nn = n0; nn < n1; ++nn) {
    if (nn + 1 < n1)
      load_chunk<E, VEC>(nx, x0 + (size_t)(nn + 1) * nb_row, col0, j, lanes,
                         c);
    float mn = -INFINITY;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (ok[e]) mn = fmaxf(mn, xn[e]);
    mn = group_max(mn, lanes);
    float an = 0.0f, b = 0.0f, g = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (ok[e]) an += expf(xn[e] - mn);
      b = fmaf(p[e], xo[e] - xn[e], b);
      if (column<E, VEC>(col0, j, lanes, e) == label) g = xn[e];
    }
    an = group_sum(an, lanes);
    b = group_sum(b, lanes);
    g = group_sum(g, lanes);             // one lane at most holds x[y]
    if (active && j == 0)
      part[(((size_t)i * n + nn) * r + rr) * chunks + k] =
          make_float4(mn, an, b, g);
#pragma unroll
    for (int e = 0; e < E; ++e) xn[e] = nx[e];
  }
}

// One row's chunk partials merged in a fixed order (flash-style: the
// maxima first, then the rescaled sums): its NLL lse_nb - x_nb[y] and,
// with verification, its KL b / a_own - lse_own + lse_nb. A group of
// `lanes` lanes shares the row, lane k0 taking chunks k0, k0 + lanes, ...
// (one lane: chunk order); every lane of the warp must call it.
__device__ __forceinline__ void merge_row(const float4* pr, const float2* po,
                                          int chunks, bool lsh, int k0,
                                          int lanes, float& nll, float& kl) {
  float mn = -INFINITY;
  for (int k = k0; k < chunks; k += lanes) mn = fmaxf(mn, pr[k].x);
  mn = group_max(mn, lanes);
  float an = 0.0f, g = 0.0f;
  for (int k = k0; k < chunks; k += lanes) {
    const float4 v = pr[k];
    an += v.y * expf(v.x - mn);
    g += v.w;
  }
  const float lse_nb = mn + logf(group_sum(an, lanes));
  nll = lse_nb - group_sum(g, lanes);
  kl = 0.0f;
  if (lsh) {
    float mo = -INFINITY;
    for (int k = k0; k < chunks; k += lanes) mo = fmaxf(mo, po[k].x);
    mo = group_max(mo, lanes);
    float ao = 0.0f, b = 0.0f;
    for (int k = k0; k < chunks; k += lanes) {
      const float s = expf(po[k].x - mo);
      ao += po[k].y * s;
      b += pr[k].z * s;
    }
    ao = group_sum(ao, lanes);
    kl = group_sum(b, lanes) / ao - (mo + logf(ao)) + lse_nb;
  }
}

// Rows of many chunks (C >= MERGE_CHUNKS * 512): one warp per (client,
// neighbour, r) row, lanes strided over its chunks, into (m, n, r)
// NLL and KL scratch.
__global__ void __launch_bounds__(MASK_THREADS)
exchange_merge_kernel(const float4* __restrict__ part,
                      const float2* __restrict__ own_part, int n, int r,
                      int chunks, long long rows, int lsh_verification,
                      float* __restrict__ nll_s, float* __restrict__ kl_s) {
  const long long row =
      (long long)blockIdx.x * (MASK_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;               // the whole warp; no block sync
  const long long i = row / ((long long)n * r);
  const int rr = (int)(row % r);
  float nll, kl;
  merge_row(part + row * chunks, own_part + (i * r + rr) * chunks, chunks,
            lsh_verification != 0, threadIdx.x & 31, 32, nll, kl);
  if ((threadIdx.x & 31) == 0) {
    nll_s[row] = nll;
    kl_s[row] = kl;
  }
}

// The target of client i over [e0, e0 + TILE): sum_n valid_n * nb[n] /
// max(count, 1), the valid neighbours listed in n order LIST at a time,
// then read: VPT float4 a thread (16 bytes a load when VEC, else 4 * VPT
// strided floats), four neighbours' loads in flight. Every thread of the
// block calls it.
template <bool VEC>
__device__ __forceinline__ void target_tile(const float* nb_i,
                                            const int* valid_i, int n,
                                            long long rc, long long e0,
                                            int count, int* list,
                                            int& listed, float* t_i) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[4 * VPT];
#pragma unroll
  for (int w = 0; w < 4 * VPT; ++w) acc[w] = 0.0f;
  // element w of this thread: VEC, 4 consecutive ones per float4
  auto elem = [&](int w) -> long long {
    return VEC ? e0 + 4 * (tid + (long long)TARGET_THREADS * (w / 4)) + w % 4
               : e0 + tid + (long long)TARGET_THREADS * w;
  };
  for (int b0 = 0; b0 < n; b0 += LIST) {
    if (warp == 0) {
      int at = 0;
      for (int b = b0; b < min(n, b0 + LIST); b += 32) {
        const bool v = b + lane < n && valid_i[b + lane];
        const unsigned ball = __ballot_sync(0xffffffffu, v);
        if (v) list[at + __popc(ball & ((1u << lane) - 1))] = b + lane;
        at += __popc(ball);
      }
      if (lane == 0) listed = at;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < listed; ++t) {
      const float* x = nb_i + (size_t)list[t] * rc;
#pragma unroll
      for (int w = 0; w < 4 * VPT; w += VEC ? 4 : 1) {
        const long long e = elem(w);
        if (VEC) {
          if (e < rc) {
            const float4 v = *reinterpret_cast<const float4*>(x + e);
            acc[w] += v.x;
            acc[w + 1] += v.y;
            acc[w + 2] += v.z;
            acc[w + 3] += v.w;
          }
        } else if (e < rc) {
          acc[w] += x[e];
        }
      }
    }
    __syncthreads();
  }
  const float denom = fmaxf((float)count, 1.0f);
#pragma unroll
  for (int w = 0; w < 4 * VPT; w += VEC ? 4 : 1) {
    const long long e = elem(w);
    if (VEC) {
      if (e < rc)
        *reinterpret_cast<float4*>(t_i + e) =
            make_float4(acc[w] / denom, acc[w + 1] / denom,
                        acc[w + 2] / denom, acc[w + 3] / denom);
    } else if (e < rc) {
      t_i[e] = acc[w] / denom;
    }
  }
}

// kl_mean (m, n) and valid (m, n) are written and read back by the same
// block past LIST neighbours (else it keeps them in shared memory), so
// they are neither const nor __restrict__ (no read-only-cache loads).
// With `fused` (R*C of at most FUSED_RC) the block also writes its
// client's target.
template <bool VEC>
__global__ void __launch_bounds__(MASK_THREADS)
exchange_mask_kernel(const float4* __restrict__ part,
                     const float2* __restrict__ own_part,
                     const int* __restrict__ sel,
                     const float* __restrict__ nb, int n, int r, int c,
                     int chunks, int lsh_verification, int fused,
                     const float* __restrict__ nll_s,
                     const float* __restrict__ kl_s,
                     float* __restrict__ l_out, float* kl_mean, int* valid,
                     int* __restrict__ count_out,
                     float* __restrict__ target_out) {
  __shared__ int list[LIST];
  __shared__ int listed;
  __shared__ float klm_s[LIST];
  __shared__ int valid_s[LIST];
  const size_t i = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* sel_i = sel + i * n;
  // per-neighbour KL means and flags in shared memory up to LIST slots
  const bool small = n <= LIST;
  float* klm = small ? klm_s : kl_mean + i * n;
  int* flags = small ? valid_s : valid + i * n;
  const bool lsh = lsh_verification != 0;

  // 1. means over r: one warp per neighbour, lanes strided over r, each
  // lane merging its rows' chunks (or reading them, merged by
  // exchange_merge_kernel), then a shuffle tree
  for (int nn = warp; nn < n; nn += MASK_THREADS / 32) {
    const size_t row = (i * n + nn) * r;
    float sl = 0.0f, sk = 0.0f;
    for (int rr = lane; rr < r; rr += 32) {
      float nll, kl;
      if (chunks >= MERGE_CHUNKS) {
        nll = nll_s[row + rr];
        kl = kl_s[row + rr];
      } else {
        merge_row(part + (row + rr) * chunks,
                  own_part + (i * r + rr) * chunks, chunks, lsh, 0, 1, nll,
                  kl);
      }
      sl += nll;
      sk += kl;
    }
    sl = group_sum(sl, 32);
    sk = group_sum(sk, 32);
    if (lane == 0) {
      l_out[i * n + nn] = sl / (float)r;
      klm[nn] = sel_i[nn] != 0 ? sk / (float)r : INFINITY;
    }
  }
  int n_valid = 0;
  for (int b = 0; b < n; b += MASK_THREADS)     // also a block barrier
    n_valid += __syncthreads_count(b + tid < n && sel_i[b + tid] != 0);

  // 2. the §3.5 mask and the number of valid neighbours
  const int keep = (n_valid + 1) / 2;
  int count = 0;
  for (int b = 0; b < n; b += MASK_THREADS) {
    const int nn = b + tid;
    bool v = false;
    if (nn < n) {
      v = sel_i[nn] != 0;
      if (lsh) {
        const float kn = klm[nn];
        int rank = 0;
        for (int k = 0; k < n; ++k) {
          const float kk = klm[k];
          rank += (kk < kn) || (kk == kn && k < nn);
        }
        v = v && rank < keep;
      }
      flags[nn] = v;
      valid[i * n + nn] = v;
    }
    count += __syncthreads_count(v);
  }
  if (tid == 0) count_out[i] = count;

  // 3. the small client's target, in this launch
  if (fused) {
    const long long rc = (long long)r * c;
    for (long long e0 = 0; e0 < rc; e0 += TILE)
      target_tile<VEC>(nb + i * n * rc, flags, n, rc, e0, count, list,
                       listed, target_out + i * rc);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(TARGET_THREADS)
exchange_target_kernel(const float* __restrict__ nb,
                       const int* __restrict__ valid,
                       const int* __restrict__ count, int n, long long rc,
                       long long tiles, float* __restrict__ target_out) {
  __shared__ int list[LIST];
  __shared__ int listed;
  const long long i = blockIdx.x / tiles;
  target_tile<VEC>(nb + (size_t)i * n * rc, valid + i * n, n, rc,
                   (blockIdx.x % tiles) * TILE, count[i], list, listed,
                   target_out + (size_t)i * rc);
}

template <int E, bool VEC>
cudaError_t launch_stats(const float* own, const float* nb, const int* y,
                         int n, int r, int c, int lanes, int chunks,
                         int row_groups, int groups, int per_group,
                         long long units, int lsh, float4* part,
                         float2* own_part, cudaStream_t s) {
  const long long blocks = (units + STATS_THREADS / 32 - 1) /
                           (STATS_THREADS / 32);
  exchange_stats_kernel<E, VEC><<<(unsigned)blocks, STATS_THREADS, 0, s>>>(
      own, nb, y, n, r, c, lanes, chunks, row_groups, groups, per_group,
      units, lsh, part, own_part);
  return cudaGetLastError();
}

// Launches 2 and 3 (3 only when the target is not fused into 2).
template <bool VEC>
cudaError_t launch_mask_target(const float4* part, const float2* own_part,
                               const int* sel, const float* nb, int m, int n,
                               int r, int c, int chunks, int lsh, int fused,
                               float* nll_s, float* kl_s, float* l_out,
                               float* klm_s, int* valid_out, int* count_out,
                               float* target_out, cudaStream_t s) {
  cudaError_t err;
  if (chunks >= MERGE_CHUNKS) {
    const long long rows = (long long)m * n * r;
    const long long blocks = (rows + MASK_THREADS / 32 - 1) /
                             (MASK_THREADS / 32);
    exchange_merge_kernel<<<(unsigned)blocks, MASK_THREADS, 0, s>>>(
        part, own_part, n, r, chunks, rows, lsh, nll_s, kl_s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  exchange_mask_kernel<VEC><<<m, MASK_THREADS, 0, s>>>(
      part, own_part, sel, nb, n, r, c, chunks, lsh, fused, nll_s, kl_s,
      l_out, klm_s, valid_out, count_out, target_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || fused) return err;
  const long long rc = (long long)r * c;
  const long long tiles = (rc + TILE - 1) / TILE;
  exchange_target_kernel<VEC><<<(unsigned)(m * tiles), TARGET_THREADS, 0,
                                s>>>(nb, valid_out, count_out, n, rc, tiles,
                                     target_out);
  return cudaGetLastError();
}

}  // namespace

// own: (m, r, c) f32; nb: (m, n, r, c) f32; y: (m, r) int32 labels;
// sel: (m, n) int32 0/1. The plan (kernels/exchange.py:streamed_plan):
// `lanes` lanes per row (a power of two <= 32), `elems` columns per lane
// and chunk (4 or 16), `chunks` = ceil(c / (lanes * elems)), `groups`
// of `per_group` neighbours a warp, `fused` 1 to write the target in the
// mask launch (r * c <= FUSED_RC). Scratch: part (m, n, r, chunks)
// float4, own_part (m, r, chunks) float2, nll_s and kl_s (m, n, r) f32
// (read only when chunks >= MERGE_CHUNKS) and klm_s (m, n) f32. Outputs
// l_out (m, n) f32, valid_out (m, n) int32, target_out (m, r, c) f32,
// count_out (m,) int32 (valid neighbours). m, n, r, c >= 1; every
// pointer 16-byte aligned. Returns the first launch error, or
// cudaGetLastError() after the last launch.
extern "C" int fused_exchange_streamed(
    const float* own, const float* nb, const int* y, const int* sel, int m,
    int n, int r, int c, int lsh_verification, int lanes, int elems,
    int chunks, int groups, int per_group, int fused, float4* part,
    float2* own_part, float* nll_s, float* kl_s, float* klm_s, float* l_out,
    int* valid_out, float* target_out, int* count_out, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      (elems != 4 && elems != 16) ||
      (long long)chunks * lanes * elems < c ||
      (long long)(chunks - 1) * lanes * elems >= c || groups < 1 ||
      per_group < 1 || (long long)groups * per_group < n ||
      (long long)(groups - 1) * per_group >= n ||
      (fused && (long long)r * c > FUSED_RC))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int row_groups = (r + 32 / lanes - 1) / (32 / lanes);
  const long long units = (long long)m * row_groups * chunks * groups;
  const bool vec = c % 4 == 0;
  const int lsh = lsh_verification != 0;
  if (elems == 16)
    err = vec ? launch_stats<16, true>(own, nb, y, n, r, c, lanes, chunks,
                                       row_groups, groups, per_group, units,
                                       lsh, part, own_part, s)
              : launch_stats<16, false>(own, nb, y, n, r, c, lanes, chunks,
                                        row_groups, groups, per_group, units,
                                        lsh, part, own_part, s);
  else
    err = vec ? launch_stats<4, true>(own, nb, y, n, r, c, lanes, chunks,
                                      row_groups, groups, per_group, units,
                                      lsh, part, own_part, s)
              : launch_stats<4, false>(own, nb, y, n, r, c, lanes, chunks,
                                       row_groups, groups, per_group, units,
                                       lsh, part, own_part, s);
  if (err != cudaSuccess) return (int)err;
  // the target reads flat R*C runs: 16 bytes a load when R*C % 4 == 0
  const bool vec_t = ((long long)r * c) % 4 == 0;
  err = vec_t ? launch_mask_target<true>(part, own_part, sel, nb, m, n, r, c,
                                         chunks, lsh, fused, nll_s, kl_s,
                                         l_out, klm_s, valid_out, count_out,
                                         target_out, s)
              : launch_mask_target<false>(part, own_part, sel, nb, m, n, r,
                                          c, chunks, lsh, fused, nll_s, kl_s,
                                          l_out, klm_s, valid_out, count_out,
                                          target_out, s);
  return (int)err;
}
