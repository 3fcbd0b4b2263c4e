// Fused all-in-one exchange (WPFed Eq. 3 + §3.5 + the distillation
// target) for Hopper (sm_90a).
//
// Replaces repro/kernels/exchange.py:fused_exchange (_exchange_kernel),
// which runs one grid step per client over its whole (N, R, C) slab in
// VMEM. In one launch it computes, per client i:
//   1. the log-softmax statistics of each own row r;
//   2. for each neighbour row (n, r): the shared neighbour log-softmax,
//      the Eq. 3 label NLL -logp_nb[y] and the §3.5 row KL
//      sum_c p_own * (logp_own - logp_nb);
//   3. l_ij and the KL as means over r, then the §3.5 upper-half mask in
//      the stable counting-rank form rank(n) = #{k: kl_k < kl_n} +
//      #{k < n: kl_k == kl_n}, or valid = sel when lsh_verification is
//      off;
//   4. target = sum_n valid_n * nb[n] / max(sum valid, 1), has_target.
// Each formula is the one of ref.all_in_one_exchange_ref, so the results
// agree with it to f32 rounding of the sums and the transcendentals.
//
// Bound on the H100: bytes, one read of the (M, N, R, C) neighbour and
// (M, R, C) own logits and one write of the target. At the main path's
// M=10, N=9, R=64, C=10 that is 0.3 MB (under a microsecond), so there
// the launch and the chain of dependent steps set the time; from M in
// the thousands (ANN federations, which "auto" also sends here) it is
// the bytes, and the per-client chain of steps that has to hide them.
//
// The design, against both:
// - A thread-block cluster of G <= 8 CTAs per client (G from the
//   wrapper's plan, `exchange.oneshot_plan`: 8 at small M, so M=10 runs
//   80 CTAs; 1 once M alone fills the card). CTA g owns the q
//   consecutive rows [g*q, g*q + q) of the client's flattened (n, r)
//   rows, a contiguous piece of the slab.
// - Where the client's rows and own logits fit in shared memory (the
//   plan's `staged`: 23 KB at N=9, R=64, C=10; 41 KB at N=16), each CTA
//   brings its piece in with one TMA bulk copy (cp.async.bulk on an
//   mbarrier; a plain copy when R*C % 4 != 0 leaves a piece off 16
//   bytes), and the statistics and the target read it from there: the
//   neighbour logits leave device memory once. Otherwise (e.g. C=1,024)
//   the rows are read from device memory, 16 bytes a load where
//   C % 4 == 0, by CTAs of 512 threads (256 when staged), and the target
//   reads them again through L2.
// - Lanes match C: a group of L lanes takes a row, with shuffles within
//   the group (L = the power of two >= C / 16, at most 32, doubled while
//   a CTA's rows would leave half its threads idle: 2 at the main shape,
//   72 rows a CTA; one lane a row, in fully unrolled loops, at C <= 16
//   and M >= 528). Own-row statistics are computed once per CTA for the
//   rows r its piece touches, never per neighbour row; when staged, the
//   own slab becomes logp_own and p_own in place, so a neighbour element
//   costs one expf.
// - Per-row NLL and KL stay in each CTA's shared memory. After a cluster
//   barrier every CTA forms the per-neighbour means of all N in a fixed
//   order (one warp per neighbour, lanes strided over r, then a shuffle
//   tree), reading the other CTAs' rows through distributed shared
//   memory, and the mask from them; CTA 0 writes l_ij, valid and
//   has_target. Each CTA then writes 1/G of the target, adding the valid
//   neighbours in n order (from the owners' shared memory when staged in
//   a cluster), and a last cluster barrier keeps every CTA's memory
//   alive until the cluster's reads are done.
// Every sum runs in one fixed order and nothing is atomic, so a launch
// gives the same bits every time; at the same lanes per row, staged and
// unstaged launches give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// threads of a CTA: staged, 256 (four CTAs of 54 KB a SM at N=16, R=64,
// C=10); unstaged, 512 (rows of 4 KB read from device memory want more
// loads in flight)
template <bool STAGED>
__host__ __device__ constexpr int threads() {
  return STAGED ? 256 : 512;
}
constexpr int MAX_CLUSTER = 8;
constexpr int HEAD = 4;   // floats before the arrays: the mbarrier (8 bytes)
constexpr int SMALL_C = 16;   // rows of at most this many take one lane

// Offsets, in floats, of the per-CTA arrays in dynamic shared memory;
// kernels/exchange.py:oneshot_layout_bytes mirrors `bytes`.
struct Layout {
  int slab, own_lpo, own_p, own_max, own_lse, nll, kl, klm, valid, bytes;
};

__host__ __device__ inline Layout layout(int n, int r, int c, int q,
                                         bool staged, bool lsh) {
  Layout L;
  int off = 0;
  if (staged) {
    off = HEAD;
    L.slab = off;
    off += q * c;
    L.own_lpo = off;
    off += lsh ? r * c : 0;
    L.own_p = off;
    off += lsh ? r * c : 0;
    L.own_max = L.own_lse = off;
  } else {
    L.slab = L.own_lpo = L.own_p = 0;
    L.own_max = off;
    off += r;
    L.own_lse = off;
    off += r;
  }
  L.nll = off;
  off += q;
  L.kl = off;
  off += q;
  L.klm = off;
  off += n;
  L.valid = off;
  off += n;
  L.bytes = 4 * off;
  return L;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Calls f(k) for this lane's elements k of a row of c: j, j + L, ...;
// with SMALL (one lane a row, c <= SMALL_C) fully unrolled, in the same
// order.
template <bool SMALL, typename F>
__device__ __forceinline__ void for_row(int c, int j, int lanes, F f) {
  if (SMALL) {
#pragma unroll
    for (int k = 0; k < SMALL_C; ++k)
      if (k < c) f(k);
  } else {
#pragma unroll 4
    for (int k = j; k < c; k += lanes) f(k);
  }
}

// Max and log-sum-exp of one row of c values (any memory), over the L
// lanes of a group: lane j takes elements j, j + L, ... (float4 groups
// of them when VEC). Every lane of the warp must call it.
template <bool VEC, bool SMALL>
__device__ __forceinline__ void row_stats(const float* x, int c, int j,
                                          int lanes, float& mx, float& ls) {
  mx = -INFINITY;
  if (VEC && !SMALL) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int k = j; k < c / 4; k += lanes) {
      const float4 v = x4[k];
      mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
  } else {
    for_row<SMALL>(c, j, lanes, [&](int k) { mx = fmaxf(mx, x[k]); });
  }
  mx = group_max(mx, lanes);
  float s = 0.0f;
  if (VEC && !SMALL) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll 4
    for (int k = j; k < c / 4; k += lanes) {
      const float4 v = x4[k];
      s += expf(v.x - mx);
      s += expf(v.y - mx);
      s += expf(v.z - mx);
      s += expf(v.w - mx);
    }
  } else {
    for_row<SMALL>(c, j, lanes, [&](int k) { s += expf(x[k] - mx); });
  }
  ls = logf(group_sum(s, lanes));
}

// One element's KL term: acc + p_own * (logp_own - logp_nb).
__device__ __forceinline__ float kl_term(float acc, float p, float lpo,
                                         float x, float mx, float ls) {
  return fmaf(p, lpo - ((x - mx) - ls), acc);
}

template <bool STAGED, bool VEC, bool SMALL>
__global__ void __launch_bounds__(threads<STAGED>())
fused_exchange_kernel(const float* __restrict__ own,
                      const float* __restrict__ nb,
                      const int* __restrict__ y, const int* __restrict__ sel,
                      int n, int r, int c, int q, int lanes, int tma,
                      int lsh_verification, float* __restrict__ l_out,
                      int* __restrict__ valid_out,
                      float* __restrict__ target_out,
                      int* __restrict__ has_out) {
  constexpr int THREADS = threads<STAGED>(), NWARPS = THREADS / 32;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const bool lsh = lsh_verification != 0;
  const Layout Lo = layout(n, r, c, q, STAGED, lsh);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t i = blockIdx.x / G;
  const int nr = n * r;
  const int row0 = g * q;
  const int rows = max(0, min(q, nr - row0));
  const size_t rc = (size_t)r * c;
  const float* own_i = own + i * rc;
  const float* nb_i = nb + i * (size_t)nr * c;
  const int* y_i = y + i * r;
  const int* sel_i = sel + i * n;
  float* slab = sm + Lo.slab;
  float* own_lpo = sm + Lo.own_lpo;
  float* own_p = sm + Lo.own_p;

  // 1. this CTA's rows and the own slab into shared memory; the
  // selection flags meanwhile
  int* valid_s = reinterpret_cast<int*>(sm + Lo.valid);
  for (int nn = tid; nn < n; nn += THREADS) valid_s[nn] = sel_i[nn] != 0;
  if (STAGED) {
    if (tma) {
      uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
      if (tid == 0) mbar_init(bar);
      __syncthreads();
      if (tid == 0) {
        const uint32_t nb_bytes = (uint32_t)rows * c * 4;
        const uint32_t own_bytes = lsh ? (uint32_t)rc * 4 : 0;
        mbar_expect(bar, nb_bytes + own_bytes);
        if (nb_bytes) bulk_copy(slab, nb_i + (size_t)row0 * c, nb_bytes, bar);
        if (own_bytes) bulk_copy(own_lpo, own_i, own_bytes, bar);
      }
      mbar_wait(bar, 0);
    } else {
      for (int k = tid; k < rows * c; k += THREADS)
        slab[k] = nb_i[(size_t)row0 * c + k];
      if (lsh)
        for (int k = tid; k < (int)rc; k += THREADS) own_lpo[k] = own_i[k];
      __syncthreads();
    }
  }

  const int per_warp = 32 / lanes;
  const int sub = lane / lanes, j = lane % lanes;

  // 2. own-row statistics, once per CTA, for the r its rows touch
  if (lsh) {
    const int r_first = row0 % r;
    for (int base = warp * per_warp; base < r; base += NWARPS * per_warp) {
      const int rr = base + sub;
      const bool touched =
          rr < r && (rows >= r || (rr - r_first + r) % r < rows);
      const int rs = rr < r ? rr : 0;
      const float* o = STAGED ? own_lpo + (size_t)rs * c : own_i + (size_t)rs * c;
      float om, ol;
      row_stats<VEC, SMALL>(o, c, j, lanes, om, ol);
      if (!touched) continue;       // after the group's shuffles
      if (STAGED) {   // each lane rewrites the elements it read
        float* lpo = own_lpo + (size_t)rr * c;
        float* p = own_p + (size_t)rr * c;
        if (VEC && !SMALL) {
          float4* l4 = reinterpret_cast<float4*>(lpo);
          float4* p4 = reinterpret_cast<float4*>(p);
          for (int k = j; k < c / 4; k += lanes) {
            float4 v = l4[k];
            v.x = (v.x - om) - ol;
            v.y = (v.y - om) - ol;
            v.z = (v.z - om) - ol;
            v.w = (v.w - om) - ol;
            l4[k] = v;
            p4[k] = make_float4(expf(v.x), expf(v.y), expf(v.z), expf(v.w));
          }
        } else {
          for_row<SMALL>(c, j, lanes, [&](int k) {
            const float v = (lpo[k] - om) - ol;
            lpo[k] = v;
            p[k] = expf(v);
          });
        }
      } else if (j == 0) {
        sm[Lo.own_max + rr] = om;
        sm[Lo.own_lse + rr] = ol;
      }
    }
    __syncthreads();
  }

  // 3. this CTA's neighbour rows: NLL and KL per row
  for (int base = warp * per_warp; base < rows; base += NWARPS * per_warp) {
    const int lr = base + sub;
    const bool active = lr < rows;
    const int lrs = active ? lr : 0;
    const int row = row0 + lrs, rr = row % r;
    const int label = y_i[rr];   // in flight while the row is reduced
    const float* x = STAGED ? slab + (size_t)lrs * c
                            : nb_i + (size_t)row * c;
    float mx, ls;
    row_stats<VEC, SMALL>(x, c, j, lanes, mx, ls);
    float acc = 0.0f;
    if (lsh) {
      if (STAGED) {
        const float* lpo = own_lpo + (size_t)rr * c;
        const float* p = own_p + (size_t)rr * c;
        if (VEC && !SMALL) {
          const float4* x4 = reinterpret_cast<const float4*>(x);
          const float4* l4 = reinterpret_cast<const float4*>(lpo);
          const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll 4
          for (int k = j; k < c / 4; k += lanes) {
            const float4 v = x4[k], lo = l4[k], pp = p4[k];
            acc = kl_term(acc, pp.x, lo.x, v.x, mx, ls);
            acc = kl_term(acc, pp.y, lo.y, v.y, mx, ls);
            acc = kl_term(acc, pp.z, lo.z, v.z, mx, ls);
            acc = kl_term(acc, pp.w, lo.w, v.w, mx, ls);
          }
        } else {
          for_row<SMALL>(c, j, lanes, [&](int k) {
            acc = kl_term(acc, p[k], lpo[k], x[k], mx, ls);
          });
        }
      } else {
        const float* o = own_i + (size_t)rr * c;
        const float om = sm[Lo.own_max + rr], ol = sm[Lo.own_lse + rr];
        if (VEC && !SMALL) {
          const float4* x4 = reinterpret_cast<const float4*>(x);
          const float4* o4 = reinterpret_cast<const float4*>(o);
#pragma unroll 4
          for (int k = j; k < c / 4; k += lanes) {
            const float4 v = x4[k], ov = o4[k];
            float lo = (ov.x - om) - ol;
            acc = kl_term(acc, expf(lo), lo, v.x, mx, ls);
            lo = (ov.y - om) - ol;
            acc = kl_term(acc, expf(lo), lo, v.y, mx, ls);
            lo = (ov.z - om) - ol;
            acc = kl_term(acc, expf(lo), lo, v.z, mx, ls);
            lo = (ov.w - om) - ol;
            acc = kl_term(acc, expf(lo), lo, v.w, mx, ls);
          }
        } else {
          for_row<SMALL>(c, j, lanes, [&](int k) {
            const float lo = (o[k] - om) - ol;
            acc = kl_term(acc, expf(lo), lo, x[k], mx, ls);
          });
        }
      }
      acc = group_sum(acc, lanes);
    }
    if (active && j == 0) {
      // as jnp.take_along_axis in fill mode: [-c, 0) wraps, any other
      // label outside [0, c) reads NaN (and so does that client's l_ij)
      const int lab = label < 0 ? label + c : label;
      sm[Lo.nll + lr] = (lab >= 0 && lab < c) ? -((x[lab] - mx) - ls) : NAN;
      sm[Lo.kl + lr] = acc;
    }
  }
  cluster.sync();

  // 4. per-neighbour means over r (every CTA, all n), reading each row
  // from the CTA that owns it
  float* klm = sm + Lo.klm;
  for (int nn = warp; nn < n; nn += NWARPS) {
    float sl = 0.0f, sk = 0.0f;
    for (int rr = lane; rr < r; rr += 32) {
      const int row = nn * r + rr;
      const int owner = G == 1 ? 0 : row / q;
      const float* rem = cluster.map_shared_rank(sm, owner);
      const int lr = row - owner * q;
      sl += rem[Lo.nll + lr];
      if (lsh) sk += rem[Lo.kl + lr];
    }
    sl = group_sum(sl, 32);
    sk = group_sum(sk, 32);
    if (lane == 0) {
      klm[nn] = sk / (float)r;
      if (g == 0) l_out[i * n + nn] = sl / (float)r;
    }
  }
  __syncthreads();

  // 5. the §3.5 mask (every CTA computes all of it)
  for (int nn = tid; nn < n; nn += THREADS)
    if (!valid_s[nn]) klm[nn] = INFINITY;
  int n_valid = 0;
  for (int b = 0; b < n; b += THREADS)          // also a block barrier
    n_valid += __syncthreads_count(b + tid < n && valid_s[b + tid]);
  if (lsh) {
    const int keep = (n_valid + 1) / 2;
    for (int nn = tid; nn < n; nn += THREADS) {
      const float kn = klm[nn];
      int rank = 0;
      for (int k = 0; k < n; ++k) {
        const float kk = klm[k];
        rank += (kk < kn) || (kk == kn && k < nn);
      }
      valid_s[nn] = valid_s[nn] && rank < keep;
    }
  }
  int count = 0;
  for (int b = 0; b < n; b += THREADS)
    count += __syncthreads_count(b + tid < n && valid_s[b + tid]);
  if (g == 0)
    for (int nn = tid; nn < n; nn += THREADS)
      valid_out[i * n + nn] = valid_s[nn];
  // the valid neighbours in n order, over klm (no longer read)
  int* list = reinterpret_cast<int*>(klm);
  if (warp == 0) {
    int at = 0;
    for (int b = 0; b < n; b += 32) {
      const bool v = b + lane < n && valid_s[b + lane];
      const unsigned ball = __ballot_sync(0xffffffffu, v);
      if (v) list[at + __popc(ball & ((1u << lane) - 1))] = b + lane;
      at += __popc(ball);
    }
  }
  __syncthreads();

  // 6. this CTA's share of the target, valid neighbours added in n order.
  // Unstaged, or staged in one CTA, neighbour n's element e lies at
  // n * R*C + e (16 bytes a load when R*C % 4 == 0); staged in a
  // cluster, row (n, r) lies in its owner's piece.
  const float denom = fmaxf((float)count, 1.0f);
  const int share = ((int)((rc + G - 1) / G) + 3) / 4 * 4;
  const int e0 = g * share, e1 = min((int)rc, e0 + share);
  float* t_i = target_out + i * rc;
  const float* flat = STAGED ? slab : nb_i;
  if ((!STAGED || G == 1) && rc % 4 == 0) {
    for (int e = e0 + 4 * tid; e < e1; e += 4 * THREADS) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int t = 0; t < count; ++t) {
        const float4 v =
            *reinterpret_cast<const float4*>(flat + list[t] * rc + e);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(t_i + e) =
          make_float4(acc.x / denom, acc.y / denom, acc.z / denom,
                      acc.w / denom);
    }
  } else if (!STAGED || G == 1) {
    for (int e = e0 + tid; e < e1; e += THREADS) {
      float acc = 0.0f;
#pragma unroll 4
      for (int t = 0; t < count; ++t) acc += flat[list[t] * rc + e];
      t_i[e] = acc / denom;
    }
  } else if (VEC) {
    for (int e = e0 + 4 * tid; e < e1; e += 4 * THREADS) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int rr = e / c, cc = e - rr * c;
#pragma unroll 4
      for (int t = 0; t < count; ++t) {
        const int row = list[t] * r + rr;
        const int owner = row / q;
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(slab, owner) +
            (size_t)(row - owner * q) * c + cc);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(t_i + e) =
          make_float4(acc.x / denom, acc.y / denom, acc.z / denom,
                      acc.w / denom);
    }
  } else {
    for (int e = e0 + tid; e < e1; e += THREADS) {
      float acc = 0.0f;
      const int rr = e / c, cc = e - rr * c;
#pragma unroll 4
      for (int t = 0; t < count; ++t) {
        const int row = list[t] * r + rr;
        const int owner = row / q;
        acc += cluster.map_shared_rank(slab, owner)[(size_t)(row - owner * q) *
                                                        c + cc];
      }
      t_i[e] = acc / denom;
    }
  }
  if (g == 0 && tid == 0) has_out[i] = count > 0;
  cluster.sync();   // no CTA leaves while another reads its memory
}

template <bool STAGED, bool VEC, bool SMALL>
cudaError_t launch(const float* own, const float* nb, const int* y,
                   const int* sel, int m, int n, int r, int c, int q,
                   int cluster, int lanes, int tma, int lsh, float* l_out,
                   int* valid_out, float* target_out, int* has_out,
                   size_t smem, cudaStream_t stream) {
  auto kernel = fused_exchange_kernel<STAGED, VEC, SMALL>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)m * cluster);
  cfg.blockDim = dim3(threads<STAGED>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, own, nb, y, sel, n, r, c, q, lanes,
                            tma, lsh, l_out, valid_out, target_out, has_out);
}

}  // namespace

// Dynamic shared memory of one CTA for the plan (q rows, staged or not).
extern "C" int fused_exchange_smem_bytes(int n, int r, int c, int q,
                                         int staged, int lsh_verification) {
  return layout(n, r, c, q, staged != 0, lsh_verification != 0).bytes;
}

// own: (m, r, c) f32; nb: (m, n, r, c) f32; y: (m, r) int32 labels;
// sel: (m, n) int32 0/1; outputs l_out (m, n) f32, valid_out (m, n) int32,
// target_out (m, r, c) f32, has_out (m,) int32. The plan
// (kernels/exchange.py:oneshot_plan): `cluster` CTAs per client, each
// owning q consecutive (n, r) rows (q a multiple of 4 when cluster > 1),
// `lanes` lanes per row (a power of two <= 32), `staged` 1 to hold the
// rows in shared memory. n <= 512; every pointer 16-byte aligned.
// Returns cudaGetLastError() after launching.
extern "C" int fused_exchange(const float* own, const float* nb,
                              const int* y, const int* sel, int m, int n,
                              int r, int c, int lsh_verification, int cluster,
                              int q, int lanes, int staged, float* l_out,
                              int* valid_out, float* target_out, int* has_out,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cluster < 1 || cluster > MAX_CLUSTER || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || (long long)cluster * q < (long long)n * r ||
      (cluster > 1 && q % 4))
    return (int)cudaErrorInvalidValue;
  const int lsh = lsh_verification != 0;
  const size_t smem = layout(n, r, c, q, staged != 0, lsh).bytes;
  const int tma = ((long long)r * c) % 4 == 0;
  const int key = (staged ? 4 : 0) + (c % 4 == 0 ? 2 : 0) +
                  (lanes == 1 && c <= SMALL_C ? 1 : 0);
  cudaError_t (*const launches[8])(
      const float*, const float*, const int*, const int*, int, int, int, int,
      int, int, int, int, int, float*, int*, float*, int*, size_t,
      cudaStream_t) = {launch<false, false, false>, launch<false, false, true>,
                       launch<false, true, false>,  launch<false, true, true>,
                       launch<true, false, false>,  launch<true, false, true>,
                       launch<true, true, false>,   launch<true, true, true>};
  err = launches[key](own, nb, y, sel, m, n, r, c, q, cluster, lanes, tma,
                      lsh, l_out, valid_out, target_out, has_out, smem,
                      (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
