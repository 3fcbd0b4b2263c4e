// Batched and single-client LSH projection (WPFed Eq. 5) for Hopper
// (sm_90a).
//
// Replaces repro/kernels/lsh_projection.py:lsh_project_sums_batched
// (_lsh_batched_kernel) and repro/kernels/lsh_projection.py:
// lsh_project_sums (_lsh_kernel): sums[m, j] = sum_p x[m, p] * R[p, j],
// with R the +-1 Rademacher matrix that is never stored: R[p, j] depends
// only on (p, j, seed) through the uint32 hash of rademacher_block, so the
// kernel regenerates its entries on the chip.
//
// The invariant. Every sum sums[m, j] is computed the same way. P is cut
// into S = P / L consecutive splits of length L. Within a split one f32
// chain runs acc = fmaf(r, x, acc) from 0.0f in increasing p; the splits
// are then added in the fixed order k = 0..S-1 in f64, starting from 0.0,
// and the f64 total is rounded to f32 once. (An f32 running total over
// S = 511,513 splits of 2,048, a quarter of Minitron-4B, drifted 1e-5
// from the exact sum, ten times the plain version's error; in f64 only
// the splits' own f32 chains round.) L is
// chosen by the caller from P alone (lsh_projection.py:split_len), never
// from M, bits or the tiling, so any row of the batched kernel equals the
// single-client kernel's sums bit for bit, at any M, and the result is the
// same from run to run. No atomics, no TF32, no tensor cores, no fast-math
// and no flush-to-zero: a rounding change near zero flips a code bit.
// Because r = +-1, r * x is exact and fmaf rounds as acc + r * x does, so
// the plain-tensor twin ref.lsh_project_sums_split_order reproduces the
// kernel bit for bit.
//
// The split plan (in the wrapper): L is the largest of 128, 256, ...,
// 2048 that still gives one split per SM (P / L >= 132), else 128. So
// P = 4,096 runs 32 splits of 128 and P >= 270,336 (mnist: 421,888) runs
// splits of 2,048. The row and bit tilings below never change a sum's
// order, so they follow the shape freely. Grid axis x is the split.
//
// Three instances of the partial kernel, picked here from (M, bits, S):
// * single row (M = 1): one thread per bit, TB bits per block;
// * few rows (2 <= M < 64): one thread per bit with TM in {4, 8, 16}
//   rows in registers, the hash computed per thread and shared by its TM
//   rows. TM is the largest (at most M rounded up to the set) whose grid
//   holds >= 2 * 132 warps.
//   Both stage x in shared memory as xs[TM][128], double-buffered by
//   cp.async so the next 128 parameters load while these are summed, and
//   read it as float4 broadcasts (TM * 4 KB). TB in {32, ..., 256} is the
//   largest that divides bits and leaves >= 3 * 132 blocks, else 32. The
//   factor 3 was tuned on two shapes only, in experiments not kept in the
//   repository: it picks TB = 128 at M = 10, P = 421,888 and at M = 35,
//   P = 12,288, which ran faster there than the TB = 64 that 4 * 132
//   picks at the first and the TB = 256 that 2 * 132 picks at the second.
// * many rows (M >= 64): a register-tiled outer product. A 256-thread
//   block owns 128 rows x 128 bits, each thread an 8 x 8 tile of
//   accumulators. Per step of 32 parameters the block hashes the 32 x 128
//   tile of R once into shared memory as +-1.0f (16 KB) and stages the
//   32 x 128 tile of x transposed to [p][m] (16 KB; float4 groups
//   XOR-swizzled by p so the transposed stores hit 32 banks); each thread
//   then reads 2 float4 of x and 2 of r per p and issues 64 FMAs. Two
//   blocks share an SM (at most 128 registers), so one block's staging
//   runs under the other's FMAs.
// A second kernel (lsh_reduce_kernel) adds the S partial sums of each
// output in order k = 0..S-1 in f64: a block copies up to 128 splits of 32
// outputs into shared memory at once (cp.async) and one warp adds them.
//
// Bound on the H100: M*P*4 bytes of x over 3.35 TB/s, or the larger of
// 2*M*P*bits f32 operations over the 67 TFLOP/s of the f32 pipes and the
// hash's integer-pipe instructions per (p, j) over the int32 rate: 5 in
// this file's sm_90a code (3 LOP3 and 2 SHF, as `cuobjdump -sass` of the
// built library shows: p * K1 becomes an add and h * K3 an IMAD, both on
// the FMA pipe, and the last shift, xor and bit test fuse into one LOP3).
// One client's sums (single row) are bound by the hash: at P = 421,888,
// bits = 256 about 32 us against 3.2 us of f32 work. At M >= 64 the f32
// work binds,
// and the many-row instance spends 64 of about 72 issue slots per p on
// FMAs; the single/few-row instances spend TM of about TM + 8 + TM / 4.
// The partial buffer (S, M, bits) adds S*M*bits*4 bytes written and read
// once: bits / L times x's own bytes (2x at L = 128, bits = 256). The
// wrapper keeps it within 512 MiB by launching a large batch as groups of
// rows (lsh_projection.py:row_groups); a group is an ordinary launch here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t K1 = 2654435761u;
constexpr uint32_t K2 = 40503u;
constexpr uint32_t K3 = 2246822519u;
// streaming multiprocessors of the H100; lsh_projection.py:NUM_SMS, which
// fixes the split length, is the same count (a test holds them equal)
constexpr int SMS = 132;
constexpr int SUB = 128;       // parameters staged at once (single / few)
constexpr int BM = 128;        // many rows: rows per block
constexpr int BJ = 128;        // many rows: bits per block
constexpr int TS = 32;         // many rows: parameters per step
constexpr int NT = 256;        // many rows: threads per block
constexpr int MANY_MIN_M = 64;

enum Instance { SINGLE = 0, FEW = 1, MANY = 2 };

__device__ __forceinline__ float rademacher(uint32_t p, uint32_t cj) {
  // rademacher_block: h = (i*K1) ^ ((j*K2) + seed*K3); cj holds the
  // right-hand operand, which depends on the bit alone.
  uint32_t h = (p * K1) ^ cj;
  h ^= h >> 15;
  h *= K3;
  h ^= h >> 13;
  return ((h >> 9) & 1u) ? -1.0f : 1.0f;
}

// Asynchronous 16-byte copy global -> shared (cp.async); with valid ==
// false it reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Single and few rows: block (s, t, z) sums split s for rows
// [t*RM, t*RM+RM) and bits [z*TB, z*TB+TB), one thread per bit (TB
// divides bits).
template <int RM, int TB>
__global__ void __launch_bounds__(TB)
lsh_partial_kernel(const float* __restrict__ x, int m, long long p_total,
                   int chunk, int bits, uint32_t seed, uint32_t i0,
                   float* __restrict__ partial) {
  __shared__ __align__(16) float xs[2][RM][SUB];   // double-buffered
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * RM;
  const int j = blockIdx.z * TB + threadIdx.x;
  const uint32_t cj = (uint32_t)j * K2 + seed * K3;
  const long long p_begin = (long long)split * chunk;
  // x[m0:m0+RM, p_begin+s : +SUB] -> xs[buf], float4 along p
  auto stage = [&](int buf, int s) {
    for (int idx = threadIdx.x; idx < RM * SUB / 4; idx += TB) {
      const int t = idx / (SUB / 4), q = idx % (SUB / 4);
      const bool ok = m0 + t < m;
      cp_async16(&xs[buf][t][4 * q],
                 ok ? x + (long long)(m0 + t) * p_total + p_begin + s + 4 * q
                    : x,
                 ok);
    }
    cp_async_commit();
  };

  float acc[RM];
#pragma unroll
  for (int t = 0; t < RM; ++t) acc[t] = 0.0f;

  stage(0, 0);
  int buf = 0;
  for (int s = 0; s < chunk; s += SUB, buf ^= 1) {
    // the next step's x is in flight while this one is summed
    if (s + SUB < chunk) stage(buf ^ 1, s + SUB);
    else cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const uint32_t p0 = (uint32_t)(p_begin + s) + i0;   // wraps mod 2^32
#pragma unroll 4
    for (int pp = 0; pp < SUB; pp += 4) {
      const float r0 = rademacher(p0 + pp + 0, cj);
      const float r1 = rademacher(p0 + pp + 1, cj);
      const float r2 = rademacher(p0 + pp + 2, cj);
      const float r3 = rademacher(p0 + pp + 3, cj);
#pragma unroll
      for (int t = 0; t < RM; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(&xs[buf][t][pp]);
        acc[t] = fmaf(r0, v.x, acc[t]);
        acc[t] = fmaf(r1, v.y, acc[t]);
        acc[t] = fmaf(r2, v.z, acc[t]);
        acc[t] = fmaf(r3, v.w, acc[t]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < RM; ++t) {
    if (m0 + t < m)
      partial[((long long)split * m + m0 + t) * bits + j] = acc[t];
  }
}

// Many rows: block (s, t, z) sums split s for rows [t*BM, t*BM+BM) and
// bits [z*BJ, z*BJ+BJ). Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and bits {4tx..4tx+3, 64+4tx..64+4tx+3}
// of the tile.
__global__ void __launch_bounds__(NT, 2)
lsh_partial_many_kernel(const float* __restrict__ x, int m,
                        long long p_total, int chunk, int bits,
                        uint32_t seed, uint32_t i0,
                        float* __restrict__ partial) {
  // xs[p * BM + 4 * (g ^ ((p >> 2) & 7)) + e] = x[m0 + 4g + e, p]
  __shared__ __align__(16) float xs[TS * BM];
  __shared__ __align__(16) float rs[TS][BJ];   // R[p, j0 + j] as +-1.0f
  const int split = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int j0 = blockIdx.z * BJ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p_begin = (long long)split * chunk;
  // R tile: this thread hashes bit j0 + gj at parameters gp, gp + 2, ...
  const int gj = tid % BJ, gp = tid / BJ;
  const uint32_t cj = (uint32_t)(j0 + gj) * K2 + seed * K3;
  // x tile: this thread loads 4 parameters 4xq..4xq+3 of rows xr + 32k
  const int xq = tid % 8, xr = tid / 8;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0f;

  for (int s = 0; s < chunk; s += TS) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BM / 32; ++k) {
      const int row = xr + 32 * k;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + row < m)
        v = *reinterpret_cast<const float4*>(
            x + (long long)(m0 + row) * p_total + p_begin + s + 4 * xq);
      // (p >> 2) & 7 == xq for p = 4xq + e
      float* dst = xs + 4 * xq * BM + 4 * ((row >> 2) ^ xq) + (row & 3);
      dst[0 * BM] = v.x;
      dst[1 * BM] = v.y;
      dst[2 * BM] = v.z;
      dst[3 * BM] = v.w;
    }
    const uint32_t p0 = (uint32_t)(p_begin + s) + i0;   // wraps mod 2^32
#pragma unroll
    for (int k = 0; k < TS / 2; ++k) {
      const int pp = gp + 2 * k;
      rs[pp][gj] = rademacher(p0 + pp, cj);
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < TS; ++pp) {
      const int sw = (pp >> 2) & 7;
      const float4 a0 = *reinterpret_cast<const float4*>(
          &xs[pp * BM + 4 * (ty ^ sw)]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &xs[pp * BM + 4 * ((16 + ty) ^ sw)]);
      const float4 b0 = *reinterpret_cast<const float4*>(&rs[pp][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&rs[pp][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[i][jj] = fmaf(b[jj], a[i], acc[i][jj]);
    }
  }
  // bits % 32 == 0 and j0 % 128 == 0: a float4 group is all in or all out
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= m) continue;
    float* dst = partial + ((long long)split * m + row) * bits;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = j0 + 64 * h + 4 * tx;
      if (col < bits)
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(acc[i][4 * h + 0], acc[i][4 * h + 1],
                        acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// out[i] = sum over k = 0..S-1, in order and in f64, of partial[k, i],
// rounded to f32 once. A block
// owns RW = 32 outputs. Its 256 threads copy up to RK = 128 splits of them
// into shared memory with cp.async (16 bytes each, all in flight at
// once), then its first warp adds them in order, one output per lane. So
// S splits cost about S / RK round trips to memory, and small outputs
// still spread over n / 32 blocks.
constexpr int RT = 256;            // threads per reduce block
constexpr int RW = 32;             // outputs per reduce block
constexpr int RK = 128;            // splits staged per round (16 KB)
constexpr int RROWS = RT / (RW / 4);   // split rows one pass copies

__global__ void __launch_bounds__(RT)
lsh_reduce_kernel(const float* __restrict__ partial, int splits, long long n,
                  float* __restrict__ out) {
  __shared__ __align__(16) float ps[RK][RW];
  const int t = threadIdx.x;
  const long long i0 = (long long)blockIdx.x * RW;
  const int c4 = t % (RW / 4), r0 = t / (RW / 4);
  const bool col_ok = i0 + 4 * c4 < n;      // n % 4 == 0
  double s = 0.0;
  for (int k0 = 0; k0 < splits; k0 += RK) {
    const int kc = splits - k0 < RK ? splits - k0 : RK;
#pragma unroll
    for (int q = 0; q < RK / RROWS; ++q) {
      const int k = r0 + q * RROWS;
      const bool ok = col_ok && k < kc;
      cp_async16(&ps[k][4 * c4],
                 ok ? partial + (long long)(k0 + k) * n + i0 + 4 * c4
                    : partial,
                 ok);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (t < RW) {
#pragma unroll 8
      for (int k = 0; k < kc; ++k) s += (double)ps[k][t];
    }
    __syncthreads();
  }
  if (t < RW && i0 + t < n) out[i0 + t] = (float)s;
}

struct Plan {
  int instance, tm, tb;
};

Plan make_plan(int m, long long splits, int bits) {
  Plan pl{m == 1 ? SINGLE : (m < MANY_MIN_M ? FEW : MANY), 1, 32};
  if (pl.instance == MANY) {
    pl.tm = BM;
    pl.tb = BJ;
    return pl;
  }
  if (pl.instance == FEW) {
    const int cap = m <= 4 ? 4 : (m <= 8 ? 8 : 16);
    pl.tm = 4;
    for (int tm = cap; tm > 4; tm /= 2) {
      if (splits * ((m + tm - 1) / tm) * (bits / 32) >= 2 * SMS) {
        pl.tm = tm;
        break;
      }
    }
  }
  const long long row_tiles = (m + pl.tm - 1) / pl.tm;
  for (int tb = 256; tb > 32; tb /= 2) {
    if (bits % tb == 0 && splits * row_tiles * (bits / tb) >= 3 * SMS) {
      pl.tb = tb;
      break;
    }
  }
  return pl;
}

template <int RM, int TB>
void launch_rows(const float* x, int m, long long p, int chunk, int bits,
                 uint32_t seed, uint32_t i0, float* partial,
                 cudaStream_t st) {
  dim3 grid((unsigned)(p / chunk), (m + RM - 1) / RM, (bits + TB - 1) / TB);
  lsh_partial_kernel<RM, TB><<<grid, TB, 0, st>>>(x, m, p, chunk, bits,
                                                   seed, i0, partial);
}

template <int RM>
void launch_tb(int tb, const float* x, int m, long long p, int chunk,
               int bits, uint32_t seed, uint32_t i0, float* partial,
               cudaStream_t st) {
  switch (tb) {
    case 256: return launch_rows<RM, 256>(x, m, p, chunk, bits, seed, i0,
                                          partial, st);
    case 128: return launch_rows<RM, 128>(x, m, p, chunk, bits, seed, i0,
                                          partial, st);
    case 64: return launch_rows<RM, 64>(x, m, p, chunk, bits, seed, i0,
                                        partial, st);
    default: return launch_rows<RM, 32>(x, m, p, chunk, bits, seed, i0,
                                        partial, st);
  }
}

int launch(const float* x, int m, long long p, int chunk, int bits,
           unsigned int seed, unsigned int i0, float* partial, float* out,
           int device, void* stream) {
  if (chunk <= 0 || chunk % SUB || p % chunk || bits % 32 || m <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long splits = p / chunk;
  const Plan pl = make_plan(m, splits, bits);
  if (pl.instance == MANY) {
    dim3 grid((unsigned)splits, (m + BM - 1) / BM, (bits + BJ - 1) / BJ);
    lsh_partial_many_kernel<<<grid, NT, 0, st>>>(x, m, p, chunk, bits,
                                                 seed, i0, partial);
  } else if (pl.tm == 1) {
    launch_tb<1>(pl.tb, x, m, p, chunk, bits, seed, i0, partial, st);
  } else if (pl.tm == 4) {
    launch_tb<4>(pl.tb, x, m, p, chunk, bits, seed, i0, partial, st);
  } else if (pl.tm == 8) {
    launch_tb<8>(pl.tb, x, m, p, chunk, bits, seed, i0, partial, st);
  } else {
    launch_tb<16>(pl.tb, x, m, p, chunk, bits, seed, i0, partial, st);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)m * bits;
  lsh_reduce_kernel<<<(unsigned)((n + RW - 1) / RW), RT, 0, st>>>(
      partial, (int)splits, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (m, p) f32 contiguous and 16-byte aligned, p % chunk == 0, chunk %
// 128 == 0; partial: (p/chunk, m, bits) f32 scratch; out: (m, bits) f32.
// Returns cudaGetLastError() after launching.
extern "C" int lsh_project_sums_batched(const float* x, int m, long long p,
                                        int chunk, int bits,
                                        unsigned int seed, float* partial,
                                        float* out, int device,
                                        void* stream) {
  return launch(x, m, p, chunk, bits, seed, 0u, partial, out, device,
                stream);
}

// One client: x: (p,) f32; partial: (p/chunk, bits) f32 scratch; out:
// (bits,) f32. The single-row instance of the same launch, so its sums
// equal the batched kernel's row bit for bit. x[p] is hashed as row
// i0 + p of R, mod 2^32 (rademacher_block's uint32(i0) + iota): a shard
// of a longer vector that starts at global index i0 (core/lsh.py:
// sharded_lsh_code); i0 = 0 is the unsharded call.
extern "C" int lsh_project_sums(const float* x, long long p, int chunk,
                                int bits, unsigned int seed, unsigned int i0,
                                float* partial, float* out, int device,
                                void* stream) {
  return launch(x, 1, p, chunk, bits, seed, i0, partial, out, device,
                stream);
}

// The launch's choice for (m, p, chunk, bits), launching nothing:
// out3 = {instance (0 single, 1 few, 2 many rows), rows per block (TM),
// bits per block (TB)}. Returns 0.
extern "C" int lsh_plan(int m, long long p, int chunk, int bits, int* out3) {
  if (chunk <= 0 || m <= 0 || bits <= 0) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(m, p / chunk, bits);
  out3[0] = pl.instance;
  out3[1] = pl.tm;
  out3[2] = pl.tb;
  return 0;
}
