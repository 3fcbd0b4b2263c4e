// Flash-attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): out = softmax(q k^T * scale + mask) v for every head,
// without the (Sq, Sk) scores ever leaving the chip. Its arithmetic is the
// TPU kernel's: scores in f32, scale = dh**-0.5 when the caller passes 0,
// the causal mask aligned top-left (query i sees keys j <= i, both counted
// from 0) with a masked score of -1e30, the running max m and sum l in
// f32 with the correction exp(m_prev - m_new), and out = acc / max(l,
// 1e-30) written in the input dtype (f32 or bf16).
//
// Layout: q (B, Sq, H, dh), k/v (B, Sk, KV, dh) and out (B, Sq, H, dh),
// each read through its batch, sequence and head strides with the head
// dimension contiguous; query head h reads KV head h / (H / KV). The
// (N, S, dh) kernel layout of the TPU is the case H = KV = 1, and the
// GQA wrapper's KV repeat is never materialised. Any Sq and Sk (the tail
// tiles are masked) and dh <= 256.
//
// Bound on the H100: operations. The main path's prefill (N = 96 heads,
// Sq = Sk = 2048, dh = 128, causal) does 4 * N * S^2 * dh / 2 = 1.0e11
// f32 operations against 0.2 GB of q, k, v and out. The design is the
// simple one: one block of 256 threads per (head, tile of BQ query rows),
// the q tile and one K/V tile of BK keys staged in shared memory, scores
// and probabilities in registers (a row's 16 threads sit in one half-warp,
// so its max and sum are shuffles), then P through shared memory into
// P V. Each thread owns RI query rows and KJ keys of the score tile and
// the same RI rows times 4 * DC head columns of the output. f32 FMAs on
// the CUDA cores, float4 shared-memory reads (rows padded by 4 floats, so
// a quarter-warp's 8 rows fall on distinct banks); no tensor cores, no
// TMA, no double buffering. Causal blocks stop at the diagonal's last K/V
// tile (a tile wholly above it would add p = exp(-1e30 - m) = 0 and
// correct by 1), and the longest query tiles are scheduled first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TY = 16;           // thread rows (query rows) per block
constexpr int TX = 16;           // thread columns (keys / head dims)
constexpr int THREADS = TY * TX;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int heads, group, sq, sk, dh, nq, causal;
  float scale;
};

// Rows [row0, row0 + ROWS) of one head into dst (row stride STRIDE), as
// f32, zero past nrows and past dh.
template <typename T, int ROWS, int DH, int STRIDE>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int nrows, int dh) {
  for (int e = threadIdx.x; e < ROWS * DH; e += THREADS) {
    const int r = e / DH, d = e % DH, row = row0 + r;
    dst[r * STRIDE + d] =
        (row < nrows && d < dh) ? to_f(src[row * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = TX / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = TX / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float comp(const float4& a, int u) {
  return u == 0 ? a.x : (u == 1 ? a.y : (u == 2 ? a.z : a.w));
}

template <typename T, int RI, int KJ, int DC>
constexpr size_t smem_bytes() {
  constexpr int BQ = TY * RI, BK = TX * KJ, DH = 64 * DC;
  return sizeof(float) *
         (size_t)(BQ * (DH + 4) + BK * (DH + 4) + BK * DH + BQ * (BK + 4));
}

// RI query rows and KJ keys per thread; DC float4 chunks of the head
// dimension per thread and row (dh <= 64 * DC).
template <typename T, int RI, int KJ, int DC>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int BQ = TY * RI, BK = TX * KJ, DH = 64 * DC;
  constexpr int QS = DH + 4;  // row stride of q_s and k_s
  constexpr int PS = BK + 4;  // row stride of p_s
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * QS;  // row stride DH
  float* p_s = v_s + BK * DH;

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int n = blockIdx.x / p.nq;
  const int q0 = (p.nq - 1 - blockIdx.x % p.nq) * BQ;
  const int b = n / p.heads, h = n % p.heads, kvh = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;

  load_tile<T, BQ, DH, QS>(q_s, qg, p.qs.s, q0, p.sq, p.dh);

  float m[RI], l[RI], acc[RI][DC][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  int nk = (p.sk + BK - 1) / BK;
  if (p.causal) nk = min(nk, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's k_s, v_s and p_s reads are done
    load_tile<T, BK, DH, QS>(k_s, kg, p.ks.s, k0, p.sk, p.dh);
    load_tile<T, BK, DH, DH>(v_s, vg, p.vs.s, k0, p.sk, p.dh);
    __syncthreads();

    // scores of rows ty + TY*i and keys tx + TX*j
    float s[RI][KJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qa[RI], kb[KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        qa[i] = *reinterpret_cast<const float4*>(q_s + (ty + TY * i) * QS + d);
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kb[j] = *reinterpret_cast<const float4*>(k_s + (tx + TX * j) * QS + d);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
    }

    // online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kj = k0 + tx + TX * j;
        float x = s[i][j] * p.scale;
        if (kj >= p.sk || (p.causal && qi < kj)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float e = expf(s[i][j] - m_new);
        s[i][j] = e;
        sum += e;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
#pragma unroll
      for (int j = 0; j < KJ; ++j) p_s[(ty + TY * i) * PS + tx + TX * j] = s[i][j];
    }
    __syncwarp();  // a row's p_s entries come from its own half-warp

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        pa[i] = *reinterpret_cast<const float4*>(p_s + (ty + TY * i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vb[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c)
          vb[c] = *reinterpret_cast<const float4*>(v_s + (kk + u) * DH +
                                                   64 * c + 4 * tx);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float pv = comp(pa[i], u);
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            acc[i][c][0] = fmaf(pv, vb[c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv, vb[c].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv, vb[c].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv, vb[c].w, acc[i][c][3]);
          }
        }
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * c + 4 * tx + e;
        if (d < p.dh) og[qi * p.os.s + d] = from_f<T>(acc[i][c][e] / den);
      }
  }
}

template <typename T, int RI, int KJ, int DC>
int launch(Params p, int n, cudaStream_t stream) {
  constexpr int BQ = TY * RI;
  constexpr size_t smem = smem_bytes<T, RI, KJ, DC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, RI, KJ, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  p.nq = (p.sq + BQ - 1) / BQ;
  flash_fwd_kernel<T, RI, KJ, DC>
      <<<(unsigned)((long long)n * p.nq), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int n, cudaStream_t stream) {
  if (p.dh <= 64) return launch<T, 4, 4, 1>(p, n, stream);    // BQ=BK=64
  if (p.dh <= 128) return launch<T, 4, 4, 2>(p, n, stream);   // BQ=BK=64
  return launch<T, 2, 2, 4>(p, n, stream);                    // BQ=BK=32
}

}  // namespace

// q (batch, sq, heads, dh), k/v (batch, sk, kv_heads, dh) and o (batch, sq,
// heads, dh), f32 (bf16 == 0) or bf16, each given by its batch, sequence
// and head strides in elements (the head dimension contiguous); heads a
// multiple of kv_heads; 1 <= dh <= 256; sq, sk >= 1; scale > 0. Returns
// cudaGetLastError() after launching.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int bf16,
    int batch, int heads, int kv_heads, int sq, int sk, int dh,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.qs = {q_sb, q_ss, q_sh};
  p.ks = {k_sb, k_ss, k_sh};
  p.vs = {v_sb, v_ss, v_sh};
  p.os = {o_sb, o_ss, o_sh};
  p.heads = heads;
  p.group = heads / kv_heads;
  p.sq = sq;
  p.sk = sk;
  p.dh = dh;
  p.nq = 0;
  p.causal = causal;
  p.scale = scale;
  const int n = batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(p, n, s) : dispatch<float>(p, n, s);
}
