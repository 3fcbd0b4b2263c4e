// Flash-attention forward (online softmax) for Hopper (sm_90a), on the
// tensor cores through wgmma, with an asynchronous K/V ring.
//
// Replaces repro/kernels/flash_attention.py:flash_attention
// (_flash_kernel): out = softmax(q k^T * scale + mask) v for every head,
// without the (Sq, Sk) scores ever leaving the chip. Its arithmetic is the
// TPU kernel's: scores in f32, scale = dh**-0.5 when the caller passes 0
// (applied after q k^T), the causal mask aligned top-left (query i sees
// keys j <= i, both counted from 0) with a masked score of -1e30, the
// running max m and sum l in f32 with the correction exp(m_prev - m_new),
// and out = acc / max(l, 1e-30) written in the input dtype (f32 or bf16).
//
// Layout: q (B, Sq, H, dh), k/v (B, Sk, KV, dh) and out (B, Sq, H, dh),
// each read through its batch, sequence and head strides with the head
// dimension contiguous; query head h reads KV head h / (H / KV), so the
// GQA repeat is never materialised. Any Sq and Sk, 1 <= dh <= 256.
//
// Bound on the H100 (SXM, 700 W): operations. The serving prefill (N = 96
// heads, Sq = Sk = 2048, dh = 128, causal) does 4 * N * S(S+1)/2 * dh =
// 1.03e11 f32-accurate operations against 0.2 GB of q, k, v and out.
// f32 inputs take 3xTF32 (three TF32 products per f32 product, below):
// 495 / 3 = 165 TFLOP/s of f32 work, 0.62 ms. bf16 inputs take one bf16
// product for q k^T and two for P V: at most 989 TFLOP/s, 0.10 ms.
//
// Design. One block per (head, tile of BQ = 64 * NWG query rows); the
// longest query tiles of a head are scheduled first, and causal blocks
// stop at the diagonal's last K/V tile.
// - Threads: NWG = 2 warpgroups of 128 threads (1 at f32 dh 256), each
//   owning 64 query rows, and no producer warp: 8 warps put 2 on each of
//   the SM's four 16K-register files, so every thread may hold 255
//   registers (f32 dh 128 needs more than 168 for O, Q-hi, S and P). A
//   producer warp or warpgroup makes 3 warps per register file and caps
//   the compiled code at 168 registers; this toolchain's ptxas does not
//   compile the consumers to a setmaxnreg budget, and at 168 it
//   serialises every wgmma and spills.
// - The K/V ring: STAGES stages of one BK-key tile, filled S - 1 tiles
//   ahead by cp.async from all threads (16 bytes each, zero-filled past
//   Sk and dh) and handed over by __syncthreads. f32 splits each tile in
//   shared memory once it has landed, while the previous tile's Q K^T
//   runs: K's raw f32 is the TF32 hi (wgmma reads an f32 in shared
//   memory as TF32 by keeping its top 19 bits), K-lo = TF32(K - hi) is a
//   second copy, and V, staged raw in the V^T-lo buffer, becomes V^T-hi
//   and V^T-lo (TF32 wgmma takes only K-major operands, and V's
//   reduction axis is its keys). bf16 K and V are used as copied: V is an
//   MN-major B operand.
// - Products (wgmma, m64nNk8 tf32 / m64nNk16 bf16, f32 accumulators):
//   f32 S = Qhi Khi + Qhi Klo + Qlo Khi (3xTF32; the dropped lo*lo term
//   is 2^-22 relative) with Q-hi as register A fragments and Q-lo in
//   shared memory (at dh 256 both in shared memory); bf16 S = Q K from
//   shared memory (exact products). O += P V with P from registers: f32
//   Phi Vhi + Plo Vhi + Phi Vlo; bf16 P = Phi + Plo split into two bf16
//   (V exact), so the bf16 route keeps the plain version's f32
//   arithmetic to about 2^-16.
// - P stays in registers: the row max and sum are quad shuffles on the
//   accumulator fragment (a thread holds rows g and g + 8 of its warp's
//   16, columns 8j + 2t, 8j + 2t + 1), in base 2 with the scale folded
//   in. For bf16 that fragment is the A operand as it is. For TF32 the A
//   operand wants k = (t, t + 4) where the accumulator holds (2t,
//   2t + 1): instead of shuffling P, the keys of each 8-key group are
//   permuted in V^T (logical k = 4e + t holds key 2t + e), and the sum
//   over keys does not care about order. O is rescaled only when a row's
//   max moved.
// - Accumulation: the tensor cores round each product's sum into the f32
//   accumulator toward zero, so a long chain of products into one
//   accumulator drifts by up to an ulp per link (one chain per row gave
//   a max abs error of 1.35e-5 at the serving shape, NVIDIA H100 80GB
//   HBM3, 700 W, against 1.5e-6 for CUDA-core FMAs). So the small
//   hi x lo products of S chain into their own accumulator, and each
//   tile's P V chains into a fresh one that O takes with a rounded add.
// - Shared memory per block (bytes; the budget is 232,448):
//     f32  dh <=  64: 2 WG, BK 64, 2 stages: Q 33,280 + 2 x 70,656 = 174,592
//     f32  dh <= 128: 2 WG, BK 32, 2 stages: Q 66,560 + 2 x 70,912 = 208,384
//     f32  dh <= 256: 1 WG, BK 16, 1 stage:  Q 133,120 + 71,808    = 204,928
//     bf16 dh <=  64: 2 WG, BK 64, 4 stages: Q 16,640 + 4 x 16,640 = 83,200
//     bf16 dh <= 128: 2 WG, BK 64, 4 stages: Q 33,280 + 4 x 33,280 = 166,400
//     bf16 dh <= 256: 2 WG, BK 32, 3 stages: Q 66,560 + 3 x 33,792 = 167,936
//   A stage holds K, K-lo, V^T-hi and V^T-lo for f32, K and V for bf16;
//   f32 at dh 256 keeps Q-hi and Q-lo (two copies of its 64 rows).
// - Alignment: cp.async needs 16-byte aligned rows: the base pointer and
//   every stride used (batch, sequence, head, in bytes) and dh * itemsize
//   multiples of 16 (f32 dh a multiple of 4, bf16 of 8). Other views (bf16
//   dh = 100, odd offsets) are staged element by element through
//   registers by the same threads into the same layout. Rows past Sk and
//   columns past dh are zero in shared memory; only tiles that reach past
//   Sk or cross the diagonal are masked per element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WG = 128;            // threads of a warpgroup

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// generic-proxy shared-memory writes before the async proxy (wgmma) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 16 bytes global -> shared, asynchronous; bytes < 16 zero-fills the rest
// (0: reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma: d (64 x N, f32) += a (64 x K) b (K x N), b from shared memory,
// a from shared memory (_ss) or from four registers per thread (_rs); both
// K-major; scale_d 0 ignores d's old value.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(
    float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(
    float* d, const uint32_t* a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(
    float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(
    float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(
    float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16_ss<32>(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ss<64>(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_bf16_rs_mn(
    float* d, const uint32_t* a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16_rs_mn<64>(
    float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// --------------------------------------------------------------- layout

// A wgmma operand tile of R rows by C 16-byte chunks, as 8-row x 16-byte
// core matrices without swizzle: (row, chunk) at chunk * LBO + (row / 8) *
// SBO + (row % 8) * 16 bytes. LBO is a whole chunk column plus 16 bytes,
// so it is 16 mod 128 and a warp's 16-byte accesses that run over 8
// consecutive rows or chunks hit 8 distinct bank groups (4 wavefronts for
// 512 bytes, the least). V^T tiles use SBO = 144 so the transposing
// stores (4 consecutive rows per lane) spread over the bank groups too.
template <int R, int C, int SBO_>
struct Tile {
  static constexpr int SBO = SBO_;
  static constexpr int LBO = (R / 8) * SBO + 16;
  static constexpr int BYTES = C * LBO;
  __device__ static __forceinline__ int at(int row, int chunk) {
    return chunk * LBO + (row >> 3) * SBO + (row & 7) * 16;
  }
  // K-major (rows = M or N, chunks along K): k-step ks (chunks 2 ks and
  // 2 ks + 1) from row row0
  __device__ static __forceinline__ uint64_t desc(uint32_t base, int ks,
                                                  int row0 = 0) {
    return encode(base + 2 * ks * LBO + (row0 >> 3) * SBO, LBO, SBO);
  }
  // MN-major (rows = K, chunks along N; bf16 V): k-step ks (rows 16 ks ..)
  // from chunk c0. The leading offset steps along K (8-row groups), the
  // stride offset along N (chunks).
  __device__ static __forceinline__ uint64_t desc_mn(uint32_t base, int ks,
                                                     int c0) {
    return encode(base + 2 * ks * SBO + c0 * LBO, SBO, LBO);
  }
  __device__ static __forceinline__ uint64_t encode(uint32_t a, int lbo,
                                                    int sbo) {
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
  }
};

template <typename T, int DH_, int NWG_, int BK_, int STAGES_>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int DH = DH_, NWG = NWG_, BK = BK_, STAGES = STAGES_;
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = WG * NWG;
  static constexpr int E = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int KE = 2 * E;  // wgmma depth: 8 tf32, 16 bf16
  static constexpr int CK = DH / E;              // chunks per row
  static constexpr int SPLIT = F32 ? 2 : 1;      // hi (+ lo) copies
  static constexpr bool QLO_SMEM = F32 && DH > 128;
  static constexpr int QCOPIES = QLO_SMEM ? 2 : 1;
  using QT = Tile<64, CK, 128>;      // a warpgroup's 64 rows x head dims
  using KT = Tile<BK, CK, 128>;      // keys x head dims (also bf16 V)
  using VT = Tile<DH, BK / E, 144>;  // f32 V^T: head dims x keys
  static constexpr int V_BYTES = F32 ? VT::BYTES : KT::BYTES;
  static constexpr int Q_BYTES = NWG * QCOPIES * QT::BYTES;
  static constexpr int STAGE_BYTES = SPLIT * (KT::BYTES + V_BYTES);
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(SMEM <= 232448, "shared memory over the H100 block limit");
  static_assert(BK % KE == 0 && DH % 64 == 0, "tile shape");
  static_assert(!F32 || BK * DH * 4 <= VT::BYTES,
                "f32 V staging: the raw tile fits the V^T-lo buffer");

};

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
  int qvec, kvvec;  // rows 16-byte aligned and whole: 16-byte copies
  float scale;
};

// ------------------------------------------------------------ staging

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}
__device__ __forceinline__ float tf32(float x) {
  return __uint_as_float(tf32_bits(x));
}
__device__ __forceinline__ uint32_t lo_bits(float x) {
  return tf32_bits(x - tf32(x));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}
__device__ __forceinline__ uint4 hi4(uint4 v) {
  return make_uint4(v.x & 0xffffe000u, v.y & 0xffffe000u,
                    v.z & 0xffffe000u, v.w & 0xffffe000u);
}
__device__ __forceinline__ uint4 lo4(uint4 v) {
  return make_uint4(lo_bits(__uint_as_float(v.x)),
                    lo_bits(__uint_as_float(v.y)),
                    lo_bits(__uint_as_float(v.z)),
                    lo_bits(__uint_as_float(v.w)));
}

__device__ __forceinline__ void st16(char* base, int off, uint4 v) {
  *reinterpret_cast<uint4*>(base + off) = v;
}
__device__ __forceinline__ uint4 ld16(const char* base, int off) {
  return *reinterpret_cast<const uint4*>(base + off);
}

// Rows row0 .. row0 + ROWS - 1 of a (nrows, dh) matrix (row stride
// `stride`) into shared memory, chunk (r, c) at dst + off(r, c), by 16-byte
// cp.async from `nthreads` threads; rows past nrows and chunks past dh are
// zero-filled (the aligned path: dh * itemsize is a multiple of 16).
template <int ROWS, int CH, typename T, typename Off>
__device__ __forceinline__ void copy_rows(char* dst, Off off, const T* src,
                                          long long stride, int row0,
                                          int nrows, int dh, int tid,
                                          int nthreads) {
  constexpr int E = 16 / (int)sizeof(T);
  for (int task = tid; task < ROWS * CH; task += nthreads) {
    const int r = task / CH, c = task % CH, row = row0 + r;
    const bool ok = row < nrows && c * E < dh;
    cp_async16(dst + off(r, c), ok ? src + row * stride + c * E : src,
               ok ? 16 : 0);
  }
}

// Elements [e0, e0 + E) of one row as 16 raw bytes, zero past dh and for
// a missing row (nullptr), element by element (the unaligned path).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int e0, int dh) {
  constexpr int E = 16 / (int)sizeof(T);
  using Raw = typename std::conditional<sizeof(T) == 4, unsigned int,
                                        unsigned short>::type;
  union {
    uint4 v;
    Raw e[E];
  } u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  if (row == nullptr) return u.v;
  const Raw* r = reinterpret_cast<const Raw*>(row);
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (e0 + i < dh) u.e[i] = __ldg(r + e0 + i);
  return u.v;
}

// The aligned path's copies of one K/V tile (keys k0 .. k0 + BK - 1)
// into a ring stage: K raw as KT (f32: the TF32 hi, since wgmma reads an
// f32 in shared memory as TF32 by keeping its top 19 bits); bf16 V raw as
// KT (an MN-major operand); f32 V raw, row-major, into the V^T-lo buffer
// for `convert_tile`.
template <class C, typename T>
__device__ __forceinline__ void copy_tile(const Params& p, char* stage,
                                          const T* kg, const T* vg, int k0,
                                          int tid) {
  using KT = typename C::KT;
  constexpr int NT = C::THREADS;
  auto tile = [](int r, int c) { return KT::at(r, c); };
  copy_rows<C::BK, C::CK>(stage, tile, kg, p.ks.s, k0, p.sk, p.dh, tid, NT);
  char* v_s = stage + C::SPLIT * KT::BYTES;
  if constexpr (C::F32) {
    auto rows = [](int r, int c) { return (r * C::CK + c) * 16; };
    copy_rows<C::BK, C::CK>(v_s + C::VT::BYTES, rows, vg, p.vs.s, k0, p.sk,
                            p.dh, tid, NT);
  } else {
    copy_rows<C::BK, C::CK>(v_s, tile, vg, p.vs.s, k0, p.sk, p.dh, tid, NT);
  }
}

// f32, once a stage's copies have landed (every thread's): K-lo from
// K, and V^T-hi / V^T-lo from the raw V in the V^T-lo buffer. V^T's
// chunk 2 g8 + e holds keys 8 g8 + 2 i + e (i = 0..3): the TF32
// A-fragment's key order (see the note above).
template <class C>
__device__ __forceinline__ void convert_tile(char* stage, int tid) {
  using KT = typename C::KT;
  using VT = typename C::VT;
  constexpr int CK = C::CK, NDL = C::DH / 4;
  constexpr int VTASKS = (C::BK / 8) * NDL;
  constexpr int VPL = (VTASKS + C::THREADS - 1) / C::THREADS;
#pragma unroll 4
  for (int task = tid; task < C::BK * CK; task += C::THREADS) {
    const int off = KT::at(task / CK, task % CK);
    st16(stage + KT::BYTES, off, lo4(ld16(stage, off)));
  }
  char* vt = stage + 2 * KT::BYTES;
  char* raw = vt + VT::BYTES;
  uint4 r[VPL][2][4];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int task = tid + u * C::THREADS, g8 = task / NDL, dl = task % NDL;
    if (task < VTASKS)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[u][e][i] = ld16(raw, ((8 * g8 + 2 * i + e) * CK + dl) * 16);
  }
  __syncthreads();  // every raw row is read before it is overwritten
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int task = tid + u * C::THREADS, g8 = task / NDL, dl = task % NDL;
    if (task < VTASKS)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 col =
              make_uint4(word(r[u][e][0], j), word(r[u][e][1], j),
                         word(r[u][e][2], j), word(r[u][e][3], j));
          const int off = VT::at(4 * dl + j, 2 * g8 + e);
          st16(vt, off, hi4(col));
          st16(raw, off, lo4(col));
        }
  }
}

// The unaligned path: the same stage contents through registers, element
// by element.
template <class C, typename T>
__device__ __forceinline__ void load_tile(const Params& p, char* stage,
                                          const T* kg, const T* vg, int k0,
                                          int tid) {
  using KT = typename C::KT;
  using VT = typename C::VT;
  constexpr int E = C::E, CK = C::CK;
  char* v_s = stage + C::SPLIT * KT::BYTES;
  for (int task = tid; task < C::BK * CK; task += C::THREADS) {
    const int n = task / CK, c = task % CK, key = k0 + n;
    const int off = KT::at(n, c);
    const uint4 x =
        load_chunk<T>(key < p.sk ? kg + key * p.ks.s : nullptr, c * E, p.dh);
    if constexpr (C::F32) {
      st16(stage, off, hi4(x));
      st16(stage + KT::BYTES, off, lo4(x));
    } else {
      st16(stage, off, x);
      st16(v_s, off, load_chunk<T>(key < p.sk ? vg + key * p.vs.s : nullptr,
                                   c * E, p.dh));
    }
  }
  if constexpr (C::F32) {
    constexpr int NDL = C::DH / 4;
    for (int task = tid; task < (C::BK / 8) * NDL; task += C::THREADS) {
      const int g8 = task / NDL, dl = task % NDL;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        uint4 r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * g8 + 2 * i + e;
          r[i] = load_chunk<T>(key < p.sk ? vg + key * p.vs.s : nullptr,
                               4 * dl, p.dh);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint4 col = make_uint4(word(r[0], j), word(r[1], j),
                                       word(r[2], j), word(r[3], j));
          const int off = VT::at(4 * dl + j, 2 * g8 + e);
          st16(v_s, off, hi4(col));
          st16(v_s + VT::BYTES, off, lo4(col));
        }
      }
    }
  }
}

// ------------------------------------------------------------- kernel

template <class C, typename T>
__global__ void __launch_bounds__(C::THREADS, 1)
    flash_fwd_kernel(const Params p) {
  using QT = typename C::QT;
  using KT = typename C::KT;
  using VT = typename C::VT;
  constexpr int S = C::STAGES, E = C::E, CQ = C::CK, NS = C::DH / 64;
  extern __shared__ __align__(128) char smem[];
  char* ring = smem + C::Q_BYTES;

  const int n = blockIdx.x / p.nq;
  const int q0 = (p.nq - 1 - blockIdx.x % p.nq) * C::BQ;
  const int b = n / p.heads, h = n % p.heads, kvh = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const T* vg = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  int nk = (p.sk + C::BK - 1) / C::BK;
  if (p.causal) nk = min(nk, (min(q0 + C::BQ, p.sq) - 1) / C::BK + 1);

  const int tid = threadIdx.x;
  // the warpgroup index, warp-uniform by construction (wgmma is
  // .sync.aligned); warpgroup wg owns query rows wq0 .. wq0 + 63
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int t = tid % WG, wi = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wq0 = q0 + 64 * wg;
  char* q_s = smem + wg * C::QCOPIES * QT::BYTES;
  auto stage = [&](int it) { return ring + (it % S) * C::STAGE_BYTES; };
  // tile `it` into its stage: cp.async (aligned rows), else through
  // registers; one commit group per call either way
  auto fetch = [&](int it) {
    if (it < nk) {
      if (p.kvvec)
        copy_tile<C, T>(p, stage(it), kg, vg, it * C::BK, tid);
      else
        load_tile<C, T>(p, stage(it), kg, vg, it * C::BK, tid);
    }
    cp_async_commit();
  };
  // once tile `it` has landed in every thread's view: f32 splits it
  // (K-lo, V^T), and the stage is made visible to wgmma (after the next
  // __syncthreads)
  auto prepare = [&](int it) {
    if constexpr (C::F32) {
      if (it < nk && p.kvvec) convert_tile<C>(stage(it), tid);
    }
    fence_proxy_async();
  };

  // ---- prologue: Q raw into shared memory (f32: the TF32 hi), tiles
  // 0 .. S - 1 in flight
  if (p.qvec) {
    auto tile = [](int r, int c) { return QT::at(r, c); };
    copy_rows<64, CQ>(q_s, tile, qg, p.qs.s, wq0, p.sq, p.dh, t, WG);
  } else {
    for (int task = t; task < 64 * CQ; task += WG) {
      const int r = task / CQ, c = task % CQ, row = wq0 + r;
      st16(q_s, QT::at(r, c),
           load_chunk<T>(row < p.sq ? qg + row * p.qs.s : nullptr, c * E,
                         p.dh));
    }
  }
  cp_async_commit();
  for (int it = 0; it < S; ++it) fetch(it);
  cp_async_wait<S - 1>();  // Q and tile 0
  __syncthreads();
  // f32 at dh <= 128: Q-hi as TF32 A fragments in registers, (r, k) =
  // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each 8-column
  // step, and Q-lo in place of Q in shared memory; at dh 256 Q stays as
  // the hi operand and Q-lo is a second copy
  constexpr int QHI_STEPS = (C::F32 && !C::QLO_SMEM) ? C::DH / 8 : 1;
  uint32_t qhi[QHI_STEPS][4];
  if constexpr (C::F32) {
    if constexpr (!C::QLO_SMEM) {
      const int r0w = 16 * wi + g;
#pragma unroll
      for (int ks = 0; ks < QHI_STEPS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = 8 * ks + tq + 4 * (i >> 1);
          qhi[ks][i] = tf32_bits(*reinterpret_cast<const float*>(
              q_s + QT::at(r0w + 8 * (i & 1), col / 4) + 4 * (col % 4)));
        }
      warpgroup_sync(1 + wg);  // every fragment is read
    }
    char* lo_s = C::QLO_SMEM ? q_s + QT::BYTES : q_s;
    for (int task = t; task < 64 * CQ; task += WG) {
      const int off = QT::at(task / CQ, task % CQ);
      st16(lo_s, off, lo4(ld16(q_s, off)));
    }
  }
  prepare(0);
  __syncthreads();

  const uint32_t qb = smem_addr(q_s);
  const int r0 = wq0 + 16 * wi + g;  // this thread's rows r0, r0 + 8
  float o[NS][32];
#pragma unroll
  for (int sl = 0; sl < NS; ++sl)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[sl][i] = 0.0f;
  // the softmax in base 2: exp(x s) = exp2(x s log2(e)), so m is kept in
  // the scaled base-2 domain
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int it = 0; it < nk; ++it) {
    const int k0 = it * C::BK;
    // Every warpgroup computes every tile of the block: one wholly above
    // its diagonal (or a warpgroup past Sq) is all masked and adds p = 0
    // with corr = 1, and branching around the asynchronous products would
    // make the compiler wait for them at the join.
    // f32: the hi x hi products chain into sc, the small hi x lo ones into
    // scc (see "Accumulation" above)
    constexpr int NCC = C::SPLIT == 2 ? C::BK / 2 : 1;
    float sc[C::BK / 2], scc[NCC];
    uint32_t vb;
    {
      uint32_t qbase = qb;
      asm volatile("" : "+r"(qbase));  // descriptors are built per tile
      const uint32_t kb = smem_addr(stage(it));
      vb = kb + C::SPLIT * KT::BYTES;

      // S = Q K^T, asynchronous
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) sc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < NCC; ++i) scc[i] = 0.0f;
      fence_regs<C::BK / 2>(sc);
      fence_regs<NCC>(scc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::DH / C::KE; ++ks) {
        const uint64_t dq = QT::desc(qbase, ks), dk = KT::desc(kb, ks);
        if constexpr (C::QLO_SMEM) {  // Qhi Khi + (Qhi Klo + Qlo Khi)
          wgmma_tf32_ss<C::BK>(sc, dq, dk, 1);
          wgmma_tf32_ss<C::BK>(scc, dq, KT::desc(kb + KT::BYTES, ks), 1);
          wgmma_tf32_ss<C::BK>(scc, QT::desc(qbase + QT::BYTES, ks), dk, 1);
        } else if constexpr (C::F32) {  // dq: Q-lo
          wgmma_tf32_rs<C::BK>(sc, qhi[ks], dk, 1);
          wgmma_tf32_rs<C::BK>(scc, qhi[ks], KT::desc(kb + KT::BYTES, ks), 1);
          wgmma_tf32_ss<C::BK>(scc, dq, dk, 1);
        } else {
          wgmma_bf16_ss<C::BK>(sc, dq, dk, 1);
        }
      }
      wgmma_commit();
    }
    // while Q K^T runs: tile it + 1 has landed (every thread's copies),
    // f32 splits it into its stage (it is not the one being read)
    if constexpr (S > 1) {
      cp_async_wait<S - 2>();
      __syncthreads();
      prepare(it + 1);
    }
    {
      wgmma_wait_all();
      fence_regs<C::BK / 2>(sc);
      fence_regs<NCC>(scc);
      if constexpr (C::SPLIT == 2) {
#pragma unroll
        for (int i = 0; i < C::BK / 2; ++i) sc[i] += scc[i];
      }

      // online softmax of rows r0 (r = 0) and r0 + 8 (r = 1) over the tile
      const bool edge =
          k0 + C::BK > p.sk || (p.causal && k0 + C::BK - 1 > wq0);
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r0 + 8 * r;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[4 * j + 2 * r + e] * scale2;
            if (edge) {
              const int kj = k0 + 8 * j + 2 * tq + e;
              if (kj >= p.sk || (p.causal && kj > qi)) x = NEG_INF;
            }
            sc[4 * j + 2 * r + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = exp2f(sc[4 * j + 2 * r + e] - m_new);
            sc[4 * j + 2 * r + e] = pe;
            sum += pe;
          }
        l[r] = l[r] * corr[r] + sum;  // this thread's columns only
      }
      if (corr[0] != 1.0f || corr[1] != 1.0f) {  // a row's max moved
#pragma unroll
        for (int sl = 0; sl < NS; ++sl)
#pragma unroll
          for (int i = 0; i < 32; ++i) o[sl][i] *= corr[(i >> 1) & 1];
      }

      // P as A fragments, split hi + lo
      constexpr int PSTEPS = C::BK / C::KE;
      uint32_t ph[PSTEPS][4], pl[PSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < PSTEPS; ++ks) {
        if constexpr (C::F32) {
          // k = t <- key 2t, k = t + 4 <- key 2t + 1 (V^T is permuted)
          const float v4[4] = {sc[4 * ks], sc[4 * ks + 2], sc[4 * ks + 1],
                               sc[4 * ks + 3]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ph[ks][i] = tf32_bits(v4[i]);
            pl[ks][i] = lo_bits(v4[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
            const int base = 4 * (2 * ks + (i >> 1)) + 2 * (i & 1);
            const float a = sc[base], c = sc[base + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(
                a - __low2float(hi), c - __high2float(hi));
            ph[ks][i] = *reinterpret_cast<const uint32_t*>(&hi);
            pl[ks][i] = *reinterpret_cast<const uint32_t*>(&lo);
          }
        }
      }

      // O += P V, 64 head dims at a time: the tile's products chain into a
      // fresh accumulator acc, which O takes with a rounded add
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
        fence_regs<32>(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < PSTEPS; ++ks) {
          if constexpr (C::F32) {
            const uint64_t dv = VT::desc(vb, ks, 64 * sl);
            wgmma_tf32_rs<64>(acc, ph[ks], dv, 1);
            wgmma_tf32_rs<64>(acc, pl[ks], dv, 1);
            wgmma_tf32_rs<64>(acc, ph[ks],
                              VT::desc(vb + VT::BYTES, ks, 64 * sl), 1);
          } else {
            const uint64_t dvn = KT::desc_mn(vb, ks, 8 * sl);
            wgmma_bf16_rs_mn<64>(acc, ph[ks], dvn, 1);
            wgmma_bf16_rs_mn<64>(acc, pl[ks], dvn, 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<32>(acc);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[sl][i] += acc[i];
      }
    }
    // stage(it) is read by everyone and tile it + 1 is prepared: tile
    // it + S may take the stage (one stage: load and prepare it now)
    __syncthreads();
    fetch(it + S);
    if constexpr (S == 1) {
      cp_async_wait<0>();
      __syncthreads();
      prepare(it + 1);
      __syncthreads();
    }
  }

  // out = O / max(l, 1e-30): l summed over the row's quad
  T* og = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r0 + 8 * r;
    if (qi >= p.sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 64 * sl + 8 * j + 2 * tq + e;
          if (d < p.dh)
            og[qi * p.os.s + d] = from_f<T>(o[sl][4 * j + 2 * r + e] / den);
        }
  }
}

template <class C, typename T>
int launch(Params p, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return (int)err;
  p.nq = (p.sq + C::BQ - 1) / C::BQ;
  flash_fwd_kernel<C, T>
      <<<(unsigned)((long long)n * p.nq), C::THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int n, cudaStream_t stream) {
  // (dh, consumer warpgroups, keys per stage, stages): see the note above
  if constexpr (std::is_same<T, float>::value) {
    if (p.dh <= 64) return launch<Cfg<T, 64, 2, 64, 2>, T>(p, n, stream);
    if (p.dh <= 128) return launch<Cfg<T, 128, 2, 32, 2>, T>(p, n, stream);
    return launch<Cfg<T, 256, 1, 16, 1>, T>(p, n, stream);
  } else {
    if (p.dh <= 64) return launch<Cfg<T, 64, 2, 64, 4>, T>(p, n, stream);
    if (p.dh <= 128) return launch<Cfg<T, 128, 2, 64, 4>, T>(p, n, stream);
    return launch<Cfg<T, 256, 2, 32, 3>, T>(p, n, stream);
  }
}

// 16-byte loads are safe: base 16-byte aligned, and every stride that is
// used (its extent > 1) and the row's dh * itemsize multiples of 16 bytes
bool rows_aligned(const void* ptr, long long sb, long long ss, long long sh,
                  int batch, int seq, int heads, int dh, int item) {
  auto ok = [item](long long stride, int extent) {
    return extent <= 1 || (stride * item) % 16 == 0;
  };
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ok(sb, batch) &&
         ok(ss, seq) && ok(sh, heads) && (dh * item) % 16 == 0;
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
  const int item = bf16 ? 2 : 4;
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
  p.qvec = rows_aligned(q, q_sb, q_ss, q_sh, batch, sq, heads, dh, item);
  p.kvvec =
      rows_aligned(k, k_sb, k_ss, k_sh, batch, sk, kv_heads, dh, item) &&
      rows_aligned(v, v_sb, v_ss, v_sh, batch, sk, kv_heads, dh, item);
  p.scale = scale;
  const int n = batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(p, n, s) : dispatch<float>(p, n, s);
}
