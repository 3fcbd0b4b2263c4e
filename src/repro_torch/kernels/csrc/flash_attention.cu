// Flash-attention forward (online softmax) for Hopper (sm_90a): persistent
// blocks over packed GQA rows, on the tensor cores through wgmma, with a
// K/V ring handed over by mbarriers.
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
// Bound on the H100 (SXM, 700 W): the larger of q, k, v and out moved once
// at 3.35 TB/s and 4 * H * pairs * dh operations on the tensor cores. f32
// inputs take 3xTF32 (three TF32 products per f32 product, below): 495 / 3
// = 165 TFLOP/s of f32 work; bf16 inputs one bf16 product for q k^T and two
// for P V: at most 989 TFLOP/s. The serving prefill (96 heads, Sq = Sk =
// 2048, dh 128, causal) is bound by operations: 1.03e11, 0.62 ms in f32,
// 0.10 ms in bf16. The federation's neighbour web (B 16,384, S 32, 4 query
// heads over 1 KV head, dh 64, bf16, causal) is bound by bytes: 670 MB,
// 0.200 ms.
//
// Design.
// - Work items: (batch, KV head, tile of BQ = 64 * NWG packed rows). The
//   G = H / KV query heads of a KV head are packed into the rows, position
//   major (FlashAttention-3's PackGQA): packed row r is query position
//   r / G of head kvh * G + r % G. A K/V tile is read, and in f32 split,
//   once per item for all G heads, and the causal mask reads the position
//   r / G. At the web shape an item is 32 positions x 4 heads: 128 live
//   rows. G = 1 is the identity (one head per item, rows in order).
// - Persistent blocks over a static schedule: with more items than
//   MINB * SMs resident blocks, the grid is that many blocks (at most one
//   per pair of items), and block x takes pairs of items x, x + grid, ...
//   Items are numbered (batch, KV head) by (batch, KV head), each one's
//   row tiles in the order nt - 1, 0, nt - 2, 1, ...: a pair is the
//   longest tile left, first, and the shortest, so every pair has the
//   same causal work, and the grid works on some grid / (nt / 2) (batch,
//   KV head)s at a time, whose K/V stay in the L2. With fewer items, one
//   item a block. The block's K/V tiles form one stream across its
//   items, so the ring runs ahead into the next item. The next item's Q
//   is in flight while this item computes (two Q buffers where shared
//   memory allows; else it is loaded after the epilogue, behind the ring's
//   tiles), and O leaves through shared memory by 16-byte stores.
// - Threads: NWG = 2 warpgroups of 128 threads (1 at f32 dh 256), each
//   owning 64 rows of the item, and no producer warp: 8 warps put 2 on
//   each of the SM's four 16K-register files, so every thread may hold 255
//   registers (f32 dh 128 needs more than 168 for O, Q-hi, S and P). A
//   producer warp makes 3 warps per register file and caps the compiled
//   code at 168 registers; this toolchain's ptxas does not compile the
//   consumers to a setmaxnreg budget, and at 168 it serialises every wgmma
//   and spills. The short configuration (bf16, dh <= 64, Sk <= 32) is
//   compiled for two resident blocks per SM.
// - The ring: STAGES stages of one BK-key tile, filled STAGES - LAG tiles
//   ahead (LAG 2 for bf16's 3-4 stages, 1 for f32's 1-2). Every thread
//   copies its 16-byte chunks by cp.async (zero-filled past Sk and dh)
//   and arrives on the stage's "full" mbarrier with
//   cp.async.mbarrier.arrive.noinc, which fires once its copies have
//   landed. Each warp then "prepares" the tile: f32 splits its warpgroup's
//   keys of it (below), and a proxy fence orders the copies before the
//   wgmma reads; the warp arrives on the stage's "ready" mbarrier. Every
//   warp arrives on the stage's "empty" mbarrier once its products on the
//   stage have retired, and the loader refills the stage of tile s - LAG
//   during tile s. The loop has no __syncthreads: bf16 prepares a tile
//   ahead and its warpgroups may drift a whole tile apart, so one's
//   softmax runs under the other's wgmma; f32's two stages keep them
//   within a tile's products of each other. A fence waits for the
//   thread's copies in flight, so a tile is prepared where the thread's
//   newest copies are the ones just waited for. The copies stay per
//   thread: wgmma reads its operands in 8-row x 16-byte core matrices,
//   where a row's 16-byte chunks lie a core-matrix column apart, and a
//   bulk copy writes one contiguous run. Each warpgroup's Q has its own
//   mbarriers.
// - The issue of a wgmma blocks the warp about as long as the product
//   runs, and so does the issue of a tile's copies (an SM has few
//   requests in flight). So the aligned instance of f32 with 2 stages
//   issues tile s + 1's copies in passes between tile s's Q K^T products
//   and splits tile s + 1 between the products of the first P V slice
//   (the wait for the copies after the first k-step, then a step of each
//   thread's task after each k-step, the fence after the slice).
// - Two instances of every configuration: one for q, k and v rows that
//   are all 16-byte aligned, whose loops hold no element-by-element
//   staging, and one that stages unaligned rows through registers. The
//   staging's registers cost the aligned loops spills and left the
//   compiler too few uniform registers for the wgmma descriptors.
// - Divisions by G, by the items per (batch, KV head) and by KV go
//   through `Div` (a multiply-high and a shift, the multiplier from the
//   host): a division by a value known only at run time is a chain of
//   some 20 dependent instructions, which cost short items microseconds,
//   and the loader's item arithmetic inside the tile loop took the
//   uniform registers of the wgmma descriptors (147 `R2UR` a tile loop
//   at f32 dh 128, none without it). A tile's causal and Sk mask is one
//   compare per score against a per-row limit.
// - f32 splits each tile in shared memory once it has landed, under the
//   first 64 columns of the previous tile's P V, each warpgroup the keys
//   of its half: K's raw f32 is the TF32 hi (wgmma reads an f32 in shared
//   memory as TF32 by keeping its top 19 bits), V, staged raw in the K-lo
//   buffer, becomes V^T-hi and V^T-lo (TF32 wgmma takes only K-major
//   operands, and V's reduction axis is its keys), and K-lo = TF32(K -
//   hi) then takes the raw V's place, each thread over the chunks it has
//   read. bf16 K and V are used as copied: V is an MN-major B operand.
// - Products (wgmma, m64nNk8 tf32 / m64nNk16 bf16, f32 accumulators):
//   f32 S = Qhi Khi + Qhi Klo + Qlo Khi (3xTF32; the dropped lo*lo term
//   is 2^-22 relative) with Q-hi as register A fragments and Q-lo in
//   shared memory (at dh 256 both in shared memory); bf16 S = Q K from
//   shared memory (exact products). O += P V with P from registers: f32
//   Phi Vhi + Plo Vhi + Phi Vlo; bf16 P = Phi + Plo split into two bf16
//   (V exact), so the bf16 route keeps the plain version's f32
//   arithmetic to about 2^-16. bf16 at dh <= 128 commits the P V products
//   of every 64-column slice as one group.
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
// - Shared memory per block: mbarriers (128 bytes), the Q buffers and the
//   ring's stages (`Cfg::SMEM`, within the H100's 232,448 bytes; its
//   Python mirror is `kernels/flash_attention.py:config_smem_bytes`).
//   A stage holds K, K-lo, V^T-hi and V^T-lo for f32, K and V for bf16;
//   f32 at dh 256 keeps Q-hi and Q-lo (two copies of its 64 rows). A
//   warpgroup's Q buffer stages its O for the stores once its last
//   product has retired. `flash_plan_field` exports the plan (shared
//   memory, items, grid, tiles) for the wrapper's mirror.
// - Alignment: cp.async needs 16-byte aligned rows: the base pointer and
//   every stride used (batch, sequence, head, in bytes) and dh * itemsize
//   multiples of 16 (f32 dh a multiple of 4, bf16 of 8). Other views (bf16
//   dh = 100, odd offsets) are staged element by element through
//   registers by the same threads into the same layout, and stored element
//   by element. Rows past Sk and columns past dh are zero in shared
//   memory; only tiles that reach past Sk or cross the diagonal are masked
//   per element.
// - A wait on an mbarrier that has not completed after about 2^34 cycles
//   (some 9 s) traps, so a fault in the hand-over ends the launch with an
//   error rather than hanging the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WG = 128;            // threads of a warpgroup

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// generic-proxy shared-memory accesses before the async proxy's (wgmma)
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// an arrival on `bar` that fires once every cp.async this thread issued
// before it has landed (counted in the barrier's arrivals: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits until the phase of parity `parity` of `bar` has completed; the
// loop is PTX with uniform branches, one opaque instruction to the
// compiler. After 2^34 cycles it traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 17179869184;\n"
      "@p trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
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

// DH_: head dims (a multiple of 64); NWG_: warpgroups; BK_: keys per
// stage; STAGES_: ring stages; QBUF_: Q buffers per warpgroup; MINB_:
// resident blocks per SM the code is compiled for.
template <typename T, int DH_, int NWG_, int BK_, int STAGES_, int QBUF_,
          int MINB_>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int DH = DH_, NWG = NWG_, BK = BK_, STAGES = STAGES_;
  static constexpr int QBUF = QBUF_, MINB = MINB_;
  static constexpr int BQ = 64 * NWG;            // packed rows per item
  static constexpr int THREADS = WG * NWG;
  static constexpr int E = 16 / (int)sizeof(T);  // elements per chunk
  static constexpr int KE = 2 * E;  // wgmma depth: 8 tf32, 16 bf16
  static constexpr int CK = DH / E;              // chunks per row
  static constexpr int RS = THREADS / CK;  // rows a copy pass covers
  static constexpr int KP = BK / RS;       // copy passes of K (and of V)
  static constexpr int NS = DH / 64;             // 64-column slices of O
  static constexpr int SPLIT = F32 ? 2 : 1;      // hi (+ lo) copies
  static constexpr bool QLO_SMEM = F32 && DH > 128;
  static constexpr int QCOPIES = QLO_SMEM ? 2 : 1;
  // slices of P V committed as one group (each into its own accumulator)
  static constexpr int PVG = (F32 || DH > 128) ? 1 : NS;
  static constexpr int PK = BK / NWG;  // keys each warpgroup splits (f32)
  // the loader refills the stage of tile s - LAG during tile s: f32 (2
  // stages) the tile just done, bf16 the one before, so its warpgroups
  // may drift a whole tile apart
  static constexpr int LAG = STAGES >= 3 ? 2 : 1;
  // bf16 prepares tile s + PREP at the top of tile s (f32: tile s + 1
  // under tile s's P V, or with one stage tile s itself)
  static constexpr int PREP = STAGES - LAG - 1;
  // f32 with 2 stages prepares tile s + 1 under tile s's P V and (the
  // aligned instance) copies it between tile s's Q K^T products (an issue
  // of the copies blocks the warp about as long as they take to land)
  static constexpr bool SPLIT_COPY = F32 && STAGES == 2;


  using QT = Tile<64, CK, 128>;      // a warpgroup's 64 rows x head dims
  using KT = Tile<BK, CK, 128>;      // keys x head dims (also bf16 V)
  using VT = Tile<DH, BK / E, 144>;  // f32 V^T: head dims x keys
  static constexpr int V_BYTES = F32 ? VT::BYTES : KT::BYTES;
  static constexpr int WQ_BYTES = QCOPIES * QT::BYTES;  // a warpgroup's Q
  static constexpr int Q_BYTES = NWG * WQ_BYTES;        // one Q buffer
  static constexpr int STAGE_BYTES = SPLIT * (KT::BYTES + V_BYTES);
  static constexpr int NBAR = 3 * STAGES + NWG * QBUF;
  static constexpr int BAR_BYTES = (8 * NBAR + 127) / 128 * 128;
  static constexpr int OFF_RING = BAR_BYTES + QBUF * Q_BYTES;
  static constexpr int SMEM = OFF_RING + STAGES * STAGE_BYTES;
  static_assert(SMEM <= 232448, "shared memory over the H100 block limit");
  static_assert(MINB * (SMEM + 1024) <= 233472,
                "MINB blocks do not fit one SM's shared memory");
  static_assert(BK % KE == 0 && DH % 64 == 0, "tile shape");
  static_assert(BK % (8 * NWG) == 0, "f32 splits 8-key groups");
  static_assert(THREADS % CK == 0 && BK % RS == 0, "whole copy passes");
  static_assert(64 * CK * 16 <= QT::BYTES, "O staging fits a Q buffer");
};

struct Strides {
  long long b, s, h;
};

// x / d and x % d for 0 <= x < 2^31 by a multiply-high and a shift, with
// the multiplier computed once on the host: a division by a value known
// only at run time is a chain of some 20 dependent instructions, which the
// per-row address arithmetic of short items cannot hide
struct Div {
  int d;
  unsigned mul;  // 0 for d = 1
  int shr;
  static Div of(int d) {
    Div r{d, 0u, 0};
    if (d > 1) {
      int l = 0;
      while ((1ll << l) < d) ++l;  // ceil(log2 d)
      r.mul = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
      r.shr = l - 1;
    }
    return r;
  }
  __device__ __forceinline__ int div(int x) const {
    return mul ? (int)(__umulhi((unsigned)x, mul) >> shr) : x;
  }
  __device__ __forceinline__ int mod(int x) const { return x - div(x) * d; }
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  Div group;   // G = H / KV: query heads packed per KV head
  Div kv;      // KV heads
  int sq, sk, dh, causal;
  Div nt;      // items per (batch, KV head): ceil(Sq * G / BQ)
  int items;   // batch * KV * nt
  int paired;  // causal, items > resident blocks: blocks take pairs
  Div grid;    // blocks of the launch
  int qvec, kvvec, ovec;  // rows 16-byte aligned and whole: 16-byte copies
  float scale;
};

// One work item: the pointers of (batch, KV head), its first packed row
// and its K/V tiles. Packed row r adds (r / G) * seq + (r % G) * head
// stride to q and o.
template <typename T>
struct Item {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  int r0, nk;
};

// The item block x computes j-th: `paired` (causal, more items than
// blocks), the pairs of items x, x + grid, ...; else items x, x + grid, ...
__device__ __forceinline__ int item_index(int x, int j, int grid,
                                          int paired) {
  return paired ? 2 * (x + (j >> 1) * grid) + (j & 1) : x + j * grid;
}

// The block's item count (the grid is at most the items, or the pairs)
__device__ __forceinline__ int block_items(int x, const Div& grid,
                                           int items, int paired) {
  if (!paired) return grid.div(items - 1 - x) + 1;
  const int pairs = (items + 1) / 2, last = grid.div(pairs - 1 - x);
  return 2 * (last + 1) - ((items & 1) && pairs - 1 - x == last * grid.d);
}

// item i: (batch, KV head) i / nt, its row tiles in the order nt - 1, 0,
// nt - 2, 1, ...: a pair of items holds the longest and the shortest
// tile left, equal causal work, of one (batch, KV head)
template <class C, typename T>
__device__ __forceinline__ Item<T> item_at(const Params& p, int i) {
  const int bk = p.nt.div(i), k = i - bk * p.nt.d;
  const int tile = (k & 1) ? k >> 1 : p.nt.d - 1 - (k >> 1);
  const int b = p.kv.div(bk), kvh = bk - b * p.kv.d;
  const long long h0 = (long long)kvh * p.group.d;
  Item<T> it;
  it.q = static_cast<const T*>(p.q) + b * p.qs.b + h0 * p.qs.h;
  it.o = static_cast<T*>(p.o) + b * p.os.b + h0 * p.os.h;
  it.k = static_cast<const T*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  it.v = static_cast<const T*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  it.r0 = tile * C::BQ;
  int nk = (p.sk + C::BK - 1) / C::BK;
  if (p.causal) {
    const int last = p.group.div(min(it.r0 + C::BQ, p.sq * p.group.d) - 1);
    nk = min(nk, last / C::BK + 1);
  }
  it.nk = nk;
  return it;
}

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

template <typename T>
using Raw = typename std::conditional<sizeof(T) == 4, unsigned int,
                                      unsigned short>::type;

// Elements [e0, e0 + E) of one row as 16 raw bytes, zero past dh and for
// a missing row (nullptr), element by element (the unaligned path).
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* row, int e0, int dh) {
  constexpr int E = 16 / (int)sizeof(T);
  union {
    uint4 v;
    Raw<T> e[E];
  } u;
  u.v = make_uint4(0u, 0u, 0u, 0u);
  if (row == nullptr) return u.v;
  const Raw<T>* r = reinterpret_cast<const Raw<T>*>(row);
#pragma unroll
  for (int i = 0; i < E; ++i)
    if (e0 + i < dh) u.e[i] = __ldg(r + e0 + i);
  return u.v;
}

// A warpgroup's 64 packed rows of an item's Q into q_s (as QT), and the
// warpgroup's arrival on `bar` once they are there: cp.async (aligned
// rows), else through registers. Packed row r is position r / G of head
// kvh * G + r % G; rows past Sq * G and chunks past dh are zero.
template <class C, typename T, bool VEC>
__device__ __forceinline__ void load_q(const Params& p, const Item<T>& it,
                                       char* q_s, int wg, int t,
                                       uint64_t* bar) {
  constexpr int CQ = C::CK, E = C::E, RS = WG / CQ;
  const int wr0 = it.r0 + 64 * wg, nrows = p.sq * p.group.d;
  const int c = t % CQ;  // this thread's chunk of rows t / CQ + RS u
  const bool col = c * E < p.dh;
#pragma unroll 4
  for (int u = 0; u < 64 / RS; ++u) {
    const int r = t / CQ + RS * u, row = wr0 + r, pos = p.group.div(row);
    const T* src = row < nrows ? it.q + pos * p.qs.s +
                                     (row - pos * p.group.d) * p.qs.h
                               : nullptr;
    if (VEC || p.qvec) {
      const bool ok = src != nullptr && col;
      cp_async16(q_s + C::QT::at(r, c), ok ? src + c * E : it.q,
                 ok ? 16 : 0);
    } else {
      st16(q_s, C::QT::at(r, c), load_chunk<T>(src, c * E, p.dh));
    }
  }
  if (VEC || p.qvec) {
    cp_async_arrive(bar);
  } else {
    fence_proxy_async();
    mbar_arrive(bar);
  }
}

// Pass u of the aligned path's copies of one K/V tile (keys k0 .. k0 +
// BK - 1) into a ring stage, by 16-byte cp.async: passes 0 .. KP - 1 copy
// K, KP .. 2 KP - 1 V, each thread chunk tid % CK of keys tid / CK + RS u;
// keys past Sk and chunks past dh are zero-filled. K lands raw as KT
// (f32: the TF32 hi, since wgmma reads an f32 in shared memory as TF32 by
// keeping its top 19 bits); bf16 V raw as KT (an MN-major operand); f32 V
// raw as KT into the K-lo buffer, for `convert_part`.
template <class C, typename T>
__device__ __forceinline__ void copy_pass(const Params& p, char* stage,
                                          const T* kg, const T* vg, int k0,
                                          int tid, int u) {
  using KT = typename C::KT;
  const bool v = u >= C::KP;
  const int r = tid / C::CK + C::RS * (v ? u - C::KP : u);
  const int c = tid % C::CK, key = k0 + r;
  const bool ok = key < p.sk && c * C::E < p.dh;
  const T* src = v ? vg : kg;
  const long long stride = v ? p.vs.s : p.ks.s;
  cp_async16(stage + (v ? KT::BYTES : 0) + KT::at(r, c),
             ok ? src + key * stride + c * C::E : src, ok ? 16 : 0);
}

// f32, once a stage's copies have landed: warpgroup w's keys (w * PK ..)
// of V^T-hi / V^T-lo from the raw V staged in the K-lo buffer, then of
// K-lo from K over the raw chunks just read. A task is (8-key group g8,
// 4 head dims dl, e): keys 8 g8 + 2 i + e (i = 0..3) of V^T's chunk
// 2 g8 + e, the TF32 A-fragment's key order (see the note above). A
// thread overwrites only raw chunks it has read itself, so no barrier.
// A task runs in STEPS steps: the loads of its four raw V chunks, V^T's
// four columns, K-lo's four rows.
template <class C>
struct Split {
  using KT = typename C::KT;
  using VT = typename C::VT;
  static constexpr int NDL = C::DH / 4, PG = C::PK / 8;
  static constexpr int TASKS = 2 * PG * NDL, STEPS = 9;
  char* stage;
  int e, g8, dl;
  uint4 r[4];
  __device__ __forceinline__ Split(char* st, int w, int task)
      : stage(st),
        e(task & 1),
        g8(w * PG + (task >> 1) / NDL),
        dl((task >> 1) % NDL) {}
  __device__ __forceinline__ void step(int k) {
    char* klo = stage + KT::BYTES;
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = ld16(klo, KT::at(8 * g8 + 2 * i + e, dl));
    } else if (k <= 4) {
      const int j = k - 1;
      const uint4 col = make_uint4(word(r[0], j), word(r[1], j),
                                   word(r[2], j), word(r[3], j));
      const int off = VT::at(4 * dl + j, 2 * g8 + e);
      char* vt = stage + 2 * KT::BYTES;
      st16(vt, off, hi4(col));
      st16(vt + VT::BYTES, off, lo4(col));
    } else {
      const int off = KT::at(8 * g8 + 2 * (k - 5) + e, dl);
      st16(klo, off, lo4(ld16(stage, off)));
    }
  }
};

template <class C>
__device__ __forceinline__ void convert_part(char* stage, int w, int t) {
  for (int task = t; task < Split<C>::TASKS; task += WG) {
    Split<C> sp(stage, w, task);
#pragma unroll
    for (int k = 0; k < Split<C>::STEPS; ++k) sp.step(k);
  }
}

// The unaligned path: the same stage contents through registers, element
// by element (f32 already split: no `convert_part`).
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

// VEC: q, k and v rows are all 16-byte aligned and whole, so the loops
// carry no element-by-element staging (its registers cost the aligned
// path spills and the wgmma descriptors their uniform registers)
template <class C, typename T, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    flash_fwd_kernel(const Params p) {
  using QT = typename C::QT;
  using KT = typename C::KT;
  using VT = typename C::VT;
  constexpr int S = C::STAGES, E = C::E, NS = C::NS;
  extern __shared__ __align__(128) char smem[];
  // mbarriers: full[S] (a stage's copies landed), empty[S] (both
  // warpgroups done with it), ready[S] (fenced for wgmma; f32: split),
  // qfull[NWG][QBUF]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  uint64_t* ready = empty + S;
  uint64_t* qfull = full + 3 * S;
  char* ring = smem + C::OFF_RING;

  const int tid = threadIdx.x;
  // the warpgroup index, warp-uniform by construction (wgmma is
  // .sync.aligned); warpgroup wg owns rows 64 wg .. 64 wg + 63 of an item
  const int wg = __shfl_sync(0xffffffffu, tid / WG, 0);
  const int t = tid % WG, wi = t / 32, lane = t % 32;
  const int g = lane / 4, tq = lane % 4;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], C::THREADS);
      mbar_init(&empty[i], C::THREADS / 32);  // one arrival a warp
      mbar_init(&ready[i], C::THREADS / 32);
    }
    for (int i = 0; i < C::NWG * C::QBUF; ++i) mbar_init(&qfull[i], WG);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this block's items, `item_index`
  const int x0 = blockIdx.x, grid = p.grid.d;
  const int mine = block_items(x0, p.grid, p.items, p.paired);
  auto item = [&](int j) {
    return item_at<C, T>(p, item_index(x0, j, grid, p.paired));
  };
  auto stage = [&](int x) { return ring + (x % S) * C::STAGE_BYTES; };
  auto q_region = [&](int buf) {
    return smem + C::BAR_BYTES + buf * C::Q_BYTES + wg * C::WQ_BYTES;
  };

  // The loader: every thread's share of the next tile of the block's
  // stream (tile lt of item lj), into stage issued % S once both
  // warpgroups are done with the tile that held it, in 2 KP passes (u):
  // the first waits for the stage, the last arrives on its full mbarrier
  // and moves the loader on (the staged path loads the whole tile then).
  int issued = 0, lj = 0, lt = 0;
  Item<T> li = item(0);
  auto load_pass = [&](int u) {
    if (lj >= mine) return;
    const int st = issued % S;
    if (u == 0 && issued >= S) mbar_wait(&empty[st], ((issued / S) + 1) & 1);
    char* dst = ring + st * C::STAGE_BYTES;
    if (VEC || p.kvvec) {
      copy_pass<C, T>(p, dst, li.k, li.v, lt * C::BK, tid, u);
      if (u < 2 * C::KP - 1) return;
      cp_async_arrive(&full[st]);
    } else {
      if (u < 2 * C::KP - 1) return;
      load_tile<C, T>(p, dst, li.k, li.v, lt * C::BK, tid);
      fence_proxy_async();
      mbar_arrive(&full[st]);
    }
    ++issued;
    if (++lt == li.nk) {
      lt = 0;
      if (++lj < mine) li = item(lj);
    }
  };
  auto load_next = [&]() {
#pragma unroll
    for (int u = 0; u < 2 * C::KP; ++u) load_pass(u);
  };
  // Once tile x has landed: f32 splits this warpgroup's keys of it; the
  // proxy fence orders the copies (and splits) before wgmma reads them,
  // and the stage is ready when every warp has fenced. The fence waits
  // for this thread's copies in flight, so it runs where the newest have
  // landed: before the next tile's copies are issued.
  auto prepare = [&](int x) {
    mbar_wait(&full[x % S], (x / S) & 1);
    if constexpr (C::F32) {
      if (VEC || p.kvvec) convert_part<C>(stage(x), wg, t);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&ready[x % S]);
  };

  // ---- prologue: the first item's Q, tiles 0 .. S - LAG - 1 in flight
  load_q<C, T, VEC>(p, item(0), q_region(0), wg, t, &qfull[wg * C::QBUF]);
  for (int x = 0; x + C::LAG < S; ++x) load_next();
  if constexpr (!C::F32 || S >= 3) {
    for (int x = 0; x < C::PREP; ++x) prepare(x);
  }

  // f32 at dh <= 128: Q-hi as TF32 A fragments in registers, (r, k) =
  // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each 8-column
  // step, and Q-lo in place of Q in shared memory; at dh 256 Q stays as
  // the hi operand and Q-lo is a second copy
  constexpr int QHI_STEPS = (C::F32 && !C::QLO_SMEM) ? C::DH / 8 : 1;
  uint32_t qhi[QHI_STEPS][4];
  // the softmax in base 2: exp(x s) = exp2(x s log2(e)), so m is kept in
  // the scaled base-2 domain
  const float scale2 = p.scale * 1.4426950408889634f;
  int s = 0;  // the stream's tile being computed

  for (int j = 0; j < mine; ++j) {
    const int buf = C::QBUF == 2 ? (j & 1) : 0;
    char* q_s = q_region(buf);
    // the item's state, set while its Q lands
    const int nk = item(j).nk;
    const int wr0 = item(j).r0 + 64 * wg;   // the warpgroup's first row
    const int wpos0 = p.group.div(wr0);     // ... and its position
    const int r0 = wr0 + 16 * wi + g;       // this thread's rows r0, r0 + 8
    // in an edge tile, row r masks its keys from lim[r] on: past Sk, or
    // (causal) past the row's position; this thread's column 8 jj + e is
    // key k0 + 8 jj + 2 tq + e
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lim[r] = (p.causal ? min(p.sk, p.group.div(r0 + 8 * r) + 1) : p.sk) -
               2 * tq;
    const uint32_t qb = smem_addr(q_s);
    float o[NS][32];
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[sl][i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(&qfull[wg * C::QBUF + buf], (j / C::QBUF) & 1);
    fence_proxy_async();  // Q, copied by cp.async, is read by wgmma
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
      for (int task = t; task < 64 * C::CK; task += WG) {
        const int off = QT::at(task / C::CK, task % C::CK);
        st16(lo_s, off, lo4(ld16(q_s, off)));
      }
      fence_proxy_async();
      warpgroup_sync(1 + wg);
      // f32 with 2 stages prepares the block's first tile once its first
      // Q is split (Q landed first)
      if constexpr (S == 2) {
        if (j == 0) prepare(0);
      }
    }

    // two Q buffers: the next item's Q into the other (its last use, the
    // item before's O, has been stored), once this item's first tile is
    // prepared (the fence would wait for it)
    auto next_q = [&]() {
      if constexpr (C::QBUF == 2) {
        if (j + 1 < mine)
          load_q<C, T, VEC>(p, item(j + 1), q_region(buf ^ 1), wg, t,
                       &qfull[wg * 2 + (buf ^ 1)]);
      }
    };
    for (int it = 0; it < nk; ++it, ++s) {
      const int k0 = it * C::BK;
      // bf16 (and f32 with 3+ stages) prepares tile s + PREP before
      // copying the next one
      if constexpr (!C::F32 || S >= 3) {
        if (s + C::PREP < issued) prepare(s + C::PREP);
        if (it == 0) next_q();
      }
      if constexpr (!(C::SPLIT_COPY && VEC)) load_next();  // s + S - LAG
      if constexpr (S == 1) prepare(s);
      mbar_wait(&ready[s % S], (s / S) & 1);
      // Every warpgroup computes every tile of the item: one wholly above
      // its diagonal (or a warpgroup past Sq * G) is all masked and adds
      // p = 0 with corr = 1, and branching around the asynchronous
      // products would make the compiler wait for them at the join.
      // f32: the hi x hi products chain into sc, the small hi x lo ones
      // into scc (see "Accumulation" above)
      constexpr int NCC = C::SPLIT == 2 ? C::BK / 2 : 1;
      float sc[C::BK / 2], scc[NCC];
      uint32_t vb;
      {
        uint32_t qbase = qb;
        asm volatile("" : "+r"(qbase));  // descriptors are built per tile
        const uint32_t kb = smem_addr(stage(s));
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
            wgmma_tf32_ss<C::BK>(scc, QT::desc(qbase + QT::BYTES, ks), dk,
                                 1);
          } else if constexpr (C::F32) {  // dq: Q-lo
            wgmma_tf32_rs<C::BK>(sc, qhi[ks], dk, 1);
            wgmma_tf32_rs<C::BK>(scc, qhi[ks], KT::desc(kb + KT::BYTES, ks),
                                 1);
            wgmma_tf32_ss<C::BK>(scc, dq, dk, 1);
          } else {
            wgmma_bf16_ss<C::BK>(sc, dq, dk, 1);
          }
          if constexpr (C::SPLIT_COPY && VEC) {  // tile s + 1, between them
            constexpr int KS = C::DH / C::KE, NP = 2 * C::KP;
#pragma unroll
            for (int u = 0; u < NP; ++u)
              if (u * KS / NP == ks) load_pass(u);
          }
        }
        wgmma_commit();
      }
      if constexpr (C::F32 && S <= 2) {
        if (it == 0) next_q();
      }
      {
        wgmma_wait_all();
        fence_regs<C::BK / 2>(sc);
        fence_regs<NCC>(scc);
        if constexpr (C::SPLIT == 2) {
#pragma unroll
          for (int i = 0; i < C::BK / 2; ++i) sc[i] += scc[i];
        }

        // online softmax of rows r0 (r = 0) and r0 + 8 (r = 1) over the
        // tile
        const bool edge =
            k0 + C::BK > p.sk || (p.causal && k0 + C::BK - 1 > wpos0);
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = NEG_INF;
#pragma unroll
          for (int jj = 0; jj < C::BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * jj + 2 * r + e] * scale2;
              if (edge && 8 * jj + e >= lim[r] - k0) x = NEG_INF;
              sc[4 * jj + 2 * r + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r], mx);
          corr[r] = exp2f(m[r] - m_new);
          m[r] = m_new;
          float sum = 0.0f;
#pragma unroll
          for (int jj = 0; jj < C::BK / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pe = exp2f(sc[4 * jj + 2 * r + e] - m_new);
              sc[4 * jj + 2 * r + e] = pe;
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

        // f32 with 2 stages prepares tile s + 1 (not the one being read)
        // under the first slice's products. The aligned path splits this
        // warpgroup's keys of it between the products, since the issue of
        // a product blocks the warp about as long as the product runs: the
        // wait for its copies after the first k-step, then a step of this
        // thread's task after each k-step (actions a = 0 .. STEPS after
        // k-step a * PSTEPS / (STEPS + 1)), the fence and the arrival on
        // its ready mbarrier once the slice is issued. The staged path
        // (split as it was loaded) waits and fences after the slice's
        // issue, keeping thread-dependent branches out of the products.
        constexpr bool PV_SPLIT = C::F32 && S == 2 && VEC;
        constexpr int NA = Split<C>::STEPS + 1;
        const bool nxt = C::F32 && S == 2 && s + 1 < issued;
        const bool conv = PV_SPLIT && nxt && t < Split<C>::TASKS;
        Split<C> sp(stage(s + 1), wg, t);

        // O += P V, PVG slices of 64 head dims at a time: the tile's
        // products chain into fresh accumulators acc, which O takes with
        // a rounded add
#pragma unroll
        for (int sg = 0; sg < NS; sg += C::PVG) {
          float acc[C::PVG][32];
#pragma unroll
          for (int u = 0; u < C::PVG; ++u) {
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[u][i] = 0.0f;
            fence_regs<32>(acc[u]);
          }
          wgmma_fence();
#pragma unroll
          for (int u = 0; u < C::PVG; ++u) {
            const int sl = sg + u;
#pragma unroll
            for (int ks = 0; ks < PSTEPS; ++ks) {
              if constexpr (C::F32) {
                const uint64_t dv = VT::desc(vb, ks, 64 * sl);
                wgmma_tf32_rs<64>(acc[u], ph[ks], dv, 1);
                wgmma_tf32_rs<64>(acc[u], pl[ks], dv, 1);
                wgmma_tf32_rs<64>(acc[u], ph[ks],
                                  VT::desc(vb + VT::BYTES, ks, 64 * sl), 1);
              } else {
                const uint64_t dvn = KT::desc_mn(vb, ks, 8 * sl);
                wgmma_bf16_rs_mn<64>(acc[u], ph[ks], dvn, 1);
                wgmma_bf16_rs_mn<64>(acc[u], pl[ks], dvn, 1);
              }
              if constexpr (PV_SPLIT) {
                if (sg == 0 && u == 0) {
#pragma unroll
                  for (int a = 0; a < NA; ++a) {
                    if (a * PSTEPS / NA != ks) continue;
                    if (a == 0 && nxt)
                      mbar_wait(&full[(s + 1) % S], ((s + 1) / S) & 1);
                    if (a > 0 && conv) sp.step(a - 1);
                    asm volatile("" ::: "memory");  // keep the step here
                  }
                }
              }
            }
          }
          wgmma_commit();
          if constexpr (PV_SPLIT) {
            if (sg == 0 && nxt) {  // tile s + 1 is ready for wgmma
              fence_proxy_async();
              __syncwarp();
              if (lane == 0) mbar_arrive(&ready[(s + 1) % S]);
            }
          } else if constexpr (C::F32 && S == 2) {
            if (sg == 0 && nxt) prepare(s + 1);
          }
          wgmma_wait_all();
#pragma unroll
          for (int u = 0; u < C::PVG; ++u) {
            fence_regs<32>(acc[u]);
#pragma unroll
            for (int i = 0; i < 32; ++i) o[sg + u][i] += acc[u][i];
          }
        }
      }
      // this warp's products on the stage have retired
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s % S]);
    }

    // ---- epilogue: out = O / max(l, 1e-30), l summed over the row's
    // quad, through the warpgroup's Q buffer (its products have retired):
    // rows of CK chunks, chunk c of row r at c ^ (r % 8), then 16-byte
    // stores along each row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    constexpr int RB = C::CK * 16;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float den = fmaxf(l[r], 1e-30f);
      const int row = 16 * wi + g + 8 * r;
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int byte = (64 * sl + 8 * jj + 2 * tq) * (int)sizeof(T);
          char* dst = q_s + row * RB + (((byte >> 4) ^ (row & 7)) << 4) +
                      (byte & 15);
          const float a = o[sl][4 * jj + 2 * r] / den;
          const float c = o[sl][4 * jj + 2 * r + 1] / den;
          if constexpr (C::F32)
            *reinterpret_cast<float2*>(dst) = make_float2(a, c);
          else
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(a, c);
        }
    }
    warpgroup_sync(1 + wg);
    T* const og = item(j).o;
    const int ce = t % C::CK;  // this thread's chunk of rows t / CK + RS u
    constexpr int RS = WG / C::CK;
#pragma unroll 4
    for (int u = 0; u < 64 / RS; ++u) {
      const int r = t / C::CK + RS * u, row = wr0 + r;
      const int pos = p.group.div(row);
      if (pos >= p.sq || ce * E >= p.dh) continue;
      const uint4 val = ld16(q_s, r * RB + ((ce ^ (r & 7)) << 4));
      T* dst = og + pos * p.os.s + (row - pos * p.group.d) * p.os.h + ce * E;
      if (p.ovec) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        union {
          uint4 v;
          Raw<T> e[E];
        } w;
        w.v = val;
        Raw<T>* d = reinterpret_cast<Raw<T>*>(dst);
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (ce * E + e < p.dh) d[e] = w.e[e];
      }
    }
    warpgroup_sync(1 + wg);  // the buffer is read before its next fill
    if constexpr (C::QBUF == 1) {
      if (j + 1 < mine)
        load_q<C, T, VEC>(p, item(j + 1), q_region(0), wg, t, &qfull[wg]);
    }
  }
}

// ---------------------------------------------------------------- plan

// (dh, warpgroups, keys per stage, stages, Q buffers, blocks per SM): see
// the note above; f(Cfg{}) for the configuration of (dtype, dh, Sk)
template <typename T, typename F>
int with_cfg(int dh, int sk, F&& f) {
  if constexpr (std::is_same<T, float>::value) {
    if (dh <= 64) {
      if (sk <= 32) return f(Cfg<T, 64, 2, 32, 2, 2, 1>{});
      return f(Cfg<T, 64, 2, 64, 2, 2, 1>{});
    }
    if (dh <= 128) return f(Cfg<T, 128, 2, 32, 2, 1, 1>{});
    return f(Cfg<T, 256, 1, 16, 1, 1, 1>{});
  } else {
    if (dh <= 64) {
      if (sk <= 32) return f(Cfg<T, 64, 2, 32, 4, 2, 2>{});
      return f(Cfg<T, 64, 2, 64, 4, 2, 1>{});
    }
    if (dh <= 128) return f(Cfg<T, 128, 2, 64, 4, 2, 1>{});
    return f(Cfg<T, 256, 2, 32, 3, 1, 1>{});
  }
}

enum PlanField {
  F_SMEM = 0,
  F_ITEMS,
  F_GRID,
  F_BK,
  F_STAGES,
  F_ROWS,
  F_BLOCKS_PER_SM,
  F_GROUP,
  F_QBUF,
  F_DH,
  F_WARPGROUPS,
  F_PAIRED
};

// items of the launch: batch * KV * ceil(Sq * G / BQ)
template <class C>
long long plan_items(int batch, int sq, int heads, int kv_heads) {
  const long long g = heads / kv_heads;
  return (long long)batch * kv_heads * ((sq * g + C::BQ - 1) / C::BQ);
}

template <class C>
long long plan_field(int batch, int sq, int heads, int kv_heads, int causal,
                     int sms, int field) {
  const long long items = plan_items<C>(batch, sq, heads, kv_heads);
  const bool paired = causal && items > (long long)C::MINB * sms;
  switch (field) {
    case F_SMEM: return C::SMEM;
    case F_ITEMS: return items;
    case F_GRID: {
      const long long resident = (long long)C::MINB * sms;
      const long long units = paired ? (items + 1) / 2 : items;
      return units < resident ? units : resident;
    }
    case F_PAIRED: return paired;
    case F_BK: return C::BK;
    case F_STAGES: return C::STAGES;
    case F_ROWS: return C::BQ;
    case F_BLOCKS_PER_SM: return C::MINB;
    case F_GROUP: return heads / kv_heads;
    case F_QBUF: return C::QBUF;
    case F_DH: return C::DH;
    case F_WARPGROUPS: return C::NWG;
    default: return -1;
  }
}

int num_sms(int device) {
  static int cache[64] = {0};
  if (device >= 0 && device < 64 && cache[device] > 0) return cache[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      n <= 0)
    n = 1;
  if (device >= 0 && device < 64) cache[device] = n;
  return n;
}

template <class C, typename T>
int launch(Params p, int batch, int heads, int device, cudaStream_t stream) {
  const bool vec = p.qvec && p.kvvec;
  auto kernel =
      vec ? flash_fwd_kernel<C, T, true> : flash_fwd_kernel<C, T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long items = plan_items<C>(batch, p.sq, heads, p.kv.d);
  if (items > INT_MAX || (long long)p.sq * p.group.d > INT_MAX)
    return (int)cudaErrorInvalidValue;
  p.nt = Div::of((int)((p.sq * (long long)p.group.d + C::BQ - 1) / C::BQ));
  p.items = (int)items;
  const int sms = num_sms(device);
  p.paired = (int)plan_field<C>(batch, p.sq, heads, p.kv.d, p.causal, sms,
                                F_PAIRED);
  const int grid = (int)plan_field<C>(batch, p.sq, heads, p.kv.d, p.causal,
                                      sms, F_GRID);
  p.grid = Div::of(grid);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
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
  p.group = Div::of(heads / kv_heads);
  p.kv = Div::of(kv_heads);
  p.sq = sq;
  p.sk = sk;
  p.dh = dh;
  p.causal = causal;
  p.nt = p.grid = Div::of(1);
  p.items = p.paired = 0;
  p.qvec = rows_aligned(q, q_sb, q_ss, q_sh, batch, sq, heads, dh, item);
  p.kvvec =
      rows_aligned(k, k_sb, k_ss, k_sh, batch, sk, kv_heads, dh, item) &&
      rows_aligned(v, v_sb, v_ss, v_sh, batch, sk, kv_heads, dh, item);
  p.ovec = rows_aligned(o, o_sb, o_ss, o_sh, batch, sq, heads, dh, item);
  p.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto c) {
    using C = decltype(c);
    using T = typename std::conditional<C::F32, float, __nv_bfloat16>::type;
    return launch<C, T>(p, batch, heads, device, s);
  };
  return bf16 ? with_cfg<__nv_bfloat16>(dh, sk, go)
              : with_cfg<float>(dh, sk, go);
}

// The launch plan of a call, field by field (0 shared-memory bytes per
// block, 1 items, 2 grid on `sms` SMs, 3 keys per stage, 4 stages, 5 packed
// rows per item, 6 resident blocks per SM, 7 G, 8 Q buffers, 9 the
// configuration's head dim, 10 warpgroups, 11 whether blocks take pairs
// of items; -1 for another field): the C
// mirror of `kernels/flash_attention.py:flash_plan`. Launches nothing.
extern "C" int flash_plan_field(int bf16, int batch, int sq, int sk,
                                int heads, int kv_heads, int dh, int causal,
                                int sms, int field) {
  if (batch < 1 || sq < 1 || sk < 1 || kv_heads < 1 || heads % kv_heads ||
      dh < 1 || dh > 256 || sms < 1)
    return -1;
  auto f = [&](auto c) {
    return (int)plan_field<decltype(c)>(batch, sq, heads, kv_heads, causal,
                                        sms, field);
  };
  return bf16 ? with_cfg<__nv_bfloat16>(dh, sk, f)
              : with_cfg<float>(dh, sk, f);
}
