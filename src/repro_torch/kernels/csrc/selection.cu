// Peer selection (WPFed Eq. 6-8 + top-N) for Hopper (sm_90a): the exact
// one-shot and column-tiled entry points and the grouped ANN one, one
// design.
//
// Replaces repro/kernels/selection.py:fused_select (_select_kernel),
// repro/kernels/selection.py:fused_select_tiled (_select_tiled_kernel)
// and repro/kernels/selection.py:fused_select_ann (_select_ann_kernel;
// the grouped entry point, below: the ANN route's per-bucket lists on the
// tile instance, the per-row function's arbitrary lists on the one-row
// instance).
// For every client row i: the Hamming distance d_ij to every code, the
// weight w_ij = s_j * LUT[d_ij] under the Table-3 switches (use_rank off:
// LUT[d_ij]; use_lsh off: s_j, or 1 with both off), self at -inf, and the
// top N by weight descending, then id ascending (jax.lax.top_k's order).
// The LUT is the wrapper's (W*32+1)-entry exp table, shared with the plain
// versions, so weights equal theirs bit for bit; no exp runs here.
//
// Bound on the H100: the 2*M*M*W*32 operations of the TPU kernel's +-1
// Gram at the int8 tensor-core rate (1,979 TOP/s dense: 1.1 ms at
// M=65,536, W=8), and the M*M epilogue (a table read, a product, a
// compare per pair); the codes are M*W*4 bytes. At the main path's M=10
// it is launch latency.
//
// The design:
// - Distances on the tensor cores, exactly. The TPU kernel takes the +-1
//   Gram on the MXU (d = (W*32 - dot) / 2). Here the binary tensor-core
//   product mma.sync.m16n8k256 .b1 .and.popc takes popc(a & b) over 256
//   bits a step straight from the packed codes, and
//   d = popc(a) + popc(b) - 2 * popc(a & b), exact integers. An int8 +-1
//   Gram through mma.m16n8k32 (the codes unpacked in shared memory) gives
//   the same bits and ran slower on the H100 at every shape timed. Codes
//   are padded with zero words to KW, a multiple of 8 words (one k256 step each; 8, 16 or 32, one
//   template instance each); zero words add nothing to any popcount.
//   Word k of a row or column is the k-chunk it feeds: lane group tig
//   holds words 8s + tig (a0/a1, b0) and 8s + 4 + tig (a2/a3, b1) of step
//   s, the fragment layouts of m16n8k256.
// - A CTA of 1-4 warps owns a tile of rows, 32 a warp (two m16 tiles), a
//   multiple of 16. A warp's own rows' words and popcounts stay in
//   registers. The CTA walks its columns in ascending id in tiles of
//   BK = 64 codes and scores, brought into shared memory by cp.async, two
//   stages, the next tile in flight while this one is computed, and the
//   tile's column popcounts once per CTA. Per 8 columns a lane reads two
//   packed words a step and feeds two mmas.
// - Epilogue in registers: per pair the distance, one table read, one
//   product by the score, one compare with the row's threshold (the row's
//   last-ranked kept weight once it holds N, NaN before: every weight
//   passes an unordered compare). Self, the ragged end and rows past M
//   are handled only in the 8-column steps that touch them.
// - Lists in shared memory, one per row, owned by one lane. When any lane
//   of a warp has a candidate, the warp's weights go through an 8-column
//   exchange tile and lane l takes local row l: its 8 columns in ascending
//   id, each candidate filling a free slot or replacing the row's
//   last-ranked entry (smallest weight, of equal ones the largest id),
//   then the new last-ranked is found. Columns arrive in ascending id, so
//   a weight equal to the last-ranked one ranks after it and is not
//   taken: the list is the top N of the columns seen. Once the lists are
//   full, most pairs cost one compare.
// - Filling the card (selection.py:select_plan, from M, W, N alone): CTAs
//   of fewer warps while M leaves SMs empty, then the columns split over
//   S <= 8 CTAs of a thread-block cluster, each walking one contiguous
//   range. Each lane then sorts its row (one split: writes each entry to
//   its rank; several: sorts in place); after a cluster barrier each CTA
//   merges 1/S of the rows, 8 lanes a row reading the S sorted lists
//   through distributed shared memory, ties to the earlier split (the
//   smaller ids). That is exactly the top N of the whole row, so the bits
//   do not depend on S.
// - N > 128 or W > 32 (the one-shot entry point only; the plan picks it by
//   shape): one block of 256 threads per row, the row's weights and a
//   taken bit per column in shared memory and N first-max knockout passes
//   (distances by XOR + popcount).
// - The grouped ANN instance (fused_select_ann_grouped). A client's ANN
//   candidates depend only on its bucket (core/ann.py:bucket_candidates
//   gives one list of k positions per non-empty bucket, the sentinel m in
//   invalid ones), so up to `rows` clients of one slot are a tile of this
//   design whose columns are the slot's positions. A tile finds its slot
//   by a search over starts[] (no count comes back to the host: the grid
//   is m / rows + n_slots tiles, the surplus exits), its rows through
//   order[]; a column's code and score are gathered by its id with
//   cp.async (ids read one tile ahead into a ring of three), a sentinel's
//   as zero. A sentinel or the row itself weighs -inf and never enters a
//   list (lists start from a -inf threshold, and ranks left empty are
//   written as id 0, weight -inf, as the plain version gives them);
//   8-column steps of sentinels alone are skipped; ties rank by position;
//   ids map from positions at the output, 0 where the weight is not
//   finite. Each lane walks only its candidate columns of a step, and
//   for N <= 16 keeps its list in registers. Bound on the H100: the +-1
//   Gram of each client against its slot's valid candidates (2*W*32 int8
//   operations a pair at 1,979 TOP/s: 0.011 ms for 65,536 clustered
//   clients at K = 2,336) or the lists, codes and outputs read once
//   (0.0004 ms at 4,096); at 65,536 it runs far above both.
// - The one-row instance of the grouped entry point (warp_rows = 1). The
//   per-row function (selection.py:fused_select_ann) has arbitrary lists,
//   one a client (core/ann.py:per_row_slots: one slot a row). A tile of
//   that form holds one live row, so the tile instance runs one row's
//   products and epilogue on a warp built for 32 (2.8x the per-row
//   kernel it replaced at 65,536 clients, K = 2,336, in one H100 run;
//   selection.py:ann_plan says what was timed). Here a warp takes one
//   client: it finds the client's slot by the same search over starts[],
//   and its lanes walk the slot's positions, 32 * P a step, each lane
//   gathering its candidate's code words (16-byte loads where W % 4 == 0)
//   and score by id and taking the distance by XOR + popcount. The next
//   step's codes and scores are in flight while this step's are weighed,
//   its ids two steps ahead. The running top N lives across the warp's
//   registers, rank q * 32 + lane in lane `lane`: a candidate above the
//   threshold (the N-th weight once N are kept, -inf before, so no -inf
//   weight enters) goes in at rank #{kept weights >= it} (later
//   positions of equal weight rank after), the ranks behind it shift by
//   one lane, all in a few warp instructions; candidates go in in
//   position order, so the list is the first N of a stable sort by
//   position, as lax.top_k gives them. The list is the output, its ranks
//   past the count (0, -inf). Bound on the H100: the lists read once (the
//   M*K*4 bytes: 0.18 ms at 65,536, K = 2,336); the gathered codes come
//   from L2 (4.9 GB there; 0.78 ms in one H100 run), so it runs above it.
// Nothing is atomic and every list sees its columns in one order, so a
// launch gives the same bits every time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 64;               // columns per staged tile
constexpr int T = 2;                 // m16 row tiles a warp holds
constexpr int MAX_WARPS = 4;
constexpr int MAX_SPLITS = 8;        // the portable cluster size
constexpr int MAX_NSEL = 128;
constexpr int NR_LIST = 16;          // grouped: lists in registers to here
constexpr int KNOCK_THREADS = 256;   // knockout instance
constexpr int NONE = 0x7fffffff;     // "no candidate" index
constexpr int MAX_ROW_WARPS = 8;     // one-row instance: warps (clients) a CTA

struct Args {
  const uint32_t* codes;   // (m, w) packed bits
  const float* scores;     // (m,)
  const float* lut;        // (w*32 + 1,)
  int m, w, nsel, use_lsh, use_rank;
  int rows, splits, split_len;   // the plan (mma instances)
  int* ids_out;            // (m, nsel)
  float* w_out;            // (m, nsel)
  // the grouped (ANN) instance: one candidate list of k positions per
  // slot, the clients in slot order and each slot's offset into it
  const int* lists;        // (n_slots, k), sentinel m
  const int* order;        // (m,)
  const int* starts;       // (n_slots + 1,)
  int k, n_slots, vec;     // vec: codes rows on 16 bytes (w % 4 == 0)
};

// Words a staged column takes in shared memory: an odd multiple of 4, so
// the 8 columns x 4 words an mma step reads fall in 32 banks.
__host__ __device__ constexpr int word_stride(int kw) { return kw + 4; }

// Words between two rows' lists. Exact instances: N rounded up to 4, then
// to an odd multiple of 4, so the 8 lanes of a 16-byte access phase hit 8
// banks. Grouped: N made odd, so the 32 lanes of a warp, each on its own
// row's list, hit 32 banks.
__host__ __device__ constexpr int row_stride(int nsel, bool grouped) {
  return grouped ? nsel | 1 : 4 * (((nsel + 3) / 4) | 1);
}

// Dynamic shared memory of an mma CTA, in 4-byte words (mirrored by
// selection.py:select_smem_bytes and ann_smem_bytes): the table (to 16
// bytes), two stages of BK codes and scores, the tile's column popcounts,
// the rows' lists (values, ids; row_stride a row), each warp's
// 8-column exchange tile (8 words a row), a count per row (for the
// merge) and, in the grouped instance, three tiles of BK candidate ids.
struct Layout {
  int stage, codes0, pcol, list_v, list_i, tile, cnt, ids, bytes;
};

__host__ __device__ inline Layout layout(int kw, int rows, int nsel,
                                         bool grouped = false) {
  Layout l;
  const int lut_words = (kw * 32 + 1 + 3) / 4 * 4;
  l.stage = BK * word_stride(kw) + BK;
  l.codes0 = lut_words;
  l.pcol = lut_words + 2 * l.stage;
  l.list_v = l.pcol + BK;
  l.list_i = l.list_v + rows * row_stride(nsel, grouped);
  l.tile = l.list_i + rows * row_stride(nsel, grouped);
  l.cnt = l.tile + 8 * rows;
  l.ids = l.cnt + rows;
  l.bytes = 4 * (l.ids + (grouped ? 3 * BK : 0));
  return l;
}

// c += popc(a & b) over a 16 x 8 x 256-bit step.
__device__ __forceinline__ void mma_and_popc(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (v1, i1) ranks before (v2, i2): larger weight, then smaller id.
__device__ __forceinline__ bool ahead(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// The slot of the last-ranked of a row's n kept entries (values lv, ids
// li): the smallest weight, of equal ones the largest id.
__device__ __forceinline__ int last_slot(const float* lv, const int* li,
                                         int n) {
  int ws = 0;
  float wv = lv[0];
  int wi = li[0];
#pragma unroll 4
  for (int q = 1; q < n; ++q) {
    const float x = lv[q];
    const int xi = li[q];
    if (ahead(wv, wi, x, xi)) {
      ws = q;
      wv = x;
      wi = xi;
    }
  }
  return ws;
}

// FULL: both Table-3 switches on (the protocol's default), compiled
// without the flags' branches. GROUPED: the ANN instance (the grouped
// entry point below): a tile is up to `rows` clients of one slot, its
// columns the k candidate positions of the slot's list. NR > 0 (N <= NR):
// each lane keeps its row's list in registers while the columns stream
// by, every index static, so an insertion and the search for the new
// last-ranked entry are a chain of register operations, not of
// shared-memory accesses; the list goes to shared memory for the output.
template <int KW, bool FULL, bool GROUPED, int NR = 0>
__device__ void select_mma(const Args& a) {
  constexpr int ST = KW / 8;                  // k256 steps
  constexpr int WP = word_stride(KW);
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout L = layout(KW, a.rows, a.nsel, GROUPED);
  float* lut_s = reinterpret_cast<float*>(smem);
  int* pcol = reinterpret_cast<int*>(smem + L.pcol);
  float* list_v = reinterpret_cast<float*>(smem + L.list_v);
  int* list_i = reinterpret_cast<int*>(smem + L.list_i);
  int* cnt_s = reinterpret_cast<int*>(smem + L.cnt);
  int* ids_s = reinterpret_cast<int*>(smem + L.ids);   // grouped: 3 x BK

  const int rows = a.rows, stride = row_stride(a.nsel, GROUPED);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nthreads = blockDim.x;
  const int split = blockIdx.x % a.splits;
  const int wr = warp * 16 * T;                 // warp's first local row
  const int nsel = a.nsel, w = a.w;
  const bool lsh = a.use_lsh != 0, rank = a.use_rank != 0;
  const float nan = __int_as_float(0x7fc00000);
  // exact: rows row0.. of the codes against columns 0..m-1; grouped:
  // positions row0.. of `order`, all in one slot, against the positions
  // 0..k-1 of that slot's candidate list
  int row0, live, ncols;
  const int* list = nullptr;
  if constexpr (GROUPED) {
    // the tile's slot: the last s with key starts[s] / rows + s <= tile.
    // The keys rise with s and slot s owns the tiles from its key on, one
    // per `rows` clients, so a bound of m / rows + n_slots tiles needs
    // nothing from the data. Each warp searches 32 ways at a time, then
    // reads the slot's offsets.
    const int tile = blockIdx.x / a.splits;
    int lo = 0, hi = a.n_slots;
    while (hi - lo > 1) {
      const int step = (hi - lo + 31) / 32;
      const int s = lo + lane * step;
      const bool le = s < hi && __ldg(a.starts + s) / rows + s <= tile;
      const int last = 31 - __clz(__ballot_sync(0xffffffffu, le));
      hi = min(hi, lo + (last + 1) * step);
      lo += last * step;
    }
    const int first = __ldg(a.starts + lo);
    const int n_s = __ldg(a.starts + lo + 1) - first;
    const int j = tile - (first / rows + lo);
    if (j * rows >= n_s) return;      // past the slot's clients: no tile
    row0 = first + j * rows;
    live = min(rows, n_s - j * rows);
    ncols = a.k;
    list = a.lists + (size_t)lo * a.k;
  } else {
    row0 = (blockIdx.x / a.splits) * a.rows;
    live = min(rows, a.m - row0);
    ncols = a.m;
  }
  const int c_begin = min(ncols, split * a.split_len);
  const int c_end = min(ncols, c_begin + a.split_len);

  // grouped: each column's code and score are gathered by its candidate
  // id (from the id tile `ids`), a sentinel's as zero
  auto stage = [&](int tc0, int buf, const int* ids) {
    uint32_t* cs = smem + L.codes0 + buf * L.stage;
    float* ss = reinterpret_cast<float*>(cs + BK * WP);
    const int nk = min(BK, c_end - tc0);
    if (FULL || lsh) {
      if constexpr (GROUPED) {
        if (a.vec) {
          const int q4 = w >> 2;
          for (int e = tid; e < nk * q4; e += nthreads) {
            const int col = e / q4, q = 4 * (e - col * q4);
            const int id = ids[col];
            uint32_t* dst = cs + col * WP + q;
            if (id < a.m)
              cp_async16(dst, a.codes + (size_t)id * w + q);
            else
              *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
        } else {
          for (int e = tid; e < nk * w; e += nthreads) {
            const int col = e / w, q = e - col * w;
            const int id = ids[col];
            if (id < a.m)
              cp_async4(cs + col * WP + q, a.codes + (size_t)id * w + q);
            else
              cs[col * WP + q] = 0u;
          }
        }
      } else {
        const uint32_t* src = a.codes + (size_t)tc0 * w;
        for (int e = tid; e < nk * w; e += nthreads) {
          const int col = e / w;
          cp_async4(cs + col * WP + (e - col * w), src + e);
        }
      }
    }
    if (FULL || rank) {
      for (int e = tid; e < nk; e += nthreads) {
        if constexpr (GROUPED) {
          const int id = ids[e];
          if (id < a.m)
            cp_async4(ss + e, a.scores + id);
          else
            ss[e] = 0.0f;
        } else {
          cp_async4(ss + e, a.scores + tc0 + e);
        }
      }
    }
    cp_async_commit();
  };
  // grouped: the candidate ids of the tile at tc0 (sentinel past the
  // split), BK into registers, then into a ring of three id tiles: a
  // tile's ids are read one tile before its codes are staged
  auto load_ids = [&](int tc0, int (&r)[2]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + q * nthreads, pos = tc0 + e;
      r[q] = e < BK && pos < c_end ? __ldg(list + pos) : a.m;
    }
  };
  auto store_ids = [&](int buf, const int (&r)[2]) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = tid + q * nthreads;
      if (e < BK) ids_s[buf * BK + e] = r[q];
    }
  };

  // this warp's rows: A fragments (words 8s + tig and 8s + 4 + tig of
  // rows g and g + 8 of each m16 tile) and popcounts, once; grouped: the
  // rows' client ids (-1 past the tile) for the self mask
  uint32_t af[T][ST][4];
  int prow[T][2];
  int rid[T][2];
  auto load_rows = [&]() {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int llo = wr + 16 * t + g, lhi = llo + 8;
      int rlo = row0 + llo, rhi = row0 + lhi;
      bool inlo = rlo < a.m, inhi = rhi < a.m;
      if constexpr (GROUPED) {
        inlo = llo < live;
        inhi = lhi < live;
        rlo = inlo ? __ldg(a.order + rlo) : -1;
        rhi = inhi ? __ldg(a.order + rhi) : -1;
      }
      rid[t][0] = rlo;
      rid[t][1] = rhi;
      prow[t][0] = prow[t][1] = 0;
#pragma unroll
      for (int k = 0; k < KW; ++k) {
        const bool in = (FULL || lsh) && k < w;
        const uint32_t xl = in && inlo ? a.codes[(size_t)rlo * w + k] : 0u;
        const uint32_t xh = in && inhi ? a.codes[(size_t)rhi * w + k] : 0u;
        prow[t][0] += __popc(xl);
        prow[t][1] += __popc(xh);
        if ((k & 3) == tig) {
          af[t][k / 8][(k & 4) ? 2 : 0] = xl;
          af[t][k / 8][(k & 4) ? 3 : 1] = xh;
        }
      }
    }
  };

  // the first tile is in flight while the table and the rows load
  const int ntiles = (c_end - c_begin + BK - 1) / BK;
  if constexpr (GROUPED) {       // the rows load while the ids arrive
    int r0[2], r1[2];
    load_ids(c_begin, r0);
    load_ids(c_begin + BK, r1);
    load_rows();
    store_ids(0, r0);
    store_ids(1, r1);
    __syncthreads();
  }
  if (ntiles > 0) stage(c_begin, 0, ids_s);
#pragma unroll 16
  for (int d = tid; d <= w * 32; d += nthreads) lut_s[d] = __ldg(a.lut + d);
  if ((FULL || lsh) && w < KW) {  // padding words of both stages
    for (int e = tid; e < 2 * BK * (KW - w); e += nthreads) {
      const int s = e / (BK * (KW - w)), rest = e % (BK * (KW - w));
      smem[L.codes0 + s * L.stage + (rest / (KW - w)) * WP + w +
           rest % (KW - w)] = 0u;
    }
  }

  if constexpr (!GROUPED) load_rows();

  // thresholds of this lane's fragment rows. Grouped: -inf until a list
  // is full, so no -inf weight (a sentinel, the row itself) ever enters
  // one (the output's fill gives them), and +inf for rows past the tile,
  // so no column is a candidate there.
  float thr[T][2];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    thr[t][0] = thr[t][1] = nan;
    if constexpr (GROUPED) {
      thr[t][0] = rid[t][0] >= 0 ? -INFINITY : INFINITY;
      thr[t][1] = rid[t][1] >= 0 ? -INFINITY : INFINITY;
    }
  }
  // local row wr + lane is this lane's alone: its list's count,
  // threshold and last-ranked slot
  const bool own_ok = GROUPED ? wr + lane < live : row0 + wr + lane < a.m;
  int cnt_own = 0, last_own = 0;
  float thr_own = nan;
  if constexpr (GROUPED) thr_own = own_ok ? -INFINITY : INFINITY;
  float rv[NR > 0 ? NR : 1];          // NR > 0: the list in registers
  int ri[NR > 0 ? NR : 1];
  // a candidate (weight x, column or position pos) fills a free slot or
  // replaces the last-ranked entry, then the new last is found
  auto insert = [&](float x, int pos) {
    const int slot = cnt_own < nsel ? cnt_own++ : last_own;
    if constexpr (NR > 0) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        if (q == slot) {
          rv[q] = x;
          ri[q] = pos;
        }
      }
      if (cnt_own == nsel) {          // last_slot over the registers
        float wv = rv[0];
        int wi = ri[0], ws = 0;
#pragma unroll
        for (int q = 1; q < NR; ++q) {
          if (q < nsel && ahead(wv, wi, rv[q], ri[q])) {
            ws = q;
            wv = rv[q];
            wi = ri[q];
          }
        }
        last_own = ws;
        thr_own = wv;
      }
    } else {
      float* lv = list_v + (wr + lane) * stride;
      int* li = list_i + (wr + lane) * stride;
      lv[slot] = x;
      li[slot] = pos;
      if (cnt_own == nsel) {
        last_own = last_slot(lv, li, nsel);
        thr_own = lv[last_own];
      }
    }
  };
  float* tile = reinterpret_cast<float*>(smem + L.tile) + wr * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int tc0 = c_begin + it * BK;
    int nid[2];
    if (it + 1 < ntiles) {
      stage(tc0 + BK, (it + 1) & 1, ids_s + ((it + 1) % 3) * BK);
      if constexpr (GROUPED) {
        if (it + 2 < ntiles) load_ids(tc0 + 2 * BK, nid);
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t* cs = smem + L.codes0 + (it & 1) * L.stage;
    const float* ss = reinterpret_cast<const float*>(cs + BK * WP);
    const int nk = min(BK, c_end - tc0);
    if (FULL || lsh) {
      // the tile's column popcounts, once for the CTA; the columns past
      // the ragged end as a zero code, so every distance indexes the table
      for (int col = tid; col < ((nk + 7) & ~7); col += nthreads) {
        int pc = 0;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          if (col >= nk) cs[col * WP + k] = 0u;
          pc += __popc(cs[col * WP + k]);
        }
        pcol[col] = pc;
      }
      __syncthreads();
    }
    // grouped: the tile's ids; 8-column steps of sentinels alone, and
    // all steps of a warp whose rows lie past the tile, are skipped (they
    // could only add -inf entries, which the output's fill gives as well)
    const int* ids_t = ids_s + (it % 3) * BK;
    unsigned long long valid = ~0ull;
    if constexpr (GROUPED) {
      valid = __ballot_sync(0xffffffffu, ids_t[lane] < a.m) |
              (unsigned long long)__ballot_sync(0xffffffffu,
                                                ids_t[lane + 32] < a.m)
                  << 32;
      if (wr >= live) valid = 0;
    }
    for (int n0 = 0; n0 < nk; n0 += 8) {
      if (((valid >> n0) & 0xffull) == 0) continue;
      int acc[T][4];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t][0] = acc[t][1] = acc[t][2] =
          acc[t][3] = 0;
      if (FULL || lsh) {
        __syncwarp();        // mma.sync.aligned: the whole warp, converged
#pragma unroll
        for (int st = 0; st < ST; ++st) {
          const uint32_t b0 = cs[(n0 + g) * WP + 8 * st + tig];
          const uint32_t b1 = cs[(n0 + g) * WP + 8 * st + 4 + tig];
#pragma unroll
          for (int t = 0; t < T; ++t)
            mma_and_popc(acc[t], af[t][st], b0, b1);
        }
      }
      // the epilogue: weights, candidates, lists
      const int j0 = tc0 + n0;
      const int2 pc = *reinterpret_cast<const int2*>(pcol + n0 + 2 * tig);
      const float2 s = (FULL || rank) ? *reinterpret_cast<const float2*>(
                                            ss + n0 + 2 * tig)
                                      : make_float2(1.0f, 1.0f);
      // grouped: a column is the candidate id cid; a sentinel or the
      // row's own id weighs -inf and is no candidate (columns past the
      // split hold sentinels, rows past the tile a threshold of +inf)
      int2 cid = make_int2(0, 0);
      if constexpr (GROUPED)
        cid = *reinterpret_cast<const int2*>(ids_t + n0 + 2 * tig);
      // exact: self, the split's ragged end and rows past M only where
      // they occur
      const bool edge = !GROUPED &&
                        (j0 + 8 > c_end || row0 + wr + 16 * T > a.m ||
                         (j0 < row0 + wr + 16 * T && j0 + 8 > row0 + wr));
      float v[T][4];
      bool cand[T][4];
      bool any = false;
      if (FULL && !edge) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int d = prow[t][i >> 1] + ((i & 1) ? pc.y : pc.x) -
                          2 * acc[t][i];
            v[t][i] = ((i & 1) ? s.y : s.x) * lut_s[d];
            bool ok = true;
            if constexpr (GROUPED) {
              const int c = (i & 1) ? cid.y : cid.x;
              ok = c < a.m && c != rid[t][i >> 1];
              if (!ok) v[t][i] = -INFINITY;
            }
            cand[t][i] = ok && !(v[t][i] <= thr[t][i >> 1]);
            any |= cand[t][i];
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sc = (i & 1) ? s.y : s.x;
            float x = sc;
            if (FULL || lsh) {
              const int d = prow[t][i >> 1] + ((i & 1) ? pc.y : pc.x) -
                            2 * acc[t][i];
              const float l = lut_s[d];
              x = (FULL || rank) ? sc * l : l;
            }
            bool ok;
            if constexpr (GROUPED) {
              const int c = (i & 1) ? cid.y : cid.x;
              ok = c < a.m && c != rid[t][i >> 1];
              if (!ok) x = -INFINITY;
            } else {
              const int row = row0 + wr + 16 * t + g + (i >> 1) * 8;
              const int col = j0 + 2 * tig + (i & 1);
              if (col == row) x = -INFINITY;
              ok = col < c_end && row < a.m;
            }
            v[t][i] = x;
            cand[t][i] = ok && !(x <= thr[t][i >> 1]);
            any |= cand[t][i];
          }
        }
      }
      if (__any_sync(0xffffffffu, any)) {
        // through the warp's tile: lane l takes local row wr + l, its 8
        // columns in ascending id; a candidate fills a free slot or
        // replaces the row's last-ranked entry, then the new last is found
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tile[(16 * t + g + (i >> 1) * 8) * 8 + 2 * tig + (i & 1)] =
                v[t][i];
        __syncwarp();
        if (own_ok) {
          const float4 lo = *reinterpret_cast<const float4*>(tile + lane * 8);
          const float4 hi =
              *reinterpret_cast<const float4*>(tile + lane * 8 + 4);
          const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          const int ncol = min(8, c_end - j0);
          if constexpr (GROUPED) {
            // each lane walks only the columns that pass its threshold on
            // entry (a bit each), so a step costs the warp its busiest
            // lane's insertions, not one pass per column any lane takes
            unsigned cm = 0;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              cm |= c < ncol && !(x[c] <= thr_own) ? 1u << c : 0u;
            while (cm) {
              const int c = __ffs(cm) - 1;
              cm &= cm - 1;
              float xc = x[0];
#pragma unroll
              for (int q = 1; q < 8; ++q) xc = c == q ? x[q] : xc;
              if (!(xc <= thr_own)) insert(xc, j0 + c);
            }
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c)
              if (c < ncol && !(x[c] <= thr_own)) insert(x[c], j0 + c);
          }
        }
        // the fragment rows' thresholds, from their owner lanes
#pragma unroll
        for (int t = 0; t < T; ++t) {
          thr[t][0] = __shfl_sync(0xffffffffu, thr_own, 16 * t + g);
          thr[t][1] = __shfl_sync(0xffffffffu, thr_own, 16 * t + g + 8);
        }
      }
    }
    if constexpr (GROUPED) {
      if (it + 2 < ntiles) store_ids((it + 2) % 3, nid);
    }
    __syncthreads();        // this stage is free for the tile after next
  }
  if constexpr (NR > 0) {   // the register list to its row in shared memory
    if (own_ok) {
#pragma unroll
      for (int q = 0; q < NR; ++q) {
        if (q < cnt_own) {
          list_v[(wr + lane) * stride + q] = rv[q];
          list_i[(wr + lane) * stride + q] = ri[q];
        }
      }
    }
  }

  if (a.splits == 1) {
    // one split: each lane writes its row's entries straight to their
    // ranks (the count of entries ahead of each); grouped: positions to
    // candidate ids (0 where the weight is not finite), and ranks past
    // the entries kept (skipped sentinels) as (0, -inf)
    if (own_ok) {
      const float* lv = list_v + (wr + lane) * stride;
      const int* li = list_i + (wr + lane) * stride;
      int out_row = row0 + wr + lane, cn = nsel;
      if constexpr (GROUPED) {
        out_row = __ldg(a.order + row0 + wr + lane);
        cn = cnt_own;
      }
      const size_t out = (size_t)out_row * nsel;
      for (int e = 0; e < cn; ++e) {
        const float ve = lv[e];
        const int ie = li[e];
        int rank = 0;
#pragma unroll 4
        for (int f = 0; f < cn; ++f) rank += ahead(lv[f], li[f], ve, ie);
        if constexpr (GROUPED)
          a.ids_out[out + rank] = isfinite(ve) ? __ldg(list + ie) : 0;
        else
          a.ids_out[out + rank] = ie;
        a.w_out[out + rank] = ve;
      }
      for (int e = cn; e < nsel; ++e) {
        a.ids_out[out + e] = 0;
        a.w_out[out + e] = -INFINITY;
      }
    }
    return;
  }
  // each lane sorts its row in place, best first, for the merge (an
  // insertion sort under the total order), and publishes its count
  if (own_ok) {
    float* lv = list_v + (wr + lane) * stride;
    int* li = list_i + (wr + lane) * stride;
    for (int e = 1; e < cnt_own; ++e) {
      const float ve = lv[e];
      const int ie = li[e];
      int p = e;
      for (; p > 0 && ahead(ve, ie, lv[p - 1], li[p - 1]); --p) {
        lv[p] = lv[p - 1];
        li[p] = li[p - 1];
      }
      lv[p] = ve;
      li[p] = ie;
    }
  }
  cnt_s[wr + lane] = cnt_own;
  // merge the S column splits of each of this CTA's 1/S of the rows: 8
  // lanes a row, lane q walking split q's sorted list through distributed
  // shared memory; each step the group's best head (weight, then id: ids
  // are unique across splits, so ties go to the earlier split) is written
  // and its lane advances; grouped: an exhausted row writes (0, -inf)
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int S = a.splits;
  const int per = (rows + S - 1) / S;
  const int r_hi = min(live, (split + 1) * per);
  const int q = tid & 7;
  const unsigned gmask = 0xffu << (lane & 24);
  for (int r = split * per + (tid >> 3); r < r_hi; r += nthreads >> 3) {
    const float* rv = q < S ? cluster.map_shared_rank(list_v, q) + r * stride
                            : nullptr;
    const int* ri = q < S ? cluster.map_shared_rank(list_i, q) + r * stride
                          : nullptr;
    const int cn = q < S ? *cluster.map_shared_rank(cnt_s + r, q) : 0;
    int head = 0;
    float hv = cn > 0 ? rv[0] : -INFINITY;
    int hi = cn > 0 ? ri[0] : NONE;
    int out_row = row0 + r;
    if constexpr (GROUPED) out_row = __ldg(a.order + row0 + r);
    const size_t out = (size_t)out_row * nsel;
    for (int p = 0; p < nsel; ++p) {
      float bv = hv;
      int bi = hi;
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(gmask, bv, off, 8);
        const int oi = __shfl_xor_sync(gmask, bi, off, 8);
        if (ahead(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (q == 0) {
        if constexpr (GROUPED)
          a.ids_out[out + p] = isfinite(bv) ? __ldg(list + bi) : 0;
        else
          a.ids_out[out + p] = bi;
        a.w_out[out + p] = bv;
      }
      if (hi == bi) {
        ++head;
        hv = head < cn ? rv[head] : -INFINITY;
        hi = head < cn ? ri[head] : NONE;
      }
    }
  }
  cluster.sync();           // no CTA leaves while another reads its lists
}

// (v1, i1) ranks before (v2, i2): larger weight, then smaller id.
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  if (i1 == NONE) return false;
  if (i2 == NONE) return true;
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// N > 128 or W > 32: one block per row, the row's weights and a taken
// bit per column in shared memory (knockout_smem_bytes), N first-max
// knockout passes (distances by XOR + popcount).
__host__ __device__ inline size_t knockout_smem_bytes(int m) {
  return 4 * ((size_t)m + (m + 31) / 32);
}

__device__ void select_knockout(const Args& a) {
  extern __shared__ __align__(16) uint32_t smem[];
  float* wrow = reinterpret_cast<float*>(smem);               // m weights
  uint32_t* taken = smem + a.m;                               // m bits
  __shared__ float red_v[KNOCK_THREADS / 32];
  __shared__ int red_i[KNOCK_THREADS / 32];

  const int i = blockIdx.x, m = a.m, w = a.w, nsel = a.nsel;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* ci = a.codes + (size_t)i * w;

  for (int j = threadIdx.x; j < m; j += KNOCK_THREADS) {
    float v;
    if (j == i) {
      v = -INFINITY;
    } else {
      v = a.use_rank ? a.scores[j] : 1.0f;
      if (a.use_lsh) {
        const uint32_t* cj = a.codes + (size_t)j * w;
        int d = 0;
        for (int k = 0; k < w; ++k) d += __popc(ci[k] ^ cj[k]);
        v = v * a.lut[d];
      }
    }
    wrow[j] = v;
  }
  for (int k = threadIdx.x; k < (m + 31) / 32; k += KNOCK_THREADS)
    taken[k] = 0u;
  __syncthreads();

  for (int t = 0; t < nsel; ++t) {
    float bv = -INFINITY;
    int bi = NONE;
    for (int j = threadIdx.x; j < m; j += KNOCK_THREADS) {
      if (!((taken[j >> 5] >> (j & 31)) & 1u) &&
          before(wrow[j], j, bv, bi)) {
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
      for (int k = 1; k < KNOCK_THREADS / 32; ++k) {
        if (before(red_v[k], red_i[k], bv, bi)) {
          bv = red_v[k];
          bi = red_i[k];
        }
      }
      a.ids_out[(size_t)i * nsel + t] = bi;
      a.w_out[(size_t)i * nsel + t] = bv;
      if (bi != NONE) taken[bi >> 5] |= 1u << (bi & 31);
    }
    __syncthreads();
  }
}

// The one-shot entry point's kernels: KW > 0 the mma instances, 0 the
// knockout instance.
template <int KW, bool FULL>
__global__ void __launch_bounds__(KW == 0 ? KNOCK_THREADS : 32 * MAX_WARPS)
fused_select_kernel(Args a) {
  if constexpr (KW == 0) {
    select_knockout(a);
  } else {
    select_mma<KW, FULL, false>(a);
  }
}

// The column-tiled entry point's kernels (the same mma design).
template <int KW, bool FULL>
__global__ void __launch_bounds__(32 * MAX_WARPS) select_tiled_kernel(Args a) {
  select_mma<KW, FULL, false>(a);
}

// The grouped ANN entry point's kernels (the same design on one slot's
// candidate list a tile); NR = NR_LIST for N <= NR_LIST.
template <int KW, bool FULL, int NR>
__global__ void __launch_bounds__(32 * MAX_WARPS)
select_ann_grouped_kernel(Args a) {
  select_mma<KW, FULL, true, NR>(a);
}

// A candidate id names a client: 0 <= id < m (the sentinel m, and any id
// outside the range, weighs -inf and is never read).
__device__ __forceinline__ bool in_range(int id, int m) {
  return (unsigned)id < (unsigned)m;
}

// The one-row instance (see the head of the file): warp `warp` of CTA b
// takes client position p = b * a.rows + warp of order[]. KW: the code
// words padded to 8, 16 or 32; P: candidates a lane takes a step; NQ: list
// ranks a lane holds (N <= 32 * NQ).
template <int KW, bool FULL, int NQ>
__global__ void __launch_bounds__(32 * MAX_ROW_WARPS)
select_ann_rows_kernel(Args a) {
  constexpr int P = KW <= 16 ? 2 : 1;
  constexpr int STEP = 32 * P;
  constexpr unsigned ALL = 0xffffffffu;
  __shared__ float lut_s[32 * 32 + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = a.m, w = a.w, k = a.k, nsel = a.nsel;
  const bool lsh = FULL || a.use_lsh != 0, rank = FULL || a.use_rank != 0;
  for (int d = threadIdx.x; d <= w * 32; d += blockDim.x)
    lut_s[d] = __ldg(a.lut + d);
  __syncthreads();
  const int p = blockIdx.x * a.rows + warp;
  if (p >= m) return;
  // the slot whose clients hold position p: the last s with starts[s] <= p
  // (32 ways a round)
  int lo = 0, hi = a.n_slots;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int s = lo + lane * step;
    const bool le = s < hi && __ldg(a.starts + s) <= p;
    const int last = 31 - __clz(__ballot_sync(ALL, le));
    hi = min(hi, lo + (last + 1) * step);
    lo += last * step;
  }
  const int row = __ldg(a.order + p);
  const int* list = a.lists + (size_t)lo * k;
  uint32_t own[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q)
    own[q] = lsh && q < w ? __ldg(a.codes + (size_t)row * w + q) : 0u;

  auto load_ids = [&](int c0, int (&r)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int pos = c0 + 32 * j + lane;
      r[j] = pos < k ? __ldg(list + pos) : m;
    }
  };
  // a candidate's code words and score, zero for a sentinel
  auto gather = [&](const int (&id)[P], uint32_t (&c)[P][KW], float (&sc)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool ok = in_range(id[j], m);
      const uint32_t* src = a.codes + (size_t)(ok ? id[j] : 0) * w;
      if (lsh && a.vec) {
#pragma unroll
        for (int q = 0; q < KW; q += 4) {
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (ok && q < w) v = __ldg(reinterpret_cast<const uint4*>(src + q));
          c[j][q] = v.x;
          c[j][q + 1] = v.y;
          c[j][q + 2] = v.z;
          c[j][q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < KW; ++q)
          c[j][q] = lsh && ok && q < w ? __ldg(src + q) : 0u;
      }
      sc[j] = rank && ok ? __ldg(a.scores + id[j]) : 0.0f;
    }
  };

  // the running list: rank q * 32 + lane in (lv[q], li[q]); empty ranks
  // (-inf, 0), which no candidate's weight reaches
  float lv[NQ];
  int li[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    lv[q] = -INFINITY;
    li[q] = 0;
  }
  int cnt = 0;
  float thr = -INFINITY;
  const int q_last = (nsel - 1) >> 5, l_last = (nsel - 1) & 31;
  auto insert = [&](float v, int id) {
    int at = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) at += __popc(__ballot_sync(ALL, lv[q] >= v));
#pragma unroll
    for (int q = NQ - 1; q >= 0; --q) {
      float up = __shfl_up_sync(ALL, lv[q], 1);
      int upi = __shfl_up_sync(ALL, li[q], 1);
      if (q > 0) {
        const float cv = __shfl_sync(ALL, lv[q > 0 ? q - 1 : 0], 31);
        const int ci = __shfl_sync(ALL, li[q > 0 ? q - 1 : 0], 31);
        if (lane == 0) {
          up = cv;
          upi = ci;
        }
      }
      const int r = q * 32 + lane;
      if (r > at) {
        lv[q] = up;
        li[q] = upi;
      } else if (r == at) {
        lv[q] = v;
        li[q] = id;
      }
      if (r >= nsel) {
        lv[q] = -INFINITY;
        li[q] = 0;
      }
    }
    if (++cnt >= nsel) {
      cnt = nsel;
      float t = lv[0];
#pragma unroll
      for (int q = 1; q < NQ; ++q) t = q == q_last ? lv[q] : t;
      thr = __shfl_sync(ALL, t, l_last);
    }
  };

  int id0[P], id1[P], id2[P];
  uint32_t c0w[P][KW], c1w[P][KW];
  float s0[P], s1[P];
  load_ids(0, id0);
  load_ids(STEP, id1);
  gather(id0, c0w, s0);
  for (int c0 = 0; c0 < k; c0 += STEP) {
    // in flight while this step is weighed: the next step's codes and
    // scores, the ids of the step after
    gather(id1, c1w, s1);
    load_ids(c0 + 2 * STEP, id2);
    float v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float x = rank ? s0[j] : 1.0f;
      if (lsh) {
        int d = 0;
#pragma unroll
        for (int q = 0; q < KW; ++q) d += __popc(own[q] ^ c0w[j][q]);
        x = x * lut_s[d];
      }
      v[j] = in_range(id0[j], m) && id0[j] != row ? x : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      unsigned enter = __ballot_sync(ALL, v[j] > thr);
      while (enter) {
        const int src = __ffs(enter) - 1;
        enter &= enter - 1;
        const float vs = __shfl_sync(ALL, v[j], src);
        const int is = __shfl_sync(ALL, id0[j], src);
        if (vs > thr) insert(vs, is);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      id0[j] = id1[j];
      id1[j] = id2[j];
      s0[j] = s1[j];
#pragma unroll
      for (int q = 0; q < KW; ++q) c0w[j][q] = c1w[j][q];
    }
  }
  const size_t out = (size_t)row * nsel;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = q * 32 + lane;
    if (r < nsel) {
      a.ids_out[out + r] = li[q];
      a.w_out[out + r] = lv[q];
    }
  }
}

// The one-row instance for kw words, N and the switches: `tiles` CTAs of
// a.rows warps.
template <int KW>
cudaError_t launch_rows_kw(const Args& a, int tiles, cudaStream_t s) {
  const bool full = a.use_lsh && a.use_rank;
  const int nq = a.nsel <= 32 ? 1 : (a.nsel <= 64 ? 2 : 4);
  const dim3 grid((unsigned)tiles), block(32 * a.rows);
  switch (nq * 2 + full) {
    case 2: select_ann_rows_kernel<KW, false, 1><<<grid, block, 0, s>>>(a); break;
    case 3: select_ann_rows_kernel<KW, true, 1><<<grid, block, 0, s>>>(a); break;
    case 4: select_ann_rows_kernel<KW, false, 2><<<grid, block, 0, s>>>(a); break;
    case 5: select_ann_rows_kernel<KW, true, 2><<<grid, block, 0, s>>>(a); break;
    case 8: select_ann_rows_kernel<KW, false, 4><<<grid, block, 0, s>>>(a); break;
    default: select_ann_rows_kernel<KW, true, 4><<<grid, block, 0, s>>>(a); break;
  }
  return cudaGetLastError();
}

int launch_rows(const Args& a, int kw, int tiles, cudaStream_t s) {
  if ((kw != 8 && kw != 16 && kw != 32) || a.w > kw || a.nsel > MAX_NSEL ||
      a.rows < 1 || a.rows > MAX_ROW_WARPS || tiles < 1 ||
      (long long)tiles * a.rows < a.m)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (kw == 8)
    err = launch_rows_kw<8>(a, tiles, s);
  else if (kw == 16)
    err = launch_rows_kw<16>(a, tiles, s);
  else
    err = launch_rows_kw<32>(a, tiles, s);
  return (int)err;
}

enum class Kind { oneshot, tiled, grouped };

// `row_ctas` tiles of a.rows rows, each a cluster of a.splits CTAs.
template <int KW, Kind KIND, bool FULL, int NR>
cudaError_t launch_mma(const Args& a, size_t smem_bytes, int row_ctas,
                       cudaStream_t stream) {
  void (*kernel)(Args);
  if constexpr (KIND == Kind::grouped)
    kernel = select_ann_grouped_kernel<KW, FULL, NR>;
  else if constexpr (KIND == Kind::tiled)
    kernel = select_tiled_kernel<KW, FULL>;
  else
    kernel = fused_select_kernel<KW, FULL>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const int warps = a.rows / (16 * T);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(row_ctas * a.splits));
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// The instance for kw words and the switches.
template <Kind KIND, int NR>
cudaError_t launch_kw(const Args& a, int kw, size_t smem_bytes, int row_ctas,
                      cudaStream_t s) {
  const bool full = a.use_lsh && a.use_rank;
  switch (kw * 2 + full) {
    case 16: return launch_mma<8, KIND, false, NR>(a, smem_bytes, row_ctas, s);
    case 17: return launch_mma<8, KIND, true, NR>(a, smem_bytes, row_ctas, s);
    case 32: return launch_mma<16, KIND, false, NR>(a, smem_bytes, row_ctas, s);
    case 33: return launch_mma<16, KIND, true, NR>(a, smem_bytes, row_ctas, s);
    case 64: return launch_mma<32, KIND, false, NR>(a, smem_bytes, row_ctas, s);
    default: return launch_mma<32, KIND, true, NR>(a, smem_bytes, row_ctas, s);
  }
}

// The plan's checks, then the instance; the grouped kernel keeps lists of
// N <= NR_LIST in registers.
template <Kind KIND>
int launch_plan(const Args& a, int kw, int row_ctas, cudaStream_t s) {
  const int unit = 16 * T;
  if ((kw != 8 && kw != 16 && kw != 32) || a.w > kw || a.nsel > MAX_NSEL ||
      a.rows < unit || a.rows % unit || a.rows / unit > MAX_WARPS ||
      a.splits < 1 || a.splits > MAX_SPLITS || a.split_len < 1 ||
      (long long)a.splits * a.split_len < (KIND == Kind::grouped ? a.k : a.m) ||
      row_ctas < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem_bytes =
      layout(kw, a.rows, a.nsel, KIND == Kind::grouped).bytes;
  cudaError_t err;
  if constexpr (KIND == Kind::grouped) {
    err = a.nsel <= NR_LIST
              ? launch_kw<KIND, NR_LIST>(a, kw, smem_bytes, row_ctas, s)
              : launch_kw<KIND, 0>(a, kw, smem_bytes, row_ctas, s);
  } else {
    err = launch_kw<KIND, 0>(a, kw, smem_bytes, row_ctas, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <Kind KIND>
int launch(const void* codes, const float* scores, const float* lut, int m,
           int w, int nsel, int use_lsh, int use_rank, int kw, int rows,
           int splits, int split_len, int* ids_out, float* w_out, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a = {static_cast<const uint32_t*>(codes), scores, lut, m, w,
                  nsel, use_lsh, use_rank, rows, splits, split_len, ids_out,
                  w_out};
  const cudaStream_t s = (cudaStream_t)stream;
  if (m < 2 || nsel < 1 || nsel > m - 1 || w < 1)
    return (int)cudaErrorInvalidValue;
  if (kw == 0) {                       // knockout: one-shot entry only
    if (KIND != Kind::oneshot) return (int)cudaErrorInvalidValue;
    const size_t smem_bytes = knockout_smem_bytes(m);
    if (smem_bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(fused_select_kernel<0, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    fused_select_kernel<0, false><<<m, KNOCK_THREADS, smem_bytes, s>>>(a);
    return (int)cudaGetLastError();
  }
  return launch_plan<KIND>(a, kw, (m + rows - 1) / rows, s);
}

}  // namespace

// Dynamic shared memory of one mma CTA of the plan (KW words, `rows`
// rows, N = nsel); selection.py:select_smem_bytes mirrors it.
extern "C" int select_smem_bytes(int kw, int rows, int nsel) {
  return layout(kw, rows, nsel).bytes;
}

// The same for the grouped ANN instance; selection.py:ann_smem_bytes.
extern "C" int ann_smem_bytes(int kw, int rows, int nsel) {
  return layout(kw, rows, nsel, true).bytes;
}

// codes: (m, w) uint32 bit patterns; scores: (m,) f32; lut: (w*32+1,) f32;
// ids_out: (m, nsel) int32; w_out: (m, nsel) f32; 1 <= nsel <= m - 1. The
// plan (kernels/selection.py:select_plan): kw, 8, 16 or 32 words >= w, for
// the mma instance with `rows` rows a CTA (a multiple of 32, at most 128)
// and the columns cut into `splits` ranges of `split_len` (nsel <= 128);
// kw = 0 for the knockout instance (one block per row). Returns
// cudaGetLastError() after launching.
extern "C" int fused_select(const void* codes, const float* scores,
                            const float* lut, int m, int w, int nsel,
                            int use_lsh, int use_rank, int kw, int rows,
                            int splits, int split_len, int* ids_out,
                            float* w_out, int device, void* stream) {
  return launch<Kind::oneshot>(codes, scores, lut, m, w, nsel, use_lsh,
                               use_rank, kw, rows, splits, split_len, ids_out,
                               w_out, device, stream);
}

// The column-tiled entry point: the same arguments; the mma instance only.
extern "C" int fused_select_tiled(const void* codes, const float* scores,
                                  const float* lut, int m, int w, int nsel,
                                  int use_lsh, int use_rank, int kw, int rows,
                                  int splits, int split_len, int* ids_out,
                                  float* w_out, int device, void* stream) {
  return launch<Kind::tiled>(codes, scores, lut, m, w, nsel, use_lsh,
                             use_rank, kw, rows, splits, split_len, ids_out,
                             w_out, device, stream);
}

// The grouped ANN entry point: each client i of slot s (the clients
// order[starts[s]:starts[s+1]]) takes the top nsel of Eq. 6-8 over the
// slot's k candidate positions lists[s, :] (ids in [0, m], m the
// sentinel), ties by position. codes, scores, lut, ids_out and w_out as
// above, written at row i; 1 <= nsel <= min(k, 128), w <= 32. The plan
// (kernels/selection.py:ann_plan): kw, `rows` a tile (a multiple of 32,
// at most 128), the positions cut into `splits` ranges of `split_len`,
// and `tiles` >= ceil(m / rows) + n_slots tiles of which those past a
// slot's clients exit; with warp_rows = 1 the one-row instance instead:
// `tiles` >= ceil(m / rows) CTAs of `rows` warps (at most 8), one client
// a warp (splits and split_len unused). Returns cudaGetLastError() after
// launching.
extern "C" int fused_select_ann_grouped(
    const void* codes, const float* scores, const float* lut,
    const int* lists, const int* order, const int* starts, int m, int w,
    int k, int n_slots, int nsel, int use_lsh, int use_rank, int kw, int rows,
    int splits, int split_len, int tiles, int warp_rows, int* ids_out,
    float* w_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 1 || w < 1 || k < 1 || n_slots < 1 || nsel < 1 || nsel > k ||
      (long long)tiles * rows < m)
    return (int)cudaErrorInvalidValue;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  const Args a = {static_cast<const uint32_t*>(codes), scores, lut, m, w,
                  nsel, use_lsh, use_rank, rows, splits, split_len, ids_out,
                  w_out, lists, order, starts, k, n_slots, vec};
  if (warp_rows) return launch_rows(a, kw, tiles, (cudaStream_t)stream);
  return launch_plan<Kind::grouped>(a, kw, tiles, (cudaStream_t)stream);
}
