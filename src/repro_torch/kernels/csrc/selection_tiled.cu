// Column-tiled peer selection (WPFed Eq. 6-8 + top-N) for Hopper (sm_90a).
//
// Replaces repro/kernels/selection.py:fused_select_tiled
// (_select_tiled_kernel). Same contract as csrc/selection.cu: for every
// row i, the top N of w_ij = s_j * LUT[popc(c_i ^ c_j)] under the Table-3
// switches, self at -inf, ranked by weight descending, then id ascending.
// The LUT is the wrapper's exp table, so weights equal the plain version's
// bit for bit.
//
// The TPU kernel walks column tiles on a sequential grid and carries the
// running top-N in VMEM scratch. Here a block of BM threads owns BM rows,
// one thread per row, and walks all M columns itself in tiles of BK codes
// (and their scores) staged in shared memory: each code is read from L2
// once per row block, not once per row, and every thread of the block
// reads the same column at the same time (a shared-memory broadcast).
// Each thread keeps its row's running top-N in shared memory, sorted best
// first, laid out [slot][row] so the block's accesses hit distinct banks.
// Columns arrive in ascending id, so a column joins the full list only if
// its weight is strictly larger than the list's last (an equal weight has
// a larger id and ranks after it); insertion shifts the smaller entries
// down. That is exactly the first N of a stable descending sort. Shared
// memory is BK*W*4 + BK*4 + (W*32+1)*4 + BM*N*8 bytes, independent of M;
// no (M, M) array reaches device memory.
//
// Bound on the H100: integer operations, about 3*M*M*W XOR, popcount and
// add (6.2 ms at M=65,536, W=8); codes are M*W*4 bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // rows per block, one thread each
constexpr int BK = 512;   // columns per shared-memory tile

// W > 0: the row's code words in registers; W == 0: any width, read
// from the block's copy of its rows' codes in shared memory.
template <int W>
__global__ void __launch_bounds__(BM)
select_tiled_kernel(const uint32_t* __restrict__ codes,
                    const float* __restrict__ scores,
                    const float* __restrict__ lut, int m, int w, int nsel,
                    int use_lsh, int use_rank, int* __restrict__ ids_out,
                    float* __restrict__ w_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* tile = smem;                                   // BK * w
  float* tile_s = reinterpret_cast<float*>(tile + BK * w); // BK
  float* lut_s = tile_s + BK;                              // w*32 + 1
  float* top_v = lut_s + (w * 32 + 1);                     // nsel * BM
  int* top_i = reinterpret_cast<int*>(top_v + nsel * BM);  // nsel * BM
  uint32_t* rows_s = reinterpret_cast<uint32_t*>(top_i + nsel * BM);
  // rows_s: w * BM, only for W == 0

  const int t = threadIdx.x;
  const int row = blockIdx.x * BM + t;
  const bool live = row < m;

  for (int k = t; k < w * 32 + 1; k += BM) lut_s[k] = lut[k];
  uint32_t a[W > 0 ? W : 1];
  if (W > 0) {
#pragma unroll
    for (int k = 0; k < (W > 0 ? W : 1); ++k)
      a[k] = live ? codes[(size_t)row * w + k] : 0u;
  } else {
    for (int k = 0; k < w; ++k)
      rows_s[k * BM + t] = live ? codes[(size_t)row * w + k] : 0u;
  }

  int cnt = 0;               // entries in the running list
  float thr = -INFINITY;     // the list's last weight once it is full

  for (int c0 = 0; c0 < m; c0 += BK) {
    const int nk = min(BK, m - c0);
    __syncthreads();         // previous tile consumed
    const uint32_t* src = codes + (size_t)c0 * w;
    for (int e = t; e < nk * w; e += BM) tile[e] = src[e];
    for (int e = t; e < nk; e += BM) tile_s[e] = scores[c0 + e];
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < nk; ++jj) {
      const int j = c0 + jj;
      float v;
      if (j == row) {
        v = -INFINITY;
      } else {
        v = use_rank ? tile_s[jj] : 1.0f;
        if (use_lsh) {
          int d = 0;
          const uint32_t* b = tile + jj * (W > 0 ? W : w);
          if (W > 0) {
#pragma unroll
            for (int k = 0; k < (W > 0 ? W : 1); ++k) d += __popc(a[k] ^ b[k]);
          } else {
            for (int k = 0; k < w; ++k) d += __popc(rows_s[k * BM + t] ^ b[k]);
          }
          v = v * lut_s[d];
        }
      }
      if (cnt < nsel || v > thr) {
        int p = cnt < nsel ? cnt : nsel - 1;
        while (p > 0 && v > top_v[(p - 1) * BM + t]) {
          top_v[p * BM + t] = top_v[(p - 1) * BM + t];
          top_i[p * BM + t] = top_i[(p - 1) * BM + t];
          --p;
        }
        top_v[p * BM + t] = v;
        top_i[p * BM + t] = j;
        if (cnt < nsel) ++cnt;
        thr = top_v[(nsel - 1) * BM + t];
      }
    }
  }
  if (live) {
    for (int k = 0; k < nsel; ++k) {
      ids_out[(size_t)row * nsel + k] = top_i[k * BM + t];
      w_out[(size_t)row * nsel + k] = top_v[k * BM + t];
    }
  }
}

template <int W>
cudaError_t launch(const uint32_t* codes, const float* scores,
                   const float* lut, int m, int w, int nsel, int use_lsh,
                   int use_rank, int* ids_out, float* w_out, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_tiled_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (m + BM - 1) / BM;
  select_tiled_kernel<W><<<blocks, BM, smem, stream>>>(
      codes, scores, lut, m, w, nsel, use_lsh, use_rank, ids_out, w_out);
  return cudaGetLastError();
}

}  // namespace

// codes: (m, w) uint32 bit patterns; scores: (m,) f32; lut: (w*32+1,) f32;
// ids_out: (m, nsel) int32; w_out: (m, nsel) f32; 1 <= nsel <= m - 1.
// The wrapper bounds w <= 32 and nsel <= 128, which keeps the block's
// shared memory under 227 KB. Returns cudaGetLastError() after launching.
extern "C" int fused_select_tiled(const void* codes, const float* scores,
                                  const float* lut, int m, int w, int nsel,
                                  int use_lsh, int use_rank, int* ids_out,
                                  float* w_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool generic = !(w == 2 || w == 4 || w == 8 || w == 16);
  const size_t smem = 4 * ((size_t)BK * w + BK + w * 32 + 1 +
                           2 * (size_t)nsel * BM + (generic ? w * BM : 0));
  const uint32_t* c = static_cast<const uint32_t*>(codes);
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 2: err = launch<2>(c, scores, lut, m, w, nsel, use_lsh, use_rank,
                            ids_out, w_out, smem, s); break;
    case 4: err = launch<4>(c, scores, lut, m, w, nsel, use_lsh, use_rank,
                            ids_out, w_out, smem, s); break;
    case 8: err = launch<8>(c, scores, lut, m, w, nsel, use_lsh, use_rank,
                            ids_out, w_out, smem, s); break;
    case 16: err = launch<16>(c, scores, lut, m, w, nsel, use_lsh, use_rank,
                              ids_out, w_out, smem, s); break;
    default: err = launch<0>(c, scores, lut, m, w, nsel, use_lsh, use_rank,
                             ids_out, w_out, smem, s); break;
  }
  return (int)err;
}
