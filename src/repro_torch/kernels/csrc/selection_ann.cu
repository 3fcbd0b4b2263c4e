// ANN peer selection (WPFed Eq. 6-8 + top-N on candidate sets) for
// Hopper (sm_90a).
//
// Replaces repro/kernels/selection.py:fused_select_ann
// (_select_ann_kernel). For every row i and its K candidate ids
// cand[i, :] (from core/ann.py; the sentinel id M marks an invalid slot):
// w = s_c * LUT[popc(code_i ^ code_c)] under the Table-3 switches (s_c
// taken as 1 without use_rank, the LUT dropped without use_lsh), -inf for
// self and for any id outside [0, M); the result is the first N entries
// of a stable descending sort of the row's weights by candidate position,
// with id 0 wherever the weight is not finite. The LUT is the wrapper's
// exp table, so the weights equal the plain version's (ref.ann_select_ref)
// bit for bit.
//
// The TPU wrapper gathers an (M, K, W) tensor of candidate codes before
// the kernel; at M=65,536, K=2,336 that is 4.9 GB written and read again.
// Here each lane gathers its candidate's W words by id: the whole (M, W)
// code table is 2 MB at that size and stays in the 50 MB L2, so device
// memory sees the candidate ids once (612 MB there) and little else.
//
// One warp per row, ROWS warps per block. The warp walks the K positions
// in chunks of 32, lane l on position c0 + l (coalesced id loads), and
// merges each chunk into the row's running top-N, kept sorted best first
// in shared memory. A chunk entry enters only when the list has room or
// its weight is strictly above the list's last; entries go in lane order
// and are inserted after every equal weight. The running entries all have
// earlier positions than the chunk, so this is exactly the first N of a
// stable sort by position, as lax.top_k breaks ties. A warp vote skips
// the lanes that cannot enter, so most chunks cost one ballot once the
// list is full.
//
// Bound on the H100: about 3*M*K*W integer operations (XOR, popcount,
// add) on the valid candidates, or the M*K*4 bytes of candidate ids; at
// M=65,536, K=2,336, W=8 about 0.22 ms and 0.18 ms.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;          // rows per block, one warp each
constexpr unsigned FULL = 0xffffffffu;

// W > 0: the row's code words in registers; W == 0: any width w.
template <int W>
__global__ void __launch_bounds__(ROWS * 32)
select_ann_kernel(const uint32_t* __restrict__ codes,
                  const float* __restrict__ scores,
                  const float* __restrict__ lut,
                  const int* __restrict__ cand, int m, int w, int k,
                  int nsel, int use_lsh, int use_rank,
                  int* __restrict__ ids_out, float* __restrict__ w_out) {
  extern __shared__ float smem[];
  float* lut_s = smem;                                     // w*32 + 1
  float* top_v_all = lut_s + (w * 32 + 1);                 // ROWS * nsel
  int* top_i_all = reinterpret_cast<int*>(top_v_all + ROWS * nsel);
  uint32_t* own_all = reinterpret_cast<uint32_t*>(top_i_all + ROWS * nsel);
  // own_all: ROWS * w words, for W == 0

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < w * 32 + 1; e += ROWS * 32) lut_s[e] = lut[e];
  __syncthreads();
  const int row = blockIdx.x * ROWS + warp;
  if (row >= m) return;

  float* top_v = top_v_all + warp * nsel;
  int* top_i = top_i_all + warp * nsel;
  uint32_t* own = own_all + warp * w;
  uint32_t a[W > 0 ? W : 1];
  if (W > 0) {
#pragma unroll
    for (int q = 0; q < (W > 0 ? W : 1); ++q) a[q] = codes[(size_t)row * w + q];
  } else {
    for (int q = lane; q < w; q += 32) own[q] = codes[(size_t)row * w + q];
    __syncwarp();
  }

  int cnt = 0;               // entries in the running list (lane 0's view)
  float thr = -INFINITY;     // the list's last weight once it is full
  const int* crow = cand + (size_t)row * k;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int pos = c0 + lane;
    const bool in_k = pos < k;
    const int c = in_k ? crow[pos] : m;
    float v = -INFINITY;
    if (c >= 0 && c < m && c != row) {
      v = use_rank ? scores[c] : 1.0f;
      if (use_lsh) {
        int d = 0;
        const uint32_t* b = codes + (size_t)c * w;
        if (W > 0) {
#pragma unroll
          for (int q = 0; q < (W > 0 ? W : 1); ++q) d += __popc(a[q] ^ __ldg(b + q));
        } else {
          for (int q = 0; q < w; ++q) d += __popc(own[q] ^ __ldg(b + q));
        }
        v = v * lut_s[d];
      }
    }
    cnt = __shfl_sync(FULL, cnt, 0);
    thr = __shfl_sync(FULL, thr, 0);
    unsigned enter = __ballot_sync(FULL, in_k && (cnt < nsel || v > thr));
    while (enter) {
      const int src = __ffs(enter) - 1;
      enter &= enter - 1;
      const float vs = __shfl_sync(FULL, v, src);
      const int cs = __shfl_sync(FULL, c, src);
      if (lane == 0 && (cnt < nsel || vs > thr)) {
        int p = cnt < nsel ? cnt : nsel - 1;
        while (p > 0 && vs > top_v[p - 1]) {
          top_v[p] = top_v[p - 1];
          top_i[p] = top_i[p - 1];
          --p;
        }
        top_v[p] = vs;
        top_i[p] = cs;
        if (cnt < nsel) ++cnt;
        if (cnt == nsel) thr = top_v[nsel - 1];
      }
    }
  }
  __syncwarp();
  for (int p = lane; p < nsel; p += 32) {
    const float v = top_v[p];
    ids_out[(size_t)row * nsel + p] = isfinite(v) ? top_i[p] : 0;
    w_out[(size_t)row * nsel + p] = v;
  }
}

template <int W>
cudaError_t launch(const uint32_t* codes, const float* scores,
                   const float* lut, const int* cand, int m, int w, int k,
                   int nsel, int use_lsh, int use_rank, int* ids_out,
                   float* w_out, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_ann_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (m + ROWS - 1) / ROWS;
  select_ann_kernel<W><<<blocks, ROWS * 32, smem, stream>>>(
      codes, scores, lut, cand, m, w, k, nsel, use_lsh, use_rank, ids_out,
      w_out);
  return cudaGetLastError();
}

}  // namespace

// codes: (m, w) uint32 bit patterns; scores: (m,) f32; lut: (w*32+1,) f32;
// cand: (m, k) int32 ids in [0, m], m the sentinel; ids_out: (m, nsel)
// int32; w_out: (m, nsel) f32; 1 <= nsel <= k. The wrapper bounds
// w <= 32 and nsel <= 128. Returns cudaGetLastError() after launching.
extern "C" int fused_select_ann(const void* codes, const float* scores,
                                const float* lut, const int* cand, int m,
                                int w, int k, int nsel, int use_lsh,
                                int use_rank, int* ids_out, float* w_out,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool generic = !(w == 2 || w == 4 || w == 8 || w == 16);
  const size_t smem = 4 * ((size_t)w * 32 + 1 + 2 * (size_t)ROWS * nsel +
                           (generic ? (size_t)ROWS * w : 0));
  const uint32_t* c = static_cast<const uint32_t*>(codes);
  cudaStream_t s = (cudaStream_t)stream;
  switch (w) {
    case 2: err = launch<2>(c, scores, lut, cand, m, w, k, nsel, use_lsh,
                            use_rank, ids_out, w_out, smem, s); break;
    case 4: err = launch<4>(c, scores, lut, cand, m, w, k, nsel, use_lsh,
                            use_rank, ids_out, w_out, smem, s); break;
    case 8: err = launch<8>(c, scores, lut, cand, m, w, k, nsel, use_lsh,
                            use_rank, ids_out, w_out, smem, s); break;
    case 16: err = launch<16>(c, scores, lut, cand, m, w, k, nsel, use_lsh,
                              use_rank, ids_out, w_out, smem, s); break;
    default: err = launch<0>(c, scores, lut, cand, m, w, k, nsel, use_lsh,
                             use_rank, ids_out, w_out, smem, s); break;
  }
  return (int)err;
}
