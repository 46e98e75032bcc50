// Tensor-core MLP chain on bf16 WMMA tiles (m16n16k16, f32 accumulation),
// for a block that holds all of a chain's weights in shared memory and walks
// over 64-point tiles of the point axis (a persistent block per SM).
//
// It serves the bf16 bodies of all four kernels at every width but the
// flagship's: those (the proposal fields' H = 40, (80, 16, 1) and the field's
// H = 128, (256, 128, 128, 16), (15 + F, 64, 64, 3)) run the wgmma bodies of
// wgmma_chain.cuh, and come here only when a measurement forces them to.
//
// Layout in shared memory:
// - activations: [point][feature] bf16, row stride ld (the widest padded
//   width + 8, so that the 16 rows a fragment load touches fall in different
//   banks);
// - layer l's weights: (Kp_l, Np_l) bf16 row-major, row stride Np_l + 8, with
//   the widths padded to 16 by zero rows and columns; its bias f32 (Np_l).
// The zero padding makes a padded output column exactly 0, so it can feed
// the next layer's padded input rows.
#pragma once

#include <mma.h>

#include "fused_chain.cuh"

#define NKT_MMA_ROWS 64  // points per tile: 4 row slabs of 16
#define NKT_MMA_WARPS 8  // 2 warps per row slab, splitting the column tiles
#define NKT_MMA_THREADS (NKT_MMA_WARPS * 32)
#define NKT_MMA_MAX_TILES 8  // column tiles per warp: padded widths up to 256

__host__ __device__ inline int nkt_pad16(int v) { return (v + 15) / 16 * 16; }

struct MmaChain {
  int n_layers;
  int kp[NKT_MAX_LAYERS];
  int np[NKT_MAX_LAYERS];
  int w_s[NKT_MAX_LAYERS];  // bf16 element offset of W_l in the weight region
  int b_s[NKT_MAX_LAYERS];  // float offset of b_l in the bias region
};

// Host: the shared-memory placement of one chain after *w_elems / *b_floats
// (updated). Each W_l starts on 16 elements (32 bytes, as wmma loads need).
// Returns the widest padded width, or an error code below 0.
static inline int nkt_mma_chain(const Chain& c, MmaChain* m, int* w_elems, int* b_floats) {
  m->n_layers = c.n_layers;
  int widest = 0;
  for (int l = 0; l < c.n_layers; ++l) {
    m->kp[l] = nkt_pad16(c.dims[l]);
    m->np[l] = nkt_pad16(c.dims[l + 1]);
    if (m->np[l] > 16 * 2 * NKT_MMA_MAX_TILES) return NKT_ERR_SMEM;
    m->w_s[l] = *w_elems;
    *w_elems = nkt_pad16(*w_elems + m->kp[l] * (m->np[l] + 8));
    m->b_s[l] = *b_floats;
    *b_floats += m->np[l];
    if (m->kp[l] > widest) widest = m->kp[l];
    if (m->np[l] > widest) widest = m->np[l];
  }
  return widest;
}

// Byte offsets of the shared-memory regions of a tensor-core kernel.
struct MmaSmem {
  size_t w, b, B, x, scratch, act0, act1, total;
};

__host__ __device__ inline size_t nkt_align128(size_t v) { return (v + 127) / 128 * 128; }

__host__ __device__ inline MmaSmem nkt_mma_smem(int w_elems, int b_floats, int H, int ld) {
  MmaSmem s;
  s.w = 0;
  s.b = nkt_align128(s.w + (size_t)w_elems * 2);
  s.B = nkt_align128(s.b + (size_t)b_floats * 4);
  s.x = nkt_align128(s.B + (size_t)3 * H * 4);
  s.scratch = nkt_align128(s.x + (size_t)3 * NKT_MMA_ROWS * 4);
  s.act0 = nkt_align128(s.scratch + (size_t)NKT_MMA_WARPS * 256 * 4);
  s.act1 = nkt_align128(s.act0 + (size_t)NKT_MMA_ROWS * ld * 2);
  s.total = nkt_align128(s.act1 + (size_t)NKT_MMA_ROWS * ld * 2);
  return s;
}

// Device, whole block: the tile's positions x[:, p0:p0+64] into xs (3, 64),
// zeros past the ragged edge.
__device__ __forceinline__ void nkt_mma_load_x(const float* x, int n, long long p0, float* xs) {
  if (threadIdx.x < 3 * NKT_MMA_ROWS) {
    const int r = threadIdx.x % NKT_MMA_ROWS, d = threadIdx.x / NKT_MMA_ROWS;
    xs[d * NKT_MMA_ROWS + r] = p0 + r < n ? x[(size_t)d * n + p0 + r] : 0.0f;
  }
}

// Device, whole block: copy a chain from the packed f32 buffer into its
// padded bf16 / f32 places in shared memory.
__device__ inline void nkt_mma_stage(const Chain& c, const MmaChain& m, const float* wb,
                                     __nv_bfloat16* ws, float* bs) {
  for (int l = 0; l < c.n_layers; ++l) {
    const int din = c.dims[l], dout = c.dims[l + 1], ld = m.np[l] + 8;
    for (int i = threadIdx.x; i < m.kp[l] * ld; i += blockDim.x) {
      const int k = i / ld, o = i % ld;
      const float v = (k < din && o < dout) ? wb[c.w_off[l] + k * dout + o] : 0.0f;
      ws[m.w_s[l] + i] = __float2bfloat16_rn(v);
    }
    for (int i = threadIdx.x; i < m.np[l]; i += blockDim.x)
      bs[m.b_s[l] + i] = i < dout ? wb[c.b_off[l] + i] : 0.0f;
  }
}

// Device, one warp: its share of one layer for the tile,
// act (64, kp) @ W (kp, np) + bias, handing each f32 value to
// epi(row, o, v) for every row and padded output column o of the share.
// Warp w takes the 16 rows (w % 4) * 16 and the NTW column tiles w / 4,
// w / 4 + 2, ...; NTW is a template argument so the accumulators stay in
// registers. They go through the warp's 16x16 f32 scratch so the epilogue
// knows each value's (row, column).
template <int NTW, class Epi>
__device__ __forceinline__ void nkt_mma_warp(const __nv_bfloat16* act, int lda,
                                             const __nv_bfloat16* W, int ldw, const float* bias,
                                             int kp, float* scratch, const Epi& epi) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * 16, c = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NTW];
#pragma unroll
  for (int t = 0; t < NTW; ++t) wmma::fill_fragment(acc[t], 0.0f);
  for (int k0 = 0; k0 < kp; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[NTW];
    wmma::load_matrix_sync(a, act + r0 * lda + k0, lda);
#pragma unroll
    for (int t = 0; t < NTW; ++t)
      wmma::load_matrix_sync(b[t], W + k0 * ldw + (c + 2 * t) * 16, ldw);
#pragma unroll
    for (int t = 0; t < NTW; ++t) wmma::mma_sync(acc[t], a, b[t], acc[t]);
  }
#pragma unroll
  for (int t = 0; t < NTW; ++t) {
    wmma::store_matrix_sync(scratch, acc[t], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 256; e += 32) {
      const int o = (c + 2 * t) * 16 + e % 16;
      epi(r0 + e / 16, o, scratch[e] + bias[o]);
    }
    __syncwarp();
  }
}

// Device, whole block: one layer of the chain for the tile, np <= 32 * MAXT
// (each warp takes at most MAXT column tiles; a smaller MAXT instantiates
// fewer accumulators and so needs fewer registers).
template <int MAXT = NKT_MMA_MAX_TILES, class Epi>
__device__ __forceinline__ void nkt_mma_layer(const __nv_bfloat16* act, int lda,
                                              const __nv_bfloat16* W, int ldw, const float* bias,
                                              int kp, int np, float* scratch, const Epi& epi) {
  const int c = (threadIdx.x / 32) / 4;
#define NKT_MMA_CASE(k)                                                       \
  case k:                                                                     \
    if constexpr (MAXT >= k) nkt_mma_warp<k>(act, lda, W, ldw, bias, kp, scratch, epi); \
    break;
  switch ((np / 16 - c + 1) / 2) {
    NKT_MMA_CASE(1)
    NKT_MMA_CASE(2)
    NKT_MMA_CASE(3)
    NKT_MMA_CASE(4)
    NKT_MMA_CASE(5)
    NKT_MMA_CASE(6)
    NKT_MMA_CASE(7)
    NKT_MMA_CASE(8)
    default: break;  // no column tile for this warp
  }
#undef NKT_MMA_CASE
}

// Device, whole block: the Fourier encoding of the tile into enc (ROWS, kp)
// bf16 with row stride ld: proj = B^T x in f32 from xs (3, ROWS) and Bs
// (3, H), s in columns [0, H), c in [H, 2H), zeros up to kp. Lanes take
// frequencies and warps take rows, so there is no division and consecutive
// lanes store to consecutive columns.
template <bool TRI, int ROWS = NKT_MMA_ROWS>
__device__ __forceinline__ void nkt_mma_encode(const float* xs, const float* Bs, int H, int kp,
                                               __nv_bfloat16* enc, int ld) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int h = lane; h < H; h += 32) {
    const float b0 = Bs[h], b1 = Bs[H + h], b2 = Bs[2 * H + h];
#pragma unroll 4
    for (int r = warp; r < ROWS; r += NKT_MMA_WARPS) {
      const float u = fmaf(b2, xs[2 * ROWS + r], fmaf(b1, xs[ROWS + r], b0 * xs[r]));
      float sv, cv;
      if (TRI) {
        sv = nkt_tri_s(u);
        cv = nkt_tri_c(u);
      } else {
        sincosf(u, &sv, &cv);
      }
      enc[r * ld + h] = __float2bfloat16_rn(sv);
      enc[r * ld + H + h] = __float2bfloat16_rn(cv);
    }
  }
  const int pad = kp - 2 * H;
  for (int i = threadIdx.x; i < ROWS * pad; i += blockDim.x)
    enc[(i / pad) * ld + 2 * H + i % pad] = __float2bfloat16_rn(0.0f);
}
