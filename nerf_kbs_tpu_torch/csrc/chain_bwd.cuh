// Shared device code of the two backward fused-field kernels
// (fourier_mlp_bwd.cu, fourier_field_bwd.cu).
//
// Both recompute the forward per tile of points and keep every layer's input
// in shared memory, then walk the chain backwards. Per layer i with input
// act_i and incoming gradient dh_i (of the layer's pre-activation):
//   dW_i += act_i^T . dh_i      (contracts over the tile's points)
//   db_i += sum over points of dh_i (f32, before any rounding)
//   dh_{i-1} = (W_i . dh_i) * (pre_{i-1} > 0)
// Weight gradients are sums over all points. Blocks run in no order, so each
// persistent block adds into a partial buffer in device memory that it alone
// owns (padded (kp, np) f32 per layer, see GradLayout), walking its tiles in a
// fixed order, and nkt_reduce_partials sums the partials over blocks in block
// order: no float atomics, and the same launch gives the same bits.
//
// bf16 compute runs on the tensor cores (WMMA m16n16k16, f32 accumulation):
// - act_i and dh_i live as [point][feature] bf16 (see mma_chain.cuh);
// - dW reads act_i as a col_major matrix_a fragment (the transpose for free)
//   and loads / stores its f32 accumulator fragment straight from / to the
//   block's partial, which stays in L2;
// - W . dh reads the resident weights as col_major matrix_b fragments, and
//   its epilogue applies the relu mask and writes dh_{i-1} over act_i in
//   place (dW_i has read act_i by then);
// - the relu mask is the sign of the stored bf16 activation: relu(pre)
//   rounded to bf16 is > 0 exactly when pre > 0, except for a positive pre
//   below the smallest bf16 subnormal (~4.6e-41), which no finite-weight
//   chain produces in practice;
// - a bias gradient is summed in f32 in the epilogue, per 16-row slab into
//   accumulators in shared memory that only one warp touches.
// f32 compute (the oracle mode) keeps one thread per point with per-point
// columns in shared memory (fused_chain.cuh); the dW product is done by the
// whole block, one thread per weight, summing over the tile's points.
#pragma once

#include "mma_chain.cuh"

// The SM count that sizes the grid of every backward body: a fixed 132 (an
// H100 SXM's), not the card's own. A block's partial holds the sums of the
// tiles it walks, and the grid decides that partition, so with a fixed grid
// the weight gradients' order of summation, and so their bits, depends on
// the shape alone: a training step repeats bit for bit on any card. On a card
// with fewer SMs the persistent blocks queue; on one with more, SMs idle.
// The wrappers size the partials to match (ops/fused_field.py BWD_GRID_SMS).
#define NKT_BWD_GRID_SMS 132

// Placement of one chain's weight-gradient partial: layer l's dW as (kp, np)
// f32 row-major at w[l], its db (np) at b[l]; all offsets in floats.
struct GradLayout {
  int w[NKT_MAX_LAYERS];
  int b[NKT_MAX_LAYERS];
  int kp[NKT_MAX_LAYERS];
  int np[NKT_MAX_LAYERS];
};

// Host: appends a chain's partial after *floats (updated).
static inline void nkt_grad_layout(const Chain& c, GradLayout* g, int* floats) {
  for (int l = 0; l < c.n_layers; ++l) {
    g->kp[l] = nkt_pad16(c.dims[l]);
    g->np[l] = nkt_pad16(c.dims[l + 1]);
    g->w[l] = *floats;
    *floats += g->kp[l] * g->np[l];
    g->b[l] = *floats;
    *floats += g->np[l];
  }
}

// Sums a chain's partials over blocks, in block order, into the packed
// layout of the forward's weights (fused_chain.cuh): one thread per weight
// or bias.
__global__ void nkt_reduce_partials(const float* __restrict__ partials, int nblocks, int stride,
                                    Chain c, GradLayout g, float* __restrict__ out) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  int src = -1, dst = -1;
  for (int l = 0; l < c.n_layers; ++l) {
    const int dout = c.dims[l + 1], nw = c.dims[l] * dout;
    if (idx < nw) {
      src = g.w[l] + (idx / dout) * g.np[l] + idx % dout;
      dst = c.w_off[l] + idx;
      break;
    }
    idx -= nw;
    if (idx < dout) {
      src = g.b[l] + idx;
      dst = c.b_off[l] + idx;
      break;
    }
    idx -= dout;
  }
  if (src < 0) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += partials[(size_t)b * stride + src];
  out[dst] = s;
}

static inline int nkt_launch_reduce(const float* partials, int nblocks, int stride, const Chain& c,
                                    const GradLayout& g, float* out, cudaStream_t stream) {
  int total = 0;
  for (int l = 0; l < c.n_layers; ++l) total += (c.dims[l] + 1) * c.dims[l + 1];
  nkt_reduce_partials<<<(total + 255) / 256, 256, 0, stream>>>(partials, nblocks, stride, c, g,
                                                                out);
  return (int)cudaGetLastError();
}

// d tri / du = +4 where the wave's fraction is past 0.5, else -4; sincos
// gives c and -s.
template <bool TRI>
__device__ __forceinline__ void nkt_basis_grads(float u, float* dsdu, float* dcdu) {
  if (TRI) {
    float fs = u + 0.75f;
    fs = fs - floorf(fs);
    const float fc = u - floorf(u);
    *dsdu = fs > 0.5f ? 4.0f : -4.0f;
    *dcdu = fc > 0.5f ? 4.0f : -4.0f;
  } else {
    float s, c;
    sincosf(u, &s, &c);
    *dsdu = c;
    *dcdu = -s;
  }
}

// ---------------------------------------------------------------------------
// bf16 compute: tensor cores. ROWS points per tile (a multiple of 16 dividing
// 128); the 8 warps split into ROWS / 16 row slabs times 8 / (ROWS / 16)
// column groups.
// ---------------------------------------------------------------------------

// Device, whole block: out (ROWS, ndim) = A (ROWS, kdim) . M, with M = W
// (kdim, ndim) row-major when !WT, or M = W^T for W (ndim, kdim) row-major
// when WT. Each f32 value goes to epi(row, col, v), whose return value is
// summed over the slab's 16 rows into colsum[col] when colsum is not null
// (colsum belongs to this warp's slab). With TR the epilogue walks each 16x16
// tile row-fastest, for an epilogue that stores feature-major to device
// memory (no colsum then).
template <int ROWS, bool WT, bool TR = false, class Epi>
__device__ __forceinline__ void nkt_bwd_gemm(const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* W, int ldw, int kdim, int ndim,
                                             float* scratch, float* colsum, const Epi& epi) {
  using namespace nvcuda;
  constexpr int RS = ROWS / 16, CG = NKT_MMA_WARPS / RS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % RS) * 16;
  for (int t = warp / RS; t < ndim / 16; t += CG) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + r0 * lda + k0, lda);
      if (WT) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, W + (t * 16) * ldw + k0, ldw);
        wmma::mma_sync(acc, a, b, acc);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, W + k0 * ldw + t * 16, ldw);
        wmma::mma_sync(acc, a, b, acc);
      }
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 256; e += 32) {
      const int r = TR ? e % 16 : e / 16, c = TR ? e / 16 : e % 16;
      scratch[r * 16 + c] = epi(r0 + r, t * 16 + c, scratch[r * 16 + c]);
    }
    __syncwarp();
    if (colsum != nullptr && lane < 16) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) s += scratch[r * 16 + lane];
      colsum[t * 16 + lane] += s;
    }
    __syncwarp();
  }
}

// Device, whole block: gpart (kp, np) f32 in device memory += act^T . dh for
// act (ROWS, kp) and dh (ROWS, np), both bf16 [point][feature]. A warp owns
// whole 16x16 output tiles, so no two warps touch the same address.
template <int ROWS>
__device__ __forceinline__ void nkt_bwd_dw(const __nv_bfloat16* act, int lda, int kp,
                                           const __nv_bfloat16* dh, int lddh, int np,
                                           float* gpart) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int nt = np / 16, ntiles = (kp / 16) * nt;
  for (int ti = warp; ti < ntiles; ti += NKT_MMA_WARPS) {
    const int ki = ti / nt, oi = ti % nt;
    float* dst = gpart + (size_t)ki * 16 * np + oi * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, dst, np, wmma::mem_row_major);
#pragma unroll
    for (int p0 = 0; p0 < ROWS; p0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, act + p0 * lda + ki * 16, lda);
      wmma::load_matrix_sync(b, dh + p0 * lddh + oi * 16, lddh);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(dst, acc, np, wmma::mem_row_major);
  }
}

// The activations a chain keeps for its backward: acts[l] is layer l's input
// (ROWS, kp_l) bf16 with row stride ld[l].
struct BwdActs {
  __nv_bfloat16* a[NKT_MAX_LAYERS];
  int ld[NKT_MAX_LAYERS];
};

// Device, whole block: layers [0, upto) of the chain's forward with relu,
// acts.a[0] holding the input; fills acts.a[1 .. upto].
template <int ROWS>
__device__ __forceinline__ void nkt_bwd_forward(const MmaChain& m, const __nv_bfloat16* ws,
                                                const float* bs, const BwdActs& acts, int upto,
                                                float* scratch) {
  for (int l = 0; l < upto; ++l) {
    __nv_bfloat16* out = acts.a[l + 1];
    const int ldo = acts.ld[l + 1];
    const float* bias = bs + m.b_s[l];
    auto relu_store = [=](int row, int o, float v) {
      out[row * ldo + o] = __float2bfloat16_rn(fmaxf(v + bias[o], 0.0f));
      return 0.0f;
    };
    nkt_bwd_gemm<ROWS, false>(acts.a[l], acts.ld[l], ws + m.w_s[l], m.np[l] + 8, m.kp[l],
                              m.np[l], scratch, nullptr, relu_store);
    __syncthreads();
  }
}

// Device, whole block: backward through layers top .. 0. dh (ROWS, np_top)
// bf16 is the gradient of layer top's pre-activation, rounded; the caller has
// already added layer top's bias gradient. Adds every layer's dW into gpart
// and the bias gradients of layers top-1 .. 0 into db (this warp's slab's
// accumulators, indexed like the chain's bias region). On return *dh0 / *ld0
// give the gradient of layer 0's pre-activation (it overwrote acts.a[1], or
// is dh itself when top == 0). Ends with a barrier.
template <int ROWS>
__device__ __forceinline__ void nkt_bwd_chain(const MmaChain& m, const GradLayout& gl,
                                              const __nv_bfloat16* ws, const BwdActs& acts, int top,
                                              const __nv_bfloat16* dh, int lddh, float* gpart,
                                              float* db, float* scratch,
                                              const __nv_bfloat16** dh0, int* ld0) {
  for (int i = top; i >= 0; --i) {
    nkt_bwd_dw<ROWS>(acts.a[i], acts.ld[i], m.kp[i], dh, lddh, m.np[i], gpart + gl.w[i]);
    __syncthreads();
    if (i == 0) break;
    __nv_bfloat16* a = acts.a[i];
    const int la = acts.ld[i];
    auto mask_store = [=](int row, int k, float v) {
      const float d = __bfloat162float(a[row * la + k]) > 0.0f ? v : 0.0f;
      a[row * la + k] = __float2bfloat16_rn(d);
      return d;
    };
    nkt_bwd_gemm<ROWS, true>(dh, lddh, ws + m.w_s[i], m.np[i] + 8, m.np[i], m.kp[i], scratch,
                             db + m.b_s[i - 1], mask_store);
    __syncthreads();
    dh = a;
    lddh = la;
  }
  *dh0 = dh;
  *ld0 = lddh;
}

// Device, whole block: dx for the tile from the gradient of the first
// layer's pre-activation: d_enc = dh0 . W0^T, dproj = ds * s' + dc * c',
// dx = B . dproj, all in f32 after the bf16 product. Each warp reduces its
// 16 columns per row into dxp[column tile][row][3]; then one thread per
// (row, coordinate) sums the column tiles in order and stores dx (3, n).
// dxp holds (kp0 / 16) * ROWS * 3 floats. Ends with a barrier.
template <int ROWS, bool TRI>
__device__ __forceinline__ void nkt_bwd_dx(const MmaChain& m, const __nv_bfloat16* ws,
                                           const __nv_bfloat16* dh0, int ld0, const float* xs,
                                           const float* Bs, int H, float* scratch, float* dxp,
                                           float* dx, int n, long long p0) {
  using namespace nvcuda;
  constexpr int RS = ROWS / 16, CG = NKT_MMA_WARPS / RS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % RS) * 16;
  const int nct = m.kp[0] / 16;
  auto deriv = [=](int row, int o, float v) {
    if (o >= 2 * H) return 0.0f;
    const int h = o < H ? o : o - H;
    const float u = fmaf(Bs[2 * H + h], xs[2 * ROWS + row],
                         fmaf(Bs[H + h], xs[ROWS + row], Bs[h] * xs[row]));
    float dsdu, dcdu;
    nkt_basis_grads<TRI>(u, &dsdu, &dcdu);
    return v * (o < H ? dsdu : dcdu);
  };
  for (int t = warp / RS; t < nct; t += CG) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k0 = 0; k0 < m.np[0]; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, dh0 + r0 * ld0 + k0, ld0);
      wmma::load_matrix_sync(b, ws + m.w_s[0] + (t * 16) * (m.np[0] + 8) + k0, m.np[0] + 8);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int e = lane; e < 256; e += 32) scratch[e] = deriv(r0 + e / 16, t * 16 + e % 16, scratch[e]);
    __syncwarp();
    if (lane < 16) {
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
      for (int j = 0; j < 16; ++j) {
        const int o = t * 16 + j;
        if (o >= 2 * H) break;
        const int h = o < H ? o : o - H;
        const float w = scratch[lane * 16 + j];
        d0 = fmaf(Bs[h], w, d0);
        d1 = fmaf(Bs[H + h], w, d1);
        d2 = fmaf(Bs[2 * H + h], w, d2);
      }
      float* dst = dxp + ((size_t)t * ROWS + r0 + lane) * 3;
      dst[0] = d0;
      dst[1] = d1;
      dst[2] = d2;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * ROWS; i += blockDim.x) {
    const int d = i / ROWS, r = i % ROWS;
    float s = 0.0f;
    for (int t = 0; t < nct; ++t) s += dxp[((size_t)t * ROWS + r) * 3 + d];
    if (p0 + r < n) dx[(size_t)d * n + p0 + r] = s;
  }
  __syncthreads();
}

// Device, whole block: the tile's rows of a (D, n) f32 array into dst (D,
// ROWS), zeros past the ragged edge.
template <int ROWS>
__device__ __forceinline__ void nkt_bwd_load_rows(const float* src, int D, int n, long long p0,
                                                  float* dst) {
  for (int i = threadIdx.x; i < D * ROWS; i += blockDim.x) {
    const int d = i / ROWS, r = i % ROWS;
    dst[i] = p0 + r < n ? src[(size_t)d * n + p0 + r] : 0.0f;
  }
}

// Device, whole block, at the end of the kernel: this block's bias-gradient
// accumulators (RS slabs of b_floats each, laid out like the chain's bias
// region) summed over slabs in order into the block's partial.
template <int ROWS>
__device__ __forceinline__ void nkt_bwd_flush_bias(const MmaChain& m, const GradLayout& gl,
                                                   const float* db_s, int b_floats,
                                                   float* gpart) {
  constexpr int RS = ROWS / 16;
  for (int l = 0; l < m.n_layers; ++l)
    for (int o = threadIdx.x; o < m.np[l]; o += blockDim.x) {
      float s = 0.0f;
      for (int r = 0; r < RS; ++r) s += db_s[r * b_floats + m.b_s[l] + o];
      gpart[gl.b[l] + o] = s;
    }
}

// ---------------------------------------------------------------------------
// f32 compute: one thread per point, NKT_TILE points per block, columns
// [feature][point] in shared memory
// ---------------------------------------------------------------------------

// Device, whole block (after a barrier): gw (din rows of np) += act . dh^T
// and gb += row sums of dh over the tile's points, for act (din, NKT_TILE)
// and dh (dout, NKT_TILE). One thread per weight; the point index is
// staggered by the lane so the 32 lanes read 32 different banks.
__device__ __forceinline__ void nkt_f32_dw(const float* act, int din, const float* dh, int dout,
                                           float* gw, int np, float* gb) {
  const int lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < din * dout; e += blockDim.x) {
    const int k = e / dout, o = e % dout;
    float s = 0.0f;
    for (int j = 0; j < NKT_TILE; ++j) {
      const int p = (j + lane) % NKT_TILE;
      s = fmaf(act[k * NKT_TILE + p], dh[o * NKT_TILE + p], s);
    }
    gw[k * np + o] += s;
  }
  for (int o = threadIdx.x; o < dout; o += blockDim.x) {
    float s = 0.0f;
    for (int j = 0; j < NKT_TILE; ++j) s += dh[o * NKT_TILE + (j + lane) % NKT_TILE];
    gb[o] += s;
  }
}

// Device, one thread (its point's columns): dot of W's row k (dout) with dh.
__device__ __forceinline__ float nkt_f32_wdh(const float* Wrow, const float* dhcol, int dout) {
  float s = 0.0f;
  for (int o = 0; o < dout; ++o) s = fmaf(Wrow[o], dhcol[o * NKT_TILE], s);
  return s;
}

// Device, whole block: backward through layers top .. 0 of a chain in f32.
// cols[l] is layer l's input (dims[l] rows) and cols[top + 1] holds the
// gradient of layer top's pre-activation; each dh_{i-1} overwrites cols[i].
// `t` is this thread's point. Starts and ends with a barrier.
struct F32Cols {
  float* c[NKT_MAX_LAYERS + 1];
};

__device__ __forceinline__ void nkt_f32_chain_bwd(const Chain& ch, const GradLayout& gl,
                                                  const float* W, const F32Cols& cols, int top,
                                                  float* gpart, int t) {
  for (int i = top; i >= 0; --i) {
    __syncthreads();
    nkt_f32_dw(cols.c[i], ch.dims[i], cols.c[i + 1], ch.dims[i + 1], gpart + gl.w[i], gl.np[i],
               gpart + gl.b[i]);
    __syncthreads();
    if (i == 0) break;
    float* a = cols.c[i] + t;
    const float* dh = cols.c[i + 1] + t;
    const int dout = ch.dims[i + 1];
    for (int k = 0; k < ch.dims[i]; ++k) {
      const float da = nkt_f32_wdh(W + ch.w_off[i] + (size_t)k * dout, dh, dout);
      a[k * NKT_TILE] = a[k * NKT_TILE] > 0.0f ? da : 0.0f;
    }
  }
}

// Device, one thread: dx of its point from the gradient dh0 (column) of the
// first layer's pre-activation: ds_h = W0[h, :] . dh0, dc_h = W0[H + h, :] .
// dh0, dx = B . (ds * s' + dc * c').
template <bool TRI>
__device__ __forceinline__ void nkt_f32_dx(const float* W0, int d1, const float* dh0,
                                           const float* __restrict__ Bm, int H, float x0, float x1,
                                           float x2, float out[3]) {
  out[0] = out[1] = out[2] = 0.0f;
  for (int h = 0; h < H; ++h) {
    const float b0 = __ldg(Bm + h), b1 = __ldg(Bm + H + h), b2 = __ldg(Bm + 2 * H + h);
    const float u = fmaf(b2, x2, fmaf(b1, x1, b0 * x0));
    float dsdu, dcdu;
    nkt_basis_grads<TRI>(u, &dsdu, &dcdu);
    const float ds = nkt_f32_wdh(W0 + (size_t)h * d1, dh0, d1);
    const float dc = nkt_f32_wdh(W0 + (size_t)(H + h) * d1, dh0, d1);
    const float dproj = ds * dsdu + dc * dcdu;
    out[0] = fmaf(b0, dproj, out[0]);
    out[1] = fmaf(b1, dproj, out[1]);
    out[2] = fmaf(b2, dproj, out[2]);
  }
}

// Device, whole block: zero this block's partial. The caller follows it with
// a barrier.
__device__ __forceinline__ void nkt_zero_partial(float* gpart, int floats) {
  for (int i = threadIdx.x; i < floats; i += blockDim.x) gpart[i] = 0.0f;
}
