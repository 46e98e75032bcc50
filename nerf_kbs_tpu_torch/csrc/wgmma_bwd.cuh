// The wgmma backward's shared pieces, for the two kernels whose backward
// runs the base chain H = 128, (256, 128, 128, 16) on wgmma: the field
// backward (fourier_field_bwd.cu, both chains) and the fused MLP backward at
// the base widths (fourier_mlp_bwd.cu, the base chain alone, also with one
// hidden layer, (256, 128, 16)).
//
// Both split the work in two. A per-point pass walks 64-point tiles, one
// warpgroup a tile, recomputes the forward and walks the chain backwards
// with every activation and gradient in registers (relu masks as bits, bias
// gradients as f32 column sums by a shuffle butterfly), and leaves every
// layer's input and pre-activation gradient as bf16 [point][feature] tiles
// in the core layout in a scratch tensor. Weight-gradient passes then
// contract those tiles over points (nkt_field_dw_kernel per layer,
// nkt_field_dw0_kernel for the first layer, which recomputes the encoding
// instead of reading it), each block over a contiguous range of tiles into
// a partial of its own; a last kernel sums the partials in block order.
#pragma once

#include "chain_bwd.cuh"
#include "wgmma_chain.cuh"

// One warpgroup: the packed rows `a` (WIDTH / 4 words a thread) of its tile
// into the tile's place in scratch array `first`. A warp's store of one word
// is one core matrix: 128 contiguous bytes.
template <int WIDTH>
__device__ __forceinline__ void nkt_wg_store_tile(uint32_t* scratch, int first, int ntiles,
                                                  int tile, const WgLane& L, const uint32_t* a) {
  nkt_wg_put_tile<WIDTH>(
      scratch + ((size_t)first * ntiles + (size_t)tile * WIDTH) * (NKT_WG_ROWS / 2), L, a);
}

// One step of the column-sum butterfly over the 8 lanes that share t: the
// lanes with `bit` set keep the upper half of s, the others the lower half,
// and each adds its partner's share. With one value left both keep the sum.
template <int V>
__device__ __forceinline__ void nkt_wg_halve(float* s, int lane, int bit) {
  if (V >= 2) {
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const bool up = lane & bit;
      const float send = up ? s[i] : s[i + V / 2], keep = up ? s[i + V / 2] : s[i];
      s[i] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
  } else {
    s[0] += __shfl_xor_sync(0xffffffffu, s[0], bit);
  }
}

// Entries a thread owns of the column sums of a (64, 2R) accumulator after
// nkt_wg_colsum.
__host__ __device__ constexpr int nkt_db_count(int R) { return R >= 16 ? R / 16 : 1; }

// Adds the sums of the warp's 16 rows of acc, per column, into db: the thread
// ends up owning nkt_db_count(R) of the warp's 2R columns (nkt_db_column).
template <int R>
__device__ __forceinline__ void nkt_wg_colsum(const float (&acc)[R], int lane, float* db) {
  constexpr int V = R / 2;
  float s[V];
#pragma unroll
  for (int q = 0; q < V; ++q) s[q] = acc[4 * (q / 2) + q % 2] + acc[4 * (q / 2) + 2 + q % 2];
  constexpr int V1 = V >= 2 ? V / 2 : 1, V2 = V1 >= 2 ? V1 / 2 : 1;
  nkt_wg_halve<V>(s, lane, 16);
  nkt_wg_halve<V1>(s, lane, 8);
  nkt_wg_halve<V2>(s, lane, 4);
#pragma unroll
  for (int i = 0; i < nkt_db_count(R); ++i) db[i] += s[i];
}

// Column of db[i] of nkt_wg_colsum, or -1 where another lane owns the sum.
template <int R>
__device__ __forceinline__ int nkt_db_column(int i, int lane) {
  int v = R / 2, q = i;
  for (int bit = 16; bit >= 4; bit >>= 1) {
    if (v >= 2) {
      v /= 2;
      if (lane & bit) q += v;
    } else if (lane & bit) {
      return -1;
    }
  }
  return 8 * (q / 2) + 2 * (lane % 4) + q % 2;
}

// Gradient of a hidden layer's pre-activation from acc = dh_next . W^T: the
// relu mask, the f32 column sums into db, then rounded and packed as the next
// product's A operand.
template <int R>
__device__ __forceinline__ void nkt_wg_dh(float (&acc)[R], const uint32_t* mask, int lane,
                                          float* db, uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = (mask[i / 32] >> (i % 32)) & 1u ? acc[i] : 0.0f;
  nkt_wg_colsum(acc, lane, db);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    a[2 * j] = nkt_pack_bf16(acc[4 * j], acc[4 * j + 1]);
    a[2 * j + 1] = nkt_pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Writes the column sums db of nkt_wg_colsum (this lane's share) into the
// warp's row of bias gradients at `row` (one float per column).
template <int R>
__device__ __forceinline__ void nkt_wg_db_put(const float* db, int lane, float* row) {
#pragma unroll
  for (int i = 0; i < nkt_db_count(R); ++i) {
    const int c = nkt_db_column<R>(i, lane);
    if (c >= 0) row[c] = db[i];
  }
}

// dx of the thread's two rows from dh_0 of the base chain (h, the packed A
// operand of the (64, 128) gradient): d_enc = dh_0 . W_0^T, the s half then
// the c half into acc; dproj = d_enc times the basis derivative; dx = B .
// dproj, all in f32, summed over the quad that shares a row. W_0^T [128][256]
// sits at w_b0 in shared memory, B (3, 128) at Bs.
template <bool TRI>
__device__ __forceinline__ void nkt_wg_base_dx(float (&acc)[64], const uint32_t* h, uint32_t w_b0,
                                               const float* Bs, const WgLane& L,
                                               const float (&xa)[3], const float (&xb)[3],
                                               long long pa, long long pb, int n,
                                               float* __restrict__ dx) {
  constexpr int H = 128;
  float da[3] = {0.0f, 0.0f, 0.0f}, dbx[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    nkt_wg_backward<8>(acc, h, w_b0, 128, half * H);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int hh = 8 * (i / 4) + 2 * L.t + i % 2;
      const float b0 = Bs[hh], b1 = Bs[H + hh], b2 = Bs[2 * H + hh];
      const bool row_a = (i % 4) < 2;
      const float u = row_a ? fmaf(b2, xa[2], fmaf(b1, xa[1], b0 * xa[0]))
                            : fmaf(b2, xb[2], fmaf(b1, xb[1], b0 * xb[0]));
      float dsdu, dcdu;
      nkt_basis_grads<TRI>(u, &dsdu, &dcdu);
      const float w = acc[i] * (half ? dcdu : dsdu);
      if (row_a) {
        da[0] = fmaf(b0, w, da[0]);
        da[1] = fmaf(b1, w, da[1]);
        da[2] = fmaf(b2, w, da[2]);
      } else {
        dbx[0] = fmaf(b0, w, dbx[0]);
        dbx[1] = fmaf(b1, w, dbx[1]);
        dbx[2] = fmaf(b2, w, dbx[2]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    da[d] += __shfl_xor_sync(0xffffffffu, da[d], 1);
    da[d] += __shfl_xor_sync(0xffffffffu, da[d], 2);
    dbx[d] += __shfl_xor_sync(0xffffffffu, dbx[d], 1);
    dbx[d] += __shfl_xor_sync(0xffffffffu, dbx[d], 2);
    if (L.t == 0) {
      if (pa < n) dx[(size_t)d * n + pa] = da[d];
      if (pb < n) dx[(size_t)d * n + pb] = dbx[d];
    }
  }
}

// Tiles in flight per block of the weight-gradient passes: a ring of
// shared-memory buffers filled by cp.async, the copies of the next
// NKT_DW_STAGES - 1 tiles running behind the current tile's products.
#define NKT_DW_STAGES 4

// The weight-gradient pass of one layer: dW (KF, NO) = act^T . dh over all
// points, act (width KF) and dh (width NO) being scratch arrays of the
// per-point pass. Each block takes a contiguous range of tiles, keeps the f32
// accumulator in registers over the whole range (warpgroup s owns rows
// [64 s, 64 s + 64)), and writes it once into its partial: row f of the
// product is row f - row_shift of the layer's dW, rows outside [0, din) are
// dropped.
template <int KF, int NO>
__global__ void __launch_bounds__((KF + 63) / 64 * NKT_WG_THREADS)
    nkt_field_dw_kernel(const uint4* __restrict__ act, const uint4* __restrict__ dh, int ntiles,
                        float* __restrict__ partials, int stride, int w_off, int row_shift,
                        int din) {
  constexpr int THREADS = (KF + 63) / 64 * NKT_WG_THREADS;
  constexpr int A_V = 64 * KF / 8, B_V = 64 * NO / 8;  // 16-byte vectors per tile
  // a 32-wide act tile is read as a 64-row slab: its buffer has the room
  constexpr int A_BUF = 64 * (KF < 64 ? 64 : KF) * 2, BUF = A_BUF + 64 * NO * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t0 = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  const WgLane L = nkt_wg_lane();
  const int slab = threadIdx.x / NKT_WG_THREADS;
  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.0f;

  auto fetch = [&](int tile, int buf) {
    if (tile < t1) {
      uint4* a = reinterpret_cast<uint4*>(smem + buf * BUF);
      uint4* b = reinterpret_cast<uint4*>(smem + buf * BUF + A_BUF);
      for (int v = threadIdx.x; v < A_V; v += THREADS)
        nkt_cp_async16(a + v, act + (size_t)tile * A_V + v);
      for (int v = threadIdx.x; v < B_V; v += THREADS)
        nkt_cp_async16(b + v, dh + (size_t)tile * B_V + v);
    }
    nkt_cp_commit();  // an empty group past the range keeps the count in step
  };
  for (int s = 0; s < NKT_DW_STAGES - 1; ++s) fetch(t0 + s, s);
  for (int tile = t0; tile < t1; ++tile) {
    const int cur = (tile - t0) % NKT_DW_STAGES;
    nkt_cp_wait<NKT_DW_STAGES - 2>();  // this thread's copies of `tile` have landed
    nkt_fence_async_smem();
    __syncthreads();  // everyone's have, and the last tile's products are done
    fetch(tile + NKT_DW_STAGES - 1, (cur + NKT_DW_STAGES - 1) % NKT_DW_STAGES);
    const uint32_t a_addr = nkt_smem_addr(smem + cur * BUF) + slab * 8 * 1024;
    const uint32_t b_addr = nkt_smem_addr(smem + cur * BUF + A_BUF);
    nkt_wg_fence();
#pragma unroll
    for (int ks = 0; ks < NKT_WG_ROWS / 16; ++ks)
      nkt_wgmma_ss<1, 1>(acc, nkt_wg_desc(a_addr + ks * 256, 128, 1024),
                         nkt_wg_desc(b_addr + ks * 256, 128, 1024), 1);
    nkt_wg_commit();
    nkt_wg_wait<0>();
  }
  nkt_wg_settle(acc);
  float* gw = partials + (size_t)blockIdx.x * stride + w_off;
#pragma unroll
  for (int j = 0; j < NO / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * slab + 16 * L.w + L.g + 8 * r - row_shift;
      if (row >= 0 && row < din)
        *reinterpret_cast<float2*>(gw + (size_t)row * NO + 8 * j + 2 * L.t) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// The weight-gradient pass of the first base layer: dW_0 (2H, 128) =
// enc(x)^T . dh_0, the encoding recomputed from x straight into A operands
// (rows are encoding features, columns points), never stored. Four
// warpgroups own 64 features each; dh_0 tiles come from scratch as in
// nkt_field_dw_kernel, x tiles beside them (zeros past the ragged edge).
template <bool TRI>
__global__ void __launch_bounds__(4 * NKT_WG_THREADS)
    nkt_field_dw0_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                         const uint4* __restrict__ dh, int ntiles, float* __restrict__ partials,
                         int stride, int w_off) {
  constexpr int H = 128, NO = 128, THREADS = 4 * NKT_WG_THREADS;
  constexpr int B_V = 64 * NO / 8;
  constexpr int BUF = 64 * NO * 2 + 3 * 64 * 4;  // dh tile, then x (3, 64)
  extern __shared__ __align__(128) unsigned char smem[];
  const int t0 = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t1 = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  const WgLane L = nkt_wg_lane();
  const int slab = threadIdx.x / NKT_WG_THREADS;
  const bool cos_half = slab >= 2;
  // the thread's two encoding features and their frequencies
  const int ha = 64 * (slab % 2) + 16 * L.w + L.g, hb = ha + 8;
  float Ba[3], Bb[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    Ba[d] = Bm[d * H + ha];
    Bb[d] = Bm[d * H + hb];
  }
  float acc[NO / 2];
#pragma unroll
  for (int i = 0; i < NO / 2; ++i) acc[i] = 0.0f;

  auto fetch = [&](int tile, int buf) {
    if (tile < t1) {
      uint4* b = reinterpret_cast<uint4*>(smem + buf * BUF);
      for (int v = threadIdx.x; v < B_V; v += THREADS)
        nkt_cp_async16(b + v, dh + (size_t)tile * B_V + v);
      if (threadIdx.x < 3 * 64) {
        const long long p = (long long)tile * 64 + threadIdx.x % 64;
        const bool valid = p < n;
        nkt_cp_async4(reinterpret_cast<float*>(smem + buf * BUF + 64 * NO * 2) + threadIdx.x,
                      valid ? x + (size_t)(threadIdx.x / 64) * n + p : x, valid);
      }
    }
    nkt_cp_commit();
  };
  auto enc = [&](const float (&Bv)[3], float x0, float x1, float x2) {
    const float u = fmaf(Bv[2], x2, fmaf(Bv[1], x1, Bv[0] * x0));
    if (TRI) return cos_half ? nkt_tri_c(u) : nkt_tri_s(u);
    float s, c;
    sincosf(u, &s, &c);
    return cos_half ? c : s;
  };
  for (int s = 0; s < NKT_DW_STAGES - 1; ++s) fetch(t0 + s, s);
  for (int tile = t0; tile < t1; ++tile) {
    const int cur = (tile - t0) % NKT_DW_STAGES;
    nkt_cp_wait<NKT_DW_STAGES - 2>();
    nkt_fence_async_smem();
    __syncthreads();
    fetch(tile + NKT_DW_STAGES - 1, (cur + NKT_DW_STAGES - 1) % NKT_DW_STAGES);
    const float* xs = reinterpret_cast<const float*>(smem + cur * BUF + 64 * NO * 2);
    const uint32_t b_addr = nkt_smem_addr(smem + cur * BUF);
    uint32_t a[4 * (NKT_WG_ROWS / 16)];
#pragma unroll
    for (int ks = 0; ks < NKT_WG_ROWS / 16; ++ks)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = 16 * ks + 8 * half + 2 * L.t;  // points p, p + 1
        const float2 x0 = *reinterpret_cast<const float2*>(xs + p);
        const float2 x1 = *reinterpret_cast<const float2*>(xs + 64 + p);
        const float2 x2 = *reinterpret_cast<const float2*>(xs + 128 + p);
        a[4 * ks + 2 * half] = nkt_pack_bf16(enc(Ba, x0.x, x1.x, x2.x), enc(Ba, x0.y, x1.y, x2.y));
        a[4 * ks + 2 * half + 1] =
            nkt_pack_bf16(enc(Bb, x0.x, x1.x, x2.x), enc(Bb, x0.y, x1.y, x2.y));
      }
    nkt_wg_fence();
#pragma unroll
    for (int ks = 0; ks < NKT_WG_ROWS / 16; ++ks)
      nkt_wgmma_rs<1>(acc, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                      nkt_wg_desc(b_addr + ks * 256, 128, 1024), 1);
    nkt_wg_commit();
    nkt_wg_wait<0>();
  }
  nkt_wg_settle(acc);
  float* gw = partials + (size_t)blockIdx.x * stride + w_off;
#pragma unroll
  for (int j = 0; j < NO / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * slab + 16 * L.w + L.g + 8 * r;
      *reinterpret_cast<float2*>(gw + (size_t)row * NO + 8 * j + 2 * L.t) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

template <int KF, int NO>
static int launch_dw(const uint32_t* scratch, int act_first, int dh_first, int ntiles, int grid,
                     float* partials, int stride, int w_off, int row_shift, int din,
                     cudaStream_t stream) {
  constexpr int THREADS = (KF + 63) / 64 * NKT_WG_THREADS;
  constexpr int BUF = 64 * (KF < 64 ? 64 : KF) * 2 + 64 * NO * 2;
  cudaError_t err = cudaFuncSetAttribute(nkt_field_dw_kernel<KF, NO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         NKT_DW_STAGES * BUF);
  if (err != cudaSuccess) return (int)err;
  const size_t per = (size_t)ntiles * (NKT_WG_ROWS / 2);  // words per unit of width
  nkt_field_dw_kernel<KF, NO><<<grid, THREADS, NKT_DW_STAGES * BUF, stream>>>(
      reinterpret_cast<const uint4*>(scratch + act_first * per),
      reinterpret_cast<const uint4*>(scratch + dh_first * per), ntiles, partials, stride, w_off,
      row_shift, din);
  return (int)cudaGetLastError();
}

// dW_0 of the base chain by nkt_field_dw0_kernel over the dh_0 tiles at
// `dh0` (one scratch array), `grid` blocks, into each block's partial at w_off.
template <bool TRI>
static int launch_dw0(const float* x, int n, const float* Bm, const uint32_t* dh0, int ntiles,
                      int grid, float* partials, int stride, int w_off, cudaStream_t stream) {
  constexpr int smem = NKT_DW_STAGES * (64 * 128 * 2 + 3 * 64 * 4);
  cudaError_t err = cudaFuncSetAttribute(nkt_field_dw0_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nkt_field_dw0_kernel<TRI><<<grid, 4 * NKT_WG_THREADS, smem, stream>>>(
      x, n, Bm, reinterpret_cast<const uint4*>(dh0), ntiles, partials, stride, w_off);
  return (int)cudaGetLastError();
}
