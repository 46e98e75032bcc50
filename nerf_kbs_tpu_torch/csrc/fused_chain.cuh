// Shared device code of the fused-field kernels (fourier_mlp_fwd.cu,
// fourier_field_fwd.cu and, through chain_bwd.cuh, their backwards).
//
// Two designs share it. The bf16 operating point runs on the tensor cores
// (mma_chain.cuh). f32 compute, the oracle mode, runs here:
// - one thread per point, NKT_TILE points per block;
// - the per-point activations of a layer live in shared memory as columns
//   [feature][point], so a thread only ever touches its own column and the
//   layer chain needs no barrier;
// - weights are read by every thread at the same address (a broadcast), from
//   shared memory when they fit and through L1/L2 otherwise, as float4 where
//   the layer width allows;
// - products are f32 FMAs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NKT_TILE 64
#define NKT_MAX_LAYERS 8
// weights are copied into shared memory when they take at most this much
#define NKT_SMEM_WEIGHT_BYTES (48 * 1024)

// Error codes below 0 are argument errors found before any launch.
#define NKT_ERR_LAYERS (-1)
#define NKT_ERR_PACKING (-2)
#define NKT_ERR_SMEM (-3)
#define NKT_ERR_VARIANT (-4)

// One MLP chain: layer l maps dims[l] -> dims[l+1]; its weights W (dims[l],
// dims[l+1]) row-major and bias b (dims[l+1]) sit at w_off / b_off floats in
// the packed buffer, each start rounded up to 4 floats (16 bytes).
struct Chain {
  int n_layers;
  int dims[NKT_MAX_LAYERS + 1];
  int w_off[NKT_MAX_LAYERS];
  int b_off[NKT_MAX_LAYERS];
};

static inline int nkt_round4(int v) { return (v + 3) / 4 * 4; }

// Fills a Chain from host dims; returns the packed size in floats, or an
// error code below 0.
static inline int nkt_chain_from_dims(Chain* c, const int* dims, int n_layers) {
  if (n_layers < 1 || n_layers > NKT_MAX_LAYERS) return NKT_ERR_LAYERS;
  c->n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) c->dims[i] = dims[i];
  int off = 0;
  for (int i = 0; i < n_layers; ++i) {
    c->w_off[i] = off;
    off = nkt_round4(off + dims[i] * dims[i + 1]);
    c->b_off[i] = off;
    off = nkt_round4(off + dims[i + 1]);
  }
  return off;
}

// tri_s / tri_c of ops/fused_field.py: triangle waves of period 1.
__device__ __forceinline__ float nkt_tri_s(float u) {
  float f = u + 0.75f;
  f = f - floorf(f);
  return 4.0f * fabsf(f - 0.5f) - 1.0f;
}

__device__ __forceinline__ float nkt_tri_c(float u) {
  float f = u - floorf(u);
  return 4.0f * fabsf(f - 0.5f) - 1.0f;
}

// proj = B^T x in f32 (B is (3, H) row-major), then the basis pair: rows
// [0, H) of the column get s, rows [H, 2H) get c. sincosf, not the fast
// intrinsic: with B pre-scaled by 2*pi the arguments reach ~1600 rad.
template <bool TRI>
__device__ __forceinline__ void nkt_encode(const float* __restrict__ Bm, int H, float x0,
                                           float x1, float x2, float* col) {
  for (int h = 0; h < H; ++h) {
    float u = fmaf(__ldg(Bm + 2 * H + h), x2, fmaf(__ldg(Bm + H + h), x1, __ldg(Bm + h) * x0));
    float s, c;
    if (TRI) {
      s = nkt_tri_s(u);
      c = nkt_tri_c(u);
    } else {
      sincosf(u, &s, &c);
    }
    col[h * NKT_TILE] = s;
    col[(H + h) * NKT_TILE] = c;
  }
}

// OC outputs [o0, o0 + OC) of one layer for this thread's point; epi(o, v)
// receives each f32 pre-activation.
template <int OC, class Epi>
__device__ __forceinline__ void nkt_dense_chunk(const float* in, int din, const float* W,
                                                int dout, const float* b, int o0, Epi& epi) {
  float acc[OC];
#pragma unroll
  for (int j = 0; j < OC; ++j) acc[j] = b[o0 + j];
#pragma unroll 2
  for (int k = 0; k < din; ++k) {
    const float a = in[k * NKT_TILE];
    const float* w = W + (size_t)k * dout + o0;
    if constexpr (OC % 4 == 0) {
#pragma unroll
      for (int q = 0; q < OC / 4; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(w + 4 * q);
        acc[4 * q + 0] = fmaf(a, wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(a, wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(a, wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(a, wv.w, acc[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[j] = fmaf(a, w[j], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < OC; ++j) epi(o0 + j, acc[j]);
}

// One dense layer. Widths that are a multiple of 4 go 16 (then 4) outputs at
// a time with float4 weight loads; any other width, and the width-1 output of
// the proposal field, is a dot-reduce per output.
template <class Epi>
__device__ __forceinline__ void nkt_dense(const float* in, int din, const float* W,
                                          int dout, const float* b, Epi epi) {
  int o0 = 0;
  if (dout % 4 == 0) {
    for (; o0 + 16 <= dout; o0 += 16) nkt_dense_chunk<16>(in, din, W, dout, b, o0, epi);
    for (; o0 + 4 <= dout; o0 += 4) nkt_dense_chunk<4>(in, din, W, dout, b, o0, epi);
  }
  for (; o0 < dout; ++o0) nkt_dense_chunk<1>(in, din, W, dout, b, o0, epi);
}

// Runs layers [0, L-1) of a chain with relu, ping-ponging between the two
// column buffers (*cur holds the input); on return *cur holds the input of
// the last layer and *nxt is free.
__device__ __forceinline__ void nkt_hidden_layers(const Chain& ch, const float* W, float** cur,
                                                  float** nxt) {
  for (int l = 0; l < ch.n_layers - 1; ++l) {
    float* out = *nxt;
    auto relu_store = [=](int o, float v) { out[o * NKT_TILE] = fmaxf(v, 0.0f); };
    nkt_dense(*cur, ch.dims[l], W + ch.w_off[l], ch.dims[l + 1], W + ch.b_off[l], relu_store);
    *nxt = *cur;
    *cur = out;
  }
}

// Rows each column buffer must hold for a chain whose input sits in buffer
// `first` with `in_rows` rows: the hidden outputs alternate buffers.
static inline void nkt_chain_rows(const Chain& ch, int first, int in_rows, int rows[2]) {
  if (in_rows > rows[first]) rows[first] = in_rows;
  int cur = first;
  for (int l = 0; l < ch.n_layers - 1; ++l) {
    cur ^= 1;
    if (ch.dims[l + 1] > rows[cur]) rows[cur] = ch.dims[l + 1];
  }
}

__host__ __device__ static inline size_t nkt_round16(size_t v) { return (v + 15) / 16 * 16; }

extern "C" const char* nkt_error_string(int code) {
  switch (code) {
    case NKT_ERR_LAYERS: return "layer count outside [1, 8]";
    case NKT_ERR_PACKING: return "packed weight size does not match the layer dims";
    case NKT_ERR_SMEM: return "shared memory need exceeds the 227 KB a block can use";
    case NKT_ERR_VARIANT: return "the kernel variant asked for does not take these shapes";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}
