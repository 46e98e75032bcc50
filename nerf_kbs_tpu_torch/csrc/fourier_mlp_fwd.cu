// Forward fused Fourier-feature MLP for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_fwd_body` of nerf_kbs_tpu/ops/fused_field.py
// (pallas_call in `_fwd`, public `fourier_mlp`). It computes, per point,
//   proj = B^T x (f32), s, c = tri or sin/cos of proj,
//   h = relu(W0a^T s + W0b^T c + b0), ..., out = W_last^T h + b_last,
// feature-major: x (3, N) f32 in, out (out_dim, N) f32 out.
//
// What bounds it here: at the proposal fields' shapes (H = 40, dims
// (80, 16, 1)) a point costs ~2.8 kFLOP against 16 bytes of device memory
// (12 in, 4 out), about 177 FLOP/byte: below the H100's ~295 bf16 FLOP/byte,
// so the bound is the bytes, ~15 us for the 3.1M points of proposal round 0.
//
// What the design does about it: nothing of the (80, N) encoding or the
// hidden layers reaches device memory, and the point axis is read and
// written once, coalesced. At the bf16 operating point the hidden layers are
// bf16 WMMA products on the tensor cores (mma_chain.cuh) with the few
// weights resident in shared memory; ~37 KB per block lets several
// persistent blocks share an SM, so one block's barriers and global loads
// overlap another's work. A width-1 output is a dot-reduce per point, not a
// one-column product. f32 compute (the oracle mode) runs one thread per point
// on f32 FMAs (fused_chain.cuh).
#include "mma_chain.cuh"

// ---------------------------------------------------------------------------
// f32 compute: one thread per point
// ---------------------------------------------------------------------------

template <bool TRI>
__global__ void __launch_bounds__(NKT_TILE)
    fourier_mlp_fwd_f32_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                               int H, const float* __restrict__ wb, int wb_floats, int w_in_smem,
                               Chain ch, int rows0, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sw = reinterpret_cast<float*>(smem);
  const size_t wbytes = w_in_smem ? nkt_round16((size_t)wb_floats * sizeof(float)) : 0;
  float* buf0 = reinterpret_cast<float*>(smem + wbytes);
  if (w_in_smem) {
    for (int i = threadIdx.x; i < wb_floats; i += blockDim.x) sw[i] = wb[i];
    __syncthreads();
  }
  const float* W = w_in_smem ? sw : wb;

  const int t = threadIdx.x;
  const long long p = (long long)blockIdx.x * NKT_TILE + t;
  if (p >= n) return;  // no barrier follows: the ragged edge simply stops
  float* cur = buf0 + t;
  float* nxt = buf0 + (size_t)rows0 * NKT_TILE + t;

  nkt_encode<TRI>(Bm, H, x[p], x[(size_t)n + p], x[2 * (size_t)n + p], cur);
  nkt_hidden_layers(ch, W, &cur, &nxt);
  const int l = ch.n_layers - 1;
  auto store_out = [=](int o, float v) { out[(size_t)o * n + p] = v; };
  nkt_dense(cur, ch.dims[l], W + ch.w_off[l], ch.dims[l + 1], W + ch.b_off[l], store_out);
}

template <bool TRI>
static int launch_f32(const float* x, int n, const float* Bm, int H, const float* wb,
                      int wb_floats, const Chain& ch, float* out, cudaStream_t stream) {
  int rows[2] = {0, 0};
  nkt_chain_rows(ch, 0, 2 * H, rows);
  const int w_in_smem = (size_t)wb_floats * sizeof(float) <= NKT_SMEM_WEIGHT_BYTES;
  const size_t wbytes = w_in_smem ? nkt_round16((size_t)wb_floats * sizeof(float)) : 0;
  const size_t smem = wbytes + (size_t)(rows[0] + rows[1]) * NKT_TILE * sizeof(float);
  if (smem > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_mlp_fwd_f32_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + NKT_TILE - 1) / NKT_TILE;
  fourier_mlp_fwd_f32_kernel<TRI><<<grid, NKT_TILE, smem, stream>>>(
      x, n, Bm, H, wb, wb_floats, w_in_smem, ch, rows[0], out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute: tensor cores (see mma_chain.cuh)
// ---------------------------------------------------------------------------

// MAXT bounds the column tiles a warp takes (hidden widths up to 32 * MAXT);
// the proposal fields' widths take MAXT = 2, which leaves registers for
// three blocks per SM.
template <bool TRI, int MAXT>
__global__ void __launch_bounds__(NKT_MMA_THREADS, MAXT <= 2 ? 3 : 1)
    fourier_mlp_fwd_mma_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                               int H, const float* __restrict__ wb, Chain ch, MmaChain m,
                               int w_elems, int b_floats, int ld, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MmaSmem L = nkt_mma_smem(w_elems, b_floats, H, ld);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  float* bs = reinterpret_cast<float*>(smem + L.b);
  float* Bs = reinterpret_cast<float*>(smem + L.B);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + (threadIdx.x / 32) * 256;
  nkt_mma_stage(ch, m, wb, ws, bs);
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) Bs[i] = Bm[i];

  const int last = ch.n_layers - 1;
  const int dout = ch.dims[last + 1];
  const int ntiles = (n + NKT_MMA_ROWS - 1) / NKT_MMA_ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * NKT_MMA_ROWS;
    __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem + L.act0);
    __nv_bfloat16* nxt = reinterpret_cast<__nv_bfloat16*>(smem + L.act1);
    // the barrier also keeps this tile's writes behind the last tile's reads
    __syncthreads();
    nkt_mma_load_x(x, n, p0, xs);
    __syncthreads();
    nkt_mma_encode<TRI>(xs, Bs, H, m.kp[0], cur, ld);
    __syncthreads();
    for (int l = 0; l < last; ++l) {
      __nv_bfloat16* out_buf = nxt;
      auto relu_store = [=](int row, int o, float v) {
        out_buf[row * ld + o] = __float2bfloat16_rn(fmaxf(v, 0.0f));
      };
      nkt_mma_layer<MAXT>(cur, ld, ws + m.w_s[l], m.np[l] + 8, bs + m.b_s[l], m.kp[l],
                          m.np[l], scratch, relu_store);
      __syncthreads();
      nxt = cur;
      cur = out_buf;
    }
    const __nv_bfloat16* W = ws + m.w_s[last];
    const float* b = bs + m.b_s[last];
    if (dout == 1) {
      // width-1 output: a dot-reduce per point over the bf16 activations
      const int r = threadIdx.x;
      if (r < NKT_MMA_ROWS && p0 + r < n) {
        const int ldw = m.np[last] + 8;
        float acc = b[0];
        for (int k = 0; k < ch.dims[last]; ++k)
          acc = fmaf(__bfloat162float(cur[r * ld + k]), __bfloat162float(W[k * ldw]), acc);
        out[p0 + r] = acc;
      }
    } else {
      auto store_out = [=](int row, int o, float v) {
        if (o < dout && p0 + row < n) out[(size_t)o * n + p0 + row] = v;
      };
      nkt_mma_layer<MAXT>(cur, ld, W, m.np[last] + 8, b, m.kp[last], m.np[last], scratch,
                          store_out);
    }
  }
}

template <bool TRI, int MAXT>
static int launch_mma(const float* x, int n, const float* Bm, int H, const float* wb,
                      const Chain& ch, const MmaChain& m, int w_elems, int b_floats, int ld,
                      float* out, cudaStream_t stream) {
  const MmaSmem L = nkt_mma_smem(w_elems, b_floats, H, ld);
  if (L.total > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_mlp_fwd_mma_kernel<TRI, MAXT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fourier_mlp_fwd_mma_kernel<TRI, MAXT>, NKT_MMA_THREADS, L.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return NKT_ERR_SMEM;
  const int ntiles = (n + NKT_MMA_ROWS - 1) / NKT_MMA_ROWS;
  const int grid = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  fourier_mlp_fwd_mma_kernel<TRI, MAXT><<<grid, NKT_MMA_THREADS, L.total, stream>>>(
      x, n, Bm, H, wb, ch, m, w_elems, b_floats, ld, out);
  return (int)cudaGetLastError();
}

// x (3, n) f32, Bm (3, H) f32, wb the packed chain (see fused_chain.cuh) whose
// first layer takes 2H inputs, out (dims[n_layers], n) f32; all contiguous on
// the device. bf16 compute runs on the tensor cores, f32 compute on FMAs.
// Launches on `stream`, does not synchronise; returns the launch error (0 on
// success).
extern "C" int nkt_fourier_mlp_fwd(const float* x, int n, const float* Bm, int H, const float* wb,
                                   int wb_floats, const int* dims, int n_layers, int tri, int bf16,
                                   float* out, void* stream) {
  Chain ch;
  const int packed = nkt_chain_from_dims(&ch, dims, n_layers);
  if (packed < 0) return packed;
  if (packed != wb_floats || dims[0] != 2 * H) return NKT_ERR_PACKING;
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    MmaChain m;
    int w_elems = 0, b_floats = 0;
    const int widest = nkt_mma_chain(ch, &m, &w_elems, &b_floats);
    if (widest < 0) return widest;
    int np_max = 0;
    for (int l = 0; l < n_layers; ++l) np_max = m.np[l] > np_max ? m.np[l] : np_max;
    const int ld = widest + 8;
#define NKT_LAUNCH(T, MT) launch_mma<T, MT>(x, n, Bm, H, wb, ch, m, w_elems, b_floats, ld, out, s)
    if (np_max <= 64) return tri ? NKT_LAUNCH(true, 2) : NKT_LAUNCH(false, 2);
    return tri ? NKT_LAUNCH(true, NKT_MMA_MAX_TILES) : NKT_LAUNCH(false, NKT_MMA_MAX_TILES);
#undef NKT_LAUNCH
  }
  return tri ? launch_f32<true>(x, n, Bm, H, wb, wb_floats, ch, out, s)
             : launch_f32<false>(x, n, Bm, H, wb, wb_floats, ch, out, s);
}
