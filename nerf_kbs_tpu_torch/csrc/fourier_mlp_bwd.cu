// Backward fused Fourier-feature MLP for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_bwd_body` of nerf_kbs_tpu/ops/fused_field.py
// (pallas_call in `_bwd`, the VJP of the public `fourier_mlp`). From x (3, N),
// B (3, H), the chain's weights and g (D, N), the gradient of the output, it
// recomputes the forward per tile (nothing was saved but the inputs) and gives
//   dW_i, db_i for every layer, summed over all points,
//   dx = B . (ds * s' + dc * c') (3, N) when need_dx, else nothing.
// Rounding follows the Pallas body: in bf16 mode dh is rounded before the dW
// product and before the W . dh product, the relu mask comes from the sign of
// the pre-activation, bias gradients sum the f32 dh, and a width-1 last layer
// (the proposal fields') is an f32 multiply-reduce with the f32 weight and no
// rounding of dh.
//
// What bounds it here: at the proposal fields' shapes (H = 40, dims
// (80, 16, 1)) without dx a point costs ~6 kFLOP (recompute, dW, W . dh)
// against 16 bytes (x 12, g 4): about even between the H100's memory and its
// tensor cores, ~10 us for the 1.57M points of proposal round 0.
//
// What the design does about it: one pass over the points, nothing of the
// encoding or the hidden layers in device memory. Persistent blocks (several
// per SM: ~45 KB of shared memory each) keep the weights resident as bf16 and
// walk over 64-point tiles; the products are WMMA tiles (chain_bwd.cuh). The
// weight gradients of a block go into a partial that it alone owns (1.3 K
// floats, L2 resident) and a second small kernel sums the partials in block
// order, so the result does not depend on the order blocks ran in. This first
// version reads and writes the dW accumulators in L2 once per tile; keeping
// them in registers across tiles is the obvious next step.
// f32 compute (the oracle mode) runs one thread per point (chain_bwd.cuh).
#include "chain_bwd.cuh"

#define NKT_C_ROWS 64

// ---------------------------------------------------------------------------
// f32 compute
// ---------------------------------------------------------------------------

template <bool TRI>
__global__ void __launch_bounds__(NKT_TILE)
    fourier_mlp_bwd_f32_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                               int H, const float* __restrict__ wb, Chain ch, GradLayout gl,
                               const float* __restrict__ g, int need_dx, float* __restrict__ dx,
                               float* __restrict__ partials, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* base = reinterpret_cast<float*>(smem);
  F32Cols cols;
  int rows = 0;
  for (int l = 0; l <= ch.n_layers; ++l) {
    cols.c[l] = base + (size_t)rows * NKT_TILE;
    rows += ch.dims[l];
  }
  float* gpart = partials + (size_t)blockIdx.x * stride;
  nkt_zero_partial(gpart, stride);
  __syncthreads();

  const int t = threadIdx.x, L = ch.n_layers;
  const int ntiles = (n + NKT_TILE - 1) / NKT_TILE;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p = (long long)tile * NKT_TILE + t;
    const bool valid = p < n;
    const float x0 = valid ? x[p] : 0.0f, x1 = valid ? x[(size_t)n + p] : 0.0f,
                x2 = valid ? x[2 * (size_t)n + p] : 0.0f;
    __syncthreads();
    nkt_encode<TRI>(Bm, H, x0, x1, x2, cols.c[0] + t);
    for (int l = 0; l < L - 1; ++l) {
      float* out = cols.c[l + 1] + t;
      auto relu_store = [=](int o, float v) { out[o * NKT_TILE] = fmaxf(v, 0.0f); };
      nkt_dense(cols.c[l] + t, ch.dims[l], wb + ch.w_off[l], ch.dims[l + 1], wb + ch.b_off[l],
                relu_store);
    }
    for (int o = 0; o < ch.dims[L]; ++o)
      cols.c[L][o * NKT_TILE + t] = valid ? g[(size_t)o * n + p] : 0.0f;
    nkt_f32_chain_bwd(ch, gl, wb, cols, L - 1, gpart, t);
    if (need_dx && valid) {
      float d[3];
      nkt_f32_dx<TRI>(wb + ch.w_off[0], ch.dims[1], cols.c[1] + t, Bm, H, x0, x1, x2, d);
      dx[p] = d[0];
      dx[(size_t)n + p] = d[1];
      dx[2 * (size_t)n + p] = d[2];
    }
  }
}

template <bool TRI>
static int launch_f32(const float* x, int n, const float* Bm, int H, const float* wb,
                      const Chain& ch, const GradLayout& gl, const float* g, int need_dx,
                      float* dx, float* partials, int partial_rows, int stride, int* nblocks,
                      cudaStream_t stream) {
  int rows = 0;
  for (int l = 0; l <= ch.n_layers; ++l) rows += ch.dims[l];
  const size_t smem = (size_t)rows * NKT_TILE * sizeof(float);
  if (smem > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_mlp_bwd_f32_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + NKT_TILE - 1) / NKT_TILE;
  const int grid = ntiles < partial_rows ? ntiles : partial_rows;
  *nblocks = grid;
  fourier_mlp_bwd_f32_kernel<TRI><<<grid, NKT_TILE, smem, stream>>>(
      x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, stride);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute: tensor cores
// ---------------------------------------------------------------------------

// Byte offsets of the kernel's shared-memory regions.
struct CSmem {
  size_t w, b, B, x, g, scratch, db, dwl, dxp, dh, act[NKT_MAX_LAYERS], total;
};

static CSmem c_smem(const Chain& ch, const MmaChain& m, int w_elems, int b_floats, int H) {
  constexpr int RS = NKT_C_ROWS / 16;
  const int L = ch.n_layers;
  CSmem s;
  s.w = 0;
  s.b = nkt_align128(s.w + (size_t)w_elems * 2);
  s.B = nkt_align128(s.b + (size_t)b_floats * 4);
  s.x = nkt_align128(s.B + (size_t)3 * H * 4);
  s.g = nkt_align128(s.x + (size_t)3 * NKT_C_ROWS * 4);
  s.scratch = nkt_align128(s.g + (size_t)ch.dims[L] * NKT_C_ROWS * 4);
  s.db = nkt_align128(s.scratch + (size_t)NKT_MMA_WARPS * 256 * 4);
  s.dwl = nkt_align128(s.db + (size_t)RS * b_floats * 4);
  s.dxp = nkt_align128(s.dwl + (size_t)RS * m.kp[L - 1] * 4);
  s.dh = nkt_align128(s.dxp + (size_t)(m.kp[0] / 16) * NKT_C_ROWS * 3 * 4);
  size_t off = nkt_align128(s.dh + (size_t)NKT_C_ROWS * (m.np[L - 1] + 8) * 2);
  for (int l = 0; l < L; ++l) {
    s.act[l] = off;
    off = nkt_align128(off + (size_t)NKT_C_ROWS * (m.kp[l] + 8) * 2);
  }
  s.total = off;
  return s;
}

template <bool TRI>
__global__ void __launch_bounds__(NKT_MMA_THREADS)
    fourier_mlp_bwd_mma_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                               int H, const float* __restrict__ wb, Chain ch, MmaChain m,
                               GradLayout gl, CSmem S, int b_floats, const float* __restrict__ g,
                               int need_dx, float* __restrict__ dx, float* __restrict__ partials,
                               int stride) {
  constexpr int ROWS = NKT_C_ROWS, RS = ROWS / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + S.w);
  float* bs = reinterpret_cast<float*>(smem + S.b);
  float* Bs = reinterpret_cast<float*>(smem + S.B);
  float* xs = reinterpret_cast<float*>(smem + S.x);
  float* gs = reinterpret_cast<float*>(smem + S.g);
  const int warp = threadIdx.x / 32;
  float* scratch = reinterpret_cast<float*>(smem + S.scratch) + warp * 256;
  float* db_s = reinterpret_cast<float*>(smem + S.db);
  float* dwl_s = reinterpret_cast<float*>(smem + S.dwl);
  float* dxp = reinterpret_cast<float*>(smem + S.dxp);
  __nv_bfloat16* dh_top = reinterpret_cast<__nv_bfloat16*>(smem + S.dh);
  const int L = ch.n_layers, dout = ch.dims[L], din_last = ch.dims[L - 1];
  const int kp_last = m.kp[L - 1], np_last = m.np[L - 1];
  BwdActs acts;
  for (int l = 0; l < L; ++l) {
    acts.a[l] = reinterpret_cast<__nv_bfloat16*>(smem + S.act[l]);
    acts.ld[l] = m.kp[l] + 8;
  }
  float* gpart = partials + (size_t)blockIdx.x * stride;
  // this warp's slab's bias-gradient accumulators
  float* db = db_s + (warp % RS) * b_floats;
  const bool wide1 = dout == 1 && L >= 2;  // f32 multiply-reduce for the last layer

  nkt_mma_stage(ch, m, wb, ws, bs);
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) Bs[i] = Bm[i];
  for (int i = threadIdx.x; i < RS * b_floats; i += blockDim.x) db_s[i] = 0.0f;
  for (int i = threadIdx.x; i < RS * kp_last; i += blockDim.x) dwl_s[i] = 0.0f;
  nkt_zero_partial(gpart, stride);

  const int ntiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * ROWS;
    __syncthreads();
    nkt_bwd_load_rows<ROWS>(x, 3, n, p0, xs);
    nkt_bwd_load_rows<ROWS>(g, dout, n, p0, gs);
    __syncthreads();
    nkt_mma_encode<TRI, ROWS>(xs, Bs, H, m.kp[0], acts.a[0], acts.ld[0]);
    __syncthreads();
    nkt_bwd_forward<ROWS>(m, ws, bs, acts, L - 1, scratch);

    const __nv_bfloat16* dh0;
    int ld0;
    if (wide1) {
      // threads (slab, k): dW_last[k] += a[p][k] g[p]; dh = w[k] g[p] where
      // a[p][k] > 0, in f32, summed into layer L-2's bias gradient and then
      // rounded over a in place
      __nv_bfloat16* a = acts.a[L - 1];
      const int la = acts.ld[L - 1];
      for (int i = threadIdx.x; i < RS * din_last; i += blockDim.x) {
        const int slab = i / din_last, k = i % din_last;
        const float w = wb[ch.w_off[L - 1] + k];
        float dw = 0.0f, dbv = 0.0f;
        for (int r = slab * 16; r < slab * 16 + 16; ++r) {
          const float av = __bfloat162float(a[r * la + k]), gv = gs[r];
          dw = fmaf(av, gv, dw);
          const float d = av > 0.0f ? w * gv : 0.0f;
          dbv += d;
          a[r * la + k] = __float2bfloat16_rn(d);
        }
        dwl_s[slab * kp_last + k] += dw;
        db_s[slab * b_floats + m.b_s[L - 2] + k] += dbv;
      }
      if (threadIdx.x < RS) {
        float s = 0.0f;
        for (int r = threadIdx.x * 16; r < threadIdx.x * 16 + 16; ++r) s += gs[r];
        db_s[threadIdx.x * b_floats + m.b_s[L - 1]] += s;
      }
      __syncthreads();
      nkt_bwd_chain<ROWS>(m, gl, ws, acts, L - 2, a, la, gpart, db, scratch, &dh0, &ld0);
    } else {
      const int ldh = np_last + 8;
      for (int i = threadIdx.x; i < ROWS * np_last; i += blockDim.x) {
        const int r = i / np_last, o = i % np_last;
        dh_top[r * ldh + o] = __float2bfloat16_rn(o < dout ? gs[o * ROWS + r] : 0.0f);
      }
      for (int i = threadIdx.x; i < RS * dout; i += blockDim.x) {
        const int slab = i / dout, o = i % dout;
        float s = 0.0f;
        for (int r = slab * 16; r < slab * 16 + 16; ++r) s += gs[o * ROWS + r];
        db_s[slab * b_floats + m.b_s[L - 1] + o] += s;
      }
      __syncthreads();
      nkt_bwd_chain<ROWS>(m, gl, ws, acts, L - 1, dh_top, ldh, gpart, db, scratch, &dh0, &ld0);
    }
    if (need_dx) nkt_bwd_dx<ROWS, TRI>(m, ws, dh0, ld0, xs, Bs, H, scratch, dxp, dx, n, p0);
  }
  __syncthreads();
  nkt_bwd_flush_bias<ROWS>(m, gl, db_s, b_floats, gpart);
  if (wide1)
    for (int k = threadIdx.x; k < din_last; k += blockDim.x) {
      float s = 0.0f;
      for (int r = 0; r < RS; ++r) s += dwl_s[r * kp_last + k];
      gpart[gl.w[L - 1] + k * np_last] = s;
    }
}

template <bool TRI>
static int launch_mma(const float* x, int n, const float* Bm, int H, const float* wb,
                      const Chain& ch, const GradLayout& gl, const float* g, int need_dx,
                      float* dx, float* partials, int partial_rows, int stride, int* nblocks,
                      cudaStream_t stream) {
  MmaChain m;
  int w_elems = 0, b_floats = 0;
  const int widest = nkt_mma_chain(ch, &m, &w_elems, &b_floats);
  if (widest < 0) return widest;
  const CSmem S = c_smem(ch, m, w_elems, b_floats, H);
  if (S.total > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_mlp_bwd_mma_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fourier_mlp_bwd_mma_kernel<TRI>, NKT_MMA_THREADS, S.total)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return NKT_ERR_SMEM;
  const int ntiles = (n + NKT_C_ROWS - 1) / NKT_C_ROWS;
  int grid = sms * per_sm;
  if (grid > ntiles) grid = ntiles;
  if (grid > partial_rows) grid = partial_rows;
  *nblocks = grid;
  fourier_mlp_bwd_mma_kernel<TRI><<<grid, NKT_MMA_THREADS, S.total, stream>>>(
      x, n, Bm, H, wb, ch, m, gl, S, b_floats, g, need_dx, dx, partials, stride);
  return (int)cudaGetLastError();
}

// x (3, n), Bm (3, H), wb the packed chain with f32 (unrounded) weights, g
// (dims[n_layers], n), all f32 and contiguous on the device. dx (3, n) is
// written when need_dx (it may be null otherwise). partials is scratch of
// partial_rows x partial_stride floats, partial_stride being the padded size
// of one block's weight gradients (sum over layers of pad16(in) * pad16(out) +
// pad16(out)). dwb receives the gradients in wb's packed layout (the padding
// between parts is left as it was). Launches on `stream`, does not
// synchronise; returns the launch error (0 on success).
extern "C" int nkt_fourier_mlp_bwd(const float* x, int n, const float* Bm, int H, const float* wb,
                                   int wb_floats, const int* dims, int n_layers, int tri, int bf16,
                                   int need_dx, const float* g, float* dx, float* partials,
                                   int partial_rows, int partial_stride, float* dwb,
                                   void* stream) {
  Chain ch;
  const int packed = nkt_chain_from_dims(&ch, dims, n_layers);
  if (packed < 0) return packed;
  GradLayout gl;
  int stride = 0;
  nkt_grad_layout(ch, &gl, &stride);
  if (packed != wb_floats || dims[0] != 2 * H || stride != partial_stride || partial_rows < 1)
    return NKT_ERR_PACKING;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(dwb, 0, (size_t)wb_floats * sizeof(float), s);
    return (int)err;
  }
  int nblocks = 0, rc;
  if (bf16)
    rc = tri ? launch_mma<true>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                stride, &nblocks, s)
             : launch_mma<false>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                 stride, &nblocks, s);
  else
    rc = tri ? launch_f32<true>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                stride, &nblocks, s)
             : launch_f32<false>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                 stride, &nblocks, s);
  if (rc != 0) return rc;
  return nkt_launch_reduce(partials, nblocks, stride, ch, gl, dwb, s);
}
