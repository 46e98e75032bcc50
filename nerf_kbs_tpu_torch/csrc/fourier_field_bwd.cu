// Backward fully fused nerfacto field for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_field_bwd_body` (with `_chain_bwd`) of
// nerf_kbs_tpu/ops/fused_field.py (pallas_call in `_field_bwd`, the VJP of the
// public `fourier_field_mlp`). From x (3, N), feats (F, N), B (3, H), both
// chains' weights and g (4, N), the gradient of [sigma_raw; rgb], it
// recomputes the forward per tile and gives
//   d_rgb_pre = g[1:] * rgb * (1 - rgb), backward through the rgb chain,
//   dfeats = d_rgb_in[G:] (F, N), d_base_out = [g[0]; d_rgb_in[:G]],
//   backward through the base chain, dW / db of both chains summed over all
//   points, and dx (3, N) when need_dx.
// Rounding follows the Pallas bodies (see chain_bwd.cuh). Without need_dx the
// product W_0 . dh of the base chain is skipped: nothing reads it.
//
// What bounds it here: at nerfacto-tpu widths (H = 128, base (256, 128, 128,
// 16), rgb (31, 64, 64, 3), F = 16) a point costs ~115 kFLOP of recompute,
// ~115 kFLOP of dW products and ~50 kFLOP of W . dh (~115 k with dx) against
// 156 bytes (x 12, feats 64, g 16, dfeats 64): ~1800 FLOP/byte, so the bound
// is the arithmetic, ~0.22 ms for the 786,432 points of a 16,384-ray step at
// 989 TFLOP/s.
//
// What the design does about it, and what it costs: one persistent block per
// SM keeps all 57,472 weights resident as bf16 (~128 KB) and walks over
// 32-point tiles (64 do not fit: the backward keeps every layer's input of
// the tile, ~46 KB at 32 points). Every product is a WMMA tile product
// (chain_bwd.cuh). The weight gradients (58 K floats, 234 KB per block) fit
// neither in shared memory beside the weights nor in registers, so each
// block adds one tile's act^T . dh at a time into its own partial in device
// memory (132 x 234 KB = 31 MB, inside the 50 MB L2): that is a read and a
// write of 234 KB through L2 for every 32 points, about 11 GB of L2 traffic
// for 786,432 points, and it is expected to cost more than the arithmetic.
// A second small kernel sums the partials in block order: no float atomics,
// and a repeat of the launch gives the same bits.
// f32 compute (the oracle mode) runs one thread per point (chain_bwd.cuh).
#include "chain_bwd.cuh"

#define NKT_D_ROWS 32

// ---------------------------------------------------------------------------
// f32 compute
// ---------------------------------------------------------------------------

template <bool TRI>
__global__ void __launch_bounds__(NKT_TILE)
    fourier_field_bwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                                 int n, int F, const float* __restrict__ Bm, int H,
                                 const float* __restrict__ base_wb, Chain base, GradLayout glb,
                                 const float* __restrict__ rgb_wb, Chain rgb, GradLayout glr,
                                 const float* __restrict__ g, int need_dx, float* __restrict__ dx,
                                 float* __restrict__ dfeats, float* __restrict__ partials,
                                 int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* smem_f = reinterpret_cast<float*>(smem);
  F32Cols cb, cr;
  int rows = 0;
  for (int l = 0; l <= base.n_layers; ++l) {
    cb.c[l] = smem_f + (size_t)rows * NKT_TILE;
    rows += base.dims[l];
  }
  for (int l = 0; l <= rgb.n_layers; ++l) {
    cr.c[l] = smem_f + (size_t)rows * NKT_TILE;
    rows += rgb.dims[l];
  }
  float* gpart = partials + (size_t)blockIdx.x * stride;
  nkt_zero_partial(gpart, stride);
  __syncthreads();

  const int t = threadIdx.x, Lb = base.n_layers, Lr = rgb.n_layers;
  const int G = base.dims[Lb] - 1;
  const int ntiles = (n + NKT_TILE - 1) / NKT_TILE;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p = (long long)tile * NKT_TILE + t;
    const bool valid = p < n;
    const float x0 = valid ? x[p] : 0.0f, x1 = valid ? x[(size_t)n + p] : 0.0f,
                x2 = valid ? x[2 * (size_t)n + p] : 0.0f;
    __syncthreads();
    // forward, keeping every layer's input
    nkt_encode<TRI>(Bm, H, x0, x1, x2, cb.c[0] + t);
    for (int l = 0; l < Lb - 1; ++l) {
      float* out = cb.c[l + 1] + t;
      auto relu_store = [=](int o, float v) { out[o * NKT_TILE] = fmaxf(v, 0.0f); };
      nkt_dense(cb.c[l] + t, base.dims[l], base_wb + base.w_off[l], base.dims[l + 1],
                base_wb + base.b_off[l], relu_store);
    }
    float* rgb_in = cr.c[0] + t;
    {
      const int l = Lb - 1;
      auto geo_store = [=](int o, float v) {
        if (o > 0) rgb_in[(o - 1) * NKT_TILE] = v;
      };
      nkt_dense(cb.c[l] + t, base.dims[l], base_wb + base.w_off[l], base.dims[l + 1],
                base_wb + base.b_off[l], geo_store);
    }
    for (int f = 0; f < F; ++f)
      rgb_in[(G + f) * NKT_TILE] = valid ? feats[(size_t)f * n + p] : 0.0f;
    for (int l = 0; l < Lr - 1; ++l) {
      float* out = cr.c[l + 1] + t;
      auto relu_store = [=](int o, float v) { out[o * NKT_TILE] = fmaxf(v, 0.0f); };
      nkt_dense(cr.c[l] + t, rgb.dims[l], rgb_wb + rgb.w_off[l], rgb.dims[l + 1],
                rgb_wb + rgb.b_off[l], relu_store);
    }
    {
      // d_rgb_pre = g[1:] * rgb * (1 - rgb)
      const int l = Lr - 1;
      float* d_pre = cr.c[Lr] + t;
      auto sigmoid_grad = [=](int o, float v) {
        const float s = 1.0f / (1.0f + expf(-v));
        const float go = valid ? g[(size_t)(1 + o) * n + p] : 0.0f;
        d_pre[o * NKT_TILE] = go * s * (1.0f - s);
      };
      nkt_dense(cr.c[l] + t, rgb.dims[l], rgb_wb + rgb.w_off[l], rgb.dims[l + 1],
                rgb_wb + rgb.b_off[l], sigmoid_grad);
    }
    nkt_f32_chain_bwd(rgb, glr, rgb_wb, cr, Lr - 1, gpart, t);
    // d_rgb_in = W_r0 . dh_r0: rows [0, G) feed the base chain, the rest is dfeats
    {
      const int d1 = rgb.dims[1];
      float* d_base_out = cb.c[Lb] + t;
      d_base_out[0] = valid ? g[p] : 0.0f;
      for (int k = 0; k < G + F; ++k) {
        const float v = nkt_f32_wdh(rgb_wb + rgb.w_off[0] + (size_t)k * d1, cr.c[1] + t, d1);
        if (k < G)
          d_base_out[(1 + k) * NKT_TILE] = v;
        else if (valid)
          dfeats[(size_t)(k - G) * n + p] = v;
      }
    }
    nkt_f32_chain_bwd(base, glb, base_wb, cb, Lb - 1, gpart, t);
    if (need_dx && valid) {
      float d[3];
      nkt_f32_dx<TRI>(base_wb + base.w_off[0], base.dims[1], cb.c[1] + t, Bm, H, x0, x1, x2, d);
      dx[p] = d[0];
      dx[(size_t)n + p] = d[1];
      dx[2 * (size_t)n + p] = d[2];
    }
  }
}

template <bool TRI>
static int launch_f32(const float* x, const float* feats, int n, int F, const float* Bm, int H,
                      const float* base_wb, const Chain& base, const GradLayout& glb,
                      const float* rgb_wb, const Chain& rgb, const GradLayout& glr, const float* g,
                      int need_dx, float* dx, float* dfeats, float* partials, int partial_rows,
                      int stride, int* nblocks, cudaStream_t stream) {
  int rows = 0;
  for (int l = 0; l <= base.n_layers; ++l) rows += base.dims[l];
  for (int l = 0; l <= rgb.n_layers; ++l) rows += rgb.dims[l];
  const size_t smem = (size_t)rows * NKT_TILE * sizeof(float);
  if (smem > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_field_bwd_f32_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + NKT_TILE - 1) / NKT_TILE;
  const int grid = ntiles < partial_rows ? ntiles : partial_rows;
  *nblocks = grid;
  fourier_field_bwd_f32_kernel<TRI><<<grid, NKT_TILE, smem, stream>>>(
      x, feats, n, F, Bm, H, base_wb, base, glb, rgb_wb, rgb, glr, g, need_dx, dx, dfeats,
      partials, stride);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute: tensor cores
// ---------------------------------------------------------------------------

// Byte offsets of the kernel's shared-memory regions.
struct DSmem {
  size_t w, b, B, x, g, scratch, db, dxp, dh_r, dh_b, dbo, act_b[NKT_MAX_LAYERS],
      act_r[NKT_MAX_LAYERS], total;
};

static DSmem d_smem(const MmaChain& mb, const MmaChain& mr, int w_elems, int b_floats, int H) {
  constexpr int ROWS = NKT_D_ROWS, RS = ROWS / 16;
  const int Lb = mb.n_layers, Lr = mr.n_layers;
  DSmem s;
  s.w = 0;
  s.b = nkt_align128(s.w + (size_t)w_elems * 2);
  s.B = nkt_align128(s.b + (size_t)b_floats * 4);
  s.x = nkt_align128(s.B + (size_t)3 * H * 4);
  s.g = nkt_align128(s.x + (size_t)3 * ROWS * 4);
  s.scratch = nkt_align128(s.g + (size_t)4 * ROWS * 4);
  s.db = nkt_align128(s.scratch + (size_t)NKT_MMA_WARPS * 256 * 4);
  s.dxp = nkt_align128(s.db + (size_t)RS * b_floats * 4);
  s.dh_r = nkt_align128(s.dxp + (size_t)(mb.kp[0] / 16) * ROWS * 3 * 4);
  s.dh_b = nkt_align128(s.dh_r + (size_t)ROWS * (mr.np[Lr - 1] + 8) * 2);
  s.dbo = nkt_align128(s.dh_b + (size_t)ROWS * (mb.np[Lb - 1] + 8) * 2);
  size_t off = nkt_align128(s.dbo + (size_t)ROWS * mb.np[Lb - 1] * 4);
  for (int l = 0; l < Lb; ++l) {
    s.act_b[l] = off;
    off = nkt_align128(off + (size_t)ROWS * (mb.kp[l] + 8) * 2);
  }
  for (int l = 0; l < Lr; ++l) {
    s.act_r[l] = off;
    off = nkt_align128(off + (size_t)ROWS * (mr.kp[l] + 8) * 2);
  }
  s.total = off;
  return s;
}

template <bool TRI>
__global__ void __launch_bounds__(NKT_MMA_THREADS, 1)
    fourier_field_bwd_mma_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                                 int n, int F, const float* __restrict__ Bm, int H,
                                 const float* __restrict__ base_wb, Chain base, MmaChain mb,
                                 GradLayout glb, const float* __restrict__ rgb_wb, Chain rgb,
                                 MmaChain mr, GradLayout glr, DSmem S, int b_floats,
                                 const float* __restrict__ g, int need_dx, float* __restrict__ dx,
                                 float* __restrict__ dfeats, float* __restrict__ partials,
                                 int stride) {
  constexpr int ROWS = NKT_D_ROWS, RS = ROWS / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + S.w);
  float* bs = reinterpret_cast<float*>(smem + S.b);
  float* Bs = reinterpret_cast<float*>(smem + S.B);
  float* xs = reinterpret_cast<float*>(smem + S.x);
  float* gs = reinterpret_cast<float*>(smem + S.g);
  const int warp = threadIdx.x / 32;
  float* scratch = reinterpret_cast<float*>(smem + S.scratch) + warp * 256;
  float* db_s = reinterpret_cast<float*>(smem + S.db);
  float* dxp = reinterpret_cast<float*>(smem + S.dxp);
  __nv_bfloat16* dh_r = reinterpret_cast<__nv_bfloat16*>(smem + S.dh_r);
  __nv_bfloat16* dh_b = reinterpret_cast<__nv_bfloat16*>(smem + S.dh_b);
  float* dbo = reinterpret_cast<float*>(smem + S.dbo);
  const int Lb = base.n_layers, Lr = rgb.n_layers;
  const int G = base.dims[Lb] - 1;
  const int npb = mb.np[Lb - 1], ldhb = npb + 8, ldhr = mr.np[Lr - 1] + 8;
  BwdActs ab, ar;
  for (int l = 0; l < Lb; ++l) {
    ab.a[l] = reinterpret_cast<__nv_bfloat16*>(smem + S.act_b[l]);
    ab.ld[l] = mb.kp[l] + 8;
  }
  for (int l = 0; l < Lr; ++l) {
    ar.a[l] = reinterpret_cast<__nv_bfloat16*>(smem + S.act_r[l]);
    ar.ld[l] = mr.kp[l] + 8;
  }
  float* gpart = partials + (size_t)blockIdx.x * stride;
  float* db = db_s + (warp % RS) * b_floats;  // this warp's slab's accumulators

  nkt_mma_stage(base, mb, base_wb, ws, bs);
  nkt_mma_stage(rgb, mr, rgb_wb, ws, bs);
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) Bs[i] = Bm[i];
  for (int i = threadIdx.x; i < RS * b_floats; i += blockDim.x) db_s[i] = 0.0f;
  nkt_zero_partial(gpart, stride);

  const int ntiles = (n + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * ROWS;
    __syncthreads();
    nkt_bwd_load_rows<ROWS>(x, 3, n, p0, xs);
    nkt_bwd_load_rows<ROWS>(g, 4, n, p0, gs);
    __syncthreads();
    nkt_mma_encode<TRI, ROWS>(xs, Bs, H, mb.kp[0], ab.a[0], ab.ld[0]);
    __syncthreads();

    // ---- forward, keeping every layer's input
    nkt_bwd_forward<ROWS>(mb, ws, bs, ab, Lb - 1, scratch);
    __nv_bfloat16* rgb_in = ar.a[0];
    const int ldri = ar.ld[0];
    {
      const int l = Lb - 1;
      const float* bias = bs + mb.b_s[l];
      auto geo_store = [=](int row, int o, float v) {
        if (o >= 1 && o <= G) rgb_in[row * ldri + o - 1] = __float2bfloat16_rn(v + bias[o]);
        return 0.0f;
      };
      nkt_bwd_gemm<ROWS, false>(ab.a[l], ab.ld[l], ws + mb.w_s[l], mb.np[l] + 8, mb.kp[l],
                                mb.np[l], scratch, nullptr, geo_store);
      for (int i = threadIdx.x; i < ROWS * (mr.kp[0] - G); i += blockDim.x) {
        const int r = i % ROWS, f = i / ROWS;
        const float v = (f < F && p0 + r < n) ? feats[(size_t)f * n + p0 + r] : 0.0f;
        rgb_in[r * ldri + G + f] = __float2bfloat16_rn(v);
      }
      __syncthreads();
    }
    nkt_bwd_forward<ROWS>(mr, ws, bs, ar, Lr - 1, scratch);
    {
      // last rgb layer: d_rgb_pre = g[1:] * rgb * (1 - rgb), its f32 values
      // summed into the layer's bias gradient
      const int l = Lr - 1;
      const float* bias = bs + mr.b_s[l];
      auto sigmoid_grad = [=](int row, int o, float v) {
        float d = 0.0f;
        if (o < 3) {
          const float s = 1.0f / (1.0f + expf(-(v + bias[o])));
          d = gs[(1 + o) * ROWS + row] * s * (1.0f - s);
        }
        dh_r[row * ldhr + o] = __float2bfloat16_rn(d);
        return d;
      };
      nkt_bwd_gemm<ROWS, false>(ar.a[l], ar.ld[l], ws + mr.w_s[l], mr.np[l] + 8, mr.kp[l],
                                mr.np[l], scratch, db + mr.b_s[l], sigmoid_grad);
      __syncthreads();
    }

    // ---- rgb chain backward
    const __nv_bfloat16* dh0;
    int ld0;
    nkt_bwd_chain<ROWS>(mr, glr, ws, ar, Lr - 1, dh_r, ldhr, gpart, db, scratch, &dh0, &ld0);
    {
      // d_rgb_in = dh_r0 . W_r0^T: columns [0, G) go to d_base_out[1:], the
      // next F are dfeats (stored feature-major, so the tile is walked
      // row-fastest)
      auto split_store = [=](int row, int k, float v) {
        if (k < G) {
          dbo[row * npb + 1 + k] = v;
          dh_b[row * ldhb + 1 + k] = __float2bfloat16_rn(v);
        } else if (k - G < F && p0 + row < n) {
          dfeats[(size_t)(k - G) * n + p0 + row] = v;
        }
        return 0.0f;
      };
      nkt_bwd_gemm<ROWS, true, true>(dh0, ld0, ws + mr.w_s[0], mr.np[0] + 8, mr.np[0], mr.kp[0],
                                     scratch, nullptr, split_store);
      // d_base_out[0] = g[0]; columns past 1 + G are padding
      for (int i = threadIdx.x; i < ROWS * (npb - G); i += blockDim.x) {
        const int r = i % ROWS, j = i / ROWS;
        const int o = j == 0 ? 0 : G + j;
        const float v = j == 0 ? gs[r] : 0.0f;
        dbo[r * npb + o] = v;
        dh_b[r * ldhb + o] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      // bias gradient of the last base layer: f32 column sums per slab
      for (int i = threadIdx.x; i < RS * npb; i += blockDim.x) {
        const int slab = i / npb, o = i % npb;
        float s = 0.0f;
        for (int r = slab * 16; r < slab * 16 + 16; ++r) s += dbo[r * npb + o];
        db_s[slab * b_floats + mb.b_s[Lb - 1] + o] += s;
      }
    }

    // ---- base chain backward
    nkt_bwd_chain<ROWS>(mb, glb, ws, ab, Lb - 1, dh_b, ldhb, gpart, db, scratch, &dh0, &ld0);
    if (need_dx) nkt_bwd_dx<ROWS, TRI>(mb, ws, dh0, ld0, xs, Bs, H, scratch, dxp, dx, n, p0);
  }
  __syncthreads();
  nkt_bwd_flush_bias<ROWS>(mb, glb, db_s, b_floats, gpart);
  nkt_bwd_flush_bias<ROWS>(mr, glr, db_s, b_floats, gpart);
}

template <bool TRI>
static int launch_mma(const float* x, const float* feats, int n, int F, const float* Bm, int H,
                      const float* base_wb, const Chain& base, const GradLayout& glb,
                      const float* rgb_wb, const Chain& rgb, const GradLayout& glr, const float* g,
                      int need_dx, float* dx, float* dfeats, float* partials, int partial_rows,
                      int stride, int* nblocks, cudaStream_t stream) {
  MmaChain mb, mr;
  int w_elems = 0, b_floats = 0;
  const int wb = nkt_mma_chain(base, &mb, &w_elems, &b_floats);
  if (wb < 0) return wb;
  const int wr = nkt_mma_chain(rgb, &mr, &w_elems, &b_floats);
  if (wr < 0) return wr;
  const DSmem S = d_smem(mb, mr, w_elems, b_floats, H);
  if (S.total > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_field_bwd_mma_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ntiles = (n + NKT_D_ROWS - 1) / NKT_D_ROWS;
  int grid = sms;
  if (grid > ntiles) grid = ntiles;
  if (grid > partial_rows) grid = partial_rows;
  *nblocks = grid;
  fourier_field_bwd_mma_kernel<TRI><<<grid, NKT_MMA_THREADS, S.total, stream>>>(
      x, feats, n, F, Bm, H, base_wb, base, mb, glb, rgb_wb, rgb, mr, glr, S, b_floats, g,
      need_dx, dx, dfeats, partials, stride);
  return (int)cudaGetLastError();
}

// x (3, n), feats (F, n), Bm (3, H), base_wb / rgb_wb the packed chains with
// f32 (unrounded) weights, g (4, n), all f32 and contiguous on the device.
// dfeats (F, n) is always written; dx (3, n) when need_dx (it may be null
// otherwise). partials is scratch of partial_rows x partial_stride floats,
// partial_stride being the padded size of one block's weight gradients (over
// the layers of both chains, pad16(in) * pad16(out) + pad16(out)). d_base_wb
// and d_rgb_wb receive the gradients in the packed layouts of base_wb and
// rgb_wb. Launches on `stream`, does not synchronise; returns the launch
// error (0 on success).
extern "C" int nkt_fourier_field_bwd(const float* x, const float* feats, int n, int F,
                                     const float* Bm, int H, const float* base_wb,
                                     int base_floats, const int* base_dims, int n_base,
                                     const float* rgb_wb, int rgb_floats, const int* rgb_dims,
                                     int n_rgb, int tri, int bf16, int need_dx, const float* g,
                                     float* dx, float* dfeats, float* partials, int partial_rows,
                                     int partial_stride, float* d_base_wb, float* d_rgb_wb,
                                     void* stream) {
  Chain base, rgb;
  const int pb = nkt_chain_from_dims(&base, base_dims, n_base);
  if (pb < 0) return pb;
  const int pr = nkt_chain_from_dims(&rgb, rgb_dims, n_rgb);
  if (pr < 0) return pr;
  GradLayout glb, glr;
  int stride = 0;
  nkt_grad_layout(base, &glb, &stride);
  nkt_grad_layout(rgb, &glr, &stride);
  if (pb != base_floats || pr != rgb_floats || base_dims[0] != 2 * H ||
      rgb_dims[0] != base_dims[n_base] - 1 + F || rgb_dims[n_rgb] != 3 ||
      stride != partial_stride || partial_rows < 1)
    return NKT_ERR_PACKING;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(d_base_wb, 0, (size_t)base_floats * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(d_rgb_wb, 0, (size_t)rgb_floats * sizeof(float), s);
  }
  int nblocks = 0, rc;
#define NKT_ARGS                                                                              \
  x, feats, n, F, Bm, H, base_wb, base, glb, rgb_wb, rgb, glr, g, need_dx, dx, dfeats, partials, \
      partial_rows, stride, &nblocks, s
  if (bf16)
    rc = tri ? launch_mma<true>(NKT_ARGS) : launch_mma<false>(NKT_ARGS);
  else
    rc = tri ? launch_f32<true>(NKT_ARGS) : launch_f32<false>(NKT_ARGS);
#undef NKT_ARGS
  if (rc != 0) return rc;
  rc = nkt_launch_reduce(partials, nblocks, stride, base, glb, d_base_wb, s);
  if (rc != 0) return rc;
  return nkt_launch_reduce(partials, nblocks, stride, rgb, glr, d_rgb_wb, s);
}
