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
// What the design does about it. Three bodies; in all of them each block
// leaves its weight-gradient sums in a partial of its own and a last small
// kernel sums the partials in block order: no float atomics, and a repeat of
// the launch gives the same bits.
// - bf16 at the flagship widths, two passes on wgmma (wgmma_chain.cuh,
//   wgmma_bwd.cuh).
//   The per-point pass (fourier_field_bwd_wgmma_kernel): persistent blocks of
//   two warpgroups, each on its own 64-point tile with no block barrier and
//   the weights resident as in the forward kernel. It recomputes the forward
//   and walks both chains backwards with every activation and gradient in
//   registers: a W . dh product reads the resident W^T with the trans flag,
//   its accumulator has the layout of the forward accumulator, so the relu
//   mask is a bit per register kept from the forward, and masked, rounded and
//   packed it is the next product's A operand. Bias gradients are f32 column
//   sums by a shuffle butterfly into a few registers a thread keeps over all
//   its tiles. Every layer's input and pre-activation gradient goes out once
//   as a bf16 tile in the core layout (a warp's store is 128 contiguous
//   bytes), 1,664 bytes a point. The weight-gradient passes
//   (nkt_field_dw_kernel per layer, nkt_field_dw0_kernel for the first
//   layer, which recomputes the encoding instead of reading it) are split-K
//   products over points: each block takes a contiguous range of tiles,
//   reads act and dh tiles as trans operands, keeps the f32 dW accumulator in
//   registers over its whole range and writes it once. All six layers go this
//   way rather than the small ones accumulating in the per-point pass: one
//   product routine, and registers there are taken by the chain.
//   What limits it now: the per-point pass, by the same ALU work as the
//   forward plus the bias-sum shuffles and the scratch stores; the
//   weight-gradient passes move the scratch (2 x 1.3 GB at 786,432 points)
//   and run one block per SM with one tile in flight.
// - bf16 at any other widths (fourier_field_bwd_mma_kernel, chain_bwd.cuh):
//   one block per SM on 32-point WMMA tiles; each tile's act^T . dh is added
//   into the block's 234 KB partial in device memory, a round trip through L2
//   per tile that takes half its time.
// - f32 compute (the oracle mode): one thread per point (chain_bwd.cuh).
#include "wgmma_bwd.cuh"

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
  const int sms = NKT_BWD_GRID_SMS;
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

// ---------------------------------------------------------------------------
// bf16 compute at the flagship widths: wgmma (see wgmma_chain.cuh)
// ---------------------------------------------------------------------------

#define NKT_D_WARPGROUPS 2

// Per-point widths (bf16 values) of what the per-point pass leaves for the
// weight-gradient pass, as running sums: array `a` of the scratch tensor
// starts at a * 64 * ntiles elements and holds one [point][feature] tile in
// the core layout (64 * width elements) per 64 points.
template <int KR>
struct FieldScratch {
  // layer inputs: h1, h2 (base hidden), ri (the rgb chain's input), r1, r2
  static constexpr int h1 = 0, h2 = 128, ri = 256, r1 = 256 + KR, r2 = r1 + 64;
  // gradients of the pre-activations of base layers 0..2 and rgb layers 0..2
  static constexpr int d_b0 = r2 + 64, d_b1 = d_b0 + 128, d_b2 = d_b1 + 128, d_r0 = d_b2 + 16,
                       d_r1 = d_r0 + 64, d_r2 = d_r1 + 64, total = d_r2 + 16;
};

// The per-point pass. Each warpgroup walks its own 64-point tiles: forward
// through both chains (as the forward kernel), then backward, every
// activation and gradient staying in registers between products. It writes
// dfeats, dx (NEED_DX), every layer's input and pre-activation gradient as
// bf16 tiles into `scratch` for the weight-gradient pass, and the block's
// bias gradients (f32 sums) into its partial.
template <bool TRI, int KR, bool NEED_DX>
__global__ void __launch_bounds__(NKT_D_WARPGROUPS * NKT_WG_THREADS, 1)
    fourier_field_bwd_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                                   int n, const float* __restrict__ Bm,
                                   const uint4* __restrict__ image,
                                   const float* __restrict__ base_wb, Chain base, GradLayout glb,
                                   const float* __restrict__ rgb_wb, Chain rgb, GradLayout glr,
                                   const float* __restrict__ g, float* __restrict__ dx,
                                   float* __restrict__ dfeats, uint32_t* __restrict__ scratch,
                                   float* __restrict__ partials, int stride) {
  using I = FieldImage<KR>;
  using S = FieldScratch<KR>;
  constexpr int FSTEPS = KR / 16 - 1, F = 16 * FSTEPS;
  extern __shared__ __align__(128) unsigned char smem[];
  nkt_field_stage<KR>(smem, image, base_wb, base, rgb_wb, rgb, Bm);
  nkt_fence_async_smem();
  __syncthreads();
  const uint32_t ws = nkt_smem_addr(smem);
  const float* bs = reinterpret_cast<const float*>(smem + I::bytes);
  const float* Bs = bs + I::bias_floats;
  const WgLane L = nkt_wg_lane();
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / NKT_WG_THREADS;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;

  // bias-gradient sums over all of this thread's tiles
  float db_b0[nkt_db_count(64)] = {}, db_b1[nkt_db_count(64)] = {}, db_b2[nkt_db_count(8)] = {};
  float db_r0[nkt_db_count(32)] = {}, db_r1[nkt_db_count(32)] = {}, db_r2[nkt_db_count(8)] = {};

  for (int tile = blockIdx.x * NKT_D_WARPGROUPS + wg; tile < ntiles;
       tile += gridDim.x * NKT_D_WARPGROUPS) {
    const long long pa = (long long)tile * NKT_WG_ROWS + 16 * L.w + L.g, pb = pa + 8;
    float xa[3], xb[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      xa[d] = pa < n ? x[(size_t)d * n + pa] : 0.0f;
      xb[d] = pb < n ? x[(size_t)d * n + pb] : 0.0f;
    }
    uint32_t rgb_in[4 * (1 + FSTEPS)];
    {
      uint32_t fe[4 * FSTEPS];
      nkt_wg_load_feats<FSTEPS>(feats, n, pa, pb, L.t, fe);
#pragma unroll
      for (int i = 0; i < 4 * FSTEPS; ++i) rgb_in[4 + i] = fe[i];
    }

    // ---- forward, keeping the relu masks and writing every layer's input
    uint32_t m_h1[2], m_h2[2], m_r1[1], m_r2[1];
    uint32_t h[32];
    {
      float acc[64];
      nkt_wg_first_layer<TRI, I::H>(acc, Bs, L.t, xa, xb, ws + I::w_b0);
      nkt_wg_relu_pack<true>(acc, bs + I::b_b0, L.t, h, m_h1);
      nkt_wg_store_tile<128>(scratch, S::h1, ntiles, tile, L, h);
      nkt_wg_forward<8>(acc, h, ws + I::w_b1);
      nkt_wg_relu_pack<true>(acc, bs + I::b_b1, L.t, h, m_h2);
      nkt_wg_store_tile<128>(scratch, S::h2, ntiles, tile, L, h);
    }
    {
      float acc[8];
      nkt_wg_forward<8>(acc, h, ws + I::w_b2);
      float sigma_a, sigma_b;  // the output gradient needs no sigma_raw
      nkt_wg_base_out(acc, bs + I::b_b2, L.t, rgb_in, &sigma_a, &sigma_b);
      nkt_wg_store_tile<KR>(scratch, S::ri, ntiles, tile, L, rgb_in);
    }
    uint32_t r[16];
    uint32_t d16[4];  // a 16-wide gradient as one k-step
    {
      float acc[32];
      nkt_wg_forward<KR / 16>(acc, rgb_in, ws + I::w_r0);
      nkt_wg_relu_pack<true>(acc, bs + I::b_r0, L.t, r, m_r1);
      nkt_wg_store_tile<64>(scratch, S::r1, ntiles, tile, L, r);
      nkt_wg_forward<4>(acc, r, ws + I::w_r1);
      nkt_wg_relu_pack<true>(acc, bs + I::b_r1, L.t, r, m_r2);
      nkt_wg_store_tile<64>(scratch, S::r2, ntiles, tile, L, r);
    }
    {
      // d_rgb_pre = g[1:] * rgb * (1 - rgb) in columns 0..2, zeros beyond
      float acc[8];
      nkt_wg_forward<4>(acc, r, ws + I::w_r2);
      const float2 b = *reinterpret_cast<const float2*>(bs + I::b_r2 + 2 * (L.t % 2));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * (i / 4) + 2 * L.t + i % 2;
        const long long p = (i % 4) < 2 ? pa : pb;
        float d = 0.0f;
        if (c < 3) {
          const float s = 1.0f / (1.0f + expf(-(acc[i] + (i % 2 ? b.y : b.x))));
          const float go = p < n ? g[(size_t)(1 + c) * n + p] : 0.0f;
          d = go * s * (1.0f - s);
        }
        acc[i] = d;
      }
      nkt_wg_colsum(acc, lane, db_r2);
      d16[0] = nkt_pack_bf16(acc[0], acc[1]);
      d16[1] = nkt_pack_bf16(acc[2], acc[3]);
      d16[2] = nkt_pack_bf16(acc[4], acc[5]);
      d16[3] = nkt_pack_bf16(acc[6], acc[7]);
      nkt_wg_store_tile<16>(scratch, S::d_r2, ntiles, tile, L, d16);
    }

    // ---- backward through the rgb chain
    {
      float acc[32];
      nkt_wg_backward<1>(acc, d16, ws + I::w_r2, 16, 0);
      nkt_wg_dh(acc, m_r2, lane, db_r1, r);
      nkt_wg_store_tile<64>(scratch, S::d_r1, ntiles, tile, L, r);
      nkt_wg_backward<4>(acc, r, ws + I::w_r1, 64, 0);
      nkt_wg_dh(acc, m_r1, lane, db_r0, r);
      nkt_wg_store_tile<64>(scratch, S::d_r0, ntiles, tile, L, r);
    }
    {
      // d_rgb_in = dh_r0 . W_r0^T: column 0 is sigma_raw's place and takes
      // g[0], columns 1..15 are geo (together the base chain's output
      // gradient), the rest dfeats
      float acc[KR / 2];
      nkt_wg_backward<4>(acc, r, ws + I::w_r0, 64, 0);
      if (L.t == 0) {
        acc[0] = pa < n ? g[pa] : 0.0f;
        acc[2] = pb < n ? g[pb] : 0.0f;
      }
#pragma unroll
      for (int i = 8; i < KR / 2; ++i) {
        const int f = 8 * (i / 4) + 2 * L.t + i % 2 - 16;
        const long long p = (i % 4) < 2 ? pa : pb;
        if (f < F && p < n) dfeats[(size_t)f * n + p] = acc[i];
      }
      float dbo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) dbo[i] = acc[i];
      nkt_wg_colsum(dbo, lane, db_b2);
      d16[0] = nkt_pack_bf16(dbo[0], dbo[1]);
      d16[1] = nkt_pack_bf16(dbo[2], dbo[3]);
      d16[2] = nkt_pack_bf16(dbo[4], dbo[5]);
      d16[3] = nkt_pack_bf16(dbo[6], dbo[7]);
      nkt_wg_store_tile<16>(scratch, S::d_b2, ntiles, tile, L, d16);
    }

    // ---- backward through the base chain
    {
      float acc[64];
      nkt_wg_backward<1>(acc, d16, ws + I::w_b2, 16, 0);
      nkt_wg_dh(acc, m_h2, lane, db_b1, h);
      nkt_wg_store_tile<128>(scratch, S::d_b1, ntiles, tile, L, h);
      nkt_wg_backward<8>(acc, h, ws + I::w_b1, 128, 0);
      nkt_wg_dh(acc, m_h1, lane, db_b0, h);
      nkt_wg_store_tile<128>(scratch, S::d_b0, ntiles, tile, L, h);
      if (NEED_DX) nkt_wg_base_dx<TRI>(acc, h, ws + I::w_b0, Bs, L, xa, xb, pa, pb, n, dx);
    }
  }

  // ---- the block's bias gradients: every warp's sums side by side in shared
  // memory (over the weights, which nothing reads any more), then summed over
  // warps in order
  __syncthreads();
  float* dbs = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  constexpr int NW = NKT_D_WARPGROUPS * 4;
  float* row = dbs + warp * I::bias_floats;
  nkt_wg_db_put<64>(db_b0, lane, row + I::b_b0);
  nkt_wg_db_put<64>(db_b1, lane, row + I::b_b1);
  nkt_wg_db_put<8>(db_b2, lane, row + I::b_b2);
  nkt_wg_db_put<32>(db_r0, lane, row + I::b_r0);
  nkt_wg_db_put<32>(db_r1, lane, row + I::b_r1);
  nkt_wg_db_put<8>(db_r2, lane, row + I::b_r2);
  __syncthreads();
  float* gpart = partials + (size_t)blockIdx.x * stride;
  const int off[6] = {I::b_b0, I::b_b1, I::b_b2, I::b_r0, I::b_r1, I::b_r2};
  const int end[6] = {I::b_b1, I::b_b2, I::b_r0, I::b_r1, I::b_r2, I::bias_floats};
  for (int l = 0; l < 6; ++l) {
    const int dst = l < 3 ? glb.b[l] : glr.b[l - 3];
    for (int c = threadIdx.x; c < end[l] - off[l]; c += blockDim.x) {
      float s = 0.0f;
      for (int w = 0; w < NW; ++w) s += dbs[w * I::bias_floats + off[l] + c];
      gpart[dst + c] = s;
    }
  }
}

template <bool TRI, int KR, bool NEED_DX>
static int launch_wgmma(const float* x, const float* feats, int n, const float* Bm,
                        const void* image, const float* base_wb, const Chain& base,
                        const GradLayout& glb, const float* rgb_wb, const Chain& rgb,
                        const GradLayout& glr, const float* g, float* dx, float* dfeats,
                        uint32_t* scratch, float* partials, int partial_rows, int stride,
                        int* nblocks, cudaStream_t stream) {
  using I = FieldImage<KR>;
  using S = FieldScratch<KR>;
  const size_t smem = I::bytes + (I::bias_floats + 3 * I::H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fourier_field_bwd_wgmma_kernel<TRI, KR, NEED_DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int sms = NKT_BWD_GRID_SMS;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  int grid = sms;
  if (grid > ntiles) grid = ntiles;
  if (grid > partial_rows) grid = partial_rows;
  *nblocks = grid;
  fourier_field_bwd_wgmma_kernel<TRI, KR, NEED_DX>
      <<<grid, NKT_D_WARPGROUPS * NKT_WG_THREADS, smem, stream>>>(
          x, feats, n, Bm, reinterpret_cast<const uint4*>(image), base_wb, base, glb, rgb_wb, rgb,
          glr, g, dx, dfeats, scratch, partials, stride);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t per = (size_t)ntiles * (NKT_WG_ROWS / 2);  // words per unit of width
  if ((rc = launch_dw0<TRI>(x, n, Bm, scratch + S::d_b0 * per, ntiles, grid, partials, stride,
                            glb.w[0], stream)) != 0)
    return rc;
#define NKT_DW(KF, NO, a, d, off, shift, din)                                                     \
  if ((rc = launch_dw<KF, NO>(scratch, S::a, S::d, ntiles, grid, partials, stride, off, shift,    \
                              din, stream)) != 0)                                                 \
    return rc;
  NKT_DW(128, 128, h1, d_b1, glb.w[1], 0, 128)
  NKT_DW(128, 16, h2, d_b2, glb.w[2], 0, 128)
  NKT_DW(KR, 64, ri, d_r0, glr.w[0], 1, KR - 1)
  NKT_DW(64, 64, r1, d_r1, glr.w[1], 0, 64)
  NKT_DW(64, 16, r2, d_r2, glr.w[2], 0, 64)
#undef NKT_DW
  return 0;
}

// x (3, n), feats (F, n), Bm (3, H), base_wb / rgb_wb the packed chains with
// f32 (unrounded) weights, g (4, n), all f32 and contiguous on the device.
// dfeats (F, n) is always written; dx (3, n) when need_dx (it may be null
// otherwise). partials is scratch of partial_rows x partial_stride floats,
// partial_stride being the padded size of one block's weight gradients (over
// the layers of both chains, pad16(in) * pad16(out) + pad16(out)). d_base_wb
// and d_rgb_wb receive the gradients in the packed layouts of base_wb and
// rgb_wb. bf16 compute has two bodies, named by `variant`: 1 is the wgmma
// design (a per-point pass, then one weight-gradient pass per layer), for the
// flagship widths only (nkt_field_is_flagship); it needs `image`, the bf16
// weight image (wgmma_chain.cuh FieldImage), and `scratch`, of
// ceil(n / 64) * 64 * FieldScratch::total bf16 values. 0 is the WMMA body,
// which takes every shape. Launches on `stream`, does not synchronise;
// returns the launch error (0 on success).
extern "C" int nkt_fourier_field_bwd(const float* x, const float* feats, int n, int F,
                                     const float* Bm, int H, const float* base_wb,
                                     int base_floats, const int* base_dims, int n_base,
                                     const float* rgb_wb, int rgb_floats, const int* rgb_dims,
                                     int n_rgb, int tri, int bf16, int need_dx, const float* g,
                                     float* dx, float* dfeats, float* partials, int partial_rows,
                                     int partial_stride, float* d_base_wb, float* d_rgb_wb,
                                     int variant, const void* image, int image_bytes,
                                     void* scratch, long long scratch_bytes, void* stream) {
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
  if (variant != 0) {
    if (!(bf16 && variant == 1 && nkt_field_is_flagship(base, rgb, H, F))) return NKT_ERR_VARIANT;
    const long long ntiles = ((long long)n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
    const int width = F == 16 ? FieldScratch<32>::total : FieldScratch<64>::total;
    if (image_bytes != (F == 16 ? FieldImage<32>::bytes : FieldImage<64>::bytes) ||
        scratch_bytes != ntiles * NKT_WG_ROWS * width * 2)
      return NKT_ERR_VARIANT;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(d_base_wb, 0, (size_t)base_floats * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(d_rgb_wb, 0, (size_t)rgb_floats * sizeof(float), s);
  }
  int nblocks = 0, rc;
  if (variant == 1) {
#define NKT_ARGS                                                                            \
  x, feats, n, Bm, image, base_wb, base, glb, rgb_wb, rgb, glr, g, dx, dfeats,              \
      reinterpret_cast<uint32_t*>(scratch), partials, partial_rows, stride, &nblocks, s
#define NKT_PICK(TRI, KR) \
  (need_dx ? launch_wgmma<TRI, KR, true>(NKT_ARGS) : launch_wgmma<TRI, KR, false>(NKT_ARGS))
    if (F == 16)
      rc = tri ? NKT_PICK(true, 32) : NKT_PICK(false, 32);
    else
      rc = tri ? NKT_PICK(true, 64) : NKT_PICK(false, 64);
#undef NKT_PICK
#undef NKT_ARGS
  } else {
#define NKT_ARGS                                                                              \
  x, feats, n, F, Bm, H, base_wb, base, glb, rgb_wb, rgb, glr, g, need_dx, dx, dfeats, partials, \
      partial_rows, stride, &nblocks, s
    if (bf16)
      rc = tri ? launch_mma<true>(NKT_ARGS) : launch_mma<false>(NKT_ARGS);
    else
      rc = tri ? launch_f32<true>(NKT_ARGS) : launch_f32<false>(NKT_ARGS);
#undef NKT_ARGS
  }
  if (rc != 0) return rc;
  rc = nkt_launch_reduce(partials, nblocks, stride, base, glb, d_base_wb, s);
  if (rc != 0) return rc;
  return nkt_launch_reduce(partials, nblocks, stride, rgb, glr, d_rgb_wb, s);
}
