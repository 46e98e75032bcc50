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
// (80, 16, 1)) without dx a point moves 16 bytes (x 12, g 4) and costs ~5.4
// kFLOP on the tensor cores (recompute and dW_0): 7.5 us of memory time and
// 8.6 us of tensor-core time for the 1.57M points of proposal round 0. As in
// the forward, the bound is the f32 ALU work of the recomputed encoding and
// of the width-1 step, ~650 scalar instructions a point, 31 us on the 132
// SMs x 128 lanes of an H100 SXM at its maximum clock of 1.98 GHz.
//
// What the design does about it. Four bodies; in all of them each block
// leaves its weight-gradient sums in a partial of its own and a second small
// kernel sums the partials in block order: no float atomics, and a repeat of
// the launch gives the same bits.
// - bf16 at the proposal fields' widths (fourier_mlp_bwd_wgmma_kernel, see
//   wgmma_chain.cuh): one persistent block per SM of four warpgroups, each
//   on its own 64-point tiles with no block barrier in the tile loop. The
//   forward is the forward kernel's: positions and g of the thread's two rows
//   prefetched into registers a tile ahead, the encoding in pair order made
//   k-step by k-step behind the running product. The width-1 step is per
//   thread on its four hidden columns: the relu mask from the f32
//   pre-activation, dh = mask ? w_1 g : 0 with the unrounded w_1, and
//   dW_1 += h g, db_1 += g, db_0 += dh as f32 sums the thread keeps in
//   registers over all its tiles (9 registers), reduced over lanes by a
//   shuffle butterfly and over warps in a fixed order once, at the block's
//   end. dW_0 = enc^T . bf16(dh) contracts over points: the warpgroup leaves
//   its A-operand words of the encoding and of dh as [point][feature] tiles
//   in shared memory (4-byte stores, 128 contiguous bytes a warp), and after
//   one warpgroup-wide named barrier eight m64n16k16 products read both tiles
//   with the trans flags into 16 f32 accumulators a thread, which stay in
//   registers over all tiles and run behind the next tile's encoding (the
//   tiles are double-buffered, so one barrier a tile is enough). The 80
//   feature rows take two 64-row products, features [0, 64) and [16, 80):
//   the overlap costs idle tensor-core time and saves a padded tile. With
//   need_dx, d_enc = bf16(dh) . W_0^T is five more n16 products on the
//   resident image with the trans flag, whose accumulators have the
//   encoding's layout, so the thread that made s(u), c(u) applies their
//   derivatives and B and a quad shuffle finishes dx. Nothing per point
//   reaches device memory but dx.
// - bf16 at the field's base widths (H = 128, dims (256, 128, 128, 16), the
//   semantics path's base MLP): the field backward's design for its base
//   chain (wgmma_bwd.cuh), in two passes. The per-point pass
//   (fourier_mlp_bwd_base_wgmma_kernel), persistent blocks of two
//   warpgroups, each on its own 64-point tile with no block barrier, the
//   base image (BaseImage) resident as in the forward: it recomputes the two
//   hidden layers keeping the relu masks as bits from the f32
//   pre-activations, takes dh_2 = g (all 16 columns, bf16 for the products,
//   f32 for the bias sum), and forms dh_1 and dh_0 by W . dh products on the
//   resident W^T with the trans flag, in registers; with NEED_DX d_enc =
//   dh_0 . W_0^T and dx = B . (d_enc * slopes) as the field backward forms
//   it. Bias gradients are f32 sums of the unrounded dh by a shuffle
//   butterfly. h1, h2, dh_0, dh_1 and dh_2 go out once as bf16 tiles in the
//   core layout, 528 values a point (MlpBaseScratch). The weight-gradient
//   passes are the field backward's own (nkt_field_dw0_kernel for dW_0,
//   which recomputes the encoding; nkt_field_dw_kernel for dW_1, dW_2).
//   What bounds it: ~238 kFLOP a point on the tensor cores (recompute, dW,
//   W . dh), 0.047 ms at the 196,608 points of a 4,096-ray step; the scratch
//   round trip adds ~416 MB of device memory traffic there (~0.12 ms).
// - bf16 at any other widths (fourier_mlp_bwd_mma_kernel, chain_bwd.cuh):
//   WMMA tiles with activations in shared memory; each tile's act^T . dh goes
//   through the block's partial in L2. At the proposal widths it needs about
//   five times the wgmma body's time, at the base widths 24 times the
//   bound.
// - f32 compute (the oracle mode): one thread per point (chain_bwd.cuh).
#include "wgmma_bwd.cuh"

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
// bf16 compute at any widths: WMMA (see chain_bwd.cuh)
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

// ---------------------------------------------------------------------------
// bf16 compute at the proposal fields' widths: wgmma (see wgmma_chain.cuh)
// ---------------------------------------------------------------------------

// Warpgroups per block, one block per SM: 512 threads leave 128 registers a
// thread, and a block leaves one partial, so the reduction reads 132 of them.
// Shapes of 16 to 24 warps an SM timed within 6% of each other on an H100
// 80GB HBM3 at 700 W; 32 warps leave 64 registers a thread, which spill.
#define NKT_C_WARPGROUPS 4
#define NKT_C_BLOCKS_PER_SM 1

// A warpgroup's tile in shared memory: the encoding [64 points][80 features]
// and dh [64 points][16] as bf16 in the core layout; two of them per warpgroup.
#define NKT_C_ENC_BYTES (NKT_WG_ROWS * 2 * MlpImage::H * 2)
#define NKT_C_TILE_BYTES (NKT_C_ENC_BYTES + NKT_WG_ROWS * MlpImage::HID * 2)
#define NKT_C_SMEM (MlpImage::bytes + NKT_C_WARPGROUPS * 2 * NKT_C_TILE_BYTES)

template <bool TRI, bool NEED_DX>
__global__ void __launch_bounds__(NKT_C_WARPGROUPS * NKT_WG_THREADS, NKT_C_BLOCKS_PER_SM)
    fourier_mlp_bwd_wgmma_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                                 const uint4* __restrict__ image, const float* __restrict__ wb,
                                 Chain ch, GradLayout gl, const float* __restrict__ g,
                                 float* __restrict__ dx, float* __restrict__ partials, int stride) {
  using I = MlpImage;
  constexpr int KSTEPS = I::H / 8, K = 2 * I::H;
  extern __shared__ __align__(128) unsigned char smem[];
  nkt_mlp_stage(smem, image, wb, ch, Bm, false);
  nkt_fence_async_smem();
  __syncthreads();
  const uint32_t ws = nkt_smem_addr(smem);
  const float* fs = reinterpret_cast<const float*>(smem + I::w0_bytes);
  const float* Bs = fs + I::B;
  const WgLane L = nkt_wg_lane();
  const int wg = threadIdx.x / NKT_WG_THREADS;
  unsigned char* tiles = smem + I::bytes + wg * 2 * NKT_C_TILE_BYTES;
  // the thread's hidden columns 2t, 2t + 1, 8 + 2t, 9 + 2t: their bias and
  // their weight in the width-1 layer (f32, unrounded)
  float b0[4], w1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    b0[c] = fs[I::b0 + 8 * (c / 2) + 2 * L.t + c % 2];
    w1[c] = fs[I::w1 + 8 * (c / 2) + 2 * L.t + c % 2];
  }
  // sums over all of this thread's tiles: dW_0 (two 64-row products of 16
  // columns), dW_1 and db_0 of its four columns, db_1
  float dw0[2][8], s_dw1[4], s_db0[4], s_db1 = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) dw0[0][i] = dw0[1][i] = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) s_dw1[c] = s_db0[c] = 0.0f;

  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  const int step = gridDim.x * NKT_C_WARPGROUPS;
  int tile = blockIdx.x * NKT_C_WARPGROUPS + wg;
  auto load_g = [&](long long t, float* ga, float* gb) {
    const long long pa = t * NKT_WG_ROWS + 16 * L.w + L.g, pb = pa + 8;
    *ga = pa < n ? g[pa] : 0.0f;
    *gb = pb < n ? g[pb] : 0.0f;
  };
  float xa[3], xb[3], ga, gb;
  nkt_wg_load_x(x, n, tile, L, xa, xb);
  load_g(tile, &ga, &gb);

  // no block barrier in this loop: each warpgroup walks its own tiles
  for (int it = 0; tile < ntiles; tile += step, ++it) {
    float na[3], nb[3], nga, ngb;  // the next tile's inputs, in flight behind this tile's work
    nkt_wg_load_x(x, n, (long long)tile + step, L, na, nb);
    load_g((long long)tile + step, &nga, &ngb);
    // this tile's buffer: the products that read it two tiles ago are done
    // on every warp (each passed the wait of a first layer since, and then a
    // barrier)
    uint32_t* enc_t = reinterpret_cast<uint32_t*>(tiles + (it & 1) * NKT_C_TILE_BYTES);
    uint32_t* dh_t = enc_t + NKT_C_ENC_BYTES / 4;

    // ---- forward: the hidden layer's pre-activation, the encoding kept
    float acc[8];
    nkt_wg_first_layer_pairs<TRI, I::H>(
        acc, Bs, L.t, xa, xb, ws, [&](int ks, const uint32_t(&a)[4]) {
          nkt_wg_put_tile<16>(enc_t + ks * (16 * NKT_WG_ROWS / 2), L, a);
        });

    // ---- the width-1 layer and the relu, per thread in f32
    uint32_t d16[4];
    {
      float dh[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * (c / 2) + c % 2;
        const float pa = acc[i] + b0[c], pb = acc[i + 2] + b0[c];
        s_dw1[c] = fmaf(nkt_round_bf16(fmaxf(pa, 0.0f)), ga, s_dw1[c]);
        s_dw1[c] = fmaf(nkt_round_bf16(fmaxf(pb, 0.0f)), gb, s_dw1[c]);
        dh[i] = pa > 0.0f ? w1[c] * ga : 0.0f;
        dh[i + 2] = pb > 0.0f ? w1[c] * gb : 0.0f;
        s_db0[c] += dh[i];
        s_db0[c] += dh[i + 2];
      }
      if (L.t == 0) s_db1 += ga + gb;
#pragma unroll
      for (int j = 0; j < 4; ++j) d16[j] = nkt_pack_bf16(dh[2 * j], dh[2 * j + 1]);
    }
    nkt_wg_put_tile<16>(dh_t, L, d16);
    nkt_fence_async_smem();
    nkt_wg_sync(wg);

    // ---- dW_0 += enc^T . dh over the tile's points: features [0, 64) and
    // [16, 80); the products run on behind what follows
    {
      const uint32_t a_addr = nkt_smem_addr(enc_t), b_addr = nkt_smem_addr(dh_t);
      nkt_wg_fence();
#pragma unroll
      for (int ks = 0; ks < NKT_WG_ROWS / 16; ++ks) {
        const uint64_t bd = nkt_wg_desc(b_addr + ks * 256, 128, 1024);
        nkt_wgmma_ss<1, 1>(dw0[0], nkt_wg_desc(a_addr + ks * 256, 128, 1024), bd, 1);
        nkt_wgmma_ss<1, 1>(dw0[1], nkt_wg_desc(a_addr + 2 * 1024 + ks * 256, 128, 1024), bd, 1);
      }
      nkt_wg_commit();
    }

    if (NEED_DX) {
      // d_enc = bf16(dh) . W_0^T, k-step by k-step of the encoding: columns
      // 0..7 are ds, 8..15 dc of the frequencies the thread encoded; dproj =
      // ds s' + dc c', dx = B . dproj, all in f32
      float de[KSTEPS][8];
      nkt_wg_fence();
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        nkt_wgmma_rs<1>(de[ks], d16[0], d16[1], d16[2], d16[3],
                        nkt_wg_desc(ws + ks * 512, 128, 256), 0);
      nkt_wg_commit();
      nkt_wg_wait<0>();
      float da[3] = {0.0f, 0.0f, 0.0f}, db[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        nkt_wg_settle(de[ks]);
        const int h = 8 * ks + 2 * L.t;
        const float2 v0 = *reinterpret_cast<const float2*>(Bs + h);
        const float2 v1 = *reinterpret_cast<const float2*>(Bs + I::H + h);
        const float2 v2 = *reinterpret_cast<const float2*>(Bs + 2 * I::H + h);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float c0 = e ? v0.y : v0.x, c1 = e ? v1.y : v1.x, c2 = e ? v2.y : v2.x;
          float dsdu, dcdu;
          nkt_basis_grads<TRI>(fmaf(c2, xa[2], fmaf(c1, xa[1], c0 * xa[0])), &dsdu, &dcdu);
          const float wa = de[ks][e] * dsdu + de[ks][4 + e] * dcdu;
          nkt_basis_grads<TRI>(fmaf(c2, xb[2], fmaf(c1, xb[1], c0 * xb[0])), &dsdu, &dcdu);
          const float wb_ = de[ks][2 + e] * dsdu + de[ks][6 + e] * dcdu;
          da[0] = fmaf(c0, wa, da[0]);
          da[1] = fmaf(c1, wa, da[1]);
          da[2] = fmaf(c2, wa, da[2]);
          db[0] = fmaf(c0, wb_, db[0]);
          db[1] = fmaf(c1, wb_, db[1]);
          db[2] = fmaf(c2, wb_, db[2]);
        }
      }
      const long long p = (long long)tile * NKT_WG_ROWS + 16 * L.w + L.g + 8 * L.t;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        da[d] += __shfl_xor_sync(0xffffffffu, da[d], 1);
        db[d] += __shfl_xor_sync(0xffffffffu, db[d], 1);
        da[d] += __shfl_xor_sync(0xffffffffu, da[d], 2);
        db[d] += __shfl_xor_sync(0xffffffffu, db[d], 2);
        // lane t = 0 stores the quad's first row, t = 1 its second
        if (L.t < 2 && p < n) dx[(size_t)d * n + p] = L.t ? db[d] : da[d];
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      xa[d] = na[d];
      xb[d] = nb[d];
    }
    ga = nga;
    gb = ngb;
  }

  // ---- the block's sums into its partial, in a fixed order. The tile
  // buffers, which nothing reads any more, hold every warpgroup's dW_0
  // [K][16] and behind them every warp's 33 column sums.
  nkt_wg_wait<0>();
  nkt_wg_settle(dw0[0]);
  nkt_wg_settle(dw0[1]);
  __syncthreads();
  constexpr int NW = NKT_C_WARPGROUPS * 4, SUMS = 36;
  float* red = reinterpret_cast<float*>(smem + I::bytes);
  float* sums = red + NKT_C_WARPGROUPS * K * I::HID;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the second product's rows are features 16..79: those below 64 repeat
        // the first product's and are dropped
        const int k = 16 * half + 16 * L.w + L.g + 8 * r;
        if (half == 0 || k >= 64)
          *reinterpret_cast<float2*>(red + (wg * K + k) * I::HID + 8 * j + 2 * L.t) =
              make_float2(dw0[half][4 * j + 2 * r], dw0[half][4 * j + 2 * r + 1]);
      }
#pragma unroll
  for (int bit = 4; bit <= 16; bit <<= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s_dw1[c] += __shfl_xor_sync(0xffffffffu, s_dw1[c], bit);
      s_db0[c] += __shfl_xor_sync(0xffffffffu, s_db0[c], bit);
    }
    s_db1 += __shfl_xor_sync(0xffffffffu, s_db1, bit);
  }
  if (L.g == 0) {
    float* mine = sums + (threadIdx.x / 32) * SUMS;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mine[8 * (c / 2) + 2 * L.t + c % 2] = s_dw1[c];
      mine[16 + 8 * (c / 2) + 2 * L.t + c % 2] = s_db0[c];
    }
    if (L.t == 0) mine[32] = s_db1;
  }
  __syncthreads();
  float* gpart = partials + (size_t)blockIdx.x * stride;
  for (int i = threadIdx.x; i < K * I::HID; i += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < NKT_C_WARPGROUPS; ++w) s += red[w * K * I::HID + i];
    // row i / 16 of the pair order is this feature of [s; c]
    gpart[gl.w[0] + nkt_mlp_pair_feature(i / I::HID, I::H) * gl.np[0] + i % I::HID] = s;
  }
  for (int c = threadIdx.x; c < 33; c += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < NW; ++w) s += sums[w * SUMS + c];
    gpart[c < 16 ? gl.w[1] + c * gl.np[1] : c < 32 ? gl.b[0] + c - 16 : gl.b[1]] = s;
  }
}

template <bool TRI, bool NEED_DX>
static int launch_wgmma(const float* x, int n, const float* Bm, const void* image,
                        const float* wb, const Chain& ch, const GradLayout& gl, const float* g,
                        float* dx, float* partials, int partial_rows, int stride, int* nblocks,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(fourier_mlp_bwd_wgmma_kernel<TRI, NEED_DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, NKT_C_SMEM);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  int grid = (ntiles + NKT_C_WARPGROUPS - 1) / NKT_C_WARPGROUPS;
  if (grid > sms * NKT_C_BLOCKS_PER_SM) grid = sms * NKT_C_BLOCKS_PER_SM;
  if (grid > partial_rows) grid = partial_rows;
  *nblocks = grid;
  fourier_mlp_bwd_wgmma_kernel<TRI, NEED_DX>
      <<<grid, NKT_C_WARPGROUPS * NKT_WG_THREADS, NKT_C_SMEM, stream>>>(
          x, n, Bm, reinterpret_cast<const uint4*>(image), wb, ch, gl, g, dx, partials, stride);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute at the field's base widths: wgmma (see wgmma_bwd.cuh)
// ---------------------------------------------------------------------------

// Warpgroups per block of the per-point pass, one block per SM, as the field
// backward's: ptxas gives the pass all 255 registers a thread (88 to 232
// bytes of spills in three of its four instances), so two warpgroups of 128
// threads are what an SM's 65,536 registers hold.
#define NKT_C_BASE_WARPGROUPS 2

// Per-point widths (bf16 values) of what the per-point pass leaves for the
// weight-gradient passes, laid out as the field backward's FieldScratch: the
// hidden layers' inputs h1, h2 and the pre-activation gradients of layers
// 0..2.
struct MlpBaseScratch {
  static constexpr int h1 = 0, h2 = 128, d_b0 = 256, d_b1 = 384, d_b2 = 512, total = 528;
};

// The per-point pass: forward through the two hidden layers, then backward
// from dh_2 = g, every activation and gradient in registers between
// products. It writes dx (NEED_DX), the scratch tiles and the block's bias
// gradients (f32 sums) into its partial.
template <bool TRI, bool NEED_DX>
__global__ void __launch_bounds__(NKT_C_BASE_WARPGROUPS * NKT_WG_THREADS, 1)
    fourier_mlp_bwd_base_wgmma_kernel(const float* __restrict__ x, int n,
                                      const float* __restrict__ Bm,
                                      const uint4* __restrict__ image,
                                      const float* __restrict__ wb, Chain ch, GradLayout gl,
                                      const float* __restrict__ g, float* __restrict__ dx,
                                      uint32_t* __restrict__ scratch,
                                      float* __restrict__ partials, int stride) {
  using I = BaseImage;
  using S = MlpBaseScratch;
  extern __shared__ __align__(128) unsigned char smem[];
  nkt_base_stage(smem, image, wb, ch, Bm);
  const uint32_t ws = nkt_smem_addr(smem);
  const float* bs = reinterpret_cast<const float*>(smem + I::bytes);
  const float* Bs = bs + I::bias_floats;
  const WgLane L = nkt_wg_lane();
  const int lane = threadIdx.x % 32;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;

  // bias-gradient sums over all of this thread's tiles
  float db_b0[nkt_db_count(64)] = {}, db_b1[nkt_db_count(64)] = {}, db_b2[nkt_db_count(8)] = {};

  // no block barrier in this loop: each warpgroup walks its own tiles
  for (int tile = blockIdx.x * NKT_C_BASE_WARPGROUPS + threadIdx.x / NKT_WG_THREADS;
       tile < ntiles; tile += gridDim.x * NKT_C_BASE_WARPGROUPS) {
    const long long pa = (long long)tile * NKT_WG_ROWS + 16 * L.w + L.g, pb = pa + 8;
    float xa[3], xb[3];
    nkt_wg_load_x(x, n, tile, L, xa, xb);
    // dh_2 = g at the thread's entries of a (64, 16) accumulator: d[4j + e]
    // row a, d[4j + 2 + e] row b, of column 8j + 2t + e (zeros past the edge)
    float d[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t c = 8 * (i / 4) + 2 * L.t + i % 2;
      const long long p = i % 4 < 2 ? pa : pb;
      d[i] = p < n ? g[c * n + p] : 0.0f;
    }

    // ---- forward through the hidden layers, keeping the relu masks
    uint32_t m_h1[2], m_h2[2];
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

    // ---- dh_2 = g: its f32 column sums, then rounded as one k-step
    uint32_t d16[4];
    nkt_wg_colsum(d, lane, db_b2);
    d16[0] = nkt_pack_bf16(d[0], d[1]);
    d16[1] = nkt_pack_bf16(d[2], d[3]);
    d16[2] = nkt_pack_bf16(d[4], d[5]);
    d16[3] = nkt_pack_bf16(d[6], d[7]);
    nkt_wg_store_tile<16>(scratch, S::d_b2, ntiles, tile, L, d16);

    // ---- backward through the chain
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
  // memory (over the image, which nothing reads any more), then summed over
  // warps in order
  __syncthreads();
  float* dbs = reinterpret_cast<float*>(smem);
  constexpr int NW = NKT_C_BASE_WARPGROUPS * 4;
  float* row = dbs + (threadIdx.x / 32) * I::bias_floats;
  nkt_wg_db_put<64>(db_b0, lane, row + I::b_b0);
  nkt_wg_db_put<64>(db_b1, lane, row + I::b_b1);
  nkt_wg_db_put<8>(db_b2, lane, row + I::b_b2);
  __syncthreads();
  float* gpart = partials + (size_t)blockIdx.x * stride;
  const int off[3] = {I::b_b0, I::b_b1, I::b_b2}, end[3] = {I::b_b1, I::b_b2, I::bias_floats};
  for (int l = 0; l < 3; ++l)
    for (int c = threadIdx.x; c < end[l] - off[l]; c += blockDim.x) {
      float sum = 0.0f;
      for (int w = 0; w < NW; ++w) sum += dbs[w * I::bias_floats + off[l] + c];
      gpart[gl.b[l] + c] = sum;
    }
}

// The per-point pass, then dW_0, dW_1 and dW_2 over its scratch; every pass
// on the same `grid` blocks, each block filling its own partial.
template <bool TRI, bool NEED_DX>
static int launch_base_wgmma(const float* x, int n, const float* Bm, const void* image,
                             const float* wb, const Chain& ch, const GradLayout& gl,
                             const float* g, float* dx, uint32_t* scratch, float* partials,
                             int partial_rows, int stride, int* nblocks, cudaStream_t stream) {
  using S = MlpBaseScratch;
  constexpr int smem = BaseImage::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(fourier_mlp_bwd_base_wgmma_kernel<TRI, NEED_DX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  int grid = sms;
  if (grid > ntiles) grid = ntiles;
  if (grid > partial_rows) grid = partial_rows;
  *nblocks = grid;
  fourier_mlp_bwd_base_wgmma_kernel<TRI, NEED_DX>
      <<<grid, NKT_C_BASE_WARPGROUPS * NKT_WG_THREADS, smem, stream>>>(
          x, n, Bm, reinterpret_cast<const uint4*>(image), wb, ch, gl, g, dx, scratch, partials,
          stride);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const size_t per = (size_t)ntiles * (NKT_WG_ROWS / 2);  // words per unit of width
  if ((rc = launch_dw0<TRI>(x, n, Bm, scratch + S::d_b0 * per, ntiles, grid, partials, stride,
                            gl.w[0], stream)) != 0)
    return rc;
  if ((rc = launch_dw<128, 128>(scratch, S::h1, S::d_b1, ntiles, grid, partials, stride, gl.w[1],
                                0, 128, stream)) != 0)
    return rc;
  return launch_dw<128, 16>(scratch, S::h2, S::d_b2, ntiles, grid, partials, stride, gl.w[2], 0,
                            128, stream);
}

// x (3, n), Bm (3, H), wb the packed chain with f32 (unrounded) weights, g
// (dims[n_layers], n), all f32 and contiguous on the device. dx (3, n) is
// written when need_dx (it may be null otherwise). partials is scratch of
// partial_rows x partial_stride floats, partial_stride being the padded size
// of one block's weight gradients (sum over layers of pad16(in) * pad16(out) +
// pad16(out)). dwb receives the gradients in wb's packed layout (the padding
// between parts is left as it was). bf16 compute has three bodies, named by
// `variant`: 1 is the wgmma body for the proposal fields' widths
// (nkt_mlp_is_flagship), and needs `image`, W_0^T as bf16 of image_bytes
// (wgmma_chain.cuh MlpImage); 2 is the wgmma design for the field's base
// widths (nkt_mlp_is_base: a per-point pass, then the weight-gradient
// passes), and needs `image`, the base chain's bf16 image (BaseImage), and
// `scratch`, of ceil(n / 64) * 64 * MlpBaseScratch::total bf16 values; 0 is
// the WMMA body, which takes every shape. Launches on `stream`, does not
// synchronise; returns the launch error (0 on success).
extern "C" int nkt_fourier_mlp_bwd(const float* x, int n, const float* Bm, int H, const float* wb,
                                   int wb_floats, const int* dims, int n_layers, int tri, int bf16,
                                   int need_dx, const float* g, float* dx, float* partials,
                                   int partial_rows, int partial_stride, float* dwb, int variant,
                                   const void* image, int image_bytes, void* scratch,
                                   long long scratch_bytes, void* stream) {
  Chain ch;
  const int packed = nkt_chain_from_dims(&ch, dims, n_layers);
  if (packed < 0) return packed;
  GradLayout gl;
  int stride = 0;
  nkt_grad_layout(ch, &gl, &stride);
  if (packed != wb_floats || dims[0] != 2 * H || stride != partial_stride || partial_rows < 1)
    return NKT_ERR_PACKING;
  const long long ntiles = ((long long)n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  const bool proposal = variant == 1 && nkt_mlp_is_flagship(ch, H) &&
                        image_bytes == MlpImage::w0_bytes;
  const bool base = variant == 2 && nkt_mlp_is_base(ch, H) && image_bytes == BaseImage::bytes &&
                    scratch_bytes == ntiles * NKT_WG_ROWS * MlpBaseScratch::total * 2;
  if (variant != 0 && !(bf16 && (proposal || base))) return NKT_ERR_VARIANT;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(dwb, 0, (size_t)wb_floats * sizeof(float), s);
    return (int)err;
  }
  int nblocks = 0, rc;
#define NKT_ARGS x, n, Bm, image, wb, ch, gl, g, dx, partials, partial_rows, stride, &nblocks, s
#define NKT_PICK(TRI) \
  (need_dx ? launch_wgmma<TRI, true>(NKT_ARGS) : launch_wgmma<TRI, false>(NKT_ARGS))
#define NKT_BASE_ARGS                                                                     \
  x, n, Bm, image, wb, ch, gl, g, dx, reinterpret_cast<uint32_t*>(scratch), partials,      \
      partial_rows, stride, &nblocks, s
#define NKT_PICK_BASE(TRI)                                   \
  (need_dx ? launch_base_wgmma<TRI, true>(NKT_BASE_ARGS)     \
           : launch_base_wgmma<TRI, false>(NKT_BASE_ARGS))
  if (variant == 1)
    rc = tri ? NKT_PICK(true) : NKT_PICK(false);
  else if (variant == 2)
    rc = tri ? NKT_PICK_BASE(true) : NKT_PICK_BASE(false);
  else if (bf16)
    rc = tri ? launch_mma<true>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                stride, &nblocks, s)
             : launch_mma<false>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                 stride, &nblocks, s);
  else
    rc = tri ? launch_f32<true>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                stride, &nblocks, s)
             : launch_f32<false>(x, n, Bm, H, wb, ch, gl, g, need_dx, dx, partials, partial_rows,
                                 stride, &nblocks, s);
#undef NKT_PICK_BASE
#undef NKT_BASE_ARGS
#undef NKT_PICK
#undef NKT_ARGS
  if (rc != 0) return rc;
  return nkt_launch_reduce(partials, nblocks, stride, ch, gl, dwb, s);
}
