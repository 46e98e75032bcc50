// Forward fully fused nerfacto field for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_field_fwd_body` of
// nerf_kbs_tpu/ops/fused_field.py (pallas_call in `_field_fwd`, public
// `fourier_field_mlp`). Per point:
//   enc = [s; c] of proj = B^T x                        (f32 proj)
//   base = base chain(enc)  -> (1 + G) pre-activations  (relu between layers)
//   rgb = sigmoid(rgb chain([geo; feats]))
//   out = [sigma_raw; rgb]                              (4, N) f32
// with x (3, N) f32 and feats (F, N) f32 per-point conditioning rows.
//
// What bounds it here: at nerfacto-tpu widths (H = 128, base (256, 128, 128,
// 16), rgb (31, 64, 64, 3)) a point costs ~115.7 kFLOP against 92 bytes of
// device memory (x 12 + feats 64 + out 16): ~1260 FLOP/byte, far above the
// H100's ~295 bf16 FLOP/byte, so the bound is the arithmetic: ~0.18 ms for the
// 1.57M points of one 32768-ray chunk at 989 TFLOP/s.
//
// What the design does about it. Three bodies:
// - bf16 at the flagship widths (fourier_field_fwd_wgmma_kernel, see
//   wgmma_chain.cuh): one persistent block per SM holds the six W^T matrices
//   as bf16 in wgmma's core layout (114 KB, staged once from an image the
//   host builds) and runs three warpgroups, each on its own 64-point tile
//   with no block barrier, so one group's epilogue overlaps another's
//   products. Every product is a wgmma m64nNk16 with the weights as the
//   shared-memory operand and the accumulator in registers; the encoding is
//   computed straight into A-operand registers, k-step by k-step behind the
//   running product; bias, relu and the bf16 rounding pack the accumulator
//   into the next layer's A operand in place: no activation ever lies in
//   shared memory. The base chain's 16 outputs [sigma_raw, geo] are the rgb
//   chain's first 16 inputs as they stand (W_r0 carries a zero row for
//   sigma_raw), the feats come from device memory as the next k-steps.
//   What limits it now: not the tensor cores (~0.2 ms of their time) but the
//   f32 ALU work around them, the encoding (~3 K operations a point) and the
//   epilogues, and each warpgroup's wait for its own product before its
//   epilogue.
// - bf16 at any other widths (fourier_field_fwd_mma_kernel, mma_chain.cuh):
//   WMMA m16n16k16 tiles with activations in shared memory, 8 warps in lock
//   step on 64-point tiles; shared-memory fragment traffic and the epilogue's
//   scratch round trip limit it (71% of a tile's time).
// - f32 compute (the oracle mode): one thread per point, per-point
//   shared-memory columns, f32 FMAs and weights read as warp-wide broadcasts
//   through L1/L2; 96 KB of shared memory per 64-point block.
#include "mma_chain.cuh"
#include "wgmma_chain.cuh"

// ---------------------------------------------------------------------------
// f32 compute: one thread per point (see fused_chain.cuh)
// ---------------------------------------------------------------------------

template <bool TRI>
__global__ void __launch_bounds__(NKT_TILE)
    fourier_field_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                                 int n, int F, const float* __restrict__ Bm, int H,
                                 const float* __restrict__ base_wb, Chain base,
                                 const float* __restrict__ rgb_wb, Chain rgb, int rows0,
                                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const long long p = (long long)blockIdx.x * NKT_TILE + t;
  if (p >= n) return;  // the kernel has no barrier: the ragged edge simply stops
  float* buf0 = reinterpret_cast<float*>(smem);
  float* cur = buf0 + t;
  float* nxt = buf0 + (size_t)rows0 * NKT_TILE + t;

  nkt_encode<TRI>(Bm, H, x[p], x[(size_t)n + p], x[2 * (size_t)n + p], cur);
  nkt_hidden_layers(base, base_wb, &cur, &nxt);

  // last base layer: row 0 is sigma_raw, straight to the output; rows 1..
  // are geo, the first rows of the rgb chain's input
  int l = base.n_layers - 1;
  float* rgb_in = nxt;
  auto split_store = [=](int o, float v) {
    if (o == 0)
      out[p] = v;
    else
      rgb_in[(o - 1) * NKT_TILE] = v;
  };
  nkt_dense(cur, base.dims[l], base_wb + base.w_off[l], base.dims[l + 1],
            base_wb + base.b_off[l], split_store);
  const int G = base.dims[l + 1] - 1;
  for (int f = 0; f < F; ++f) rgb_in[(G + f) * NKT_TILE] = feats[(size_t)f * n + p];

  nxt = cur;
  cur = rgb_in;
  nkt_hidden_layers(rgb, rgb_wb, &cur, &nxt);
  l = rgb.n_layers - 1;
  auto sigmoid_store = [=](int o, float v) {
    out[(size_t)(1 + o) * n + p] = 1.0f / (1.0f + expf(-v));
  };
  nkt_dense(cur, rgb.dims[l], rgb_wb + rgb.w_off[l], rgb.dims[l + 1], rgb_wb + rgb.b_off[l],
            sigmoid_store);
}

template <bool TRI>
static int launch_f32(const float* x, const float* feats, int n, int F, const float* Bm, int H,
                      const float* base_wb, const Chain& base, const float* rgb_wb,
                      const Chain& rgb, float* out, cudaStream_t stream) {
  int rows[2] = {0, 0};
  nkt_chain_rows(base, 0, 2 * H, rows);
  // the base chain's last layer writes geo beside the feats into the buffer
  // its input does not occupy; the rgb chain starts there
  const int rgb_first = (base.n_layers - 1) % 2 == 0 ? 1 : 0;
  nkt_chain_rows(rgb, rgb_first, rgb.dims[0], rows);
  const size_t smem = (size_t)(rows[0] + rows[1]) * NKT_TILE * sizeof(float);
  if (smem > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_field_fwd_f32_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + NKT_TILE - 1) / NKT_TILE;
  fourier_field_fwd_f32_kernel<TRI><<<grid, NKT_TILE, smem, stream>>>(
      x, feats, n, F, Bm, H, base_wb, base, rgb_wb, rgb, rows[0], out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute: tensor cores (see mma_chain.cuh)
// ---------------------------------------------------------------------------

template <bool TRI>
__global__ void __launch_bounds__(NKT_MMA_THREADS, 1)
    fourier_field_fwd_mma_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                                 int n, int F, const float* __restrict__ Bm, int H,
                                 const float* __restrict__ base_wb, Chain base, MmaChain mbase,
                                 const float* __restrict__ rgb_wb, Chain rgb, MmaChain mrgb,
                                 int w_elems, int b_floats, int ld, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MmaSmem L = nkt_mma_smem(w_elems, b_floats, H, ld);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  float* bs = reinterpret_cast<float*>(smem + L.b);
  float* Bs = reinterpret_cast<float*>(smem + L.B);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* scratch = reinterpret_cast<float*>(smem + L.scratch) + (threadIdx.x / 32) * 256;
  // the two activation buffers, swapped after each layer
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem + L.act0);
  __nv_bfloat16* nxt = reinterpret_cast<__nv_bfloat16*>(smem + L.act1);

  nkt_mma_stage(base, mbase, base_wb, ws, bs);
  nkt_mma_stage(rgb, mrgb, rgb_wb, ws, bs);
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) Bs[i] = Bm[i];

  const int G = base.dims[base.n_layers] - 1;
  const int kp_rgb = mrgb.kp[0];
  const int ntiles = (n + NKT_MMA_ROWS - 1) / NKT_MMA_ROWS;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long p0 = (long long)tile * NKT_MMA_ROWS;
    // the barrier also keeps this tile's writes behind the last tile's reads
    __syncthreads();
    nkt_mma_load_x(x, n, p0, xs);
    __syncthreads();
    nkt_mma_encode<TRI>(xs, Bs, H, mbase.kp[0], cur, ld);
    __syncthreads();

    for (int l = 0; l < base.n_layers - 1; ++l) {
      __nv_bfloat16* out_buf = nxt;
      auto relu_store = [=](int row, int o, float v) {
        out_buf[row * ld + o] = __float2bfloat16_rn(fmaxf(v, 0.0f));
      };
      nkt_mma_layer(cur, ld, ws + mbase.w_s[l], mbase.np[l] + 8, bs + mbase.b_s[l],
                    mbase.kp[l], mbase.np[l], scratch, relu_store);
      __syncthreads();
      __nv_bfloat16* t = cur;
      cur = nxt;
      nxt = t;
    }
    // last base layer: column 0 is sigma_raw (f32 to the output), columns
    // 1..G are geo (bf16, the first columns of the rgb chain's input)
    {
      const int l = base.n_layers - 1;
      __nv_bfloat16* rgb_in = nxt;
      auto split_store = [=](int row, int o, float v) {
        if (o == 0) {
          if (p0 + row < n) out[p0 + row] = v;
        } else if (o <= G) {
          rgb_in[row * ld + o - 1] = __float2bfloat16_rn(v);
        }
      };
      nkt_mma_layer(cur, ld, ws + mbase.w_s[l], mbase.np[l] + 8, bs + mbase.b_s[l],
                    mbase.kp[l], mbase.np[l], scratch, split_store);
      // feats (bf16) beside geo, then zeros up to the padded width
      for (int i = threadIdx.x; i < NKT_MMA_ROWS * (kp_rgb - G); i += blockDim.x) {
        const int r = i % NKT_MMA_ROWS, f = i / NKT_MMA_ROWS;
        const float v = (f < F && p0 + r < n) ? feats[(size_t)f * n + p0 + r] : 0.0f;
        rgb_in[r * ld + G + f] = __float2bfloat16_rn(v);
      }
      __syncthreads();
      nxt = cur;
      cur = rgb_in;
    }
    for (int l = 0; l < rgb.n_layers - 1; ++l) {
      __nv_bfloat16* out_buf = nxt;
      auto relu_store = [=](int row, int o, float v) {
        out_buf[row * ld + o] = __float2bfloat16_rn(fmaxf(v, 0.0f));
      };
      nkt_mma_layer(cur, ld, ws + mrgb.w_s[l], mrgb.np[l] + 8, bs + mrgb.b_s[l],
                    mrgb.kp[l], mrgb.np[l], scratch, relu_store);
      __syncthreads();
      __nv_bfloat16* t = cur;
      cur = nxt;
      nxt = t;
    }
    {
      const int l = rgb.n_layers - 1;
      auto sigmoid_store = [=](int row, int o, float v) {
        if (o < 3 && p0 + row < n) out[(size_t)(1 + o) * n + p0 + row] = 1.0f / (1.0f + expf(-v));
      };
      nkt_mma_layer(cur, ld, ws + mrgb.w_s[l], mrgb.np[l] + 8, bs + mrgb.b_s[l],
                    mrgb.kp[l], mrgb.np[l], scratch, sigmoid_store);
    }
  }
}

template <bool TRI>
static int launch_mma(const float* x, const float* feats, int n, int F, const float* Bm, int H,
                      const float* base_wb, const Chain& base, const float* rgb_wb,
                      const Chain& rgb, float* out, cudaStream_t stream) {
  MmaChain mbase, mrgb;
  int w_elems = 0, b_floats = 0;
  const int wb = nkt_mma_chain(base, &mbase, &w_elems, &b_floats);
  if (wb < 0) return wb;
  const int wr = nkt_mma_chain(rgb, &mrgb, &w_elems, &b_floats);
  if (wr < 0) return wr;
  const int ld = (wb > wr ? wb : wr) + 8;
  const MmaSmem L = nkt_mma_smem(w_elems, b_floats, H, ld);
  if (L.total > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(fourier_field_fwd_mma_kernel<TRI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ntiles = (n + NKT_MMA_ROWS - 1) / NKT_MMA_ROWS;
  const int grid = ntiles < sms ? ntiles : sms;
  fourier_field_fwd_mma_kernel<TRI><<<grid, NKT_MMA_THREADS, L.total, stream>>>(
      x, feats, n, F, Bm, H, base_wb, base, mbase, rgb_wb, rgb, mrgb, w_elems, b_floats, ld,
      out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute at the flagship widths: wgmma (see wgmma_chain.cuh)
// ---------------------------------------------------------------------------

// warpgroups per block, each on its own tile: 384 threads leave 168 registers
// a thread, which the F = 48 instance needs (148)
#define NKT_B_WARPGROUPS 3

template <bool TRI, int KR>
__global__ void __launch_bounds__(NKT_B_WARPGROUPS * NKT_WG_THREADS, 1)
    fourier_field_fwd_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ feats,
                                   int n, const float* __restrict__ Bm,
                                   const uint4* __restrict__ image,
                                   const float* __restrict__ base_wb, Chain base,
                                   const float* __restrict__ rgb_wb, Chain rgb,
                                   float* __restrict__ out) {
  using I = FieldImage<KR>;
  constexpr int FSTEPS = KR / 16 - 1;
  extern __shared__ __align__(128) unsigned char smem[];
  nkt_field_stage<KR>(smem, image, base_wb, base, rgb_wb, rgb, Bm);
  nkt_fence_async_smem();
  __syncthreads();
  const uint32_t ws = nkt_smem_addr(smem);
  const float* bs = reinterpret_cast<const float*>(smem + I::bytes);
  const float* Bs = bs + I::bias_floats;
  const WgLane L = nkt_wg_lane();
  const int wg = threadIdx.x / NKT_WG_THREADS;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;

  // no barrier from here on: each warpgroup walks its own tiles
  for (int tile = blockIdx.x * NKT_B_WARPGROUPS + wg; tile < ntiles;
       tile += gridDim.x * NKT_B_WARPGROUPS) {
    const long long pa = (long long)tile * NKT_WG_ROWS + 16 * L.w + L.g, pb = pa + 8;
    float xa[3], xb[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      xa[d] = pa < n ? x[(size_t)d * n + pa] : 0.0f;
      xb[d] = pb < n ? x[(size_t)d * n + pb] : 0.0f;
    }
    // the rgb chain's input: k-step 0 is [0; geo], the rest the feats
    uint32_t rgb_in[4 * (1 + FSTEPS)];
    {
      uint32_t fe[4 * FSTEPS];
      nkt_wg_load_feats<FSTEPS>(feats, n, pa, pb, L.t, fe);
#pragma unroll
      for (int i = 0; i < 4 * FSTEPS; ++i) rgb_in[4 + i] = fe[i];
    }

    uint32_t h[32];
    {
      float acc[64];
      nkt_wg_first_layer<TRI, I::H>(acc, Bs, L.t, xa, xb, ws + I::w_b0);
      nkt_wg_relu_pack<false>(acc, bs + I::b_b0, L.t, h, nullptr);
      nkt_wg_forward<8>(acc, h, ws + I::w_b1);
      nkt_wg_relu_pack<false>(acc, bs + I::b_b1, L.t, h, nullptr);
    }
    {
      // last base layer: column 0 is sigma_raw (f32, to the output; its place
      // in the rgb input is zeroed: that weight row is zero and the value may
      // not be finite in bf16), columns 1..15 geo
      float acc[8];
      nkt_wg_forward<8>(acc, h, ws + I::w_b2);
      float sigma_a, sigma_b;
      nkt_wg_base_out(acc, bs + I::b_b2, L.t, rgb_in, &sigma_a, &sigma_b);
      if (L.t == 0) {
        if (pa < n) out[pa] = sigma_a;
        if (pb < n) out[pb] = sigma_b;
      }
    }
    uint32_t r[16];
    {
      float acc[32];
      nkt_wg_forward<KR / 16>(acc, rgb_in, ws + I::w_r0);
      nkt_wg_relu_pack<false>(acc, bs + I::b_r0, L.t, r, nullptr);
      nkt_wg_forward<4>(acc, r, ws + I::w_r1);
      nkt_wg_relu_pack<false>(acc, bs + I::b_r1, L.t, r, nullptr);
    }
    {
      float acc[8];
      nkt_wg_forward<4>(acc, r, ws + I::w_r2);
      // columns 0..2 are rgb: thread t holds columns 2t, 2t + 1
      if (L.t < 2) {
        const float2 b = *reinterpret_cast<const float2*>(bs + I::b_r2 + 2 * L.t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * L.t + e;
          if (c < 3) {
            const float bias = e == 0 ? b.x : b.y;
            if (pa < n) out[(size_t)(1 + c) * n + pa] = 1.0f / (1.0f + expf(-(acc[e] + bias)));
            if (pb < n) out[(size_t)(1 + c) * n + pb] = 1.0f / (1.0f + expf(-(acc[2 + e] + bias)));
          }
        }
      }
    }
  }
}

template <bool TRI, int KR>
static int launch_wgmma(const float* x, const float* feats, int n, const float* Bm,
                        const void* image, const float* base_wb, const Chain& base,
                        const float* rgb_wb, const Chain& rgb, float* out, cudaStream_t stream) {
  using I = FieldImage<KR>;
  const size_t smem = I::bytes + (I::bias_floats + 3 * I::H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fourier_field_fwd_wgmma_kernel<TRI, KR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  const int want = (ntiles + NKT_B_WARPGROUPS - 1) / NKT_B_WARPGROUPS;
  const int grid = want < sms ? want : sms;
  fourier_field_fwd_wgmma_kernel<TRI, KR>
      <<<grid, NKT_B_WARPGROUPS * NKT_WG_THREADS, smem, stream>>>(
          x, feats, n, Bm, reinterpret_cast<const uint4*>(image), base_wb, base, rgb_wb, rgb, out);
  return (int)cudaGetLastError();
}

// x (3, n) f32, feats (F, n) f32, Bm (3, H) f32, base_wb / rgb_wb the packed
// chains (see fused_chain.cuh), out (4, n) f32; all contiguous on the device.
// The base chain ends in 1 + G outputs and the rgb chain takes G + F inputs
// and gives 3. f32 compute runs on FMAs. bf16 compute has two bodies, named
// by `variant`: 1 is the wgmma body, for the flagship widths only (see
// nkt_field_is_flagship), and needs `image`, the bf16 weight image of
// image_bytes (wgmma_chain.cuh FieldImage); 0 is the WMMA body, which takes
// every shape. Launches on `stream`, does not synchronise; returns the launch
// error (0 on success).
extern "C" int nkt_fourier_field_fwd(const float* x, const float* feats, int n, int F,
                                     const float* Bm, int H, const float* base_wb,
                                     int base_floats, const int* base_dims, int n_base,
                                     const float* rgb_wb, int rgb_floats, const int* rgb_dims,
                                     int n_rgb, int tri, int bf16, int variant, const void* image,
                                     int image_bytes, float* out, void* stream) {
  Chain base, rgb;
  const int pb = nkt_chain_from_dims(&base, base_dims, n_base);
  if (pb < 0) return pb;
  const int pr = nkt_chain_from_dims(&rgb, rgb_dims, n_rgb);
  if (pr < 0) return pr;
  if (pb != base_floats || pr != rgb_floats || base_dims[0] != 2 * H ||
      rgb_dims[0] != base_dims[n_base] - 1 + F || rgb_dims[n_rgb] != 3)
    return NKT_ERR_PACKING;
  if (variant != 0 && !(bf16 && variant == 1 && nkt_field_is_flagship(base, rgb, H, F) &&
                        image_bytes == (F == 16 ? FieldImage<32>::bytes : FieldImage<64>::bytes)))
    return NKT_ERR_VARIANT;
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (variant == 1) {
#define NKT_ARGS x, feats, n, Bm, image, base_wb, base, rgb_wb, rgb, out, s
    if (F == 16) return tri ? launch_wgmma<true, 32>(NKT_ARGS) : launch_wgmma<false, 32>(NKT_ARGS);
    return tri ? launch_wgmma<true, 64>(NKT_ARGS) : launch_wgmma<false, 64>(NKT_ARGS);
#undef NKT_ARGS
  }
  if (bf16)
    return tri ? launch_mma<true>(x, feats, n, F, Bm, H, base_wb, base, rgb_wb, rgb, out, s)
               : launch_mma<false>(x, feats, n, F, Bm, H, base_wb, base, rgb_wb, rgb, out, s);
  return tri ? launch_f32<true>(x, feats, n, F, Bm, H, base_wb, base, rgb_wb, rgb, out, s)
             : launch_f32<false>(x, feats, n, F, Bm, H, base_wb, base, rgb_wb, rgb, out, s);
}
