// Forward fused Fourier-feature MLP for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `_fwd_body` of nerf_kbs_tpu/ops/fused_field.py
// (pallas_call in `_fwd`, public `fourier_mlp`). It computes, per point,
//   proj = B^T x (f32), s, c = tri or sin/cos of proj,
//   h = relu(W0a^T s + W0b^T c + b0), ..., out = W_last^T h + b_last,
// feature-major: x (3, N) f32 in, out (out_dim, N) f32 out.
// The one pallas_call (`:329`) serves the proposal fields' widths and, on
// the semantics path, the nerfacto field's base chain alone.
//
// What bounds it here: at the proposal fields' shapes (H = 40, dims
// (80, 16, 1)) a point moves 16 bytes of device memory (12 in, 4 out) and
// costs ~2.8 kFLOP on the tensor cores: 15 us of memory time and 9 us of
// tensor-core time for the 3.1M points of proposal round 0. Neither is the
// bound. The encoding is: 40 projections of 3 FMAs, 80 waves of ~5 f32
// operations and their rounding to bf16, with the epilogue ~590 scalar
// instructions a point in the tri basis, which the 132 SMs x 128 lanes of an
// H100 SXM execute in 56 us at its maximum clock of 1.98 GHz. The kernel is
// bound by the f32 ALUs.
//
// At the nerfacto field's base widths (H = 128, dims (256, 128, 128, 16)),
// which the semantics path runs alone in this kernel, a point costs ~103
// kFLOP on the tensor cores against 76 bytes (x 12, out 64) and ~2.3 K f32
// instructions (the encoding and the epilogues): the bound is the tensor
// cores, 0.021 ms for the 196,608 points of a 4,096-ray step.
//
// What the design does about it. Four bodies:
// - bf16 at the proposal fields' widths (fourier_mlp_fwd_wgmma_kernel, see
//   wgmma_chain.cuh): nothing but the encoding's own arithmetic is left per
//   point. One warpgroup owns a 64-point tile and every per-point value lives
//   in registers. A thread reads the positions of its two rows straight from
//   device memory, the next tile's before this tile's arithmetic, so no tile
//   waits for memory. The encoding is made in pair order (wgmma_chain.cuh): a
//   thread computes each projection once and gets both waves from it, packed
//   as the A operand of a k-step, and the five m64n16k16 products of the
//   first layer run behind the next k-step's encoding with W_0^T (2.5 KB)
//   resident in shared memory. The epilogue stays in registers: bias, relu,
//   the rounding to bf16, then the width-1 layer as four FMAs a row and two
//   shuffles over the quad that shares a row; a warp's store is 64 contiguous
//   bytes. There is no block barrier after the staging and no activation in
//   shared memory. Blocks are small (two warpgroups, ~3 KB of shared memory)
//   and persistent, and four of them share an SM, 32 warps. The time hardly
//   depends on that shape (six shapes from 16 to 32 warps an SM, timed on an
//   H100 80GB HBM3 at 700 W, lay within 8%): what is left is the rate of the
//   encoding's own instructions, at a little under half the ALUs' peak.
//   wgmma rather than mma.sync.m16n8k16: the tensor cores are idle either
//   way, and the header, its layouts and its probe were there.
// - bf16 at the base widths (fourier_mlp_fwd_base_wgmma_kernel<TRI, HID>):
//   the field forward's base chain without the rgb chain, with HID = 2
//   hidden layers (256, 128, 128, 16) or HID = 1, (256, 128, 16),
//   sem30k-flagship2's 2-layer base. One warpgroup owns a 64-point tile with
//   no block barrier in the tile loop; x goes straight into registers; the
//   encoding, in the field's feature order, is made k-step by k-step into A
//   operands behind the running m64n128k16 product (nkt_wg_first_layer);
//   bias, relu and the bf16 rounding pack each accumulator into the next
//   layer's A operand in registers. The image of the W^T matrices (100 KB at
//   HID = 2, 70 KB at HID = 1) is staged once a block by cp.async, with the
//   biases and B beside it. The last layer's 16 columns plus their bias go
//   out as f32, unrounded, a warp's store 32 contiguous bytes per column.
//   HID = 2: blocks of two warpgroups, two blocks an SM: the shared memory
//   holds two images, and the body fits the 128 registers a thread that
//   leaves (ptxas: 122 and 124, no spills), the accumulator (64), the packed
//   activations (32) and the rest. HID = 1: one block of four warpgroups an
//   SM (108 and 113 registers, no spills). Of the shapes timed at 786,432
//   points on an H100 80GB HBM3 at 700 W, 4 x 1 took 0.162 device ms, 2 x 2
//   0.164 and 1 x 3 0.179; 2 x 3 and 3 x 2 leave 80 registers a thread,
//   fewer than the m64n128 products need (ptxas asks for 94). Its bound is
//   the encoding's f32 instructions, ~0.056 ms at those points.
// - bf16 at any other widths (fourier_mlp_fwd_mma_kernel, mma_chain.cuh):
//   WMMA tiles with activations in shared memory and four block barriers a
//   tile; at the proposal widths it needs about four times the wgmma body's
//   time, at the base widths 17 to 18 times the bound. No main path runs it.
// - f32 compute (the oracle mode): one thread per point on f32 FMAs
//   (fused_chain.cuh).
#include "mma_chain.cuh"
#include "wgmma_chain.cuh"

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
// bf16 compute at any widths: WMMA (see mma_chain.cuh)
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

// ---------------------------------------------------------------------------
// bf16 compute at the proposal fields' widths: wgmma (see wgmma_chain.cuh)
// ---------------------------------------------------------------------------

// Warpgroups per block, each on its own tiles, and blocks per SM. The body
// needs few registers (8 accumulators, two sets of positions, two sets of
// A-operand words), so 64 a thread let 4 x 2 warpgroups share an SM.
#define NKT_A_WARPGROUPS 2
#define NKT_A_BLOCKS_PER_SM 4

template <bool TRI>
__global__ void __launch_bounds__(NKT_A_WARPGROUPS * NKT_WG_THREADS, NKT_A_BLOCKS_PER_SM)
    fourier_mlp_fwd_wgmma_kernel(const float* __restrict__ x, int n, const float* __restrict__ Bm,
                                 const uint4* __restrict__ image, const float* __restrict__ wb,
                                 Chain ch, float* __restrict__ out) {
  using I = MlpImage;
  __shared__ __align__(128) unsigned char smem[I::bytes];
  nkt_mlp_stage(smem, image, wb, ch, Bm, true);
  nkt_fence_async_smem();
  __syncthreads();
  const uint32_t ws = nkt_smem_addr(smem);
  const float* fs = reinterpret_cast<const float*>(smem + I::w0_bytes);
  const float* Bs = fs + I::B;
  const WgLane L = nkt_wg_lane();
  // the thread's hidden columns 2t, 2t + 1, 8 + 2t, 9 + 2t: their bias and
  // their weight in the width-1 layer (rounded to bf16 by the staging)
  float b0[4], w1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    b0[c] = fs[I::b0 + 8 * (c / 2) + 2 * L.t + c % 2];
    w1[c] = fs[I::w1 + 8 * (c / 2) + 2 * L.t + c % 2];
  }
  const float b1 = fs[I::b1];
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  const int step = gridDim.x * NKT_A_WARPGROUPS;
  int tile = blockIdx.x * NKT_A_WARPGROUPS + threadIdx.x / NKT_WG_THREADS;
  float xa[3], xb[3];
  nkt_wg_load_x(x, n, tile, L, xa, xb);

  // no barrier from here on: each warpgroup walks its own tiles
  for (; tile < ntiles; tile += step) {
    float na[3], nb[3];  // the next tile's positions, in flight behind this tile's work
    nkt_wg_load_x(x, n, (long long)tile + step, L, na, nb);
    float acc[8];
    nkt_wg_first_layer_pairs<TRI, I::H>(acc, Bs, L.t, xa, xb, ws,
                                        [](int, const uint32_t(&)[4]) {});
    // h = bf16(relu(acc + b_0)), out = w_1 . h + b_1 in f32: the thread's four
    // columns, then the quad
    float oa = 0.0f, ob = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = 4 * (c / 2) + c % 2;
      oa = fmaf(w1[c], nkt_round_bf16(fmaxf(acc[i] + b0[c], 0.0f)), oa);
      ob = fmaf(w1[c], nkt_round_bf16(fmaxf(acc[i + 2] + b0[c], 0.0f)), ob);
    }
    oa += __shfl_xor_sync(0xffffffffu, oa, 1);
    ob += __shfl_xor_sync(0xffffffffu, ob, 1);
    oa += __shfl_xor_sync(0xffffffffu, oa, 2);
    ob += __shfl_xor_sync(0xffffffffu, ob, 2);
    // lane t = 0 stores the quad's first row, t = 1 its second: 16 lanes of a
    // warp write 64 contiguous bytes
    if (L.t < 2) {
      const long long p = (long long)tile * NKT_WG_ROWS + 16 * L.w + L.g + 8 * L.t;
      if (p < n) out[p] = (L.t ? ob : oa) + b1;
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      xa[d] = na[d];
      xb[d] = nb[d];
    }
  }
}

template <bool TRI>
static int launch_wgmma(const float* x, int n, const float* Bm, const void* image,
                        const float* wb, const Chain& ch, float* out, cudaStream_t stream) {
  constexpr int THREADS = NKT_A_WARPGROUPS * NKT_WG_THREADS;
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fourier_mlp_fwd_wgmma_kernel<TRI>, THREADS, 0)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return NKT_ERR_SMEM;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  const int want = (ntiles + NKT_A_WARPGROUPS - 1) / NKT_A_WARPGROUPS;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  fourier_mlp_fwd_wgmma_kernel<TRI><<<grid, THREADS, 0, stream>>>(
      x, n, Bm, reinterpret_cast<const uint4*>(image), wb, ch, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 compute at the field's base widths: wgmma (see wgmma_chain.cuh)
// ---------------------------------------------------------------------------

// Warpgroups per block, each on its own tiles, and blocks per SM, by the
// chain's hidden layers (see the note at the top for the shapes timed).
template <int HID>
struct ABaseShape {
  static constexpr int warpgroups = HID == 1 ? 4 : 2;
  static constexpr int blocks = HID == 1 ? 1 : 2;
};

template <bool TRI, int HID>
__global__ void __launch_bounds__(ABaseShape<HID>::warpgroups * NKT_WG_THREADS,
                                  ABaseShape<HID>::blocks)
    fourier_mlp_fwd_base_wgmma_kernel(const float* __restrict__ x, int n,
                                      const float* __restrict__ Bm,
                                      const uint4* __restrict__ image,
                                      const float* __restrict__ wb, Chain ch,
                                      float* __restrict__ out) {
  using I = BaseImage<HID>;
  constexpr int WGS = ABaseShape<HID>::warpgroups;
  extern __shared__ __align__(128) unsigned char smem[];
  nkt_base_stage<HID>(smem, image, wb, ch, Bm);
  const uint32_t ws = nkt_smem_addr(smem);
  const float* bs = reinterpret_cast<const float*>(smem + I::bytes);
  const float* Bs = bs + I::bias_floats;
  const WgLane L = nkt_wg_lane();
  // the last layer's bias at the thread's columns 2t, 2t + 1, 8 + 2t, 9 + 2t
  const float2 b_lo = *reinterpret_cast<const float2*>(bs + I::b_out + 2 * L.t);
  const float2 b_hi = *reinterpret_cast<const float2*>(bs + I::b_out + 8 + 2 * L.t);
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;

  // no barrier from here on: each warpgroup walks its own tiles
  for (int tile = blockIdx.x * WGS + threadIdx.x / NKT_WG_THREADS; tile < ntiles;
       tile += gridDim.x * WGS) {
    float xa[3], xb[3];
    nkt_wg_load_x(x, n, tile, L, xa, xb);
    uint32_t h[32];
    {
      float acc[64];
      nkt_wg_first_layer<TRI, I::H>(acc, Bs, L.t, xa, xb, ws + I::w_hid(0));
      nkt_wg_relu_pack<false>(acc, bs + I::b_hid(0), L.t, h, nullptr);
#pragma unroll
      for (int l = 1; l < HID; ++l) {
        nkt_wg_forward<8>(acc, h, ws + I::w_hid(l));
        nkt_wg_relu_pack<false>(acc, bs + I::b_hid(l), L.t, h, nullptr);
      }
    }
    float acc[8];
    nkt_wg_forward<8>(acc, h, ws + I::w_out);
    // acc[4j + e] is row a, acc[4j + 2 + e] row b, of column 8j + 2t + e
    const long long pa = (long long)tile * NKT_WG_ROWS + 16 * L.w + L.g, pb = pa + 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const size_t c = 8 * (i / 4) + 2 * L.t + i % 2;
      const float2 b = i < 4 ? b_lo : b_hi;
      const long long p = i % 4 < 2 ? pa : pb;
      if (p < n) out[c * n + p] = acc[i] + (i % 2 ? b.y : b.x);
    }
  }
}

template <bool TRI, int HID>
static int launch_base_wgmma(const float* x, int n, const float* Bm, const void* image,
                             const float* wb, const Chain& ch, float* out, cudaStream_t stream) {
  constexpr int WGS = ABaseShape<HID>::warpgroups, THREADS = WGS * NKT_WG_THREADS;
  constexpr int smem = BaseImage<HID>::smem_bytes;
  auto kernel = fourier_mlp_fwd_base_wgmma_kernel<TRI, HID>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's shared memory and L1 as shared memory: two or more images
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return NKT_ERR_SMEM;
  const int ntiles = (n + NKT_WG_ROWS - 1) / NKT_WG_ROWS;
  const int want = (ntiles + WGS - 1) / WGS;
  const int grid = want < sms * per_sm ? want : sms * per_sm;
  kernel<<<grid, THREADS, smem, stream>>>(x, n, Bm, reinterpret_cast<const uint4*>(image), wb, ch,
                                          out);
  return (int)cudaGetLastError();
}

// x (3, n) f32, Bm (3, H) f32, wb the packed chain (see fused_chain.cuh) whose
// first layer takes 2H inputs, out (dims[n_layers], n) f32; all contiguous on
// the device. f32 compute runs on FMAs. bf16 compute has three bodies, named
// by `variant`: 1 is the wgmma body for the proposal fields' widths (see
// nkt_mlp_is_flagship), and needs `image`, W_0^T as bf16 of image_bytes
// (wgmma_chain.cuh MlpImage); it rounds the rest of wb to bf16 itself, so wb
// may come unrounded. 2 is the wgmma body for the base widths (see
// nkt_mlp_base_depth: (256, 128, 16) or (256, 128, 128, 16)), and needs
// `image`, the base chain's bf16 image (BaseImage); it reads only the f32
// biases of wb. 0 is the WMMA body, which takes every shape and wants the
// weights in wb already rounded. Launches on `stream`, does not synchronise;
// returns the launch error (0 on success).
extern "C" int nkt_fourier_mlp_fwd(const float* x, int n, const float* Bm, int H, const float* wb,
                                   int wb_floats, const int* dims, int n_layers, int tri, int bf16,
                                   int variant, const void* image, int image_bytes, float* out,
                                   void* stream) {
  Chain ch;
  const int packed = nkt_chain_from_dims(&ch, dims, n_layers);
  if (packed < 0) return packed;
  if (packed != wb_floats || dims[0] != 2 * H) return NKT_ERR_PACKING;
  const bool proposal = variant == 1 && nkt_mlp_is_flagship(ch, H) &&
                        image_bytes == MlpImage::w0_bytes;
  const int depth = variant == 2 ? nkt_mlp_base_depth(ch, H) : 0;
  const bool base =
      depth > 0 && image_bytes == (depth == 1 ? BaseImage<1>::bytes : BaseImage<2>::bytes);
  if (variant != 0 && !(bf16 && (proposal || base))) return NKT_ERR_VARIANT;
  if (n == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (variant == 1)
    return tri ? launch_wgmma<true>(x, n, Bm, image, wb, ch, out, s)
               : launch_wgmma<false>(x, n, Bm, image, wb, ch, out, s);
#define NKT_BASE(T, D) launch_base_wgmma<T, D>(x, n, Bm, image, wb, ch, out, s)
  if (variant == 2 && depth == 1) return tri ? NKT_BASE(true, 1) : NKT_BASE(false, 1);
  if (variant == 2) return tri ? NKT_BASE(true, 2) : NKT_BASE(false, 2);
#undef NKT_BASE
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
