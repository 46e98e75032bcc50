// Warpgroup MLP chain on Hopper's wgmma (m64nNk16, bf16 inputs, f32
// accumulation in registers), for all four kernels at the flagship widths:
// the two field kernels (fourier_field_fwd.cu, fourier_field_bwd.cu, see
// FieldImage), the two fused-MLP kernels at the proposal fields' widths
// (fourier_mlp_fwd.cu, fourier_mlp_bwd.cu, see MlpImage) and the same two at
// the base widths, a base chain of one or two hidden layers alone (see
// BaseImage).
//
// One warpgroup (4 warps) owns a tile of 64 points, the M dimension of every
// product. Thread (w, g, t) = (warp in the group, lane / 4, lane % 4) holds
// of a (64, N) f32 accumulator the rows 16w + g and 16w + g + 8 and, of every
// 8-column chunk j, the columns 8j + 2t and 8j + 2t + 1:
//   d[4j + 0], d[4j + 1]   row 16w + g
//   d[4j + 2], d[4j + 3]   row 16w + g + 8
// A (64, 16) bf16 A operand in registers is 4 words of two bf16 each with the
// same rows and the columns 2t, 2t + 1 (words 0, 1: the two rows) and 2t + 8,
// 2t + 9 (words 2, 3). So two neighbouring chunks of an accumulator, rounded
// and packed in pairs, ARE the A operand of the next layer's k-step: the
// activations pass from layer to layer in registers, with no shuffle and no
// shared memory.
//
// Shared-memory operands use the canonical layout without swizzle: a matrix
// X[r][c] of bf16 with c contiguous is cut into core matrices of 8 rows by 8
// columns (128 contiguous bytes, 16 bytes a row), core (c / 8, r / 8) at
// ((c / 8) * (R / 8) + r / 8) * 128 bytes for R rows. The descriptor's two
// strides are the byte distance between neighbouring cores along the
// contraction (K) dimension ("leading") and along the M / N dimension
// ("stride"), whichever of r and c those are; a transposed operand only sets
// the instruction's trans flag.
// - Weights are held as W^T, [out][in] with in contiguous: the forward's B
//   operand (K = in) is K-major, trans 0; the backward's W . dh product
//   (K = out, N = in) reads the same bytes with trans 1.
// - A tile of per-point rows [point][feature], feature contiguous, is an
//   M-major A operand (M = feature) and an N-major B operand (N = feature) of
//   the weight-gradient products, which contract over points: trans 1 both.
#pragma once

#include "fused_chain.cuh"

#define NKT_WG_ROWS 64      // points per warpgroup tile
#define NKT_WG_THREADS 128  // one warpgroup

struct WgLane {
  int w, g, t;
};

__device__ __forceinline__ WgLane nkt_wg_lane() {
  const int i = threadIdx.x % NKT_WG_THREADS;
  return WgLane{i / 32, (i % 32) / 4, i % 4};
}

__device__ __forceinline__ uint32_t nkt_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory matrix descriptor without swizzle; all arguments in bytes.
__device__ __forceinline__ uint64_t nkt_wg_desc(uint32_t addr, uint32_t leading, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

__device__ __forceinline__ void nkt_wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void nkt_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void nkt_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Writes through the generic proxy (plain stores to shared memory) become
// visible to wgmma's reads; follow it with the barrier that orders them.
__device__ __forceinline__ void nkt_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Asynchronous copies from device to shared memory (16 bytes, or 4 bytes
// that become zero when !valid), grouped by commit and awaited by group.
__device__ __forceinline__ void nkt_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(nkt_smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void nkt_cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(nkt_smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void nkt_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void nkt_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait that
// completes the products writing it.
template <int R>
__device__ __forceinline__ void nkt_wg_settle(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t nkt_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float nkt_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A barrier of one warpgroup only (named barrier 1 + wg; 0 is the block's).
__device__ __forceinline__ void nkt_wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(NKT_WG_THREADS) : "memory");
}

// One warpgroup: its packed rows `a` (A-operand words, WIDTH / 4 a thread) as
// a [point][feature] tile of 64 points by WIDTH features in the core layout
// at `tile`, in shared or device memory. A warp's store of one word is one
// core matrix, 128 contiguous bytes.
template <int WIDTH>
__device__ __forceinline__ void nkt_wg_put_tile(uint32_t* tile, const WgLane& L,
                                                const uint32_t* a) {
#pragma unroll
  for (int j = 0; j < WIDTH / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) tile[(j * 8 + 2 * L.w + r) * 32 + L.g * 4 + L.t] = a[2 * j + r];
}

// D (64, 16) f32 += A (64, 16) bf16 from registers . B (16, 16) bf16 in shared memory.
template <int TB>
__device__ __forceinline__ void nkt_wgmma_rs(float (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(bdesc), "r"(scale_d), "n"(TB));
}

// D (64, 32) f32 += A (64, 16) bf16 from registers . B (16, 32) bf16 in shared memory.
template <int TB>
__device__ __forceinline__ void nkt_wgmma_rs(float (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(bdesc), "r"(scale_d), "n"(TB));
}

// D (64, 64) f32 += A (64, 16) bf16 from registers . B (16, 64) bf16 in shared memory.
template <int TB>
__device__ __forceinline__ void nkt_wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(bdesc), "r"(scale_d), "n"(TB));
}

// D (64, 128) f32 += A (64, 16) bf16 from registers . B (16, 128) bf16 in shared memory.
template <int TB>
__device__ __forceinline__ void nkt_wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(bdesc), "r"(scale_d), "n"(TB));
}

// D (64, 16) f32 += A (64, 16) . B (16, 16), both bf16 in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void nkt_wgmma_ss(float (&d)[8], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64, 64) f32 += A (64, 16) . B (16, 64), both bf16 in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void nkt_wgmma_ss(float (&d)[32], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64, 128) f32 += A (64, 16) . B (16, 128), both bf16 in shared memory.
template <int TA, int TB>
__device__ __forceinline__ void nkt_wgmma_ss(float (&d)[64], uint64_t adesc, uint64_t bdesc,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(adesc), "l"(bdesc), "r"(scale_d), "n"(TA), "n"(TB));
}

// One layer's product for the warpgroup's tile: acc (64, N) = A . W with A
// (64, 16 * KSTEPS) in registers (a[4 * ks ..] is k-step ks) and the weights
// W^T [N][K] in the core layout at w_addr. TB = 0: acc = A . W (K = in);
// TB = 1: the same bytes read as the (K = out, N = in) operand of dh . W^T,
// for the NW inputs from in0 on, `rows` being the matrix's out count.
// Starts the products, commits and waits: the accumulator is readable on return.
template <int KSTEPS, int R>
__device__ __forceinline__ void nkt_wg_forward(float (&acc)[R], const uint32_t* a,
                                               uint32_t w_addr) {
  constexpr int N = 2 * R;
  nkt_wg_fence();
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    nkt_wgmma_rs<0>(acc, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                    nkt_wg_desc(w_addr + ks * 32 * N, 16 * N, 128), ks > 0);
  nkt_wg_commit();
  nkt_wg_wait<0>();
  nkt_wg_settle(acc);
}

template <int KSTEPS, int R>
__device__ __forceinline__ void nkt_wg_backward(float (&acc)[R], const uint32_t* a,
                                                uint32_t w_addr, int rows, int in0) {
  nkt_wg_fence();
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
    nkt_wgmma_rs<1>(acc, a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                    nkt_wg_desc(w_addr + in0 * 2 * rows + ks * 256, 128, 16 * rows), ks > 0);
  nkt_wg_commit();
  nkt_wg_wait<0>();
  nkt_wg_settle(acc);
}

// The Fourier encoding of the thread's two points as the A operand of k-step
// ks of the first layer: features [16 ks, 16 ks + 16) of [s(u); c(u)] with
// u = B^T x in f32, Bs (3, H) in shared memory.
template <bool TRI, int H>
__device__ __forceinline__ void nkt_wg_encode(const float* Bs, int ks, int t, const float (&xa)[3],
                                              const float (&xb)[3], uint32_t (&a)[4]) {
  const bool cos_half = ks >= H / 16;
  const int h0 = (ks % (H / 16)) * 16 + 2 * t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int h = h0 + 8 * half;
    const float2 b0 = *reinterpret_cast<const float2*>(Bs + h);
    const float2 b1 = *reinterpret_cast<const float2*>(Bs + H + h);
    const float2 b2 = *reinterpret_cast<const float2*>(Bs + 2 * H + h);
    float v[4];  // (row a, h), (row a, h + 1), (row b, h), (row b, h + 1)
    v[0] = fmaf(b2.x, xa[2], fmaf(b1.x, xa[1], b0.x * xa[0]));
    v[1] = fmaf(b2.y, xa[2], fmaf(b1.y, xa[1], b0.y * xa[0]));
    v[2] = fmaf(b2.x, xb[2], fmaf(b1.x, xb[1], b0.x * xb[0]));
    v[3] = fmaf(b2.y, xb[2], fmaf(b1.y, xb[1], b0.y * xb[0]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (TRI) {
        v[i] = cos_half ? nkt_tri_c(v[i]) : nkt_tri_s(v[i]);
      } else {
        float s, c;
        sincosf(v[i], &s, &c);
        v[i] = cos_half ? c : s;
      }
    }
    a[2 * half] = nkt_pack_bf16(v[0], v[1]);
    a[2 * half + 1] = nkt_pack_bf16(v[2], v[3]);
  }
}

// First layer of the base chain: acc (64, N) = enc(x) . W_0, the encoding
// made k-step by k-step in two alternating register sets, so that one step's
// product runs while the next step's encoding is computed.
template <bool TRI, int H, int R>
__device__ __forceinline__ void nkt_wg_first_layer(float (&acc)[R], const float* Bs, int t,
                                                   const float (&xa)[3], const float (&xb)[3],
                                                   uint32_t w_addr) {
  constexpr int N = 2 * R, KSTEPS = 2 * H / 16;
  uint32_t a[2][4];
  nkt_wg_encode<TRI, H>(Bs, 0, t, xa, xb, a[0]);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    nkt_wg_fence();
    nkt_wgmma_rs<0>(acc, a[ks % 2][0], a[ks % 2][1], a[ks % 2][2], a[ks % 2][3],
                    nkt_wg_desc(w_addr + ks * 32 * N, 16 * N, 128), ks > 0);
    nkt_wg_commit();
    if (ks + 1 < KSTEPS) {
      nkt_wg_wait<1>();  // step ks - 1 has read the set written next
      nkt_wg_encode<TRI, H>(Bs, ks + 1, t, xa, xb, a[(ks + 1) % 2]);
    }
  }
  nkt_wg_wait<0>();
  nkt_wg_settle(acc);
}

// Epilogue of a hidden layer: a = bf16(relu(acc + bias)) packed as the next
// layer's A operand; with MASK, bit i of mask[i / 32] is set where
// acc[i] + bias > 0.
template <bool MASK, int R>
__device__ __forceinline__ void nkt_wg_relu_pack(const float (&acc)[R], const float* bias, int t,
                                                 uint32_t* a, uint32_t* mask) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < (R + 31) / 32; ++i) mask[i] = 0;
  }
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    const float v0 = acc[4 * j] + b.x, v1 = acc[4 * j + 1] + b.y;
    const float v2 = acc[4 * j + 2] + b.x, v3 = acc[4 * j + 3] + b.y;
    if (MASK) {
      mask[(4 * j) / 32] |= (uint32_t)(v0 > 0.0f) << ((4 * j) % 32) |
                            (uint32_t)(v1 > 0.0f) << ((4 * j + 1) % 32) |
                            (uint32_t)(v2 > 0.0f) << ((4 * j + 2) % 32) |
                            (uint32_t)(v3 > 0.0f) << ((4 * j + 3) % 32);
    }
    a[2 * j] = nkt_pack_bf16(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
    a[2 * j + 1] = nkt_pack_bf16(fmaxf(v2, 0.0f), fmaxf(v3, 0.0f));
  }
}

// Per-point feats of the thread's two rows as A operands: k-step s holds
// feats [16 s, 16 s + 16) (bf16, zeros past the ragged edge).
template <int FSTEPS>
__device__ __forceinline__ void nkt_wg_load_feats(const float* __restrict__ feats, int n,
                                                  long long pa, long long pb, int t,
                                                  uint32_t (&a)[4 * FSTEPS]) {
#pragma unroll
  for (int s = 0; s < FSTEPS; ++s)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t f = 16 * s + 8 * half + 2 * t;
      const float a0 = pa < n ? feats[f * n + pa] : 0.0f, a1 = pa < n ? feats[(f + 1) * n + pa] : 0.0f;
      const float b0 = pb < n ? feats[f * n + pb] : 0.0f, b1 = pb < n ? feats[(f + 1) * n + pb] : 0.0f;
      a[4 * s + 2 * half] = nkt_pack_bf16(a0, a1);
      a[4 * s + 2 * half + 1] = nkt_pack_bf16(b0, b1);
    }
}

// Epilogue of the base chain's last layer: acc (64, 16) + bias is
// [sigma_raw, geo_0..14]. Packs it as k-step 0 of the rgb chain's input with
// column 0 zeroed (that weight row is zero, and sigma_raw may not be finite in
// bf16); the thread with t == 0 gets its two rows' sigma_raw.
__device__ __forceinline__ void nkt_wg_base_out(const float (&acc)[8], const float* bias, int t,
                                                uint32_t* rgb_in, float* sigma_a, float* sigma_b) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    float v0 = acc[4 * j] + b.x, v2 = acc[4 * j + 2] + b.x;
    const float v1 = acc[4 * j + 1] + b.y, v3 = acc[4 * j + 3] + b.y;
    if (j == 0) {
      *sigma_a = v0;
      *sigma_b = v2;
      if (t == 0) v0 = v2 = 0.0f;
    }
    rgb_in[2 * j] = nkt_pack_bf16(v0, v1);
    rgb_in[2 * j + 1] = nkt_pack_bf16(v2, v3);
  }
}

// The base chain's weight image, H = 128, dims (256, 128, ..., 128, 16) with
// HID hidden layers of 128 (2: the nerfacto field's base, 3 layers; 1: the
// 2-layer base of sem30k-flagship2's split field, (256, 128, 16)): its W^T
// matrices in the core layout, one after another (the host builds it, see
// ops/fused_field.py `_chain_image_index`), and the places of its biases in
// shared memory. HID = 2 is the first part of FieldImage; the fused-MLP
// kernels' base-width bodies hold either alone.
template <int HID>
struct BaseImage {
  static_assert(HID == 1 || HID == 2, "the base chain has one or two hidden layers");
  static constexpr int H = 128;
  // W_l^T of layer l < HID: [128][256] for l = 0, [128][128] after it
  __host__ __device__ static constexpr int w_hid(int l) {
    return l == 0 ? 0 : 128 * 256 * 2 + (l - 1) * 128 * 128 * 2;
  }
  static constexpr int w_out = 128 * 256 * 2 + (HID - 1) * 128 * 128 * 2;  // [16][128]
  static constexpr int bytes = w_out + 16 * 128 * 2;
  // biases, floats: layer l's at 128 l, the last layer's 16 behind them
  __host__ __device__ static constexpr int b_hid(int l) { return 128 * l; }
  static constexpr int b_out = 128 * HID, bias_floats = b_out + 16;
  // shared memory of a block: the image, the biases, then B (3, H)
  static constexpr int smem_bytes = bytes + (bias_floats + 3 * H) * 4;
};

// The flagship field's weight image: the base chain's (BaseImage), then the
// rgb chain's three W^T matrices in the core layout (the host builds it, see
// ops/fused_field.py `_weight_image`), and the places of the padded biases in
// shared memory. KR is the rgb chain's padded input width: column 0 is
// sigma_raw's place (a zero weight row), 1..15 geo, 16.. the per-point feats.
template <int KR>
struct FieldImage {
  using Base = BaseImage<2>;
  static constexpr int H = Base::H;
  static constexpr int w_b0 = Base::w_hid(0), w_b1 = Base::w_hid(1), w_b2 = Base::w_out;
  static constexpr int w_r0 = Base::bytes;          // [64][KR]
  static constexpr int w_r1 = w_r0 + 64 * KR * 2;  // [64][64]
  static constexpr int w_r2 = w_r1 + 64 * 64 * 2;  // [16][64]
  static constexpr int bytes = w_r2 + 16 * 64 * 2;
  // biases, floats
  static constexpr int b_b0 = Base::b_hid(0), b_b1 = Base::b_hid(1), b_b2 = Base::b_out;
  static constexpr int b_r0 = Base::bias_floats, b_r1 = b_r0 + 64, b_r2 = b_r1 + 64;
  static constexpr int bias_floats = b_r2 + 16;
};

// True when the two chains have the widths FieldImage is written for.
static inline bool nkt_field_is_flagship(const Chain& base, const Chain& rgb, int H, int F) {
  return H == 128 && base.n_layers == 3 && base.dims[0] == 256 && base.dims[1] == 128 &&
         base.dims[2] == 128 && base.dims[3] == 16 && rgb.n_layers == 3 &&
         (F == 16 || F == 48) && rgb.dims[0] == 15 + F && rgb.dims[1] == 64 &&
         rgb.dims[2] == 64 && rgb.dims[3] == 3;
}

// Device, whole block: the weight image, the biases (padded with zeros) and B
// into shared memory at smem, smem + bytes and after the biases. The caller
// follows it with nkt_fence_async_smem() and a block barrier.
template <int KR>
__device__ __forceinline__ void nkt_field_stage(unsigned char* smem, const uint4* image,
                                                const float* base_wb, const Chain& base,
                                                const float* rgb_wb, const Chain& rgb,
                                                const float* Bm) {
  using I = FieldImage<KR>;
  uint4* ws = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < I::bytes / 16; i += blockDim.x) ws[i] = image[i];
  float* bs = reinterpret_cast<float*>(smem + I::bytes);
  const int off[6] = {I::b_b0, I::b_b1, I::b_b2, I::b_r0, I::b_r1, I::b_r2};
  const int end[6] = {I::b_b1, I::b_b2, I::b_r0, I::b_r1, I::b_r2, I::bias_floats};
  for (int l = 0; l < 6; ++l) {
    const Chain& c = l < 3 ? base : rgb;
    const float* wb = l < 3 ? base_wb : rgb_wb;
    const int dout = c.dims[l % 3 + 1];
    for (int i = threadIdx.x; i < end[l] - off[l]; i += blockDim.x)
      bs[off[l] + i] = i < dout ? wb[c.b_off[l % 3] + i] : 0.0f;
  }
  float* Bs = bs + I::bias_floats;
  for (int i = threadIdx.x; i < 3 * I::H; i += blockDim.x) Bs[i] = Bm[i];
}

// The number of hidden layers of 128 (HID of BaseImage) when the chain is a
// base chain BaseImage is written for, H = 128, (256, 128, 16) or (256, 128,
// 128, 16); else 0.
static inline int nkt_mlp_base_depth(const Chain& ch, int H) {
  const int hid = ch.n_layers - 1;
  if (H != 128 || hid < 1 || hid > 2 || ch.dims[0] != 256 || ch.dims[hid + 1] != 16) return 0;
  for (int l = 1; l <= hid; ++l)
    if (ch.dims[l] != 128) return 0;
  return hid;
}

// Device, whole block: the base image into shared memory at smem by
// cp.async, its biases from the packed chain wb and B (3, H) behind it; ends
// with the block barrier that makes all of it visible to wgmma.
template <int HID>
__device__ __forceinline__ void nkt_base_stage(unsigned char* smem, const uint4* image,
                                               const float* wb, const Chain& ch,
                                               const float* Bm) {
  using I = BaseImage<HID>;
  uint4* ws = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < I::bytes / 16; i += blockDim.x) nkt_cp_async16(ws + i, image + i);
  nkt_cp_commit();
  float* bs = reinterpret_cast<float*>(smem + I::bytes);
  for (int l = 0; l <= HID; ++l) {
    const int off = l < HID ? I::b_hid(l) : I::b_out, width = l < HID ? 128 : 16;
    for (int i = threadIdx.x; i < width; i += blockDim.x) bs[off + i] = wb[ch.b_off[l] + i];
  }
  float* Bs = bs + I::bias_floats;
  for (int i = threadIdx.x; i < 3 * I::H; i += blockDim.x) Bs[i] = Bm[i];
  nkt_cp_wait<0>();
  nkt_fence_async_smem();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The proposal field's chain, H = 40, dims (80, 16, 1)
// ---------------------------------------------------------------------------

// The encoding in pair order. H = 40 is no multiple of 16, so the split of
// nkt_wg_encode (s in the first k-steps, c in the last) would fall inside a
// k-step. The order of the 2H features along K is free as long as W_0's rows
// follow it, so k-step ks holds in its columns 0..7 the s and in its columns
// 8..15 the c of the frequencies [8 ks, 8 ks + 8): H / 8 k-steps, and the
// thread that holds s(u) of a frequency also holds c(u), so each projection
// u = B^T x is computed once. Column k of this order is feature
// nkt_mlp_pair_feature(k) of [s; c] (ops/fused_field.py `_mlp_k_order`).
__host__ __device__ constexpr int nkt_mlp_pair_feature(int k, int H) {
  return k % 16 < 8 ? 8 * (k / 16) + k % 16 : H + 8 * (k / 16) + k % 16 - 8;
}

// k-step ks of the encoding of the thread's two points in pair order, Bs
// (3, H) in shared memory: a[0], a[1] the s of frequencies 8 ks + 2t, + 1 for
// the two rows, a[2], a[3] their c.
template <bool TRI, int H>
__device__ __forceinline__ void nkt_wg_encode_pairs(const float* Bs, int ks, int t,
                                                    const float (&xa)[3], const float (&xb)[3],
                                                    uint32_t (&a)[4]) {
  const int h = 8 * ks + 2 * t;
  const float2 b0 = *reinterpret_cast<const float2*>(Bs + h);
  const float2 b1 = *reinterpret_cast<const float2*>(Bs + H + h);
  const float2 b2 = *reinterpret_cast<const float2*>(Bs + 2 * H + h);
  float u[4];  // (row a, h), (row a, h + 1), (row b, h), (row b, h + 1)
  u[0] = fmaf(b2.x, xa[2], fmaf(b1.x, xa[1], b0.x * xa[0]));
  u[1] = fmaf(b2.y, xa[2], fmaf(b1.y, xa[1], b0.y * xa[0]));
  u[2] = fmaf(b2.x, xb[2], fmaf(b1.x, xb[1], b0.x * xb[0]));
  u[3] = fmaf(b2.y, xb[2], fmaf(b1.y, xb[1], b0.y * xb[0]));
  float s[4], c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (TRI) {
      s[i] = nkt_tri_s(u[i]);
      c[i] = nkt_tri_c(u[i]);
    } else {
      sincosf(u[i], &s[i], &c[i]);
    }
  }
  a[0] = nkt_pack_bf16(s[0], s[1]);
  a[1] = nkt_pack_bf16(s[2], s[3]);
  a[2] = nkt_pack_bf16(c[0], c[1]);
  a[3] = nkt_pack_bf16(c[2], c[3]);
}

// First layer of a chain with 16 hidden units on the pair-order encoding:
// acc (64, 16) = enc(x) . W_0, W_0^T [16][2H] in the core layout at w_addr
// with its columns in pair order. As nkt_wg_first_layer, one k-step's product
// runs while the next k-step's encoding is computed; keep(ks, a) sees every
// k-step's A operand once it is made (the backward stores it).
template <bool TRI, int H, class Keep>
__device__ __forceinline__ void nkt_wg_first_layer_pairs(float (&acc)[8], const float* Bs, int t,
                                                         const float (&xa)[3],
                                                         const float (&xb)[3], uint32_t w_addr,
                                                         const Keep& keep) {
  constexpr int KSTEPS = H / 8;
  uint32_t a[2][4];
  nkt_wg_encode_pairs<TRI, H>(Bs, 0, t, xa, xb, a[0]);
  keep(0, a[0]);
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    nkt_wg_fence();
    nkt_wgmma_rs<0>(acc, a[ks % 2][0], a[ks % 2][1], a[ks % 2][2], a[ks % 2][3],
                    nkt_wg_desc(w_addr + ks * 512, 256, 128), ks > 0);
    nkt_wg_commit();
    if (ks + 1 < KSTEPS) {
      nkt_wg_wait<1>();  // step ks - 1 has read the set written next
      nkt_wg_encode_pairs<TRI, H>(Bs, ks + 1, t, xa, xb, a[(ks + 1) % 2]);
      keep(ks + 1, a[(ks + 1) % 2]);
    }
  }
  nkt_wg_wait<0>();
  nkt_wg_settle(acc);
}

// What a block of the two proposal-field kernels holds in shared memory:
// W_0^T [16][80] as bf16 in the core layout with its columns in pair order
// (the host builds it, see ops/fused_field.py `_mlp_image`), then floats:
// b_0 (16), w_1 (16), b_1 and B (3, 40).
struct MlpImage {
  static constexpr int H = 40, HID = 16;
  static constexpr int w0_bytes = HID * 2 * H * 2;
  static constexpr int b0 = 0, w1 = 16, b1 = 32, B = 36, floats = B + 3 * H;
  static constexpr int bytes = (w0_bytes + floats * 4 + 127) / 128 * 128;
};

// True when the chain has the widths MlpImage is written for.
static inline bool nkt_mlp_is_flagship(const Chain& ch, int H) {
  return H == MlpImage::H && ch.n_layers == 2 && ch.dims[0] == 2 * MlpImage::H &&
         ch.dims[1] == MlpImage::HID && ch.dims[2] == 1;
}

// Device, whole block: the image, the f32 parts of the packed chain and B
// into shared memory at smem; w_1 rounded to bf16 when round_w1 (the forward's
// operand; the backward reads it unrounded). The caller follows it with
// nkt_fence_async_smem() and a block barrier.
__device__ __forceinline__ void nkt_mlp_stage(unsigned char* smem, const uint4* image,
                                              const float* wb, const Chain& ch, const float* Bm,
                                              bool round_w1) {
  using I = MlpImage;
  uint4* ws = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < I::w0_bytes / 16; i += blockDim.x) ws[i] = image[i];
  float* fs = reinterpret_cast<float*>(smem + I::w0_bytes);
  for (int i = threadIdx.x; i < I::HID; i += blockDim.x) {
    fs[I::b0 + i] = wb[ch.b_off[0] + i];
    const float w = wb[ch.w_off[1] + i];
    fs[I::w1 + i] = round_w1 ? nkt_round_bf16(w) : w;
  }
  if (threadIdx.x == 0) fs[I::b1] = wb[ch.b_off[1]];
  for (int i = threadIdx.x; i < 3 * I::H; i += blockDim.x) fs[I::B + i] = Bm[i];
}

// The positions of the thread's two rows of `tile`, zeros past the ragged
// edge and past the last tile.
__device__ __forceinline__ void nkt_wg_load_x(const float* __restrict__ x, int n, long long tile,
                                              const WgLane& L, float (&xa)[3], float (&xb)[3]) {
  const long long pa = tile * NKT_WG_ROWS + 16 * L.w + L.g, pb = pa + 8;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    xa[d] = pa < n ? x[(size_t)d * n + pa] : 0.0f;
    xb[d] = pb < n ? x[(size_t)d * n + pb] : 0.0f;
  }
}
