// A one-warpgroup test bench for the wgmma wrappers and shared-memory
// layouts of wgmma_chain.cuh: one (64, N) = A (64, 16 * ksteps) . B product
// whose operand placement (start, k-step, leading and stride byte offsets,
// trans flags) the caller states, so that a test on the card can hold the
// layout rules the kernels rely on against a plain matrix product.
#include "wgmma_chain.cuh"

template <int R, int TA, int TB>
__device__ __forceinline__ void probe_body(const float* a_rows, int lda, uint32_t a_addr,
                                           int a_step, int a_lead, int a_stride, uint32_t b_addr,
                                           int b_step, int b_lead, int b_stride, int ksteps,
                                           int a_in_regs, float* out) {
  constexpr int N = 2 * R;
  const WgLane L = nkt_wg_lane();
  const int ra = 16 * L.w + L.g, rb = ra + 8;
  float acc[R];
  for (int ks = 0; ks < ksteps; ++ks) {
    const uint64_t bd = nkt_wg_desc(b_addr + ks * b_step, b_lead, b_stride);
    nkt_wg_fence();
    if (a_in_regs) {
      const float* pa = a_rows + ra * lda + 16 * ks + 2 * L.t;
      const float* pb = a_rows + rb * lda + 16 * ks + 2 * L.t;
      nkt_wgmma_rs<TB>(acc, nkt_pack_bf16(pa[0], pa[1]), nkt_pack_bf16(pb[0], pb[1]),
                       nkt_pack_bf16(pa[8], pa[9]), nkt_pack_bf16(pb[8], pb[9]), bd, ks > 0);
    } else {
      if constexpr (R != 16)
        nkt_wgmma_ss<TA, TB>(acc, nkt_wg_desc(a_addr + ks * a_step, a_lead, a_stride), bd, ks > 0);
    }
    nkt_wg_commit();
    nkt_wg_wait<0>();
  }
  nkt_wg_settle(acc);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = 8 * j + 2 * L.t;
    out[ra * N + c] = acc[4 * j];
    out[ra * N + c + 1] = acc[4 * j + 1];
    out[rb * N + c] = acc[4 * j + 2];
    out[rb * N + c + 1] = acc[4 * j + 3];
  }
}

__global__ void __launch_bounds__(NKT_WG_THREADS)
    wgmma_probe_kernel(const float* a_rows, int lda, const uint4* a_image, int a_bytes, int a_start,
                       int a_step, int a_lead, int a_stride, const uint4* b_image, int b_bytes,
                       int b_start, int b_step, int b_lead, int b_stride, int ksteps, int n,
                       int trans_a, int trans_b, float* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* as = reinterpret_cast<uint4*>(smem);
  uint4* bs = reinterpret_cast<uint4*>(smem + a_bytes);
  for (int i = threadIdx.x; i < a_bytes / 16; i += blockDim.x) as[i] = a_image[i];
  for (int i = threadIdx.x; i < b_bytes / 16; i += blockDim.x) bs[i] = b_image[i];
  nkt_fence_async_smem();
  __syncthreads();
  const uint32_t a_addr = nkt_smem_addr(as) + a_start, b_addr = nkt_smem_addr(bs) + b_start;
  const int a_in_regs = a_bytes == 0;
#define PROBE(R, TA, TB)                                                                          \
  probe_body<R, TA, TB>(a_rows, lda, a_addr, a_step, a_lead, a_stride, b_addr, b_step, b_lead,    \
                        b_stride, ksteps, a_in_regs, out)
#define PROBE_N(TA, TB)                  \
  switch (n) {                           \
    case 16: PROBE(8, TA, TB); break;    \
    case 32: PROBE(16, TA, TB); break;   \
    case 64: PROBE(32, TA, TB); break;   \
    case 128: PROBE(64, TA, TB); break;  \
  }
  if (trans_a) {
    if (trans_b) { PROBE_N(1, 1) } else { PROBE_N(1, 0) }
  } else {
    if (trans_b) { PROBE_N(0, 1) } else { PROBE_N(0, 0) }
  }
#undef PROBE_N
#undef PROBE
}

// a_rows (64, lda) f32 is the A operand when a_bytes == 0 (rounded to bf16
// into registers); otherwise a_image (a_bytes of bf16 in the caller's layout)
// is copied to shared memory and read through a descriptor. b_image likewise.
// n in {16, 32, 64, 128} (32 only with A in registers); out (64, n) f32.
extern "C" int nkt_wgmma_probe(const float* a_rows, int lda, const void* a_image, int a_bytes,
                               int a_start, int a_step, int a_lead, int a_stride,
                               const void* b_image, int b_bytes, int b_start, int b_step,
                               int b_lead, int b_stride, int ksteps, int n, int trans_a,
                               int trans_b, float* out, void* stream) {
  if ((n != 16 && n != 32 && n != 64 && n != 128) || (n == 32 && a_bytes != 0) ||
      a_bytes % 16 || b_bytes % 16)
    return NKT_ERR_PACKING;
  const size_t smem = (size_t)a_bytes + b_bytes;
  if (smem > 232448) return NKT_ERR_SMEM;
  cudaError_t err = cudaFuncSetAttribute(wgmma_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgmma_probe_kernel<<<1, NKT_WG_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      a_rows, lda, reinterpret_cast<const uint4*>(a_image), a_bytes, a_start, a_step, a_lead,
      a_stride, reinterpret_cast<const uint4*>(b_image), b_bytes, b_start, b_step, b_lead,
      b_stride, ksteps, n, trans_a, trans_b, out);
  return (int)cudaGetLastError();
}
