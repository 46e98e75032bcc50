// The multiresolution hash grid of the non-fused path, for Hopper (sm_90a):
// one launch a field for the forward over all its levels, one for the
// backward's per-entry cotangents and the positions' gradient.
//
// Replaces no Pallas kernel: the JAX package evaluates the grid with XLA
// (nerf_kbs_tpu/ops/encoding.py hash_encoding_apply: a jnp.take of the 8
// corners of every level and a weighted sum). The port's plain version
// (ops/encoding.py hash_encoding_plain) spends ~45 PyTorch operations a
// level on it (stacks of corners and weights, outer products, the index,
// casts, one gather a level, the weighted sum, a cat) and autograd walks all
// of them back where the positions carry a gradient. Here a thread takes one
// point through every level.
//
// Table: the parameter is flat and feature-major, entry (f, level, slot) at
// f * L * T + level * T + slot; the kernels read the entry-major copy
// (L * T, F) the wrapper makes (ops/hash_grid.py), a corner's F features in
// one 4-, 8- or 16-byte load. A corner's global column is its key,
// level * T + slot: a dense level ((res + 1)^3 <= T) is indexed
// cx + r1 (cy + r1 cz), r1 = res + 1, the key clamped to L * T - 1 (a point
// on the far face reaches corner res + 1, weight 0, past the level's T
// slots and, at the last levels, past the table); a finer level by the
// spatial hash (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) masked by
// T - 1, in uint32. Corner c sits at offset (c & 1, (c >> 1) & 1,
// (c >> 2) & 1) from the cell's origin.
//
// 1. Forward (nkt_hash_grid_fwd). Position clamped into [0, 1], then per
//    level: ps = p * res, the cell floor(ps), frac = ps - floor(ps), the
//    axis weights (1 - frac, frac), corner weight (wx * wy) * wz, and
//    enc[n, l, f] = sum over c ascending of t[key_c, f] * w_c, each product
//    and add rounded on its own (no fused multiply-add): the plain version's
//    arithmetic, whose sum over the corners ops/hash_grid.py writes out in
//    the same order. enc (N, L * F), level-major. With `keys`, it also
//    writes the corners' keys (L, N, 8) int32, level-major, which the
//    backward sorts.
// 2. Backward (nkt_hash_grid_bwd), from the encoding's cotangent g (N, L * F)
//    and the positions:
//    - with `vals`: each entry's cotangent g[n, l, f] * w[n, l, c] as
//      (L, N, 8, F), the keys' order, F features of an entry together (the
//      by-key sum reads two interleaved rows a pair a load);
//    - with `dpos`: the positions' gradient (N, 3). Per level the corner's
//      dot s_c = sum over f of g_f * t[key_c, f]; per axis d the cell
//      coordinate's gradient sum over c ascending of +-s_c times the other
//      two axes' weights (+ at offset 1, - at offset 0; the other weights
//      multiplied in axis order); times res, summed over the levels
//      ascending; then times 1 inside (0, 1), 0.5 at exactly 0 or 1 (the
//      clamp's minimum or maximum splits it there), 0 outside.
//    The table's gradient is then one stable radix sort of the keys and one
//    by-key sum of `vals` through the permutation (csrc/segment_sum.cu): a
//    fixed order, no atomics.
//
// What bounds it: bytes and the corners' random reads. The hash-train-16k
// step's field (786,432 points x 16 levels) reads 8 entries of 8 bytes a
// point-level (one 32-byte sector each where they miss L2) and writes 8
// bytes of encoding and 32 of keys; the backward reads 8 bytes of
// cotangent and writes 64 of entry cotangents a point-level (the positions'
// gradient adds the 8 reads again). No shared memory, no atomics; a block
// of 256 points, one thread a point, the levels in turn.
//
// Every array contiguous on the device. Every entry point launches on
// `stream`, does not synchronise, and returns the launch error (0 on
// success) or a negative code for arguments it does not take.

#include <cuda_runtime.h>

#define NKT_HASH_ERR_SHAPE (-201)
#define NKT_HASH_ERR_FEATURES (-202)
#define NKT_HASH_ERR_OUTPUTS (-203)

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;

struct Levels {
  int res[kMaxLevels];
  unsigned dense;  // bit l: level l indexed densely
  int count;       // L
  int log2_t;      // T = 2^log2_t
};

// One point's corners at one level: their keys, weights and the axis weights.
struct Corners {
  int key[8];
  float w[8];
  float axis[3][2];  // [d][offset]: 1 - frac_d, frac_d
};

__device__ __forceinline__ void level_corners(const float p[3], int l, const Levels& lv,
                                              Corners& k) {
  const int res = lv.res[l];
  const float r = (float)res;
  int c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float ps = __fmul_rn(p[d], r);
    const float fl = floorf(ps);
    const float frac = __fsub_rn(ps, fl);
    c[d] = (int)fl;
    k.axis[d][0] = __fsub_rn(1.0f, frac);
    k.axis[d][1] = frac;
  }
  const long long lo = (long long)l << lv.log2_t;
  const long long last = ((long long)lv.count << lv.log2_t) - 1;
  const bool dense = (lv.dense >> l) & 1u;
  const long long r1 = res + 1;
  const unsigned mask = (1u << lv.log2_t) - 1u;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int bx = q & 1, by = (q >> 1) & 1, bz = (q >> 2) & 1;
    const int x = c[0] + bx, y = c[1] + by, z = c[2] + bz;
    long long key;
    if (dense) {
      key = lo + x + r1 * (y + r1 * z);
      key = key < last ? key : last;
    } else {
      key = lo + (long long)(((unsigned)x ^ ((unsigned)y * kPrime1) ^ ((unsigned)z * kPrime2))
                             & mask);
    }
    k.key[q] = (int)key;
    k.w[q] = __fmul_rn(__fmul_rn(k.axis[0][bx], k.axis[1][by]), k.axis[2][bz]);
  }
}

// F consecutive floats of a 4F-byte aligned row.
template <int F>
struct Row {
  float v[F];
};

template <int F>
__device__ __forceinline__ Row<F> load_row(const float* __restrict__ base, long long row) {
  Row<F> r;
  if constexpr (F == 1) {
    r.v[0] = __ldg(base + row);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(base) + row);
    r.v[0] = a.x;
    r.v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(base) + row * (F / 4) + i);
      r.v[4 * i] = a.x;
      r.v[4 * i + 1] = a.y;
      r.v[4 * i + 2] = a.z;
      r.v[4 * i + 3] = a.w;
    }
  }
  return r;
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ base, long long row,
                                          const float* v) {
  if constexpr (F == 1) {
    base[row] = v[0];
  } else if constexpr (F == 2) {
    reinterpret_cast<float2*>(base)[row] = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < F / 4; ++i)
      reinterpret_cast<float4*>(base)[row * (F / 4) + i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

template <int F, bool KEYS>
__global__ void __launch_bounds__(kThreads)
    hash_grid_fwd_kernel(const float* __restrict__ entries, const float* __restrict__ pos,
                         long long n, Levels lv, float* __restrict__ enc,
                         int* __restrict__ keys) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p[d] = clamp01(pos[3 * i + d]);
  for (int l = 0; l < lv.count; ++l) {
    Corners k;
    level_corners(p, l, lv, k);
    Row<F> t[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) t[q] = load_row<F>(entries, k.key[q]);
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fmul_rn(t[0].v[f], k.w[0]);
#pragma unroll
    for (int q = 1; q < 8; ++q)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(t[q].v[f], k.w[q]));
    store_row<F>(enc, i * lv.count + l, acc);
    if (KEYS) {
      int4* dst = reinterpret_cast<int4*>(keys + ((long long)l * n + i) * 8);
      dst[0] = make_int4(k.key[0], k.key[1], k.key[2], k.key[3]);
      dst[1] = make_int4(k.key[4], k.key[5], k.key[6], k.key[7]);
    }
  }
}

template <int F, bool VALS, bool DX>
__global__ void __launch_bounds__(kThreads)
    hash_grid_bwd_kernel(const float* __restrict__ entries, const float* __restrict__ pos,
                         const float* __restrict__ grad, long long n, Levels lv,
                         float* __restrict__ vals, float* __restrict__ dpos) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float raw[3], p[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    raw[d] = pos[3 * i + d];
    p[d] = clamp01(raw[d]);
  }
  float dp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < lv.count; ++l) {
    Corners k;
    level_corners(p, l, lv, k);
    const Row<F> g = load_row<F>(grad, i * lv.count + l);
    if (VALS) {
      float out[8 * F];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int f = 0; f < F; ++f) out[q * F + f] = __fmul_rn(g.v[f], k.w[q]);
      float4* dst = reinterpret_cast<float4*>(vals + ((long long)l * n + i) * 8 * F);
#pragma unroll
      for (int j = 0; j < 2 * F; ++j)
        dst[j] = make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2], out[4 * j + 3]);
    }
    if (DX) {
      Row<F> t[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) t[q] = load_row<F>(entries, k.key[q]);
      float df[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float s = __fmul_rn(g.v[0], t[q].v[0]);
#pragma unroll
        for (int f = 1; f < F; ++f) s = __fadd_rn(s, __fmul_rn(g.v[f], t[q].v[f]));
        const int b[3] = {q & 1, (q >> 1) & 1, (q >> 2) & 1};
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const int e0 = d == 0 ? 1 : 0, e1 = d == 2 ? 1 : 2;  // the other two axes, in order
          const float term = __fmul_rn(s, __fmul_rn(k.axis[e0][b[e0]], k.axis[e1][b[e1]]));
          df[d] = b[d] ? __fadd_rn(df[d], term) : __fsub_rn(df[d], term);
        }
      }
      const float r = (float)lv.res[l];
#pragma unroll
      for (int d = 0; d < 3; ++d) dp[d] = __fadd_rn(dp[d], __fmul_rn(df[d], r));
    }
  }
  if (DX) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float x = raw[d];
      dpos[3 * i + d] = (x < 0.0f || x > 1.0f)      ? 0.0f
                        : (x == 0.0f || x == 1.0f) ? __fmul_rn(dp[d], 0.5f)
                                                   : dp[d];
    }
  }
}

bool read_levels(int levels, int log2_t, const int* res, const int* dense, Levels& lv) {
  if (levels < 1 || levels > kMaxLevels || log2_t < 0 || log2_t > 30) return false;
  if (((long long)levels << log2_t) > 0x7fffffffLL) return false;
  lv.count = levels;
  lv.log2_t = log2_t;
  lv.dense = 0u;
  for (int l = 0; l < levels; ++l) {
    if (res[l] < 1) return false;
    lv.res[l] = res[l];
    if (dense[l]) lv.dense |= 1u << l;
  }
  for (int l = levels; l < kMaxLevels; ++l) lv.res[l] = 0;
  return true;
}

template <int F>
void launch_fwd(const float* entries, const float* pos, long long n, const Levels& lv,
                float* enc, int* keys, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (keys)
    hash_grid_fwd_kernel<F, true><<<blocks, kThreads, 0, s>>>(entries, pos, n, lv, enc, keys);
  else
    hash_grid_fwd_kernel<F, false><<<blocks, kThreads, 0, s>>>(entries, pos, n, lv, enc, keys);
}

template <int F>
void launch_bwd(const float* entries, const float* pos, const float* grad, long long n,
                const Levels& lv, float* vals, float* dpos, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (vals && dpos)
    hash_grid_bwd_kernel<F, true, true>
        <<<blocks, kThreads, 0, s>>>(entries, pos, grad, n, lv, vals, dpos);
  else if (vals)
    hash_grid_bwd_kernel<F, true, false>
        <<<blocks, kThreads, 0, s>>>(entries, pos, grad, n, lv, vals, dpos);
  else
    hash_grid_bwd_kernel<F, false, true>
        <<<blocks, kThreads, 0, s>>>(entries, pos, grad, n, lv, vals, dpos);
}

}  // namespace

// entries (L * 2^log2_t, features) f32, pos (n, 3) f32, res and dense (levels,)
// host ints (a level's resolution; nonzero: indexed densely), enc (n, levels
// * features) f32, keys (levels, n, 8) int32 or null.
extern "C" int nkt_hash_grid_fwd(const float* entries, const float* pos, long long n, int levels,
                                 int features, int log2_t, const int* res, const int* dense,
                                 float* enc, int* keys, void* stream) {
  Levels lv;
  if (n < 0 || !read_levels(levels, log2_t, res, dense, lv)) return NKT_HASH_ERR_SHAPE;
  if (keys && 8 * n * levels > 0x7fffffffLL) return NKT_HASH_ERR_SHAPE;
  if (n == 0) return 0;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL) return NKT_HASH_ERR_SHAPE;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (features) {
    case 1: launch_fwd<1>(entries, pos, n, lv, enc, keys, s); break;
    case 2: launch_fwd<2>(entries, pos, n, lv, enc, keys, s); break;
    case 4: launch_fwd<4>(entries, pos, n, lv, enc, keys, s); break;
    case 8: launch_fwd<8>(entries, pos, n, lv, enc, keys, s); break;
    default: return NKT_HASH_ERR_FEATURES;
  }
  return (int)cudaGetLastError();
}

// entries as the forward's (null without dpos), pos (n, 3), grad (n, levels
// * features) f32; vals (levels, n, 8, features) f32 or null, dpos (n, 3)
// f32 or null, not both null.
extern "C" int nkt_hash_grid_bwd(const float* entries, const float* pos, const float* grad,
                                 long long n, int levels, int features, int log2_t,
                                 const int* res, const int* dense, float* vals, float* dpos,
                                 void* stream) {
  Levels lv;
  if (n < 0 || !read_levels(levels, log2_t, res, dense, lv)) return NKT_HASH_ERR_SHAPE;
  if (!vals && !dpos) return NKT_HASH_ERR_OUTPUTS;
  if (dpos && !entries) return NKT_HASH_ERR_OUTPUTS;
  if (vals && 8 * n * levels > 0x7fffffffLL) return NKT_HASH_ERR_SHAPE;
  if (n == 0) return 0;
  if ((n + kThreads - 1) / kThreads > 0x7fffffffLL) return NKT_HASH_ERR_SHAPE;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (features) {
    case 1: launch_bwd<1>(entries, pos, grad, n, lv, vals, dpos, s); break;
    case 2: launch_bwd<2>(entries, pos, grad, n, lv, vals, dpos, s); break;
    case 4: launch_bwd<4>(entries, pos, grad, n, lv, vals, dpos, s); break;
    case 8: launch_bwd<8>(entries, pos, grad, n, lv, vals, dpos, s); break;
    default: return NKT_HASH_ERR_FEATURES;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nkt_error_string(int code) {
  switch (code) {
    case NKT_HASH_ERR_SHAPE: return "hash_grid: a size, level count or table size out of range";
    case NKT_HASH_ERR_FEATURES: return "hash_grid: features per level must be 1, 2, 4 or 8";
    case NKT_HASH_ERR_OUTPUTS: return "hash_grid: the backward needs vals or dpos (and entries)";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}
