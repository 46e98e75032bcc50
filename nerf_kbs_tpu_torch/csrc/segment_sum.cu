// Fixed-order segment sum for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package sums the cotangents of its
// index selections with XLA, in a fixed order: `_outer_cw_bwd`
// (nerf_kbs_tpu/ops/losses.py:76) and `_bracket_bwd`
// (nerf_kbs_tpu/ops/samplers.py:175) add one-hot contributions over the
// query axis (jnp.sum / lax.reduce over axis 2), and the hash table's
// gradient is the transpose of jnp.take. On the card PyTorch's own
// backwards of those selections (scatter_add_, the gather backward,
// index_add_) add with float atomics in an order that changes from launch
// to launch, so a training step would not repeat its bits. This kernel
// gives the same sums in one order on every launch:
//
//   out[r, e] = sum over q with idx[r, q] == e of values[r, q]
//
// in ascending q within each piece of kPiece entries (q / kPiece), and the
// pieces' sums in ascending order. A run inside one piece (every run of a
// row of at most kPiece entries: the interlevel bounds' and the sampler's
// rows) is summed serially in ascending q, 0 + v_first + ... + v_last, the
// order of a serial scatter_add_ on the CPU, bit for bit.
//
// values (R, Q) f32 or f64, idx (R, Q) or (1, Q) int32 (one index row that
// every value row shares: the hash table's F feature rows), non-decreasing
// along each row; out (R, E), every element written (0.0 for a target no
// entry names); entries outside [0, E) are never read into an output.
//
// What bounds it here: bytes. Each value and index is read once and each
// output written once; there is one add a value. At the interlevel loss's
// shape (8,192 rays x 48 queries, the lower and upper bounds' cotangents as
// 16,384 rows, into 97 env edges) that is ~13 MB, 4 us at 3.35 TB/s; at a
// hash level's (2 features x 1.57M corners into 2^19 slots) ~23 MB, 7 us.
//
// What the design does about it: two passes, no atomics. The first takes
// one thread an entry; the thread at the first entry of a piece of a run
// (a run cut at the kPiece boundaries) sums that piece serially, at most
// kPiece values, and writes its sum at the piece's last entry of `pieces`
// (R, Q) scratch. The second takes one thread a (row, target): two binary
// searches of the index row (log2 Q reads that the row's threads share
// through the L2 cache) find its run, and it adds the run's piece sums in
// order. Threads of a warp take neighbouring entries, then neighbouring
// targets, so reads and writes are contiguous. Both of the port's cases run
// in parallel: many short rows (the interlevel and sampler cotangents,
// ~10^6 threads each pass) and few rows of millions of entries whose runs
// may hold 10^5 entries (a coarse hash level's busy cell: a thread a target
// summing such a run alone took ~130 ms of a run-3 step), which the pieces
// cut into serial work of at most kPiece adds a thread and Q / kPiece adds
// at the second pass.

#include <cuda_runtime.h>

#define NKT_SEG_ERR_SHAPE (-101)
#define NKT_SEG_ERR_DTYPE (-102)

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_pieces_kernel(const T* __restrict__ values, const int* __restrict__ idx, int rows,
                          int q, long long idx_row_stride, T* __restrict__ pieces) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)rows * q) return;
  const int r = (int)(t / q);
  const int k = (int)(t - (long long)r * q);
  const int* __restrict__ row = idx + r * idx_row_stride;
  const int target = __ldg(row + k);
  if (k % kPiece != 0 && __ldg(row + k - 1) == target) return;  // not a piece's first entry
  const T* __restrict__ v = values + (long long)r * q;
  const int end = min(q, (k / kPiece + 1) * kPiece);
  T s = T(0);
  int j = k;
  for (; j < end && __ldg(row + j) == target; ++j) s += __ldg(v + j);
  pieces[(long long)r * q + j - 1] = s;
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int q, int key) {
  int lo = 0, hi = q;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_runs_kernel(const T* __restrict__ pieces, const int* __restrict__ idx, int rows,
                        int q, long long idx_row_stride, int e, T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)rows * e) return;
  const int r = (int)(t / e);
  const int target = (int)(t - (long long)r * e);
  const int* __restrict__ row = idx + r * idx_row_stride;
  const int lo = lower_bound(row, q, target);
  const int hi = lower_bound(row, q, target + 1);
  const T* __restrict__ p = pieces + (long long)r * q;
  T s = T(0);
  for (int k = lo; k < hi;) {
    const int end = min(hi, (k / kPiece + 1) * kPiece);
    s += p[end - 1];
    k = end;
  }
  out[t] = s;
}

template <typename T>
int launch(const void* values, const int* idx, int rows, int q, long long stride, int e,
           void* pieces, void* out, cudaStream_t s) {
  const long long n1 = (long long)rows * q, n2 = (long long)rows * e;
  if (n1 > 0)
    segment_pieces_kernel<T><<<(unsigned)((n1 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(values), idx, rows, q, stride, static_cast<T*>(pieces));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_runs_kernel<T><<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(pieces), idx, rows, q, stride, e, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// values (rows, q) of dtype 0 (f32) or 1 (f64), idx (idx_rows, q) int32 with
// idx_rows 1 or rows, pieces (rows, q) scratch and out (rows, e) of the
// values' dtype; all contiguous on the device. Launches on `stream`, does
// not synchronise; returns the launch error (0 on success) or a negative
// code for arguments it does not take.
extern "C" int nkt_segment_sum(const void* values, const int* idx, int rows, int q, int idx_rows,
                               int e, void* pieces, void* out, int dtype, void* stream) {
  if (rows < 0 || q < 0 || e < 0 || !(idx_rows == 1 || idx_rows == rows))
    return NKT_SEG_ERR_SHAPE;
  if (dtype != 0 && dtype != 1) return NKT_SEG_ERR_DTYPE;
  const long long most = (long long)rows * (q > e ? q : e);
  if (most == 0 || rows * (long long)e == 0) return 0;
  if ((most + kThreads - 1) / kThreads > 0x7fffffffLL) return NKT_SEG_ERR_SHAPE;
  const long long stride = idx_rows == 1 ? 0 : q;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(values, idx, rows, q, stride, e, pieces, out, s)
                    : launch<double>(values, idx, rows, q, stride, e, pieces, out, s);
}

extern "C" const char* nkt_error_string(int code) {
  switch (code) {
    case NKT_SEG_ERR_SHAPE: return "segment_sum: rows, q, e or idx_rows out of range";
    case NKT_SEG_ERR_DTYPE: return "segment_sum: values must be float32 or float64";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}
