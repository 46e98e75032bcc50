// Fixed-order segment sums and the stable sort that feeds them, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel. The JAX package sums the cotangents of its
// index selections with XLA, in a fixed order: `_outer_cw_bwd`
// (nerf_kbs_tpu/ops/losses.py:76) and `_bracket_bwd`
// (nerf_kbs_tpu/ops/samplers.py:175) add one-hot contributions over the
// query axis (jnp.sum / lax.reduce over axis 2), and the hash table's
// gradient is the transpose of jnp.take. On the card PyTorch's own
// backwards of those selections (scatter_add_, the gather backward,
// index_add_) add with float atomics in an order that changes from launch
// to launch, so a training step would not repeat its bits. These kernels
// give the same sums in one order on every launch, an order that depends on
// the shapes and the indices alone (nothing is sized from the card's SM
// count). Two regimes, two entry points.
//
// 1. Short rows, each with its own index row (nkt_segment_sum): the
//    interlevel bounds' cotangents (16,384 rows x 48 entries into 33 env
//    edges) and the pdf sampler's brackets and running maximum (rows of ~49).
//
//      out[r, e] = sum over q with idx[r, q] == e of values[r, q]
//
//    in ascending q within each piece of kPiece entries (q / kPiece), and the
//    pieces' sums in ascending order. A run inside one piece (every run of a
//    row of at most kPiece entries) is summed serially in ascending q,
//    0 + v_first + ... + v_last, the order of a serial scatter_add_ on the
//    CPU, bit for bit. Two passes: one thread an entry, where the thread at
//    a piece's first entry of a run sums that piece serially into `pieces`;
//    then one thread a (row, target), two binary searches of the index row,
//    and the run's piece sums in order. At ~10^6 short rows that is ~10^6
//    threads a pass and 4 to 7 us (bound ~2.5 us of bytes).
//
// 2. One long sorted index row that F value rows share (nkt_segment_sum_by_key):
//    the hash table's levels (F = 2 features, 1.6M to 3.1M corners into
//    2^17 to 2^19 slots), the preprocessing warp's bilinear taps.
//
//      out[f, e] = sum over k with keys[k] == e of g[f, perm[k]]
//
//    keys (M,) non-decreasing, perm (M,) the stable sort's permutation (or
//    none: the identity), so g is read through the permutation and never
//    copied into sorted order; g's rows may be strided or interleaved (the
//    hash levels' cotangents are (M, F): two features, one 8-byte load).
//    The order, the same for every row (p is a position of the sorted row;
//    a run is a maximal stretch of one key):
//    - tiles of kTile = 1,024 positions, one block each; thread t of the
//      tile holds kItems = 4 consecutive positions; two value rows a pass;
//    - the thread adds its positions serially, restarting at a run's first
//      position: s_0 = v_0, s_i = v_i at a run head, else s_{i-1} + v_i;
//    - the threads' last partials (a_t, h_t: h_t when the thread holds a run
//      head) are scanned inclusively within the warp by shuffles, Kogge-Stone
//      at distances 1, 2, 4, 8, 16 with (h, a) + (h', a') = (h | h',
//      h' ? a' : a + a'); the exclusive value of lane l is lane l - 1's;
//    - the warps' totals are combined serially in ascending warp order,
//      giving each warp its carry in: c_0 = none, c_w = c_{w-1} + W_{w-1};
//      a thread's carry is its warp's carry combined with its lane's
//      exclusive value (c + x, or x alone when x holds a head);
//    - a run that ends in the tile: s_i when its head is in the thread, else
//      carry + s_i; a run that began in the tile and ends there is written;
//    - a run that crosses tiles leaves its in-tile partial in scratch: a head
//      partial (it began before the tile and ends in it) and a tail partial
//      (it goes on past the tile: from its head, or the whole tile); a
//      second pass, one thread a (row, run), adds them in ascending tile
//      order, tail + whole tiles' ... + the last tile's head partial.
//    Targets [0, own) of `out` are overwritten (one memset of that span
//    first: a target no entry names is 0.0); targets [own, span) are added
//    to what `out` holds (a level of the hash table whose far face reaches
//    into the next level's slots, which the caller wrote first). Keys
//    outside [0, span) are never written.
//    What bounds it: bytes, and the gather of g through the permutation
//    (random reads that the L2 cache serves, one 32-byte sector each). At
//    run 3's finest level (2 x 1,572,864 corners into 2^19) the bound is
//    ~23 MB, 7 us at 3.35 TB/s. One block streams a tile of keys and
//    permutation entries with 16-byte loads, reads both features of a
//    corner in one load issued before its flags are scanned, scans with
//    shuffles and two block barriers, and searches nothing; a coarse
//    level's busy cell (~10^5 corners) is spread over ~100 blocks, and the
//    crossing runs cost O(number of tiles) adds.
//
// 3. The stable sort (nkt_radix_sort): keys (M,) in [0, 2^bits) -> the keys
//    in ascending order and the permutation that sorts them, ties in
//    ascending position: torch.sort(stable=True)'s permutation exactly. LSD
//    radix over only `bits` bits (a hash level: ceil(log2 span) <= 19), in
//    as few passes as digits of at most 9 bits need. A pass:
//    a histogram of each 4,096-key tile in shared memory (integer atomics:
//    the counts do not depend on the order), an exclusive scan of the counts
//    digit by digit over the tiles, and a scatter in which warp w of a tile
//    takes its 512 consecutive keys 32 at a time and ranks each among the
//    equal digits before it (the lanes of equal digit found by one ballot a
//    digit bit, per-warp counters in shared memory, warps in ascending
//    order), sorts the tile by digit in shared memory and writes each
//    digit's keys as one contiguous run. Bound: bytes, 16 a key a pass (the
//    key and its position read and written); the first pass reads no
//    positions.
//
// All arrays contiguous on the device but `g` and `out`, whose strides the
// caller gives. Every entry point launches on `stream`, does not
// synchronise, and returns the launch error (0 on success) or a negative
// code for arguments it does not take.

#include <cuda_runtime.h>

#define NKT_SEG_ERR_SHAPE (-101)
#define NKT_SEG_ERR_DTYPE (-102)
#define NKT_SEG_ERR_SCRATCH (-103)

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// 1. short rows
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPiece = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_pieces_kernel(const T* __restrict__ values, const int* __restrict__ idx, int rows,
                          int q, T* __restrict__ pieces) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)rows * q) return;
  const int r = (int)(t / q);
  const int k = (int)(t - (long long)r * q);
  const int* __restrict__ row = idx + (long long)r * q;
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
                        int q, int e, T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)rows * e) return;
  const int r = (int)(t / e);
  const int target = (int)(t - (long long)r * e);
  const int* __restrict__ row = idx + (long long)r * q;
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
int launch_rows(const void* values, const int* idx, int rows, int q, int e, void* pieces,
                void* out, cudaStream_t s) {
  const long long n1 = (long long)rows * q, n2 = (long long)rows * e;
  if (n1 > 0)
    segment_pieces_kernel<T><<<(unsigned)((n1 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const T*>(values), idx, rows, q, static_cast<T*>(pieces));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_runs_kernel<T><<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const T*>(pieces), idx, rows, q, e, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. one long sorted index row, F value rows
// ---------------------------------------------------------------------------

constexpr int kTileThreads = 256;
constexpr int kItems = 4;  // one int4 of keys, one of the permutation
constexpr int kTile = kTileThreads * kItems;  // sorted positions a block
constexpr int kWarps = kTileThreads / 32;
constexpr int kRowsAPass = 2;  // value rows whose gathers are in flight together

// a run's sum into its target: overwritten below `own`, added from `own` on
template <typename T>
__device__ __forceinline__ void put(T* __restrict__ out, long long ldo, int f, int key, int own,
                                    int span, T v) {
  if (key < 0 || key >= span) return;
  T* o = out + f * ldo + key;
  *o = key < own ? v : *o + v;
}

template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  using V = float2;
};
template <>
struct Pair2<double> {
  using V = double2;
};

// partials (rows, 2, ntiles): each tile's head partial (its first run, begun
// in an earlier tile, up to its end here) and tail partial (its last run, on
// past the tile: from its head, or the whole tile), for segment_carry_kernel
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
    segment_tiles_kernel(const int* __restrict__ keys, const int* __restrict__ perm,
                         const T* __restrict__ g, long long sf, long long sq, bool pairs,
                         long long m, int rows, T* __restrict__ out, long long ldo, int own,
                         int span, T* __restrict__ partials, long long ntiles) {
  __shared__ T warp_sum[kRowsAPass][kWarps];
  __shared__ T carry_sum[kRowsAPass][kWarps];
  __shared__ int warp_head[kWarps];
  __shared__ int carry_head[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long tile = blockIdx.x;
  const long long p0 = tile * kTile + (long long)t * kItems;
  const long long last = min(tile * kTile + kTile, m) - 1;  // the tile's last position
  int key[kItems], src[kItems];
  if (p0 + kItems <= m) {  // 16-byte loads: p0 is a multiple of 4 entries
    const int4 k = __ldg(reinterpret_cast<const int4*>(keys + p0));
    key[0] = k.x, key[1] = k.y, key[2] = k.z, key[3] = k.w;
    if (perm) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(perm + p0));
      src[0] = q.x, src[1] = q.y, src[2] = q.z, src[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < kItems; ++i) src[i] = (int)(p0 + i);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long p = p0 + i;
      key[i] = p < m ? __ldg(keys + p) : 0;
      src[i] = p < m ? (perm ? __ldg(perm + p) : (int)p) : 0;
    }
  }
  T s[kRowsAPass][kItems];
  if (pairs) {  // two interleaved rows: one 8- or 16-byte load a position, issued
                // before the flags' scan so that their latency overlaps it
    using V = typename Pair2<T>::V;
    const V* __restrict__ g2 = reinterpret_cast<const V*>(g);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const V x = p0 + i < m ? __ldg(g2 + src[i]) : V{T(0), T(0)};
      s[0][i] = x.x, s[1][i] = x.y;
    }
  }
  const int before = (p0 > 0 && p0 < m) ? __ldg(keys + p0 - 1) : 0;
  const int after = p0 + kItems < m ? __ldg(keys + p0 + kItems) : 0;
  unsigned valid = 0, head = 0, ends = 0;  // bit i: position p0 + i exists / heads / ends a run
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long p = p0 + i;
    if (p >= m) continue;
    valid |= 1u << i;
    if (p == 0 || (i == 0 ? before : key[i - 1]) != key[i]) head |= 1u << i;
    if (p == m - 1 || (i + 1 < kItems ? key[i + 1] : after) != key[i]) ends |= 1u << i;
  }
  // the scan's head flags depend on the keys alone: the flag each lane holds
  // before each Kogge-Stone step (bit j), its lane - 1's inclusive flag; the
  // warps' carries' flags come with the first rows' sums
  int ah = head != 0;
  unsigned step_head = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    step_head |= (unsigned)ah << j;
    const int uh = __shfl_up_sync(kFull, ah, 1 << j);
    if (lane >= (1 << j)) ah |= uh;
  }
  const int eh = __shfl_up_sync(kFull, ah, 1);
  if (lane == 31) warp_head[warp] = ah;
  const bool has = t > 0;  // a carry in: the warps' before this one, then the lanes'
  int ch = 0;

  for (int f0 = 0; f0 < rows; f0 += kRowsAPass) {
    const int nr = min(kRowsAPass, rows - f0);
    if (!pairs) {
#pragma unroll
      for (int r = 0; r < kRowsAPass; ++r)
#pragma unroll
        for (int i = 0; i < kItems; ++i)
          s[r][i] = r < nr && (valid >> i) & 1u ? __ldg(g + (f0 + r) * sf + src[i] * sq) : T(0);
    }
    T a[kRowsAPass], ea[kRowsAPass];
#pragma unroll
    for (int r = 0; r < kRowsAPass; ++r) {
      // the thread's positions added serially, restarting at a run's head
#pragma unroll
      for (int i = 1; i < kItems; ++i)
        if (!((head >> i) & 1u)) s[r][i] = s[r][i - 1] + s[r][i];
      a[r] = s[r][kItems - 1];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
#pragma unroll
      for (int r = 0; r < kRowsAPass; ++r) {
        const T ua = __shfl_up_sync(kFull, a[r], 1 << j);
        if (lane >= (1 << j) && !((step_head >> j) & 1u)) a[r] = ua + a[r];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsAPass; ++r) {
      ea[r] = __shfl_up_sync(kFull, a[r], 1);  // exclusive: lane - 1's inclusive value
      if (lane == 31) warp_sum[r][warp] = a[r];
    }
    __syncthreads();
    if (t == 0) {  // the warps' carries in, in ascending warp order
      int hh = warp_head[0];
      for (int w = 1; w < kWarps; ++w) carry_head[w] = hh, hh |= warp_head[w];
      for (int r = 0; r < nr; ++r) {
        T c = warp_sum[r][0];
        for (int w = 1; w < kWarps; ++w) {
          carry_sum[r][w] = c;
          c = warp_head[w] ? warp_sum[r][w] : c + warp_sum[r][w];
        }
      }
    }
    __syncthreads();
    ch = warp == 0 ? eh : carry_head[warp] | (lane > 0 ? eh : 0);
#pragma unroll
    for (int r = 0; r < kRowsAPass; ++r) {
      if (r >= nr) break;
      T c = ea[r];
      if (warp > 0) c = lane > 0 ? (eh ? ea[r] : carry_sum[r][warp] + ea[r]) : carry_sum[r][warp];
      const int f = f0 + r;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const long long p = p0 + i;
        const bool is_end = (ends >> i) & 1u;
        if (!((valid >> i) & 1u) || (!is_end && p != last)) continue;
        const bool in_thread = (head & ((2u << i) - 1u)) != 0;
        T total = s[r][i];
        bool began_here = in_thread;  // the run's head lies in this tile
        if (!in_thread && has) total = c + s[r][i], began_here = ch != 0;
        if (began_here && is_end)
          put(out, ldo, f, key[i], own, span, total);
        else
          partials[(2 * (long long)f + (is_end ? 0 : 1)) * ntiles + tile] = total;
      }
    }
    __syncthreads();  // warp_sum and carry_sum are rewritten for the next rows
  }
}

// one thread a (row, tile): a run that begins in the tile and goes on past
// it adds its partials in ascending tile order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    segment_carry_kernel(const int* __restrict__ keys, long long m, int rows,
                         T* __restrict__ out, long long ldo, int own, int span,
                         const T* __restrict__ partials, long long ntiles) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= rows * (ntiles - 1)) return;
  const int f = (int)(i / (ntiles - 1));
  const long long tile = i - f * (ntiles - 1);  // never the last tile
  const long long last = (tile + 1) * kTile - 1;
  const int k = __ldg(keys + last);
  if (__ldg(keys + last + 1) != k) return;                    // the tile's last run ends in it
  if (tile > 0 && __ldg(keys + tile * kTile - 1) == k) return;  // it began in an earlier tile
  const T* __restrict__ heads = partials + 2 * (long long)f * ntiles;
  const T* __restrict__ tails = heads + ntiles;
  T s = tails[tile];
  for (long long u = tile + 1;; ++u) {
    const long long ul = min((u + 1) * kTile, m) - 1;
    if (ul + 1 < m && __ldg(keys + ul) == k && __ldg(keys + ul + 1) == k) {
      s = s + tails[u];  // the whole tile u is the run
    } else {
      s = s + heads[u];
      break;
    }
  }
  put(out, ldo, f, k, own, span, s);
}

template <typename T>
int launch_by_key(const void* g, long long sf, long long sq, const int* keys, const int* perm,
                  long long m, int rows, void* out, long long ldo, int own, int span,
                  void* partials, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  if (own > 0) {  // zeros below own, where no sum lands
    const cudaError_t err = cudaMemset2DAsync(o, ldo * sizeof(T), 0, own * sizeof(T), rows, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (m == 0) return 0;
  const long long ntiles = (m + kTile - 1) / kTile;
  const bool pairs = rows == 2 && sf == 1 && sq == 2 &&
                     reinterpret_cast<unsigned long long>(g) % (2 * sizeof(T)) == 0;
  T* part = static_cast<T*>(partials);
  segment_tiles_kernel<T><<<(unsigned)ntiles, kTileThreads, 0, s>>>(
      keys, perm, static_cast<const T*>(g), sf, sq, pairs, m, rows, o, ldo, own, span, part,
      ntiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ntiles == 1) return (int)err;
  const long long n = rows * (ntiles - 1);
  segment_carry_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      keys, m, rows, o, ldo, own, span, part, ntiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3. the stable LSD radix sort
// ---------------------------------------------------------------------------

constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortRounds = 16;                        // 32-key rounds a warp
constexpr int kSortTile = kSortThreads * kSortRounds;  // 4,096 keys a block
constexpr int kWarpKeys = kSortTile / kSortWarps;      // 512 consecutive keys a warp
constexpr int kMaxDigitBits = 9;  // 19-bit keys in 3 passes, 17-bit in 2: the fastest here
constexpr int kMaxRadix = 1 << kMaxDigitBits;
constexpr int kPer = kMaxRadix / kSortThreads;  // digits a thread in the block-wide scans

// the lanes of the warp whose digit (of digit_bits bits; -1: none) equals
// this lane's, by one ballot a bit
__device__ __forceinline__ unsigned digit_peers(int d, int digit_bits) {
  unsigned peers = __ballot_sync(kFull, d >= 0);
  for (int j = 0; j < digit_bits; ++j) {
    const bool bit = (d >> j) & 1;
    const unsigned b = __ballot_sync(kFull, bit);
    peers &= bit ? b : ~b;
  }
  return peers;
}

__global__ void __launch_bounds__(kSortThreads)
    radix_hist_kernel(const int* __restrict__ keys, long long m, int shift, int radix,
                      int* __restrict__ counts, long long nblocks) {
  __shared__ int hist[kMaxRadix];
  for (int d = threadIdx.x; d < radix; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kSortTile;
  if (base + kSortTile <= m) {  // 16-byte loads
    const int4* k4 = reinterpret_cast<const int4*>(keys + base);
#pragma unroll
    for (int i = 0; i < kSortRounds / 4; ++i) {
      const int4 k = __ldg(k4 + i * kSortThreads + threadIdx.x);
      atomicAdd(&hist[(k.x >> shift) & (radix - 1)], 1);
      atomicAdd(&hist[(k.y >> shift) & (radix - 1)], 1);
      atomicAdd(&hist[(k.z >> shift) & (radix - 1)], 1);
      atomicAdd(&hist[(k.w >> shift) & (radix - 1)], 1);
    }
  } else {
    for (int i = 0; i < kSortRounds; ++i) {
      const long long p = base + i * kSortThreads + threadIdx.x;
      if (p < m) atomicAdd(&hist[(__ldg(keys + p) >> shift) & (radix - 1)], 1);
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += kSortThreads)
    counts[d * nblocks + blockIdx.x] = hist[d];
}

// the block's exclusive scan of one int a thread; `total` gets the sum
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    total += warp_tot[w];
  }
  __syncthreads();  // warp_tot may be reused
  return before + incl - x;
}

// one block a digit: the exclusive scan of its counts over the tiles, in
// place; totals[d] gets the digit's count
__global__ void __launch_bounds__(kSortThreads)
    radix_scan_kernel(int* __restrict__ counts, long long nblocks, int* __restrict__ totals) {
  __shared__ int warp_tot[kSortWarps];
  int* row = counts + blockIdx.x * nblocks;
  int carry = 0;
  for (long long c0 = 0; c0 < nblocks; c0 += kSortThreads) {
    const long long j = c0 + threadIdx.x;
    const int x = j < nblocks ? row[j] : 0;
    int total;
    const int ex = block_exclusive_scan(x, warp_tot, total);
    if (j < nblocks) row[j] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// shared memory of the scatter (dynamic): the digits' output starts, the
// warps' digit counters, the tile's keys and positions sorted by digit
constexpr int kScatterSmem = (kMaxRadix + kSortWarps * kMaxRadix + 2 * kSortTile) * sizeof(int);

// ranks the tile's keys stably by digit, sorts the tile by digit in shared
// memory, then writes each digit's keys (and positions) as one contiguous
// run of the output
__global__ void __launch_bounds__(kSortThreads)
    radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in,
                         long long m, int shift, int digit_bits, const int* __restrict__ counts,
                         const int* __restrict__ totals, long long nblocks,
                         int* __restrict__ keys_out, int* __restrict__ vals_out) {
  extern __shared__ int smem[];
  int* start = smem;                     // the digit's first output position, less its first
                                         // position in the sorted tile
  int* wcount = start + kMaxRadix;       // [warp][digit]: counts, then first positions
  int* skey = wcount + kSortWarps * kMaxRadix;  // the tile sorted by digit
  int* sval = skey + kSortTile;
  __shared__ int warp_tot[kSortWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int radix = 1 << digit_bits;
  int* mine_count = wcount + warp * kMaxRadix;
  for (int j = t; j < kSortWarps * kMaxRadix; j += kSortThreads) wcount[j] = 0;
  const long long tile0 = (long long)blockIdx.x * kSortTile;
  const long long base = tile0 + warp * kWarpKeys + lane;
  int key[kSortRounds], val[kSortRounds];
  unsigned valid = 0;
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const long long p = base + r * 32;
    key[r] = p < m ? __ldg(keys_in + p) : 0;
    val[r] = p < m ? (vals_in ? __ldg(vals_in + p) : (int)p) : 0;
    valid |= (unsigned)(p < m) << r;
  }
  __syncthreads();
  // each warp's count of each digit
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const int d = (valid >> r) & 1u ? (key[r] >> shift) & (radix - 1) : -1;
    const unsigned peers = digit_peers(d, digit_bits);
    if (d >= 0 && lane == __ffs(peers) - 1) mine_count[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per digit (kPer consecutive digits a thread): the warps' first positions
  // in the sorted tile, in ascending warp order; the digits' first positions
  // in the tile and in the output
  int count[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = t * kPer + j;
    count[j] = 0;
    if (d < radix)
      for (int w = 0; w < kSortWarps; ++w) {
        const int c = wcount[w * kMaxRadix + d];
        wcount[w * kMaxRadix + d] = count[j];
        count[j] += c;
      }
    sum += count[j];
  }
  int total;
  int at = block_exclusive_scan(sum, warp_tot, total);
  int glob_sum = 0, mine[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = t * kPer + j;
    mine[j] = d < radix ? __ldg(totals + d) : 0;
    glob_sum += mine[j];
  }
  int glob = block_exclusive_scan(glob_sum, warp_tot, total);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int d = t * kPer + j;
    if (d < radix) {
      start[d] = glob + __ldg(counts + d * nblocks + blockIdx.x) - at;
      for (int w = 0; w < kSortWarps; ++w) wcount[w * kMaxRadix + d] += at;
    }
    at += count[j];
    glob += mine[j];
  }
  __syncthreads();
  // each key to its position in the tile sorted by digit
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const int d = (valid >> r) & 1u ? (key[r] >> shift) & (radix - 1) : -1;
    const unsigned peers = digit_peers(d, digit_bits);
    const int local = d >= 0 ? mine_count[d] + __popc(peers & below) : 0;
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) mine_count[d] += __popc(peers);
    __syncwarp();
    if (d >= 0) skey[local] = key[r], sval[local] = val[r];
  }
  __syncthreads();
  const int n = (int)min((long long)kSortTile, m - tile0);
  for (int j = t; j < n; j += kSortThreads) {
    const int k = skey[j];
    const int out = start[(k >> shift) & (radix - 1)] + j;
    keys_out[out] = k;
    vals_out[out] = sval[j];
  }
}

}  // namespace

// values (rows, q) of dtype 0 (f32) or 1 (f64), idx (rows, q) int32, pieces
// (rows, q) scratch and out (rows, e) of the values' dtype.
extern "C" int nkt_segment_sum(const void* values, const int* idx, int rows, int q, int e,
                               void* pieces, void* out, int dtype, void* stream) {
  if (rows < 0 || q < 0 || e < 0) return NKT_SEG_ERR_SHAPE;
  if (dtype != 0 && dtype != 1) return NKT_SEG_ERR_DTYPE;
  const long long most = (long long)rows * (q > e ? q : e);
  if (most == 0 || rows * (long long)e == 0) return 0;
  if ((most + kThreads - 1) / kThreads > 0x7fffffffLL) return NKT_SEG_ERR_SHAPE;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_rows<float>(values, idx, rows, q, e, pieces, out, s)
                    : launch_rows<double>(values, idx, rows, q, e, pieces, out, s);
}

// g: value (f, q) at g[f * sf + q * sq] for q up to max perm (or m - 1),
// keys (m,) non-decreasing, perm (m,) or null (the identity), out (rows, >=
// span) with row stride ldo, all of dtype 0 (f32) or 1 (f64) but the int32
// keys and perm; partials scratch of partials_len >= rows * 2 * ceil(m /
// 1,024) values. Two interleaved rows (sf 1, sq 2) are read a pair a load.
extern "C" int nkt_segment_sum_by_key(const void* g, long long sf, long long sq,
                                      const int* keys, const int* perm, long long m, int rows,
                                      void* out, long long ldo, int own, int span,
                                      void* partials, long long partials_len, int dtype,
                                      void* stream) {
  if (rows < 0 || m < 0 || m > 0x7fffffffLL || own < 0 || span < own || ldo < span || sf < 0 ||
      sq < 1)
    return NKT_SEG_ERR_SHAPE;
  if (dtype != 0 && dtype != 1) return NKT_SEG_ERR_DTYPE;
  if (rows == 0) return 0;
  if (partials_len < rows * 2 * ((m + kTile - 1) / kTile)) return NKT_SEG_ERR_SCRATCH;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_by_key<float>(g, sf, sq, keys, perm, m, rows, out, ldo, own, span,
                                           partials, s)
                    : launch_by_key<double>(g, sf, sq, keys, perm, m, rows, out, ldo, own, span,
                                            partials, s);
}

// keys (m,) int32 in [0, 2^bits) -> keys_out (m,) ascending and vals_out
// (m,) the positions that sort them, stable; keys_tmp and vals_tmp (m,)
// scratch, counts scratch of counts_len >= radix * (ceil(m / 4,096) + 1)
// ints (radix = 2^ceil(bits / passes), passes = ceil(bits / 9)); every
// array 16-byte aligned.
extern "C" int nkt_radix_sort(const int* keys, long long m, int bits, int* keys_out,
                              int* vals_out, int* keys_tmp, int* vals_tmp, int* counts,
                              long long counts_len, void* stream) {
  if (m < 0 || m > 0x7fffffffLL || bits < 1 || bits > 31) return NKT_SEG_ERR_SHAPE;
  if (m == 0) return 0;
  const int passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
  const int digit_bits = (bits + passes - 1) / passes;
  const int radix = 1 << digit_bits;
  const long long nblocks = (m + kSortTile - 1) / kSortTile;
  if (counts_len < radix * (nblocks + 1)) return NKT_SEG_ERR_SCRATCH;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScatterSmem);
  if (smem_set != cudaSuccess) return (int)smem_set;
  int* totals = counts + radix * nblocks;
  const int* kin = keys;
  const int* vin = nullptr;  // the first pass's positions are the indices themselves
  for (int k = 0; k < passes; ++k) {
    const bool to_out = (passes - k) % 2 == 1;  // the last pass writes the outputs
    int* kout = to_out ? keys_out : keys_tmp;
    int* vout = to_out ? vals_out : vals_tmp;
    radix_hist_kernel<<<(unsigned)nblocks, kSortThreads, 0, s>>>(kin, m, k * digit_bits, radix,
                                                                 counts, nblocks);
    radix_scan_kernel<<<radix, kSortThreads, 0, s>>>(counts, nblocks, totals);
    radix_scatter_kernel<<<(unsigned)nblocks, kSortThreads, kScatterSmem, s>>>(
        kin, vin, m, k * digit_bits, digit_bits, counts, totals, nblocks, kout, vout);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kin = kout;
    vin = vout;
  }
  return 0;
}

extern "C" const char* nkt_error_string(int code) {
  switch (code) {
    case NKT_SEG_ERR_SHAPE: return "segment_sum: a size, span or stride out of range";
    case NKT_SEG_ERR_DTYPE: return "segment_sum: values must be float32 or float64";
    case NKT_SEG_ERR_SCRATCH: return "segment_sum: scratch too small";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}
