// Per-row sum of gathered rows, out[g, :] = sum over j of rows[table[g, j], :]
// for table[g, j] >= 0, in j order, for Hopper (sm_90a).
//
// The blend backward's second step: blend_bwd_kernel (blend.cu) writes one
// gradient row per depth-sorted pair, and this kernel sums each gaussian's
// pair rows through the (G, c) slot table that ops/raster.py's binning
// builds (-1 where a column holds no pair, or one dropped by a cap). It
// takes the place of the reference's table backward, an XLA gather of
// (G * c, W) rows and a windowed sum (gsattack/ops/pallas_blend.py
// _gather_sum_rows); that step has no Pallas kernel. The sum is taken in
// a fixed order, so two calls on the same inputs agree bit for bit, where
// atomics (or torch.index_add_) would not. There are no atomics.
//
// What bounds it on an H100: bytes. It reads the table (4 c B a
// gaussian), each named row once (4 W B) and writes each output row
// (4 W B) once, and computes one add per named float. On the main path
// about 1.5 of a gaussian's c = 12 columns are named, so the rows, read
// at random (100 B at a 4-B alignment at 19 channels), are half the
// bytes; a wide table is mostly table. The trainer's first step under
// auto_caps (110,000 x 2,500 on 100k splats) names 1.8 M of its 275 M
// slots: most rows name a few pairs and 51 name over 512, up to all 2,500.
// What keeps a kernel from that bound is latency: the row loads depend on
// the table loads, so a design that walks one gaussian's entries one load
// at a time (as a warp a gaussian did) waits on a round trip per entry
// with little in flight.
//
// Design. One kernel body. A CTA of 256 threads owns `block` consecutive
// gaussians, whose table rows are one contiguous piece of block * c
// entries, and walks it in chunks of CHUNK = 256 * TPT entries (entry
// i * 256 + tid of a chunk is thread tid's i-th). Where c <= 512 the
// piece is one chunk of 512 entries at most (block = 512 / c, at most
// MAX_BLOCK: 42 gaussians at c = 12); a wider table gives a CTA about
// WIDE_SPAN entries (6 gaussians at c = 2500) in chunks of 2,048
// (WIDE_TPT = 8 entries a thread), so that a CTA has 8 KB of table in
// flight. For each chunk:
//  1. Every thread loads its TPT entries, coalesced, all in flight at once.
//     A chunk inside one row that began in an earlier chunk and names
//     nothing stops here (one block-wide vote): most of a wide table.
//  2. The named entries are compacted into a shared list in (gaussian, j)
//     order: a ballot per (entry slot, warp), one warp's scan over the
//     SLOTS counts, and each entry's rank in its ballot. The list position
//     of the first entry of each gaussian's row follows from the same
//     counts and ballots, so gaussian k of the chunk owns list entries
//     [seg[k], seg[k + 1]); nothing is divided per entry.
//  3. All threads stage the listed rows into shared memory: thread (e,
//     col) of a (per x wb) grid copies column col of entries e, e + per,
//     ..., by 4-byte cp.async, so every load of the CTA (about 1,550 at c
//     = 12, W = 25) is in flight at once and no register waits on one.
//  4. Thread (k, col) adds gaussian k's staged values in list order,
//     starting from 0.0f, the order of gather_sum_rows_plain, and stores
//     the (gaussians, W) block, which is contiguous, coalesced. Every
//     output row is written, zero where the table names nothing.
// Wide rows (W > COLS) are summed COLS columns at a time, and a chunk with
// more named values than VALS is summed in passes. A gaussian whose sum
// runs on past a pass or a chunk keeps its partial sum in `out` (written
// and read back by the CTA that owns it, across __syncthreads), so the
// additions stay in j order. Shared memory is static (19.6 KB, and 26.1 KB
// for wide tables) and registers at most 32 (the wide instantiation
// spills 32 B), so an SM holds eight CTAs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NARROW_TPT = 2;       // table entries a thread loads, c <= THREADS * 2
constexpr int WIDE_TPT = 8;         // and per chunk of a wider table
constexpr int MAX_BLOCK = 256;      // gaussians a CTA owns, at most
constexpr int WIDE_SPAN = 16384;    // table entries a CTA owns in a wider table
constexpr int VALS = 4096;          // staged row values (16 KB)
constexpr int COLS = 64;            // columns summed per pass over the list
constexpr int MIN_CTAS = 8;         // CTAs an SM holds: at most 32 registers
constexpr int ERR_SHAPE = -1;       // W < 1 or c < 1

// Shared memory of one chunk's compaction: CHUNK entries, SLOTS ballots.
template <int TPT>
struct Chunk {
  static constexpr int CHUNK = THREADS * TPT, SLOTS = CHUNK / 32;
  static_assert(SLOTS <= 64 && SLOTS % 2 == 0, "one warp scans the ballot counts, two a lane");
  int list[CHUNK];         // the chunk's named pairs, (gaussian, j) order
  unsigned named[SLOTS];   // each (slot, warp)'s ballot
  int base[SLOTS + 1];     // named entries before each; the total
};

// Step 2 for one chunk of `len` entries whose position q is entry q / THREADS
// of thread q % THREADS (`cur`), the first of them column `off` of the
// chunk's first gaussian, `ng` gaussians meeting it: the list and seg.
// Returns the number of named entries; the caller syncs before reading.
template <int TPT>
__device__ __forceinline__ int compact(const int (&cur)[TPT], int len, int ng, int off, int c,
                                       Chunk<TPT>& sh, int* seg) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned m[TPT];
#pragma unroll
  for (int i = 0; i < TPT; ++i) m[i] = __ballot_sync(FULL, cur[i] >= 0);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < TPT; ++i) sh.named[i * WARPS + warp] = m[i];
  }
  __syncthreads();
  constexpr int SLOTS = Chunk<TPT>::SLOTS;
  if (warp == 0) {  // exclusive scan of the counts in (slot, warp) order
    const int a = 2 * lane < SLOTS ? __popc(sh.named[2 * lane]) : 0;
    const int b = 2 * lane < SLOTS ? __popc(sh.named[2 * lane + 1]) : 0;
    int incl = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += t;
    }
    if (2 * lane < SLOTS) {
      sh.base[2 * lane] = incl - a - b;
      sh.base[2 * lane + 1] = incl - b;
    }
    if (lane == 31) sh.base[SLOTS] = incl;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < TPT; ++i) {
    if (cur[i] >= 0) sh.list[sh.base[i * WARPS + warp] + __popc(m[i] & below)] = cur[i];
  }
  // Chunk position q is (slot, warp) q / 32, lane q % 32: the named
  // entries before it are base[q / 32] and those of its ballot below it.
  const int total = sh.base[SLOTS];
  for (int k = tid; k <= ng; k += THREADS) {
    const int q = k == 0 ? 0 : (k == ng ? len : k * c - off);
    seg[k] = q == len ? total
                      : sh.base[q >> 5] + __popc(sh.named[q >> 5] & ((1u << (q & 31)) - 1u));
  }
  return total;
}

// Four bytes from device memory into shared memory, asynchronously: no
// register holds them in flight (cp.async.wait_* waits for a thread's).
__device__ __forceinline__ void copy_async(void* to, const void* from) {
  const unsigned smem = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem), "l"(from) : "memory");
}

// Steps 3 and 4 for one chunk: `total` listed entries, gaussian k of the
// `ng` owning [seg[k], seg[k + 1]), its output row at dst + k * w, the
// first's sum so far there where `began`. The rows are staged into `vals`
// by cp.async: all of a thread's loads in flight at once, and
// cp.async.wait_all waits for every group of the thread.
__device__ __forceinline__ void sum_chunk(const float* __restrict__ rows, int w, int total,
                                          int ng, bool began, const int* list, float* vals,
                                          const int* seg, float* dst) {
  const int tid = threadIdx.x;
  for (int cb = 0; cb < w; cb += COLS) {
    const int wb = min(COLS, w - cb);
    const int per = THREADS / wb;  // entries staged, and gaussians summed, a step
    const int row = tid / wb, col = tid - row * wb;
    const bool on = row < per;
    const int cap = VALS / wb;  // entries staged a pass
    const float* src = rows + cb + col;
    for (int e0 = 0;; e0 += cap) {
      const int e1 = min(total, e0 + cap);
      if (on) {
        for (int x = e0 + row; x < e1; x += per) {
          copy_async(vals + (x - e0) * wb + col, src + static_cast<int64_t>(list[x]) * w);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (on) {
        for (int k = row; k < ng; k += per) {
          const int lo = max(seg[k], e0), hi = min(seg[k + 1], e1);
          const bool partial = e0 > 0 || (k == 0 && began);
          if (partial && lo >= hi) continue;  // out already holds its sum so far
          float* o = dst + static_cast<int64_t>(k) * w + cb + col;
          float acc = partial ? *o : 0.0f;
          for (int e = lo; e < hi; ++e) acc += vals[(e - e0) * wb + col];
          *o = acc;
        }
      }
      __syncthreads();
      if (e1 >= total) break;
    }
  }
}

// A CTA's `block` gaussians: their table rows, block * c entries, a chunk
// of THREADS * TPT entries at a time; one chunk unless WIDE (c > CHUNK),
// which the compiler then folds to the single pass.
template <int TPT, bool WIDE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
gather_sum_rows_kernel(const float* __restrict__ rows, const int* __restrict__ table,
                       int64_t n, int c, int w, int block, float* out) {
  constexpr int CHUNK = Chunk<TPT>::CHUNK;
  __shared__ Chunk<TPT> sh;
  __shared__ float vals[VALS];        // the rows' values, entry-major
  __shared__ int seg[MAX_BLOCK + 1];  // gaussian k of a chunk's: [seg[k], seg[k + 1])
  const int tid = threadIdx.x;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * block;
  const int span = static_cast<int>(n - g0 < block ? n - g0 : block) * c;
  const int* tab = table + g0 * c;
  float* dst = out + g0 * w;
  // The chunk's first entry is column `off` of the CTA's gaussian g_lo; a
  // gaussian whose row began in an earlier chunk (`off` > 0) has its sum
  // so far in out.
  int g_lo = 0, off = 0;
  const int chunks = WIDE ? (span + CHUNK - 1) / CHUNK : 1;
  for (int k = 0; k < chunks; ++k) {
    const int k0 = k * CHUNK, len = min(CHUNK, span - k0);
    int cur[TPT];
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int q = i * THREADS + tid;
      cur[i] = q < len ? __ldg(tab + k0 + q) : -1;
    }
    const int ng = (off + len - 1) / c + 1;  // the rows that meet the chunk
    // A chunk inside one row that began earlier and names nothing leaves
    // that row's sum in out as it is (one block-wide vote).
    bool any = false;
#pragma unroll
    for (int i = 0; i < TPT; ++i) any |= cur[i] >= 0;
    if (off == 0 || ng > 1 || __syncthreads_or(any)) {
      const int total = compact<TPT>(cur, len, ng, off, c, sh, seg);
      __syncthreads();
      sum_chunk(rows, w, total, ng, off != 0, sh.list, vals, seg,
                dst + static_cast<int64_t>(g_lo) * w);
    }
    off += len;
    g_lo += off / c;
    off %= c;
  }
}

}  // namespace

// Plain C entry point for ctypes: rows (P, w) float32, table (n, c) int32
// with entries in [-1, P), out (n, w) float32, all contiguous device
// memory. Returns cudaGetLastError() after the launch (0 = launched), or
// ERR_SHAPE. The wrapper answers n = 0 and c = 0 without a call.
extern "C" int gs_gather_sum_rows(const float* rows, const int* table, int64_t n, int c,
                                  int w, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1 || c < 1) return ERR_SHAPE;
  if (n <= 0) return 0;
  constexpr int narrow = Chunk<NARROW_TPT>::CHUNK;
  const bool wide = c > narrow;
  int block = wide ? WIDE_SPAN / c : narrow / c;
  block = block < 1 ? 1 : (block > MAX_BLOCK ? MAX_BLOCK : block);
  const unsigned blocks = static_cast<unsigned>((n + block - 1) / block);
  if (wide) {
    gather_sum_rows_kernel<WIDE_TPT, true><<<blocks, THREADS, 0, s>>>(rows, table, n, c, w, block,
                                                                     out);
  } else {
    gather_sum_rows_kernel<NARROW_TPT, false><<<blocks, THREADS, 0, s>>>(rows, table, n, c, w,
                                                                         block, out);
  }
  return static_cast<int>(cudaGetLastError());
}
