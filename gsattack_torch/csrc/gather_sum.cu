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
// atomics (or torch.index_add_) would not.
//
// Design. A group of GW lanes (8, 16 or 32, the least that holds W, or 32
// with a loop over column blocks) owns one gaussian; lane q of the group
// owns column q. The group reads its table row GW entries at a time, one
// entry a lane, coalesced; a warp ballot gives each group the columns that
// hold a pair, and the group walks them in ascending j, each lane adding
// its column of that pair's row (a row is W contiguous floats, so the
// group's loads are one contiguous piece). Only the rows the table names
// are read: on the main path about 3 of the c columns a gaussian. Every
// output row is written, zero where the table names no pair.
//
// What bounds it on an H100: bytes. It reads the table (4 c B a
// gaussian), each named row once (4 W B) and writes each output row
// (4 W B) once, and computes one add per named float.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int ERR_WIDTH = -1;  // W < 1

template <int GW>
__global__ void __launch_bounds__(THREADS)
gather_sum_rows_kernel(const float* __restrict__ rows, const int* __restrict__ table,
                       int64_t n, int c, int w, float* __restrict__ out) {
  constexpr int GROUPS = 32 / GW;  // gaussians a warp
  const int lane = threadIdx.x & 31, q = lane % GW, grp = lane / GW;
  const int64_t g = (static_cast<int64_t>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32) *
                        GROUPS + grp;
  const bool active = g < n;  // every lane takes part in the ballots
  const int* trow = table + (active ? g : 0) * c;
  const unsigned gmask = GW == 32 ? FULL : ((1u << GW) - 1u) << (grp * GW);
  for (int col0 = 0; col0 < w; col0 += GW) {
    const int col = col0 + q;
    float acc = 0.0f;
    for (int j0 = 0; j0 < c; j0 += GW) {
      const int j = j0 + q;
      const int r = active && j < c ? __ldg(trow + j) : -1;
      unsigned m = (__ballot_sync(FULL, r >= 0) & gmask) >> (grp * GW);
      while (m) {
        const int b = __ffs(m) - 1;
        m &= m - 1;
        const int rb = __ldg(trow + j0 + b);  // the entry lane b read, from L1
        if (col < w) acc += __ldg(rows + static_cast<int64_t>(rb) * w + col);
      }
    }
    if (active && col < w) out[g * w + col] = acc;
  }
}

template <int GW>
int launch(const float* rows, const int* table, int64_t n, int c, int w, float* out,
           cudaStream_t stream) {
  const int64_t per_block = (THREADS / 32) * (32 / GW);
  const int64_t blocks = (n + per_block - 1) / per_block;
  gather_sum_rows_kernel<GW><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      rows, table, n, c, w, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes: rows (P, w) float32, table (n, c) int32
// with entries in [-1, P), out (n, w) float32, all contiguous device
// memory. Returns cudaGetLastError() after the launch (0 = launched), or
// ERR_WIDTH. The wrapper launches nothing for n = 0.
extern "C" int gs_gather_sum_rows(const float* rows, const int* table, int64_t n, int c,
                                  int w, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1) return ERR_WIDTH;
  if (w <= 8) return launch<8>(rows, table, n, c, w, out, s);
  if (w <= 16) return launch<16>(rows, table, n, c, w, out, s);
  return launch<32>(rows, table, n, c, w, out, s);
}
