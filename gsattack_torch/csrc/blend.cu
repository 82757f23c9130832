// Tile blend, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of gsattack/ops/pallas_blend.py:
//   blend_fwd_kernel <- _fwd_kernel (launched by _fwd_impl)
//   blend_bwd_kernel <- _bwd_kernel (launched by _blend_bwd)
// The semantics are those of the reference blend (gsattack/ops/raster.py
// _blend_tiles): for each (view, 16x16 tile), front-to-back compositing of
// the tile's depth-sorted pairs with alpha = min(0.99, op * exp(power)),
// alpha skipped where power > 0 or alpha < 1/255, and a pixel stopping
// *before* the pair whose T * (1 - alpha) would fall below 1e-4 (that pair
// is not composited). A tile blends at most `cap` pairs.
//
// One CTA of 256 threads per (tile, view), one thread per pixel; each
// thread walks its pixel's pairs serially, so the 1e-4 stop holds
// literally. The forward saves the Inria form of state for the backward:
// final T and, per pixel, the count of pairs up to and including its last
// contributor. The power and alpha of a (pixel, pair) come from one
// function with rounded intrinsics (no FMA contraction), so both kernels
// make the same skip decisions as each other, bit for bit.
//
// Staging. A batch of pairs is gathered through gauss_idx into shared
// memory as packed records, {mx, my, A, B} and {C, op, box x, box y} as
// float4s, then the colours in two blocks (below). A group of NP lanes
// loads a pair (NP = 32 for CH = 19, 16 for CH = 3), lane q copying field q
// with one 4-byte cp.async, so the next batch is in flight while one is
// walked, and a batch costs one barrier. Nothing of the staging is held in
// registers across the walk: registers decide the CTAs an SM holds, and
// both kernels wait on latency.
//
// Forward. 64-pair batches (a tile averages ~59 on the main path) in two
// buffers; the CTA leaves once every pixel is done (__syncthreads_count).
// Before a batch is walked, each record gets the half-widths of the box
// outside which its alpha is below 1/255 (pair_extent, with margins), and
// a pixel outside skips the pair without computing its alpha. The image
// tile is composed in shared memory and written a row (16 * CH contiguous
// floats) at a time in 16-byte stores; T and `last` go per pixel,
// coalesced.
//
// Backward. Each pixel walks back to front from its last contributor,
// recovering the transmittance before each pair as T / (1 - alpha). The
// suffix S is seeded with T_final * gT, so the gradient through the
// returned transmittance is included. The power gradient is zeroed where
// the pre-clamp alpha exceeds 0.99, as the reference (and JAX's AD of
// jnp.minimum) does. The tile's g_img comes in through shared memory
// (16-byte cp.async; each thread reads its CH values at an odd word
// stride, free of bank conflicts). For each (warp, pair) with a live lane,
// the 6 + CH gradient values, padded to NP slots, are summed over the warp
// by a reduce-scatter: halving steps of __shfl_xor_sync leave lane q with
// the warp's sum of slot q, 31 shuffles (16 for CH = 3) where a butterfly
// per value took 125 (45). The first step builds the values as it sends
// or keeps them, without selects: the geometry values pair with zero
// slots, and colour slots j and CB + j pair channels whose g_img factors
// each half-warp holds in send / keep order (gS, gK), reading the pair's
// colour blocks in the same order. Lane q stores its warp's sum of slot q
// for the pair in the warp's own slots in shared memory (zero when no
// lane of the warp is live). After the batch, the 8 warps' sums of each
// (pair, value) are added in warp order and stored, with plain coalesced
// stores, in the pair's row of d_pair (P, 6 + CH): mean2d 2, conic 3,
// opacity 1, then the colours. A pair lies in one tile, so one CTA owns
// its row; the tile's rows past its deepest last contributor are zeros.
// The per-gaussian sum of the rows is a second kernel (gather_sum.cu),
// over the binning's slot table. No step uses atomics, so the gradients
// are the same from run to run, bit for bit. The warps' sums share the
// memory g_img came in through (each thread holds its own g_img by then);
// two staging buffers suffice, since a batch is flushed before the next
// is walked, at one barrier more a batch than the atomics took.
//
// What bounds it on an H100: every (pixel, pair) a kernel evaluates costs
// the alpha test, 17 fp32 operations with one exp; a live (composited)
// pair adds 4 + 2*CH in the forward, and 28 + 3*CH in the backward plus
// 6 + CH adds to sum its gradients over the tile. Per pair a CTA gathers
// (6 + CH) * 4 bytes plus a 4-byte index, and the backward writes its
// (6 + CH) * 4-byte row; the image, T and `last` are written (read back,
// with g_img, in the backward) once per pixel. chip_smoke.py counts both from a run's inputs: bytes bound both
// kernels. Neither reaches that bound. The backward's time goes to the
// (warp, pair) steps with a live lane, ~250 instructions each of which the
// reduce-scatter takes half; the forward's to the alpha tests of a tile's
// pairs and each CTA's two dependent gathers (indices, then fields).
//
// What each step bought, at chip_smoke.py phase 3's shapes on an NVIDIA
// H100 80GB HBM3 at 700 W (gsattack_torch/scripts/blend_ab.py; the steps
// are commits; PERF.md has every run). Backward, from 1.881 ms: the
// reduce-scatter 1.028; shared atomics 1.068; the cp.async ring 1.357 (95
// registers, 2 CTAs an SM); g_img through shared memory 1.352; nothing
// held across the walk, 64 registers and 4 CTAs 0.957 (its own call:
// parent 1.898); one reciprocal 0.886 and the select-free first step
// 0.864 (their call: parent 1.885). Forward, from 0.432 ms: cp.async
// staging and packed records 0.478 (64 registers, 4 CTAs); the image
// through shared memory 0.323; the alpha box 0.306, and 0.324 with the
// two colour blocks the backward needs.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;
constexpr int NWARP = BLOCK / 32;
constexpr int FWD_BATCH = 64;  // pairs staged per forward step
constexpr int BWD_BATCH = 32;  // pairs staged per backward step
constexpr int BWD_MIN_CTAS = 4;  // backward CTAs per SM that ptxas must fit
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_EPS = 1e-4f;

struct Alpha {
  float power;      // Mahalanobis power
  float expo;       // exp(min(power, 0))
  float alpha_pre;  // op * expo, before the 0.99 cap
  float alpha;      // min(0.99, alpha_pre)
  bool use;         // power <= 0 and alpha >= 1/255
};

__device__ __forceinline__ Alpha pair_alpha(float dx, float dy, float A, float B,
                                            float C, float op) {
  Alpha r;
  const float qa = __fmul_rn(__fmul_rn(A, dx), dx);
  const float qc = __fmul_rn(__fmul_rn(C, dy), dy);
  const float qb = __fmul_rn(__fmul_rn(B, dx), dy);
  r.power = __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(qa, qc)), qb);
  r.expo = expf(fminf(r.power, 0.0f));
  r.alpha_pre = __fmul_rn(op, r.expo);
  r.alpha = fminf(ALPHA_MAX, r.alpha_pre);
  r.use = (r.power <= 0.0f) && (r.alpha >= ALPHA_MIN);
  return r;
}

// The staged record of one pair: {mx, my, A, B}, {C, op, box x, box y},
// then the colours in two blocks of CB channels, each padded to CBP floats:
// channels [0, CB) and [CB, 2 CB), the latter zero past CH. The backward's
// reduce-scatter pairs channel j with channel CB + j in its first step.
template <int CH>
struct Pairs {
  static constexpr int NV = 6 + CH;                  // dmx, dmy, dA, dB, dC, dop, dcol[CH]
  static constexpr int NP = NV <= 16 ? 16 : 32;      // lanes per pair; padded value count
  static constexpr int H1 = NP / 2;                  // the reduce-scatter's first step
  static constexpr int CB = H1 - 6;                  // colour channels per block
  static constexpr int CBP = (CB + 3) / 4 * 4;       // floats per colour block
  static constexpr int STRIDE = 8 + 2 * CBP;         // floats per staged pair
  static_assert(NV <= 32, "a warp sums at most 32 values per pair");
  static_assert(CB <= CH && 2 * CB >= CH && CB % 2 == 0, "two even blocks hold the colours");
  __device__ static constexpr int col_pos(int ch) {
    return ch < CB ? 8 + ch : 8 + CBP + (ch - CB);
  }
};

// f(j, x) for the CB floats of a colour block at p (16-byte aligned), read
// as float4s and a float2.
template <int CB, typename F>
__device__ __forceinline__ void for_block(const float* p, const F& f) {
#pragma unroll
  for (int j = 0; j + 4 <= CB; j += 4) {
    const float4 c = *reinterpret_cast<const float4*>(p + j);
    f(j, c.x), f(j + 1, c.y), f(j + 2, c.z), f(j + 3, c.w);
  }
  if constexpr (CB % 4 == 2) {
    const float2 c = *reinterpret_cast<const float2*>(p + CB - 2);
    f(CB - 2, c.x), f(CB - 1, c.y);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Half-widths (x, y) of a box around the pair's mean outside which its
// alpha is below 1/255 (power <= -ln(255 op)): sqrt(2 ln(255 op) C / det)
// and sqrt(2 ln(255 op) A / det), widened by 5% in power and 0.5 px, so
// that no pixel pair_alpha would use lies outside. -1 for a pair that is
// never used (op < 1/255); +inf (no box) for a conic that is not positive
// definite or whose condition number passes ~1e4, where rounding in the
// power could outgrow the margin.
__device__ __forceinline__ float2 pair_extent(float A, float B, float C, float op) {
  if (!(op >= ALPHA_MIN)) return make_float2(-1.0f, -1.0f);
  const float det = A * C - B * B, tr = A + C;
  const float inf = __int_as_float(0x7f800000);
  if (!(A > 0.0f && C > 0.0f && det * 1e4f > tr * tr)) return make_float2(inf, inf);
  const float L = 2.1f * fmaxf(logf(op * 255.0f), 0.0f);
  return make_float2(sqrtf(L * C / det) + 0.5f, sqrtf(L * A / det) + 0.5f);
}

// Batch records [0, n): their boxes into the record's floats 6 and 7.
template <int CH>
__device__ __forceinline__ void record_extents(float* buf, int n) {
  for (int k = threadIdx.x; k < n; k += BLOCK) {
    float* pk = buf + k * Pairs<CH>::STRIDE;
    const float2 e = pair_extent(pk[2], pk[3], pk[4], pk[5]);
    pk[6] = e.x, pk[7] = e.y;
  }
}

// Stage pairs [first, first + n) of gauss_idx into `buf` as packed
// records (STRIDE floats each): a group of NP threads per pair, thread q
// of the group copying field q with one 4-byte cp.async; the group's
// thread 0 records the gaussian in `gids` (when given). Commits one group.
template <int CH, int BATCH>
__device__ __forceinline__ void stage_batch(float* buf, int* gids,
                                            const int* __restrict__ gauss_idx, int first,
                                            int n, const float* mean2d, const float* conic,
                                            const float* opacity, const float* colors) {
  using P = Pairs<CH>;
  constexpr int STEP = BLOCK / P::NP;  // pairs per pass of the CTA
  constexpr int ITER = BATCH / STEP;
  static_assert(ITER * STEP == BATCH, "a batch is whole passes of the CTA");
  const int t = threadIdx.x, q = t % P::NP, k0 = t / P::NP;
  int gid[ITER];
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int k = k0 + i * STEP;
    gid[i] = k < n ? __ldg(gauss_idx + first + k) : -1;
  }
  const float* base = q < 2 ? mean2d + q : q < 5 ? conic + (q - 2) : q == 5 ? opacity
                                                                            : colors + (q - 6);
  const int stride = q < 2 ? 2 : q < 5 ? 3 : q == 5 ? 1 : CH;
  const int pos = q < 6 ? q : P::col_pos(q - 6);
#pragma unroll
  for (int i = 0; i < ITER; ++i) {
    const int k = k0 + i * STEP;
    if (gid[i] < 0) continue;
    if (q < P::NV) cp_async4(buf + k * P::STRIDE + pos, base + (size_t)gid[i] * stride);
    if (gids != nullptr && q == 0) gids[k] = gid[i];
  }
  cp_async_commit();
}

// Lane q of the warp ends with the warp's sum of v[q] (for NP = 16, lanes q
// and q + 16 both do): each halving step keeps the half of v that bit H of
// the lane selects and adds the partner lane's copy of it.
template <int H, int NP>
__device__ __forceinline__ void halve(float (&v)[NP], int lane) {
  const bool upper = (lane & H) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, H);
  }
  if constexpr (H > 1) halve<H / 2, NP>(v, lane);
}

struct TileCtx {
  int tile, view, x0, y0, px, py, pix, start, count;
};

__device__ __forceinline__ TileCtx tile_ctx(const int* tile_start, const int* tile_end,
                                            int tiles_x, int tiles_y, int cap) {
  TileCtx c;
  c.tile = blockIdx.x;
  c.view = blockIdx.y;
  const int t = threadIdx.x;
  c.x0 = (c.tile % tiles_x) * TILE;
  c.y0 = (c.tile / tiles_x) * TILE;
  c.px = c.x0 + t % TILE;
  c.py = c.y0 + t / TILE;
  const int w_pad = tiles_x * TILE, h_pad = tiles_y * TILE;
  c.pix = (c.view * h_pad + c.py) * w_pad + c.px;
  const int r = c.view * tiles_x * tiles_y + c.tile;
  c.start = tile_start[r];
  c.count = min(max(tile_end[r] - c.start, 0), cap);
  return c;
}

// Offset in floats of the first pixel of row `r` of the tile in a
// (V, H_pad, W_pad, CH) image; a row is 16 * CH contiguous floats.
template <int CH>
__device__ __forceinline__ size_t tile_row(const TileCtx& c, int r, int tiles_x,
                                           int tiles_y) {
  const int w_pad = tiles_x * TILE, h_pad = tiles_y * TILE;
  return ((size_t)(c.view * h_pad + c.y0 + r) * w_pad + c.x0) * CH;
}

template <int CH>
__global__ void __launch_bounds__(BLOCK)
blend_fwd_kernel(const float* __restrict__ mean2d, const float* __restrict__ conic,
                 const float* __restrict__ opacity, const float* __restrict__ colors,
                 const int* __restrict__ gauss_idx, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int tiles_x, int tiles_y, int cap,
                 float* __restrict__ out_img, float* __restrict__ out_T,
                 int* __restrict__ out_last) {
  using P = Pairs<CH>;
  constexpr int STAGE = FWD_BATCH * P::STRIDE;  // floats per staging buffer
  // The two staging buffers, then the image tile in the same memory.
  constexpr int SMEM = 2 * STAGE > BLOCK * CH ? 2 * STAGE : BLOCK * CH;
  __shared__ __align__(16) float smem[SMEM];

  const TileCtx c = tile_ctx(tile_start, tile_end, tiles_x, tiles_y, cap);
  const int t = threadIdx.x;
  const float pxf = (float)c.px, pyf = (float)c.py;
  const int nb = (c.count + FWD_BATCH - 1) / FWD_BATCH;
  const auto batch_n = [&](int b) { return min(FWD_BATCH, c.count - b * FWD_BATCH); };

  const auto stage = [&](int b) {
    stage_batch<CH, FWD_BATCH>(smem + (b & 1) * STAGE, nullptr, gauss_idx,
                               c.start + b * FWD_BATCH, batch_n(b), mean2d, conic, opacity,
                               colors);
  };
  if (nb > 0) stage(0);

  float acc[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) acc[ch] = 0.0f;
  float T = 1.0f;
  int last = 0;
  bool done = false;

  for (int b = 0; b < nb; ++b) {
    cp_async_wait<0>();
    // Also the barrier that frees the buffer the next batch goes into.
    if (__syncthreads_count(done) == BLOCK) break;
    if (b + 1 < nb) stage(b + 1);
    float* buf = smem + (b & 1) * STAGE;
    const int b0 = b * FWD_BATCH, n = batch_n(b);
    record_extents<CH>(buf, n);
    __syncthreads();
    for (int k = 0; k < n && !done; ++k) {
      const float* pk = buf + k * P::STRIDE;
      const float4 g0 = *reinterpret_cast<const float4*>(pk);
      const float4 g1 = *reinterpret_cast<const float4*>(pk + 4);
      const float dx = pxf - g0.x, dy = pyf - g0.y;
      if (fabsf(dx) > g1.z || fabsf(dy) > g1.w) continue;
      const Alpha a = pair_alpha(dx, dy, g0.z, g0.w, g1.x, g1.y);
      if (!a.use) continue;
      const float test = T * (1.0f - a.alpha);
      if (test < T_EPS) {
        done = true;
        break;
      }
      const float w = a.alpha * T;
      for_block<P::CB>(pk + 8, [&](int j, float col) { acc[j] += w * col; });
      for_block<P::CB>(pk + 8 + P::CBP, [&](int j, float col) {
        if (P::CB + j < CH) acc[P::CB + j] += w * col;
      });
      T = test;
      last = b0 + k + 1;
    }
  }

  out_T[c.pix] = T;
  out_last[c.pix] = last;
  __syncthreads();  // every thread has left the walk: the buffers become the image
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) smem[t * CH + ch] = acc[ch];
  __syncthreads();
  constexpr int ROW4 = 4 * CH;  // float4s in a tile row
  for (int i = t; i < TILE * ROW4; i += BLOCK) {
    const int r = i / ROW4, j = i - r * ROW4;
    *reinterpret_cast<float4*>(out_img + tile_row<CH>(c, r, tiles_x, tiles_y) + 4 * j) =
        *reinterpret_cast<const float4*>(smem + r * TILE * CH + 4 * j);
  }
}

template <int CH>
__global__ void __launch_bounds__(BLOCK, BWD_MIN_CTAS)
blend_bwd_kernel(const float* __restrict__ mean2d, const float* __restrict__ conic,
                 const float* __restrict__ opacity, const float* __restrict__ colors,
                 const int* __restrict__ gauss_idx, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int tiles_x, int tiles_y,
                 const float* __restrict__ out_T, const int* __restrict__ last,
                 const float* __restrict__ g_img, const float* __restrict__ g_T,
                 float* __restrict__ d_pair) {
  using P = Pairs<CH>;
  constexpr int NP = P::NP, NV = P::NV;
  constexpr int STAGE = BWD_BATCH * P::STRIDE;
  constexpr int PART = NWARP * BWD_BATCH * NP;  // per-warp sums of a batch's pairs
  // The tile's g_img until each thread holds its own, then the same memory
  // holds the warps' per-pair sums.
  constexpr int SHARED = BLOCK * CH > PART ? BLOCK * CH : PART;
  __shared__ __align__(16) float s_shared[SHARED];
  __shared__ __align__(16) float s_pairs[2 * STAGE];  // two staged batches
  __shared__ int s_wmax[NWARP];
  float* const s_img = s_shared;
  float* const s_part = s_shared;

  // The forward's cap is already folded into `last`.
  const TileCtx c = tile_ctx(tile_start, tile_end, tiles_x, tiles_y, 0x7fffffff);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float pxf = (float)c.px, pyf = (float)c.py;

  constexpr int ROW4 = 4 * CH;
  for (int i = t; i < TILE * ROW4; i += BLOCK) {
    const int r = i / ROW4, j = i - r * ROW4;
    cp_async16(s_img + r * TILE * CH + 4 * j,
               g_img + tile_row<CH>(c, r, tiles_x, tiles_y) + 4 * j);
  }
  cp_async_commit();
  for (int i = t; i < 2 * STAGE; i += BLOCK) s_pairs[i] = 0.0f;  // the colour pads

  const int my_last = last[c.pix];
  float T = out_T[c.pix];
  float S = T * g_T[c.pix];
  const int wmax = __reduce_max_sync(FULL, my_last);
  if (lane == 0) s_wmax[warp] = wmax;
  __syncthreads();
  int n_hi = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) n_hi = max(n_hi, s_wmax[w]);
  // The rows of the tile's pairs past every pixel's last contributor
  // (those past the forward's cap among them) are zero.
  for (int i = t; i < (c.count - n_hi) * NV; i += BLOCK)
    d_pair[(size_t)(c.start + n_hi) * NV + i] = 0.0f;
  if (n_hi == 0) {  // no pixel of the tile has a contributor
    cp_async_wait<0>();
    return;
  }

  // Batch b holds pairs [lo(b), lo(b) + n(b)), from the top down.
  const int nb = (n_hi + BWD_BATCH - 1) / BWD_BATCH;
  const auto batch_lo = [&](int b) { return max(n_hi - (b + 1) * BWD_BATCH, 0); };
  const auto batch_n = [&](int b) { return n_hi - b * BWD_BATCH - batch_lo(b); };

  const auto stage = [&](int b) {
    stage_batch<CH, BWD_BATCH>(s_pairs + (b & 1) * STAGE, nullptr, gauss_idx,
                               c.start + batch_lo(b), batch_n(b), mean2d, conic, opacity,
                               colors);
  };
  stage(0);
  cp_async_wait<1>();  // the g_img tile; batch 0 may still be in flight
  __syncthreads();
  // This pixel's g_img as the reduce-scatter's first step sends (gS) and
  // keeps (gK) it: the lower half-warp keeps channel j and sends channel
  // CB + j, the upper half the other way round.
  constexpr int H1 = P::H1, CB = P::CB;
  const bool upper1 = (lane & H1) != 0;
  float gK[CB], gS[CB];
#pragma unroll
  for (int j = 0; j < CB; ++j) {
    const float ga = s_img[t * CH + j], gb = CB + j < CH ? s_img[t * CH + CB + j] : 0.0f;
    gK[j] = upper1 ? gb : ga;
    gS[j] = upper1 ? ga : gb;
  }

  // Batch b's rows: each pair's NV sums, the warps' partial sums added in
  // warp order, stored to the pair's row with plain (coalesced) stores.
  // Value v of a row lives in slot v below 6, channel v - 6 in slot v below
  // 6 + CB and in slot H1 + v - CB past it (nothing in [H1, H1 + 6)).
  const auto flush = [&](int b) {
    const int n = batch_n(b);
    float* dst = d_pair + (size_t)(c.start + batch_lo(b)) * NV;
    for (int i = t; i < n * NV; i += BLOCK) {
      const int k = i / NV, v = i - k * NV;
      const int q = v < 6 + CB ? v : H1 + v - CB;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += s_part[(w * BWD_BATCH + k) * NP + q];
      dst[i] = sum;
    }
  };

  for (int b = 0; b < nb; ++b) {
    cp_async_wait<0>();
    // Batch b has landed; every thread has flushed batch b - 1, whose
    // staging buffer the next batch reuses and whose sums this one's
    // overwrite (every thread has read its g_img before the first).
    __syncthreads();
    if (b + 1 < nb) stage(b + 1);

    const float* buf = s_pairs + (b & 1) * STAGE;
    float* part = s_part + warp * BWD_BATCH * NP;
    const int lo = batch_lo(b);
    for (int k = batch_n(b) - 1; k >= 0; --k) {
      const float* pk = buf + k * P::STRIDE;
      const float4 g0 = *reinterpret_cast<const float4*>(pk);
      const float2 g1 = *reinterpret_cast<const float2*>(pk + 4);
      const float dx = pxf - g0.x, dy = pyf - g0.y;
      bool use = false;
      Alpha a;
      if (lo + k < my_last) {
        a = pair_alpha(dx, dy, g0.z, g0.w, g1.x, g1.y);
        use = a.use;
      }
      if (__ballot_sync(FULL, use) == 0u) {
        if (lane < NP) part[k * NP + lane] = 0.0f;
        continue;
      }
      // A live lane's factors of its gradient values; 0 on the other lanes.
      float px_ = 0.0f, py_ = 0.0f, fo = 0.0f, fw = 0.0f;
      if (use) {
        const float inv = __fdividef(1.0f, 1.0f - a.alpha);
        const float t_exc = T * inv;
        // Colour . g_img, each half-warp reading its blocks in the order
        // of its coefficients.
        float cg = 0.0f;
        for_block<CB>(pk + 8 + (upper1 ? P::CBP : 0), [&](int j, float col) { cg += col * gK[j]; });
        for_block<CB>(pk + 8 + (upper1 ? 0 : P::CBP), [&](int j, float col) { cg += col * gS[j]; });
        const float w = a.alpha * t_exc;
        const float dalpha = t_exc * cg - S * inv;
        S += w * cg;
        T = t_exc;
        // d/d_power, zero past the 0.99 clamp; d/d_opacity = dalpha *
        // exp(power) = dpower / op, without the division (and so without
        // the reference's op = 0 guard).
        const bool clamped = a.alpha_pre > ALPHA_MAX;
        const float fd = clamped ? 0.0f : dalpha * a.alpha_pre;
        fo = clamped ? 0.0f : dalpha * a.expo;
        fw = w;
        px_ = fd * dx, py_ = fd * dy;
      }
      const float A = g0.z, B = g0.w, C = g1.x;
      // The reduce-scatter's first step builds the values as it sends or
      // keeps them: the geometry values (slots 0-5) pair with zeros, the
      // colour slots 6 + j and H1 + 6 + j hold channels j and CB + j.
      float v[H1];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float g = i == 0   ? A * px_ + B * py_
                        : i == 1 ? C * py_ + B * px_
                        : i == 2 ? -0.5f * px_ * dx
                        : i == 3 ? -px_ * dy
                        : i == 4 ? -0.5f * py_ * dy
                                 : fo;
        v[i] = (upper1 ? 0.0f : g) + __shfl_xor_sync(FULL, upper1 ? g : 0.0f, H1);
      }
#pragma unroll
      for (int i = 6; i < H1; ++i)
        v[i] = fw * gK[i - 6] + __shfl_xor_sync(FULL, fw * gS[i - 6], H1);
      halve<H1 / 2, H1>(v, lane);
      float sum = v[0];
      if constexpr (NP == 16) sum += __shfl_xor_sync(FULL, sum, 16);
      if (lane < NP) part[k * NP + lane] = sum;
    }
    __syncthreads();  // every warp's sums of batch b are in
    flush(b);
  }
}

template <int CH>
int launch_fwd(const float* mean2d, const float* conic, const float* opacity,
               const float* colors, const int* gauss_idx, const int* tile_start,
               const int* tile_end, int num_views, int tiles_x, int tiles_y, int cap,
               float* out_img, float* out_T, int* out_last, cudaStream_t stream) {
  const dim3 grid(tiles_x * tiles_y, num_views);
  blend_fwd_kernel<CH><<<grid, BLOCK, 0, stream>>>(
      mean2d, conic, opacity, colors, gauss_idx, tile_start, tile_end, tiles_x,
      tiles_y, cap, out_img, out_T, out_last);
  return (int)cudaGetLastError();
}

template <int CH>
int launch_bwd(const float* mean2d, const float* conic, const float* opacity,
               const float* colors, const int* gauss_idx, const int* tile_start,
               const int* tile_end, int num_views, int tiles_x, int tiles_y,
               const float* out_T, const int* last, const float* g_img,
               const float* g_T, float* d_pair, cudaStream_t stream) {
  const dim3 grid(tiles_x * tiles_y, num_views);
  blend_bwd_kernel<CH><<<grid, BLOCK, 0, stream>>>(
      mean2d, conic, opacity, colors, gauss_idx, tile_start, tile_end, tiles_x,
      tiles_y, out_T, last, g_img, g_T, d_pair);
  return (int)cudaGetLastError();
}

constexpr int ERR_CHANNELS = -1;  // no kernel instantiated for this CH

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// its launch (0 = launched), or ERR_CHANNELS for an unsupported channel
// count. Pointers are device pointers; all float arrays are contiguous
// float32 and all index arrays int32. The image is (V, H_pad, W_pad, CH),
// 16-byte aligned (as every PyTorch allocation is).
extern "C" int gs_blend_fwd(const float* mean2d, const float* conic,
                            const float* opacity, const float* colors,
                            const int* gauss_idx, const int* tile_start,
                            const int* tile_end, int n_ch, int num_views, int tiles_x,
                            int tiles_y, int cap, float* out_img, float* out_T,
                            int* out_last, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_ch) {
    case 3:
      return launch_fwd<3>(mean2d, conic, opacity, colors, gauss_idx, tile_start,
                           tile_end, num_views, tiles_x, tiles_y, cap, out_img, out_T,
                           out_last, s);
    case 19:
      return launch_fwd<19>(mean2d, conic, opacity, colors, gauss_idx, tile_start,
                            tile_end, num_views, tiles_x, tiles_y, cap, out_img, out_T,
                            out_last, s);
    default:
      return ERR_CHANNELS;
  }
}

extern "C" int gs_blend_bwd(const float* mean2d, const float* conic,
                            const float* opacity, const float* colors,
                            const int* gauss_idx, const int* tile_start,
                            const int* tile_end, int n_ch, int num_views, int tiles_x,
                            int tiles_y, const float* out_T, const int* last,
                            const float* g_img, const float* g_T, float* d_pair,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_ch) {
    case 3:
      return launch_bwd<3>(mean2d, conic, opacity, colors, gauss_idx, tile_start,
                           tile_end, num_views, tiles_x, tiles_y, out_T, last, g_img,
                           g_T, d_pair, s);
    case 19:
      return launch_bwd<19>(mean2d, conic, opacity, colors, gauss_idx, tile_start,
                            tile_end, num_views, tiles_x, tiles_y, out_T, last, g_img,
                            g_T, d_pair, s);
    default:
      return ERR_CHANNELS;
  }
}
