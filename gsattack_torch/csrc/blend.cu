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
// Design. One CTA of 256 threads per (tile, view), one thread per pixel.
// The CTA stages batches of pairs in shared memory, gathered through
// gauss_idx from the per-gaussian arrays, and every thread composites its
// pixel serially; the serial walk is exact, so none of the TPU kernel's
// triangular-matmul cumsums or field-major packing carries over. The CTA
// leaves once every pixel is done (__syncthreads_count). The forward saves
// the Inria form of state for the backward: final T and, per pixel, the
// count of pairs up to and including its last contributor.
//
// The backward walks each pixel's pairs back to front from its last
// contributor, recovering the transmittance before each pair as
// T / (1 - alpha). The suffix S is seeded with T_final * gT, so the
// gradient through the returned transmittance is included. The power
// gradient is zeroed where the pre-clamp alpha exceeds 0.99, as the
// reference (and JAX's AD of jnp.minimum) does. Each pair's gradient is
// summed over the tile's pixels (warp shuffles, then shared memory across
// the 8 warps) and added per gaussian with atomicAdd, so the sum order
// changes from run to run: results agree with the plain version to float
// rounding, not bit for bit.
//
// What bounds it on an H100: every (pixel, pair) a kernel evaluates costs
// the alpha test, 17 fp32 operations with one exp; a live (composited)
// pair adds 4 + 2*CH in the forward, and 28 + 3*CH in the backward plus
// 6 + CH adds to sum its gradients over the tile. Most evaluated pairs
// fail the test. Per pair a CTA gathers (6 + CH) * 4 bytes plus a 4-byte
// index; the image, T and `last` are written (read back, with the
// gradients, in the backward) once per pixel. chip_smoke.py counts both
// from a run's inputs. This simple version spends its time on serial
// per-pixel walks, uncoalesced gathers and (backward) shuffle reductions
// and atomics. Making it fast is later work.
//
// The power and alpha of a (pixel, pair) are computed by one function with
// rounded intrinsics (no FMA contraction), so the forward and the backward
// make the same skip decisions bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int BLOCK = TILE * TILE;
constexpr int NWARP = BLOCK / 32;
constexpr int BWD_BATCH = 32;  // pairs staged per backward step
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct TileCtx {
  int tile, view, px, py, pix, start, count;
};

__device__ __forceinline__ TileCtx tile_ctx(const int* tile_start, const int* tile_end,
                                            int tiles_x, int tiles_y, int cap) {
  TileCtx c;
  c.tile = blockIdx.x;
  c.view = blockIdx.y;
  const int t = threadIdx.x;
  c.px = (c.tile % tiles_x) * TILE + t % TILE;
  c.py = (c.tile / tiles_x) * TILE + t / TILE;
  const int w_pad = tiles_x * TILE, h_pad = tiles_y * TILE;
  c.pix = (c.view * h_pad + c.py) * w_pad + c.px;
  const int r = c.view * tiles_x * tiles_y + c.tile;
  c.start = tile_start[r];
  c.count = min(max(tile_end[r] - c.start, 0), cap);
  return c;
}

template <int CH>
__global__ void __launch_bounds__(BLOCK)
blend_fwd_kernel(const float* __restrict__ mean2d, const float* __restrict__ conic,
                 const float* __restrict__ opacity, const float* __restrict__ colors,
                 const int* __restrict__ gauss_idx, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int tiles_x, int tiles_y, int cap,
                 float* __restrict__ out_img, float* __restrict__ out_T,
                 int* __restrict__ out_last) {
  __shared__ float s_geom[6][BLOCK];
  __shared__ float s_col[BLOCK * CH];

  const TileCtx c = tile_ctx(tile_start, tile_end, tiles_x, tiles_y, cap);
  const int t = threadIdx.x;
  const float pxf = (float)c.px, pyf = (float)c.py;

  float acc[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) acc[ch] = 0.0f;
  float T = 1.0f;
  int last = 0;
  bool done = false;

  for (int b0 = 0; b0 < c.count; b0 += BLOCK) {
    // Also the barrier that lets the previous batch's shared data be
    // overwritten.
    if (__syncthreads_count(done) == BLOCK) break;
    const int j = b0 + t;
    if (j < c.count) {
      const int g = gauss_idx[c.start + j];
      s_geom[0][t] = mean2d[2 * g];
      s_geom[1][t] = mean2d[2 * g + 1];
      s_geom[2][t] = conic[3 * g];
      s_geom[3][t] = conic[3 * g + 1];
      s_geom[4][t] = conic[3 * g + 2];
      s_geom[5][t] = opacity[g];
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) s_col[t * CH + ch] = colors[(size_t)g * CH + ch];
    }
    __syncthreads();
    const int n = min(BLOCK, c.count - b0);
    for (int k = 0; k < n && !done; ++k) {
      const Alpha a = pair_alpha(pxf - s_geom[0][k], pyf - s_geom[1][k], s_geom[2][k],
                                 s_geom[3][k], s_geom[4][k], s_geom[5][k]);
      if (!a.use) continue;
      const float test = T * (1.0f - a.alpha);
      if (test < T_EPS) {
        done = true;
        break;
      }
      const float w = a.alpha * T;
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) acc[ch] += w * s_col[k * CH + ch];
      T = test;
      last = b0 + k + 1;
    }
  }

#pragma unroll
  for (int ch = 0; ch < CH; ++ch) out_img[(size_t)c.pix * CH + ch] = acc[ch];
  out_T[c.pix] = T;
  out_last[c.pix] = last;
}

template <int CH>
__global__ void __launch_bounds__(BLOCK)
blend_bwd_kernel(const float* __restrict__ mean2d, const float* __restrict__ conic,
                 const float* __restrict__ opacity, const float* __restrict__ colors,
                 const int* __restrict__ gauss_idx, const int* __restrict__ tile_start,
                 const int* __restrict__ tile_end, int tiles_x, int tiles_y,
                 const float* __restrict__ out_T, const int* __restrict__ last,
                 const float* __restrict__ g_img, const float* __restrict__ g_T,
                 float* __restrict__ d_mean2d, float* __restrict__ d_conic,
                 float* __restrict__ d_opacity, float* __restrict__ d_colors) {
  constexpr int NV = 6 + CH;  // dmx, dmy, dA, dB, dC, dop, dcol[CH]
  __shared__ float s_geom[6][BWD_BATCH];
  __shared__ float s_col[BWD_BATCH * CH];
  __shared__ int s_gid[BWD_BATCH];
  __shared__ float s_red[BWD_BATCH][NWARP][NV];
  __shared__ int s_hi;

  // The forward's cap is already folded into `last`.
  const TileCtx c = tile_ctx(tile_start, tile_end, tiles_x, tiles_y, 0x7fffffff);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float pxf = (float)c.px, pyf = (float)c.py;

  const int my_last = last[c.pix];
  float T = out_T[c.pix];
  float gC[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) gC[ch] = g_img[(size_t)c.pix * CH + ch];
  float S = T * g_T[c.pix];

  if (t == 0) s_hi = 0;
  __syncthreads();
  atomicMax(&s_hi, my_last);
  __syncthreads();
  const int n_hi = s_hi;

  for (int hi = n_hi; hi > 0; hi -= BWD_BATCH) {
    const int lo = max(hi - BWD_BATCH, 0);
    const int n = hi - lo;
    __syncthreads();  // the previous batch's reduction has read its buffers
    if (t < n) {
      const int g = gauss_idx[c.start + lo + t];
      s_gid[t] = g;
      s_geom[0][t] = mean2d[2 * g];
      s_geom[1][t] = mean2d[2 * g + 1];
      s_geom[2][t] = conic[3 * g];
      s_geom[3][t] = conic[3 * g + 1];
      s_geom[4][t] = conic[3 * g + 2];
      s_geom[5][t] = opacity[g];
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) s_col[t * CH + ch] = colors[(size_t)g * CH + ch];
    }
    __syncthreads();

    for (int k = n - 1; k >= 0; --k) {
      float vals[NV];
#pragma unroll
      for (int q = 0; q < NV; ++q) vals[q] = 0.0f;
      bool live = false;
      if (lo + k < my_last) {
        const float dx = pxf - s_geom[0][k], dy = pyf - s_geom[1][k];
        const float A = s_geom[2][k], B = s_geom[3][k], C = s_geom[4][k];
        const Alpha a = pair_alpha(dx, dy, A, B, C, s_geom[5][k]);
        if (a.use) {
          live = true;
          const float one_m = 1.0f - a.alpha;
          const float t_exc = T / one_m;
          float cg = 0.0f;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) cg += s_col[k * CH + ch] * gC[ch];
          const float w = a.alpha * t_exc;
          const float dalpha = t_exc * cg - S / one_m;
          S += w * cg;
          T = t_exc;
          const bool clamped = a.alpha_pre > ALPHA_MAX;
          const float dpower = clamped ? 0.0f : dalpha * a.alpha_pre;
          vals[0] = dpower * (A * dx + B * dy);
          vals[1] = dpower * (C * dy + B * dx);
          vals[2] = dpower * (-0.5f * dx * dx);
          vals[3] = dpower * (-dx * dy);
          vals[4] = dpower * (-0.5f * dy * dy);
          // d/d_opacity = dalpha * exp(power) = dpower / op, without the
          // division (and so without the reference's op = 0 guard).
          vals[5] = clamped ? 0.0f : dalpha * a.expo;
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) vals[6 + ch] = w * gC[ch];
        }
      }
      const bool any = __ballot_sync(0xffffffffu, live) != 0u;
      if (any) {
#pragma unroll
        for (int q = 0; q < NV; ++q) vals[q] = warp_sum(vals[q]);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NV; ++q) s_red[k][warp][q] = vals[q];
      }
    }
    __syncthreads();

    for (int i = t; i < n * NV; i += BLOCK) {
      const int k = i / NV, q = i % NV;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) sum += s_red[k][w][q];
      if (sum == 0.0f) continue;
      const size_t g = (size_t)s_gid[k];
      float* dst = q < 2   ? d_mean2d + 2 * g + q
                   : q < 5 ? d_conic + 3 * g + (q - 2)
                   : q == 5 ? d_opacity + g
                            : d_colors + g * CH + (q - 6);
      atomicAdd(dst, sum);
    }
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
               const float* g_T, float* d_mean2d, float* d_conic, float* d_opacity,
               float* d_colors, cudaStream_t stream) {
  const dim3 grid(tiles_x * tiles_y, num_views);
  blend_bwd_kernel<CH><<<grid, BLOCK, 0, stream>>>(
      mean2d, conic, opacity, colors, gauss_idx, tile_start, tile_end, tiles_x,
      tiles_y, out_T, last, g_img, g_T, d_mean2d, d_conic, d_opacity, d_colors);
  return (int)cudaGetLastError();
}

constexpr int ERR_CHANNELS = -1;  // no kernel instantiated for this CH

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// its launch (0 = launched), or ERR_CHANNELS for an unsupported channel
// count. Pointers are device pointers; all float arrays are contiguous
// float32 and all index arrays int32. The image is (V, H_pad, W_pad, CH).
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
                            const float* g_img, const float* g_T, float* d_mean2d,
                            float* d_conic, float* d_opacity, float* d_colors,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_ch) {
    case 3:
      return launch_bwd<3>(mean2d, conic, opacity, colors, gauss_idx, tile_start,
                           tile_end, num_views, tiles_x, tiles_y, out_T, last, g_img,
                           g_T, d_mean2d, d_conic, d_opacity, d_colors, s);
    case 19:
      return launch_bwd<19>(mean2d, conic, opacity, colors, gauss_idx, tile_start,
                            tile_end, num_views, tiles_x, tiles_y, out_T, last, g_img,
                            g_T, d_mean2d, d_conic, d_opacity, d_colors, s);
    default:
      return ERR_CHANNELS;
  }
}
