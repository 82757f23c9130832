// Row gather, out[k] = src[idx[k]], for Hopper (sm_90a).
//
// Replaces the TPU kernel of gsattack/ops/pallas_gather.py:
//   gather_rows_kernel <- _gather_rows_kernel (launched by gather_rows)
// src is a contiguous (S, W) float32 table, idx an (M,) int32 vector of
// rows in [0, S) (trusted, as in the JAX function), out a contiguous (M, W)
// float32 table. The copy is exact.
//
// Design. The TPU kernel issues one async DMA per row from a block of
// indices held in SMEM, with a ring of semaphores and a hand unroll, and
// pads W to 128 lanes; all of that exists for Mosaic and none of it carries
// over. Here the output is one flat array of 16-byte pieces (W % 4 == 0 and
// both tables 16-byte aligned) or of floats (otherwise): consecutive
// threads take consecutive pieces, so a warp reads whole rows and writes
// one contiguous stretch of out. Each thread keeps IN_FLIGHT loads of
// different rows in flight before it stores them, in a grid-stride loop of
// at most one wave of resident CTAs. Loads go through the read-only path
// (__ldg); row offsets are 64-bit. The piece index is 32-bit: the wrapper
// refuses M * W >= 2^31. A 64-bit index throughout, with one divide per
// thread instead of one per piece, ran 4-5% slower on an H100 at
// W = 16/32/40 (`python -m gsattack_torch.scripts.micro_gather main`).
//
// What bounds it on an H100: bytes. It reads each index (4 B) and each
// distinct gathered row (4 W B) once and writes each output row (4 W B)
// once, and computes nothing: 4 M + 4 W distinct + 4 M W bytes over
// 3.35 TB/s. A row of 16 floats is two 32-byte sectors, so a random row
// costs whole sectors and no more. A source larger than the 50 MB L2 is
// read from HBM at random, and a row read again may miss L2 again.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int ERR_CONFIG = -1;  // threads or in_flight not supported
constexpr int ERR_EMPTY = -2;   // rows requested from an empty table

template <typename T, int IN_FLIGHT>
__global__ void gather_rows_kernel(const T* __restrict__ src, const int* __restrict__ idx,
                                   T* __restrict__ out, uint32_t total, uint32_t row) {
  // total < 2^31 and one step is at most 132 SMs * 2048 threads * 8, so
  // e + u * stride stays below 2^32 while the loop steps past the end.
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride * IN_FLIGHT) {
    T v[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const uint32_t j = e + u * stride;
      if (j < total) {
        const uint32_t k = j / row;
        const int r = __ldg(idx + k);
        v[u] = __ldg(src + static_cast<int64_t>(r) * row + (j - k * row));
      }
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const uint32_t j = e + u * stride;
      if (j < total) out[j] = v[u];
    }
  }
}

template <typename T, int IN_FLIGHT>
int launch(const T* src, const int* idx, T* out, int64_t total, int64_t row, int threads,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One wave of resident CTAs at most (2048 threads per SM); the
  // grid-stride loop covers the rest.
  const int64_t per_cta = static_cast<int64_t>(threads) * IN_FLIGHT;
  const int64_t wave = static_cast<int64_t>(sms) * (2048 / threads);
  const int64_t want = (total + per_cta - 1) / per_cta;
  const int blocks = static_cast<int>(want < wave ? want : wave);
  gather_rows_kernel<T, IN_FLIGHT><<<blocks, threads, 0, stream>>>(
      src, idx, out, static_cast<uint32_t>(total), static_cast<uint32_t>(row));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pieces(const T* src, const int* idx, T* out, int64_t total, int64_t row,
                  int threads, int in_flight, cudaStream_t stream) {
  switch (in_flight) {
    case 1: return launch<T, 1>(src, idx, out, total, row, threads, stream);
    case 2: return launch<T, 2>(src, idx, out, total, row, threads, stream);
    case 4: return launch<T, 4>(src, idx, out, total, row, threads, stream);
    case 8: return launch<T, 8>(src, idx, out, total, row, threads, stream);
    default: return ERR_CONFIG;
  }
}

}  // namespace

// Plain C entry point for ctypes. Returns cudaGetLastError() after the
// launch (0 = launched), ERR_CONFIG for a launch setting the kernel does not
// take (threads a multiple of 32 in [32, 1024]; in_flight 1, 2, 4 or 8), or
// ERR_EMPTY for M > 0 rows of an S = 0 table. Launches nothing when M or W
// is 0. src, idx and out are device pointers; src (S, W) and out (M, W) are
// contiguous float32, idx (M,) contiguous int32, and M * W < 2^31.
extern "C" int gs_gather_rows(const float* src, const int* idx, float* out, int64_t S,
                              int W, int64_t M, int threads, int in_flight, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return ERR_CONFIG;
  if (in_flight != 1 && in_flight != 2 && in_flight != 4 && in_flight != 8) return ERR_CONFIG;
  if (M == 0 || W == 0) return 0;
  if (S == 0) return ERR_EMPTY;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (W % 4 == 0 && aligned)
    return launch_pieces(reinterpret_cast<const float4*>(src), idx,
                         reinterpret_cast<float4*>(out), M * (W / 4), W / 4, threads,
                         in_flight, s);
  return launch_pieces(src, idx, out, M * W, static_cast<int64_t>(W), threads, in_flight, s);
}
