// Seed flood + bbox/area of the seed's component, one window per block.
//
// Same semantics as ops/mser.py:flood_bbox (the plain scan flood): per pass
// every horizontal mask run, then every vertical mask run, becomes reached
// when any of its pixels is reached; one more horizontal resolve closes the
// sweep.  The window (mask + reached flags, bytes) lives in shared memory,
// so it is read from device memory once; the plain XLA version makes
// several log-depth scan sweeps over the [N, H, W] stack instead.
//
// Inputs: mask uint8 [..., H, W] (nonzero = in the level set; the border
// ring must be 0), seeds int32 [..., 2] (y, x).  Output int32 [..., 5]:
// (ymin, ymax, xmin, xmax, area), with (big, -1, big, -1, 0) for an empty
// component.  H, W <= 128.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxSide = 128;
constexpr int kStride = 132;  // bytes per shared row: 33 words, no conflicts

__device__ void resolve_rows(const uint8_t* m, uint8_t* r, int h, int w) {
  const int y = threadIdx.x;
  if (y < h) {
    const uint8_t* mr = m + y * kStride;
    uint8_t* rr = r + y * kStride;
    int x = 0;
    while (x < w) {
      if (!mr[x]) {
        ++x;
        continue;
      }
      const int start = x;
      uint8_t any = 0;
      while (x < w && mr[x]) any |= rr[x++];
      if (any)
        for (int k = start; k < x; ++k) rr[k] = 1;
    }
  }
  __syncthreads();
}

__device__ void resolve_cols(const uint8_t* m, uint8_t* r, int h, int w) {
  const int x = threadIdx.x;
  if (x < w) {
    int y = 0;
    while (y < h) {
      if (!m[y * kStride + x]) {
        ++y;
        continue;
      }
      const int start = y;
      uint8_t any = 0;
      while (y < h && m[y * kStride + x]) any |= r[(y++) * kStride + x];
      if (any)
        for (int k = start; k < y; ++k) r[k * kStride + x] = 1;
    }
  }
  __syncthreads();
}

__global__ void flood_bbox_kernel(const uint8_t* __restrict__ mask,
                                  const int32_t* __restrict__ seeds,
                                  int32_t* __restrict__ out, int h, int w,
                                  int passes, int big) {
  __shared__ uint8_t m[kMaxSide * kStride];
  __shared__ uint8_t r[kMaxSide * kStride];
  __shared__ int red[5];
  const int64_t n = blockIdx.x;
  const uint8_t* src = mask + n * h * w;
  for (int i = threadIdx.x; i < h * w; i += blockDim.x) {
    const int y = i / w, x = i - (i / w) * w;
    m[y * kStride + x] = src[i] != 0;
    r[y * kStride + x] = 0;
  }
  if (threadIdx.x == 0) {
    red[0] = big;
    red[1] = -1;
    red[2] = big;
    red[3] = -1;
    red[4] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int sy = seeds[2 * n], sx = seeds[2 * n + 1];
    if (sy >= 0 && sy < h && sx >= 0 && sx < w && m[sy * kStride + sx])
      r[sy * kStride + sx] = 1;
  }
  __syncthreads();

  for (int p = 0; p < passes; ++p) {
    resolve_rows(m, r, h, w);
    resolve_cols(m, r, h, w);
  }
  resolve_rows(m, r, h, w);

  // bbox + area: each thread folds one row, then shared atomics
  const int y = threadIdx.x;
  if (y < h) {
    int xmin = big, xmax = -1, area = 0;
    for (int x = 0; x < w; ++x) {
      if (r[y * kStride + x]) {
        xmin = min(xmin, x);
        xmax = max(xmax, x);
        ++area;
      }
    }
    if (area) {
      atomicMin(&red[0], y);
      atomicMax(&red[1], y);
      atomicMin(&red[2], xmin);
      atomicMax(&red[3], xmax);
      atomicAdd(&red[4], area);
    }
  }
  __syncthreads();
  if (threadIdx.x < 5) out[5 * n + threadIdx.x] = red[threadIdx.x];
}

ffi::Error FloodBboxImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> mask,
                         ffi::Buffer<ffi::S32> seeds,
                         ffi::ResultBuffer<ffi::S32> out, int32_t passes,
                         int32_t big) {
  const auto dims = mask.dimensions();
  if (dims.size() < 2)
    return ffi::Error::InvalidArgument("mask must be [..., H, W]");
  const int h = static_cast<int>(dims[dims.size() - 2]);
  const int w = static_cast<int>(dims[dims.size() - 1]);
  if (h > kMaxSide || w > kMaxSide)
    return ffi::Error::InvalidArgument("window side exceeds 128");
  const int64_t n = mask.element_count() / (static_cast<int64_t>(h) * w);
  if (seeds.element_count() != 2 * n || out->element_count() != 5 * n)
    return ffi::Error::InvalidArgument("seeds/out do not match the mask");
  if (n > 0) {
    flood_bbox_kernel<<<static_cast<unsigned>(n), kMaxSide, 0, stream>>>(
        mask.typed_data(), seeds.typed_data(), out->typed_data(), h, w,
        passes, big);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TsdFloodBbox, FloodBboxImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("passes")
                                  .Attr<int32_t>("big"));
