// Batch assembly of decoded images, written for Hopper (sm_90a): resize,
// crop, mirror and normalize in one pass.
//
// Replaces no Pallas kernel.  It is the card's counterpart of the native
// image-record iterator's per-sample C++ work (src/image_iter.cc:334-435,
// ImageRecordIter::ProcessSample: the MXTR passthrough :363-376,
// ResizeBilinear :84-110, the crop, the mirror and the normalisation
// :419-433), which the JAX package runs on the host; on the card the
// decoded images already lie in device memory (nvJPEG writes them
// there), so the batch is assembled where it is consumed.
//
// Input: one packed buffer of decoded HWC uint8 RGB images of varying
// sizes, and per sample b a row of 8 int64 values
//
//   offset, h, w, rh, rw, y0, x0, mirror
//
// (the image's first byte, its size, the size it is resized to, the
// crop's corner in the resized image, the mirror flag; h = 0 marks an
// empty slot, written as zeros, as the native iterator leaves the
// unfilled tail of a batch).  Output: (B, C, H, W) float32, C = 3 or 1.
//
// Each output element is the native value, bit for bit: the bilinear
// sample of ResizeBilinear (align-corners scales (sh-1)/(dh-1), the
// integer floors, the four-term sum in its order, + 0.5 and truncation
// to uint8) at (y0 + y, x0 + (mirror ? W-1-x : x)) of the resized
// image, then (px - mean[c]) * scale / std[c], or for C = 1 the grey
// sum 0.299 r + 0.587 g + 0.114 b first.  Every float operation is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn), so nvcc contracts nothing into an FMA and the kernel, its
// plain version (ops/image_batch.py) and the native code agree bit for
// bit; the library is also built with -fmad=false.
//
// Only the cropped pixels of the resized image are computed, never the
// whole resized image.  One thread an output pixel, writing its C
// channels (each a plane apart); 64-bit offsets; the ragged edge of the
// grid is masked.
//
// Bound: bytes.  The float32 output is written once (B·C·H·W·4 bytes)
// and the source pixels it touches are read (at most the whole packed
// buffer); at B=128, 3x224x224 the output alone is 77 MB, 0.023 ms at
// 3.35 TB/s.  The four source taps of neighbouring threads overlap, so
// most of the reads hit L1/L2.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
image_batch_kernel(const uint8_t* __restrict__ src,
                   const int64_t* __restrict__ table,
                   float* __restrict__ out, int batch, int channels,
                   int height, int width, float mean0, float mean1,
                   float mean2, float std0, float std1, float std2,
                   float scale) {
  const int64_t plane = static_cast<int64_t>(height) * width;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= batch * plane) return;
  const int b = static_cast<int>(idx / plane);
  const int64_t pix = idx - b * plane;
  const int y = static_cast<int>(pix / width);
  const int x = static_cast<int>(pix - static_cast<int64_t>(y) * width);
  const int64_t* row = table + 8 * static_cast<int64_t>(b);
  float* o = out + static_cast<int64_t>(b) * channels * plane + pix;
  const int h = static_cast<int>(row[1]);
  if (h == 0) {  // an empty slot of the batch's tail
    for (int c = 0; c < channels; ++c) o[c * plane] = 0.f;
    return;
  }
  const uint8_t* img = src + row[0];
  const int w = static_cast<int>(row[2]);
  const int rh = static_cast<int>(row[3]);
  const int rw = static_cast<int>(row[4]);
  const int ry = static_cast<int>(row[5]) + y;
  const int rx = static_cast<int>(row[6]) + (row[7] ? width - 1 - x : x);

  // ResizeBilinear's sample of the resized image at (ry, rx)
  const float ys =
      rh > 1 ? __fdiv_rn(static_cast<float>(h - 1), static_cast<float>(rh - 1))
             : 0.f;
  const float xs =
      rw > 1 ? __fdiv_rn(static_cast<float>(w - 1), static_cast<float>(rw - 1))
             : 0.f;
  const float fy = __fmul_rn(static_cast<float>(ry), ys);
  const int iy0 = __float2int_rz(fy);
  const int iy1 = min(iy0 + 1, h - 1);
  const float wy = __fsub_rn(fy, static_cast<float>(iy0));
  const float fx = __fmul_rn(static_cast<float>(rx), xs);
  const int ix0 = __float2int_rz(fx);
  const int ix1 = min(ix0 + 1, w - 1);
  const float wx = __fsub_rn(fx, static_cast<float>(ix0));
  const float wy1 = __fsub_rn(1.f, wy);
  const float wx1 = __fsub_rn(1.f, wx);
  const uint8_t* p00 = img + (static_cast<int64_t>(iy0) * w + ix0) * 3;
  const uint8_t* p01 = img + (static_cast<int64_t>(iy0) * w + ix1) * 3;
  const uint8_t* p10 = img + (static_cast<int64_t>(iy1) * w + ix0) * 3;
  const uint8_t* p11 = img + (static_cast<int64_t>(iy1) * w + ix1) * 3;
  float px[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t00 = __fmul_rn(__fmul_rn(static_cast<float>(p00[c]), wy1), wx1);
    const float t01 = __fmul_rn(__fmul_rn(static_cast<float>(p01[c]), wy1), wx);
    const float t10 = __fmul_rn(__fmul_rn(static_cast<float>(p10[c]), wy), wx1);
    const float t11 = __fmul_rn(__fmul_rn(static_cast<float>(p11[c]), wy), wx);
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11);
    // static_cast<unsigned char>(v + 0.5f): truncation, v + 0.5 in [0.5, 256)
    px[c] = static_cast<float>(
        static_cast<uint8_t>(__float2int_rz(__fadd_rn(v, 0.5f))));
  }
  if (channels == 3) {
    const float mean[3] = {mean0, mean1, mean2};
    const float stdv[3] = {std0, std1, std2};
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c * plane] =
          __fdiv_rn(__fmul_rn(__fsub_rn(px[c], mean[c]), scale), stdv[c]);
  } else {
    const float grey =
        __fadd_rn(__fadd_rn(__fmul_rn(0.299f, px[0]), __fmul_rn(0.587f, px[1])),
                  __fmul_rn(0.114f, px[2]));
    o[0] = __fdiv_rn(__fmul_rn(__fsub_rn(grey, mean0), scale), std0);
  }
}

}  // namespace

extern "C" int mx_image_batch(int device, const void* src, const void* table,
                              void* out, int batch, int channels, int height,
                              int width, float mean0, float mean1, float mean2,
                              float std0, float std1, float std2, float scale,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(batch) * height * width;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  image_batch_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const int64_t*>(table),
      static_cast<float*>(out), batch, channels, height, width, mean0, mean1,
      mean2, std0, std1, std2, scale);
  return cudaGetLastError();
}
