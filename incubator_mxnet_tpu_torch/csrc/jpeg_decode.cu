// JPEG decode on the card through nvJPEG, the CUDA toolkit's JPEG
// library: a small C interface for ops/jpeg_decode.py.
//
// Replaces no Pallas kernel: the JAX package decodes on the host, with
// cv2 or PIL (incubator_mxnet_tpu/image.py:27-48) or, in the native
// image-record iterator, with libjpeg on its worker threads
// (src/image_iter.cc:55-80).  This is the card's counterpart of that
// threaded libjpeg decode: the image is decoded into device memory,
// where the batch kernel (image_batch.cu) reads it.  It is a library
// call, not a kernel of this repository, and is built with -lnvjpeg.
//
// One nvJPEG handle and one decode state per device and host thread
// (the Python side keeps them; threads decode at once, each on its
// own stream).  A decode is
// nvjpegDecode with the default backend: its Huffman stage runs on the
// calling host thread, the rest on the given stream.  nvJPEG writes the
// image's planes as they are coded (NVJPEG_OUTPUT_YUV: Y, and Cb and Cr
// at their subsampled sizes; NVJPEG_OUTPUT_Y for a grey JPEG), and the
// kernel below makes the interleaved RGB image from them as libjpeg
// does, bit for bit: nvJPEG's own RGB output upsamples chroma another
// way and lands 3.7 grey levels from libjpeg's on average on a 4:2:0
// fixture (tests/fixtures/torch_jpeg/small_420.jpg, up to 29 at edges).
//
// ycc_rgb_kernel replaces no Pallas kernel: it is the chroma upsampling
// and colour conversion of the libjpeg decode that the JAX package and
// the native iterator use (libjpeg-turbo's jdsample.c "fancy"
// upsampling: h2v1, h2v2 and h1v2 triangle filters with their integer
// rounding biases; jdcolor.c's ycc_rgb_convert with its 16-bit
// fixed-point tables).  One thread an output pixel; integer arithmetic
// only.  Bound: bytes (the planes read once, 3·h·w bytes written).
//
// Every entry returns an nvjpegStatus_t (0 on success), or, for a CUDA
// failure, 1000 + the cudaError_t.

#include <cstddef>
#include <cstdint>

#include <nvjpeg.h>

#include "common.cuh"

namespace {

constexpr int kCudaBase = 1000;
constexpr int kThreads = 256;

// Chroma layouts of the kernel: as coded (4:4:4), or upsampled 2x
// across (4:2:2, h2v1), 2x both ways (4:2:0, h2v2) or 2x down (4:4:0,
// h1v2); kGrey replicates Y into three channels.
enum Mode { k444 = 0, k422 = 1, k420 = 2, k440 = 3, kGrey = 4 };

// libjpeg's fixed-point YCbCr -> RGB terms (jdcolor.c
// build_ycc_rgb_table): SCALEBITS 16, FIX(x) = x * 65536 + 0.5.
__device__ __forceinline__ int clamp255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// The chroma sample at full-resolution (y, x) of a plane of ch x cw
// coded samples with a row pitch, by libjpeg's fancy upsampling.
__device__ __forceinline__ int upsample(const uint8_t* p, int pitch, int ch,
                                        int cw, int y, int x, int mode) {
  if (mode == k444) return p[static_cast<int64_t>(y) * pitch + x];
  if (mode == k440) {
    const int r = y >> 1, v = y & 1;
    const int rn = v ? min(r + 1, ch - 1) : max(r - 1, 0);
    const int s = 3 * p[static_cast<int64_t>(r) * pitch + x] +
                  p[static_cast<int64_t>(rn) * pitch + x];
    return (s + (v ? 2 : 1)) >> 2;
  }
  const int c = x >> 1, u = x & 1;
  if (mode == k422) {
    const uint8_t* row = p + static_cast<int64_t>(y) * pitch;
    const int in = row[c];
    if (u == 0) return c == 0 ? in : (3 * in + row[c - 1] + 1) >> 2;
    return c == cw - 1 ? in : (3 * in + row[c + 1] + 2) >> 2;
  }
  // k420: column sums of this row and its vertical neighbour
  const int r = y >> 1, v = y & 1;
  const int rn = v ? min(r + 1, ch - 1) : max(r - 1, 0);
  const uint8_t* r0 = p + static_cast<int64_t>(r) * pitch;
  const uint8_t* r1 = p + static_cast<int64_t>(rn) * pitch;
  const int cs = 3 * r0[c] + r1[c];
  if (u == 0)
    return c == 0 ? (cs * 4 + 8) >> 4
                  : (3 * cs + 3 * r0[c - 1] + r1[c - 1] + 8) >> 4;
  return c == cw - 1 ? (cs * 4 + 7) >> 4
                     : (3 * cs + 3 * r0[c + 1] + r1[c + 1] + 7) >> 4;
}

__global__ void __launch_bounds__(kThreads)
ycc_rgb_kernel(const uint8_t* __restrict__ yp, int ypitch,
               const uint8_t* __restrict__ cbp, const uint8_t* __restrict__ crp,
               int cpitch, int ch, int cw, int mode, uint8_t* __restrict__ out,
               int h, int w) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(h) * w) return;
  const int y = static_cast<int>(idx / w);
  const int x = static_cast<int>(idx - static_cast<int64_t>(y) * w);
  const int lum = yp[static_cast<int64_t>(y) * ypitch + x];
  uint8_t* o = out + idx * 3;
  if (mode == kGrey) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(lum);
    return;
  }
  const int cb = upsample(cbp, cpitch, ch, cw, y, x, mode) - 128;
  const int cr = upsample(crp, cpitch, ch, cw, y, x, mode) - 128;
  const int r = lum + ((91881 * cr + 32768) >> 16);
  const int g = lum + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
  const int b = lum + ((116130 * cb + 32768) >> 16);
  o[0] = static_cast<uint8_t>(clamp255(r));
  o[1] = static_cast<uint8_t>(clamp255(g));
  o[2] = static_cast<uint8_t>(clamp255(b));
}

}  // namespace

extern "C" int mx_jpeg_create(int device, void** handle, void** state) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return kCudaBase + err;
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t st = nvjpegCreateSimple(&h);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegJpegState_t s = nullptr;
  st = nvjpegJpegStateCreate(h, &s);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(h);
    return st;
  }
  *handle = h;
  *state = s;
  return NVJPEG_STATUS_SUCCESS;
}

extern "C" int mx_jpeg_destroy(void* handle, void* state) {
  nvjpegStatus_t st =
      nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state));
  nvjpegStatus_t st2 = nvjpegDestroy(static_cast<nvjpegHandle_t>(handle));
  return st != NVJPEG_STATUS_SUCCESS ? st : st2;
}

// The image's component count, chroma subsampling
// (nvjpegChromaSubsampling_t) and the heights and widths of its first
// three components (the first is the image's size).
extern "C" int mx_jpeg_info(void* handle, const void* data, size_t length,
                            int* components, int* subsampling, int* heights,
                            int* widths) {
  int ws[NVJPEG_MAX_COMPONENT] = {0};
  int hs[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t sub;
  nvjpegStatus_t st = nvjpegGetImageInfo(
      static_cast<nvjpegHandle_t>(handle),
      static_cast<const unsigned char*>(data), length, components, &sub, ws,
      hs);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  *subsampling = static_cast<int>(sub);
  for (int c = 0; c < 3; ++c) {
    heights[c] = hs[c];
    widths[c] = ws[c];
  }
  return NVJPEG_STATUS_SUCCESS;
}

// Decodes one JPEG's planes, as coded, on stream: Y into y (pitch
// ypitch), and unless grey, Cb and Cr into cb and cr (pitch cpitch).
extern "C" int mx_jpeg_decode_planes(int device, void* handle, void* state,
                                     const void* data, size_t length,
                                     int grey, void* y, int ypitch, void* cb,
                                     void* cr, int cpitch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return kCudaBase + err;
  nvjpegImage_t img;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    img.channel[c] = nullptr;
    img.pitch[c] = 0;
  }
  img.channel[0] = static_cast<unsigned char*>(y);
  img.pitch[0] = static_cast<size_t>(ypitch);
  if (!grey) {
    img.channel[1] = static_cast<unsigned char*>(cb);
    img.channel[2] = static_cast<unsigned char*>(cr);
    img.pitch[1] = img.pitch[2] = static_cast<size_t>(cpitch);
  }
  nvjpegStatus_t st = nvjpegDecode(
      static_cast<nvjpegHandle_t>(handle),
      static_cast<nvjpegJpegState_t>(state),
      static_cast<const unsigned char*>(data), length,
      grey ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV, &img,
      static_cast<cudaStream_t>(stream));
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  err = cudaGetLastError();
  return err == cudaSuccess ? NVJPEG_STATUS_SUCCESS : kCudaBase + err;
}

// The interleaved RGB image (h x w x 3 uint8) of decoded planes, on
// stream: libjpeg's fancy upsampling of Cb and Cr (ch x cw samples) by
// mode, then its YCbCr -> RGB conversion.  Returns a cudaError_t.
extern "C" int mx_jpeg_ycc_rgb(int device, const void* y, int ypitch,
                               const void* cb, const void* cr, int cpitch,
                               int ch, int cw, int mode, void* out, int h,
                               int w, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t total = static_cast<int64_t>(h) * w;
  if (total == 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  ycc_rgb_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), ypitch, static_cast<const uint8_t*>(cb),
      static_cast<const uint8_t*>(cr), cpitch, ch, cw, mode,
      static_cast<uint8_t*>(out), h, w);
  return cudaGetLastError();
}
