// JPEG decoding on the card with nvJPEG, the CUDA toolkit's decoder, behind a
// plain C interface loaded with ctypes (vipnerf_tpu_torch/utils/jpeg.py).
//
// The JAX package reads a JPEG with imageio (libjpeg on the host). The GPU
// machine has no host JPEG decoder, so the port decodes on the card: the
// Huffman stage runs on the host inside nvjpegDecode, the IDCT and the colour
// conversion on the card. This is no port of a TPU kernel, and it is not one:
// it is the library step that reads the NeRF-LLFF source frames
// (images/*.JPG) when a database is built.
//
// Each function returns an nvjpegStatus_t (0 on success). One handle and one
// decode state serve the process, created at the first call and guarded by a
// mutex: a decode state holds one image's intermediate buffers.

#include <nvjpeg.h>

#include <cstring>
#include <mutex>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
std::mutex g_mutex;

int ensure_handle() {
  if (g_state != nullptr) return NVJPEG_STATUS_SUCCESS;
  if (g_handle == nullptr) {
    nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
    if (st != NVJPEG_STATUS_SUCCESS) {
      g_handle = nullptr;
      return st;
    }
  }
  nvjpegStatus_t st = nvjpegJpegStateCreate(g_handle, &g_state);
  if (st != NVJPEG_STATUS_SUCCESS) g_state = nullptr;
  return st;
}

}  // namespace

extern "C" {

// The header of one JPEG: number of components, chroma subsampling
// (nvjpegChromaSubsampling_t) and the size of component 0, the full image.
int jpeg_info(const unsigned char* data, size_t length, int* components,
              int* subsampling, int* width, int* height) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t sub;
  st = nvjpegGetImageInfo(g_handle, data, length, components, &sub, widths,
                          heights);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  *subsampling = static_cast<int>(sub);
  *width = widths[0];
  *height = heights[0];
  return NVJPEG_STATUS_SUCCESS;
}

// Decode one JPEG into `out` on the card, rows `pitch` bytes apart:
// interleaved RGB (NVJPEG_OUTPUT_RGBI) or, with `gray`, the luma plane alone
// (NVJPEG_OUTPUT_Y). The card's work is queued on `stream`.
int jpeg_decode(const unsigned char* data, size_t length, int gray,
                unsigned char* out, int pitch, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = out;
  image.pitch[0] = static_cast<unsigned int>(pitch);
  return nvjpegDecode(g_handle, g_state, data, length,
                      gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &image,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
