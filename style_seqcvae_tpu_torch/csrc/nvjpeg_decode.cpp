// JPEG decoding and encoding on the card through libnvjpeg (the CUDA
// toolkit's JPEG codec), behind a plain C interface for ctypes.
//
// Counterpart of the JAX package's PIL decode of JPEG files
// (style_seqcvae_tpu/data/detection.py:170-176, scripts/serve.py:483-486)
// and of the PIL encode of the world generator's images
// (scripts/make_world.py:315, quality 92, PIL's default 4:2:0 sampling).
// Not a kernel of the port: it calls the library's codec and is built
// into its own library (ops/kernels/_build.py::build_nvjpeg), so that a
// machine without libnvjpeg still builds kernels A-D.
//
// One handle, one decode state and one encode state serve the process; a
// mutex serialises the calls. The decoder writes interleaved 8-bit BGR
// (NVJPEG_OUTPUT_BGRI) on the caller's stream into a buffer the caller
// allocated; the encoder reads interleaved 8-bit RGB (NVJPEG_INPUT_RGBI)
// from the card and copies the bitstream to the caller's host buffer.

#include <cuda_runtime_api.h>
#include <nvjpeg.h>

#include <mutex>

namespace {

std::mutex g_mutex;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;
nvjpegEncoderState_t g_enc_state = nullptr;
nvjpegEncoderParams_t g_enc_params = nullptr;

int ensure_init() {
  if (g_handle != nullptr) return NVJPEG_STATUS_SUCCESS;
  nvjpegHandle_t handle = nullptr;
  nvjpegStatus_t st = nvjpegCreateSimple(&handle);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegJpegState_t state = nullptr;
  st = nvjpegJpegStateCreate(handle, &state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(handle);
    return st;
  }
  g_handle = handle;
  g_state = state;
  return NVJPEG_STATUS_SUCCESS;
}

int ensure_encoder(cudaStream_t stream) {
  if (g_enc_state != nullptr) return NVJPEG_STATUS_SUCCESS;
  nvjpegEncoderState_t state = nullptr;
  nvjpegStatus_t st = nvjpegEncoderStateCreate(g_handle, &state, stream);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegEncoderParams_t params = nullptr;
  st = nvjpegEncoderParamsCreate(g_handle, &params, stream);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegEncoderStateDestroy(state);
    return st;
  }
  g_enc_state = state;
  g_enc_params = params;
  return NVJPEG_STATUS_SUCCESS;
}

}  // namespace

extern "C" {

// nComponents, the chroma subsampling (nvjpegChromaSubsampling_t) and the
// full image's width and height; returns an nvjpegStatus_t.
int ssc_jpeg_info(const unsigned char* data, size_t length, int* components,
                  int* subsampling, int* width, int* height) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int st = ensure_init();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css = NVJPEG_CSS_UNKNOWN;
  st = nvjpegGetImageInfo(g_handle, data, length, components, &css, widths, heights);
  *subsampling = static_cast<int>(css);
  *width = widths[0];
  *height = heights[0];
  return st;
}

// Decode into out (height, width, 3) uint8 BGR, row pitch in bytes, on
// stream; returns an nvjpegStatus_t.
int ssc_jpeg_decode_bgri(const unsigned char* data, size_t length, unsigned char* out,
                         int pitch, void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  int st = ensure_init();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = out;
  image.pitch[0] = static_cast<size_t>(pitch);
  return nvjpegDecode(g_handle, g_state, data, length, NVJPEG_OUTPUT_BGRI, &image,
                      static_cast<cudaStream_t>(stream));
}

// Encode rgb (height, width, 3) uint8 RGB on the card, row pitch in bytes,
// at quality (1-100) with 4:2:0 chroma and the standard Huffman tables (as
// PIL's defaults), on stream. The bitstream's length goes to *length; when
// it fits capacity it is copied to out (host memory) and the stream is
// synchronised, else nothing is copied and NVJPEG_STATUS_INVALID_PARAMETER
// comes back with *length set, so that the caller can retry with a larger
// buffer. Returns an nvjpegStatus_t (a CUDA error as
// NVJPEG_STATUS_EXECUTION_FAILED).
int ssc_jpeg_encode_rgbi(const unsigned char* rgb, int width, int height, int pitch,
                         int quality, unsigned char* out, size_t capacity, size_t* length,
                         void* stream) {
  std::lock_guard<std::mutex> lock(g_mutex);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int st = ensure_init();
  if (st == NVJPEG_STATUS_SUCCESS) st = ensure_encoder(s);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegEncoderParamsSetQuality(g_enc_params, quality, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetSamplingFactors(g_enc_params, NVJPEG_CSS_420, s);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegEncoderParamsSetOptimizedHuffman(g_enc_params, 0, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegImage_t image;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = nullptr;
    image.pitch[c] = 0;
  }
  image.channel[0] = const_cast<unsigned char*>(rgb);
  image.pitch[0] = static_cast<size_t>(pitch);
  st = nvjpegEncodeImage(g_handle, g_enc_state, g_enc_params, &image, NVJPEG_INPUT_RGBI,
                         width, height, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  st = nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, nullptr, length, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  if (cudaStreamSynchronize(s) != cudaSuccess) return NVJPEG_STATUS_EXECUTION_FAILED;
  if (*length > capacity) return NVJPEG_STATUS_INVALID_PARAMETER;
  st = nvjpegEncodeRetrieveBitstream(g_handle, g_enc_state, out, length, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  if (cudaStreamSynchronize(s) != cudaSuccess) return NVJPEG_STATUS_EXECUTION_FAILED;
  return NVJPEG_STATUS_SUCCESS;
}

// 1 when the status blames the file (not a JPEG nvjpeg can read, cut short
// or corrupt), 0 on success, 2 when it blames the card or the library.
int ssc_jpeg_status_kind(int status) {
  switch (status) {
    case NVJPEG_STATUS_SUCCESS:
      return 0;
    case NVJPEG_STATUS_BAD_JPEG:
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
      return 1;
    default:
      return 2;
  }
}

const char* ssc_jpeg_status_name(int status) {
  switch (status) {
    case NVJPEG_STATUS_SUCCESS: return "NVJPEG_STATUS_SUCCESS";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "NVJPEG_STATUS_INVALID_PARAMETER";
    case NVJPEG_STATUS_BAD_JPEG: return "NVJPEG_STATUS_BAD_JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "NVJPEG_STATUS_EXECUTION_FAILED";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM: return "NVJPEG_STATUS_INCOMPLETE_BITSTREAM";
    default: return "unknown nvjpeg status";
  }
}

// The chroma subsampling's name (nvjpegChromaSubsampling_t).
const char* ssc_jpeg_subsampling_name(int css) {
  switch (css) {
    case NVJPEG_CSS_444: return "4:4:4";
    case NVJPEG_CSS_422: return "4:2:2";
    case NVJPEG_CSS_420: return "4:2:0";
    case NVJPEG_CSS_440: return "4:4:0";
    case NVJPEG_CSS_411: return "4:1:1";
    case NVJPEG_CSS_410: return "4:1:0";
    case NVJPEG_CSS_GRAY: return "grey";
    case NVJPEG_CSS_410V: return "4:1:0V";
    default: return "unknown";
  }
}

}  // extern "C"
