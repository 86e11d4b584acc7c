// Host data plane of merlot_reserve_tpu_torch: TFRecord framing,
// tf.train.Example parsing, JPEG decode and encode, and the fused resize,
// pad and space_to_depth patchify with the six Pillow filters and their
// antialiased coefficient windows. A C ABI loaded with ctypes by
// merlot_reserve_tpu_torch/data/native.py, which builds this file with g++
// at first use.
//
// The port's copy of merlot_reserve_tpu/native/merlot_native.cc: the
// framing, parsing and six-filter resampling code is the same, so the two
// libraries give the same bits (the 2-tap bilinear mn_resize_patchify,
// which the port's pipeline does not call, is left out). The JPEG codec is chosen at build time:
//   * libjpeg (the default, where jpeglib.h is found): decode as the JAX
//     package's library does, bit for bit, and encode;
//   * nvJPEG (built with -DMN_NVJPEG, where libjpeg is absent and the CUDA
//     toolkit has nvjpeg.h): decode and encode on the card, on a stream of
//     the calling thread's own that does not wait for the default stream,
//     and the pixels copied back to the host. nvJPEG's IDCT and chroma
//     upsampling are not libjpeg's, so its pixels differ from libjpeg's by a
//     few levels (held against known pixels, not against libjpeg).
// mn_jpeg_codec() says which one a build has.
//
// Thread-safety: a reader or example handle is single-threaded; create one
// per worker. The JPEG functions may be called from several threads.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <csetjmp>

#ifdef MN_NVJPEG
#include <cuda_runtime.h>
#include <mutex>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif

// ---------------------------------------------------------------------------
// TFRecord reader (framing only; CRC checks skipped for speed — the python
// codec verifies when asked)
// ---------------------------------------------------------------------------

struct MnRecordReader {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
};

extern "C" void* mn_reader_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new MnRecordReader();
  r->f = f;
  return r;
}

// returns length of next record (and fills *out with an internal pointer
// valid until the next call), or -1 at EOF / error.
extern "C" int64_t mn_reader_next(void* handle, const uint8_t** out) {
  auto* r = static_cast<MnRecordReader*>(handle);
  uint8_t header[12];
  if (std::fread(header, 1, 12, r->f) != 12) return -1;
  uint64_t length;
  std::memcpy(&length, header, 8);  // little-endian host assumed (x86/ARM LE)
  if (length > (1ull << 31)) return -1;
  r->buf.resize(length);
  if (std::fread(r->buf.data(), 1, length, r->f) != length) return -1;
  uint8_t footer[4];
  if (std::fread(footer, 1, 4, r->f) != 4) return -1;
  *out = r->buf.data();
  return static_cast<int64_t>(length);
}

extern "C" void mn_reader_close(void* handle) {
  auto* r = static_cast<MnRecordReader*>(handle);
  if (r->f) std::fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// tf.train.Example parser
// ---------------------------------------------------------------------------

struct MnFeature {
  // exactly one list is populated
  std::vector<std::pair<const uint8_t*, size_t>> bytes_vals;
  std::vector<float> float_vals;
  std::vector<int64_t> int_vals;
};

struct MnExample {
  std::vector<uint8_t> storage;  // owns the record bytes
  std::unordered_map<std::string, MnFeature> features;
};

static bool read_varint(const uint8_t* buf, size_t len, size_t* pos,
                        uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = buf[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

// iterate fields of a length-delimited protobuf region
template <typename F>
static bool for_each_field(const uint8_t* buf, size_t len, F&& fn) {
  size_t pos = 0;
  while (pos < len) {
    uint64_t key;
    if (!read_varint(buf, len, &pos, &key)) return false;
    uint32_t field = key >> 3, wire = key & 7;
    if (wire == 2) {
      uint64_t l;
      if (!read_varint(buf, len, &pos, &l) || pos + l > len) return false;
      fn(field, wire, buf + pos, static_cast<size_t>(l), uint64_t(0));
      pos += l;
    } else if (wire == 0) {
      uint64_t v;
      if (!read_varint(buf, len, &pos, &v)) return false;
      fn(field, wire, nullptr, size_t(0), v);
    } else if (wire == 5) {
      if (pos + 4 > len) return false;
      fn(field, wire, buf + pos, size_t(4), uint64_t(0));
      pos += 4;
    } else if (wire == 1) {
      if (pos + 8 > len) return false;
      fn(field, wire, buf + pos, size_t(8), uint64_t(0));
      pos += 8;
    } else {
      return false;
    }
  }
  return true;
}

static void parse_feature(const uint8_t* buf, size_t len, MnFeature* feat) {
  for_each_field(buf, len, [&](uint32_t kind, uint32_t wire, const uint8_t* p,
                               size_t l, uint64_t v) {
    if (wire != 2) return;
    if (kind == 1) {  // BytesList: repeated field 1 bytes
      for_each_field(p, l, [&](uint32_t f2, uint32_t w2, const uint8_t* p2,
                               size_t l2, uint64_t) {
        if (f2 == 1 && w2 == 2) feat->bytes_vals.emplace_back(p2, l2);
      });
    } else if (kind == 2) {  // FloatList: field 1 packed or repeated 32-bit
      for_each_field(p, l, [&](uint32_t f2, uint32_t w2, const uint8_t* p2,
                               size_t l2, uint64_t) {
        if (f2 != 1) return;
        if (w2 == 2) {
          for (size_t i = 0; i + 4 <= l2; i += 4) {
            float fv;
            std::memcpy(&fv, p2 + i, 4);
            feat->float_vals.push_back(fv);
          }
        } else if (w2 == 5) {
          float fv;
          std::memcpy(&fv, p2, 4);
          feat->float_vals.push_back(fv);
        }
      });
    } else if (kind == 3) {  // Int64List: field 1 packed or repeated varint
      for_each_field(p, l, [&](uint32_t f2, uint32_t w2, const uint8_t* p2,
                               size_t l2, uint64_t v2) {
        if (f2 != 1) return;
        if (w2 == 2) {
          size_t pos = 0;
          uint64_t x;
          while (pos < l2 && read_varint(p2, l2, &pos, &x))
            feat->int_vals.push_back(static_cast<int64_t>(x));
        } else if (w2 == 0) {
          feat->int_vals.push_back(static_cast<int64_t>(v2));
        }
      });
    }
  });
}

extern "C" void* mn_example_parse(const uint8_t* record, int64_t len) {
  auto* ex = new MnExample();
  ex->storage.assign(record, record + len);
  const uint8_t* buf = ex->storage.data();

  for_each_field(buf, len, [&](uint32_t f, uint32_t w, const uint8_t* p,
                               size_t l, uint64_t) {
    if (f != 1 || w != 2) return;  // Example.features
    for_each_field(p, l, [&](uint32_t f2, uint32_t w2, const uint8_t* p2,
                             size_t l2, uint64_t) {
      if (f2 != 1 || w2 != 2) return;  // map entry
      std::string key;
      const uint8_t* feat_buf = nullptr;
      size_t feat_len = 0;
      for_each_field(p2, l2, [&](uint32_t f3, uint32_t w3, const uint8_t* p3,
                                 size_t l3, uint64_t) {
        if (f3 == 1 && w3 == 2) key.assign(reinterpret_cast<const char*>(p3), l3);
        else if (f3 == 2 && w3 == 2) { feat_buf = p3; feat_len = l3; }
      });
      if (!key.empty() && feat_buf) {
        parse_feature(feat_buf, feat_len, &ex->features[key]);
      }
    });
  });
  return ex;
}

extern "C" void mn_example_free(void* handle) { delete static_cast<MnExample*>(handle); }

extern "C" int64_t mn_feature_num_bytes(void* handle, const char* key) {
  auto* ex = static_cast<MnExample*>(handle);
  auto it = ex->features.find(key);
  return it == ex->features.end() ? -1
                                  : (int64_t)it->second.bytes_vals.size();
}

extern "C" int64_t mn_feature_bytes(void* handle, const char* key, int64_t idx,
                         const uint8_t** out) {
  auto* ex = static_cast<MnExample*>(handle);
  auto it = ex->features.find(key);
  if (it == ex->features.end() ||
      idx >= (int64_t)it->second.bytes_vals.size())
    return -1;
  *out = it->second.bytes_vals[idx].first;
  return (int64_t)it->second.bytes_vals[idx].second;
}

extern "C" int64_t mn_feature_ints(void* handle, const char* key, const int64_t** out) {
  auto* ex = static_cast<MnExample*>(handle);
  auto it = ex->features.find(key);
  if (it == ex->features.end()) return -1;
  *out = it->second.int_vals.data();
  return (int64_t)it->second.int_vals.size();
}

extern "C" int64_t mn_feature_floats(void* handle, const char* key, const float** out) {
  auto* ex = static_cast<MnExample*>(handle);
  auto it = ex->features.find(key);
  if (it == ex->features.end()) return -1;
  *out = it->second.float_vals.data();
  return (int64_t)it->second.float_vals.size();
}

// ---------------------------------------------------------------------------
// JPEG decode and encode
// ---------------------------------------------------------------------------

static thread_local std::string mn_error;

extern "C" const char* mn_last_error() { return mn_error.c_str(); }

extern "C" void mn_free(void* p) { std::free(p); }

#ifndef MN_NVJPEG

extern "C" int mn_jpeg_codec() { return 1; }  // libjpeg

struct MnJpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void mn_jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<MnJpegErr*>(cinfo->err);
  char msg[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, msg);
  mn_error = msg;
  longjmp(err->jb, 1);
}

// decode into caller buffer; returns 0 ok. Query mode: out==nullptr fills
// dims only.
extern "C" int mn_decode_jpeg(const uint8_t* data, int64_t len, int channels_req,
                   int* out_h, int* out_w, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  MnJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = mn_jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  jpeg_read_header(&cinfo, TRUE);
  int channels = channels_req;
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *out_h = cinfo.output_height;
  *out_w = cinfo.output_width;
  if (!out) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  jpeg_start_decompress(&cinfo);
  int stride = cinfo.output_width * cinfo.output_components;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// [h, w, channels] uint8 (channels 1 or 3) -> baseline JPEG at `quality`
// (libjpeg's defaults: 4:2:0 chroma for RGB). *out is malloc'ed: release it
// with mn_free. Returns 0 ok.
extern "C" int mn_encode_jpeg(const uint8_t* pixels, int h, int w, int channels,
                              int quality, uint8_t** out, int64_t* out_len) {
  jpeg_compress_struct cinfo;
  MnJpegErr jerr;
  unsigned char* buf = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = mn_jpeg_error_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    std::free(buf);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = w * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(pixels) + (size_t)cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  *out_len = (int64_t)size;
  return 0;
}

#else  // MN_NVJPEG

extern "C" int mn_jpeg_codec() { return 2; }  // nvJPEG

// One handle for the process (nvJPEG's handle is thread-safe); a decoder
// state, an encoder state, a stream and device buffers per calling thread.
static nvjpegHandle_t mn_nv_handle = nullptr;
static std::once_flag mn_nv_once;
static nvjpegStatus_t mn_nv_init_status = NVJPEG_STATUS_SUCCESS;

struct MnNvThread {
  cudaStream_t stream = nullptr;
  nvjpegJpegState_t dec = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  uint8_t* dev = nullptr;
  size_t dev_bytes = 0;
  ~MnNvThread() {
    if (params) nvjpegEncoderParamsDestroy(params);
    if (enc) nvjpegEncoderStateDestroy(enc);
    if (dec) nvjpegJpegStateDestroy(dec);
    if (dev) cudaFree(dev);
    if (stream) cudaStreamDestroy(stream);
  }
};

static thread_local MnNvThread mn_nv;

static bool mn_nv_fail(const char* what, int code) {
  mn_error = std::string(what) + " failed with status " + std::to_string(code);
  return false;
}

#define MN_NV(call)                                                         \
  do {                                                                      \
    nvjpegStatus_t s_ = (call);                                             \
    if (s_ != NVJPEG_STATUS_SUCCESS) return mn_nv_fail(#call, (int)s_);     \
  } while (0)
#define MN_CU(call)                                                         \
  do {                                                                      \
    cudaError_t e_ = (call);                                                \
    if (e_ != cudaSuccess) {                                                \
      mn_error = std::string(#call) + ": " + cudaGetErrorString(e_);        \
      return false;                                                         \
    }                                                                       \
  } while (0)

// the calling thread's state, created at its first call
static bool mn_nv_ready() {
  std::call_once(mn_nv_once, [] { mn_nv_init_status = nvjpegCreateSimple(&mn_nv_handle); });
  if (mn_nv_init_status != NVJPEG_STATUS_SUCCESS)
    return mn_nv_fail("nvjpegCreateSimple", (int)mn_nv_init_status);
  if (!mn_nv.stream) MN_CU(cudaStreamCreateWithFlags(&mn_nv.stream, cudaStreamNonBlocking));
  if (!mn_nv.dec) MN_NV(nvjpegJpegStateCreate(mn_nv_handle, &mn_nv.dec));
  if (!mn_nv.enc) MN_NV(nvjpegEncoderStateCreate(mn_nv_handle, &mn_nv.enc, mn_nv.stream));
  if (!mn_nv.params) MN_NV(nvjpegEncoderParamsCreate(mn_nv_handle, &mn_nv.params, mn_nv.stream));
  return true;
}

// the thread's device buffer, grown to at least `bytes` (a cudaMalloc only
// when it grows)
static bool mn_nv_reserve(size_t bytes) {
  if (bytes <= mn_nv.dev_bytes) return true;
  if (mn_nv.dev) MN_CU(cudaFree(mn_nv.dev));
  mn_nv.dev = nullptr;
  mn_nv.dev_bytes = 0;
  MN_CU(cudaMalloc(reinterpret_cast<void**>(&mn_nv.dev), bytes));
  mn_nv.dev_bytes = bytes;
  return true;
}

static bool mn_nv_decode(const uint8_t* data, int64_t len, int channels, int* out_h,
                         int* out_w, uint8_t* out) {
  if (!mn_nv_ready()) return false;
  int ncomp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  MN_NV(nvjpegGetImageInfo(mn_nv_handle, data, (size_t)len, &ncomp, &css, widths, heights));
  *out_h = heights[0];
  *out_w = widths[0];
  if (!out) return true;
  const size_t pitch = (size_t)widths[0] * channels;
  const size_t bytes = pitch * heights[0];
  if (!mn_nv_reserve(bytes)) return false;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = mn_nv.dev;
  img.pitch[0] = pitch;
  MN_NV(nvjpegDecode(mn_nv_handle, mn_nv.dec, data, (size_t)len,
                     channels == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &img,
                     mn_nv.stream));
  MN_CU(cudaMemcpyAsync(out, mn_nv.dev, bytes, cudaMemcpyDeviceToHost, mn_nv.stream));
  MN_CU(cudaStreamSynchronize(mn_nv.stream));
  return true;
}

static bool mn_nv_encode(const uint8_t* pixels, int h, int w, int channels, int quality,
                         uint8_t** out, int64_t* out_len) {
  if (!mn_nv_ready()) return false;
  const size_t bytes = (size_t)h * w * channels;
  if (!mn_nv_reserve(bytes)) return false;
  MN_CU(cudaMemcpyAsync(mn_nv.dev, pixels, bytes, cudaMemcpyHostToDevice, mn_nv.stream));
  MN_NV(nvjpegEncoderParamsSetQuality(mn_nv.params, quality, mn_nv.stream));
  MN_NV(nvjpegEncoderParamsSetOptimizedHuffman(mn_nv.params, 0, mn_nv.stream));
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = mn_nv.dev;
  img.pitch[0] = (size_t)w * channels;
  if (channels == 1) {
    MN_NV(nvjpegEncoderParamsSetSamplingFactors(mn_nv.params, NVJPEG_CSS_GRAY, mn_nv.stream));
    MN_NV(nvjpegEncodeYUV(mn_nv_handle, mn_nv.enc, mn_nv.params, &img, NVJPEG_CSS_GRAY, w, h,
                          mn_nv.stream));
  } else {
    MN_NV(nvjpegEncoderParamsSetSamplingFactors(mn_nv.params, NVJPEG_CSS_420, mn_nv.stream));
    MN_NV(nvjpegEncodeImage(mn_nv_handle, mn_nv.enc, mn_nv.params, &img, NVJPEG_INPUT_RGBI, w,
                            h, mn_nv.stream));
  }
  size_t length = 0;
  MN_NV(nvjpegEncodeRetrieveBitstream(mn_nv_handle, mn_nv.enc, nullptr, &length, mn_nv.stream));
  MN_CU(cudaStreamSynchronize(mn_nv.stream));
  auto* buf = static_cast<uint8_t*>(std::malloc(length));
  if (!buf) {
    mn_error = "malloc failed";
    return false;
  }
  nvjpegStatus_t s = nvjpegEncodeRetrieveBitstream(mn_nv_handle, mn_nv.enc, buf, &length,
                                                   mn_nv.stream);
  cudaError_t e = cudaStreamSynchronize(mn_nv.stream);
  if (s != NVJPEG_STATUS_SUCCESS || e != cudaSuccess) {
    std::free(buf);
    mn_error = "nvjpegEncodeRetrieveBitstream failed";
    return false;
  }
  *out = buf;
  *out_len = (int64_t)length;
  return true;
}

extern "C" int mn_decode_jpeg(const uint8_t* data, int64_t len, int channels_req,
                              int* out_h, int* out_w, uint8_t* out) {
  return mn_nv_decode(data, len, channels_req, out_h, out_w, out) ? 0 : 1;
}

extern "C" int mn_encode_jpeg(const uint8_t* pixels, int h, int w, int channels,
                              int quality, uint8_t** out, int64_t* out_len) {
  return mn_nv_encode(pixels, h, w, channels, quality, out, out_len) ? 0 : 1;
}

#endif  // MN_NVJPEG

// ---------------------------------------------------------------------------
// PIL-parity separable resampling (antialiased) + pad + space_to_depth
// ---------------------------------------------------------------------------
// The training augmentation draws a random per-image resize kernel
// (reference: random TF resize method, pretrain/data_utils.py:8-23,110-117;
// host mirror: data/pretrain_pipeline.pil_resize_methods). This implements
// the same six filters with Pillow's antialiased coefficient-window
// algorithm so the fused native path stays available under augmentation.
// Kernel ids follow pil_resize_methods() order:
//   0=BICUBIC 1=BILINEAR 2=BOX 3=HAMMING 4=LANCZOS 5=NEAREST

#include <cmath>
#include <algorithm>

static double mn_filter(int k, double x) {
  switch (k) {
    case 0: {  // bicubic (Keys, a = -0.5 — Pillow's BICUBIC)
      const double a = -0.5;
      if (x < 0) x = -x;
      if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
      if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
      return 0.0;
    }
    case 1:  // bilinear (triangle)
      if (x < 0) x = -x;
      return x < 1.0 ? 1.0 - x : 0.0;
    case 2:  // box
      return (x > -0.5 && x <= 0.5) ? 1.0 : 0.0;
    case 3: {  // hamming-windowed sinc (Pillow)
      if (x < 0) x = -x;
      if (x == 0.0) return 1.0;
      if (x >= 1.0) return 0.0;
      x = x * M_PI;
      return std::sin(x) / x * (0.54 + 0.46 * std::cos(x));
    }
    case 4: {  // lanczos3
      if (x < 0) x = -x;
      if (x >= 3.0) return 0.0;
      if (x == 0.0) return 1.0;
      const double px = M_PI * x, px3 = px / 3.0;
      return (std::sin(px) / px) * (std::sin(px3) / px3);
    }
  }
  return 0.0;
}

static double mn_support(int k) {
  switch (k) {
    case 0: return 2.0;
    case 1: return 1.0;
    case 2: return 0.5;
    case 3: return 1.0;
    case 4: return 3.0;
  }
  return 1.0;
}

// Pillow-style coefficient windows for output pixels
// [out_lo, out_lo + out_n) of a full in_size -> out_size resize.
struct MnCoeffs {
  std::vector<int> xmin, xlen;
  std::vector<double> w;  // packed with max_len stride
  int max_len = 0;
};

static void mn_precompute(int k, int in_size, int out_size, int out_lo,
                          int out_n, MnCoeffs* c) {
  const double ratio = (double)in_size / out_size;
  const double filterscale = ratio > 1.0 ? ratio : 1.0;
  const double support = mn_support(k) * filterscale;
  c->max_len = (int)std::ceil(support) * 2 + 2;
  c->xmin.resize(out_n);
  c->xlen.resize(out_n);
  c->w.assign((size_t)out_n * c->max_len, 0.0);
  for (int i = 0; i < out_n; ++i) {
    const int xx = out_lo + i;
    const double center = (xx + 0.5) * ratio;
    double* ww = &c->w[(size_t)i * c->max_len];
    if (k == 5) {  // nearest: single tap at the sample point
      int x0 = (int)center;
      if (x0 >= in_size) x0 = in_size - 1;
      if (x0 < 0) x0 = 0;
      c->xmin[i] = x0;
      c->xlen[i] = 1;
      ww[0] = 1.0;
      continue;
    }
    int xmn = (int)(center - support + 0.5);
    if (xmn < 0) xmn = 0;
    int xmx = (int)(center + support + 0.5);
    if (xmx > in_size) xmx = in_size;
    double total = 0.0;
    for (int x = xmn; x < xmx; ++x) {
      const double v = mn_filter(k, (x - center + 0.5) / filterscale);
      ww[x - xmn] = v;
      total += v;
    }
    if (total != 0.0)
      for (int x = 0; x < xmx - xmn; ++x) ww[x] /= total;
    c->xmin[i] = xmn;
    c->xlen[i] = xmx - xmn;
  }
}

extern "C" void mn_resize_patchify_k(const uint8_t* rgb, int h, int w,
                                     int grid_h, int grid_w, int patch,
                                     double scale_mult, int off_y, int off_x,
                                     int kernel, float* out) {
  const int dh = grid_h * patch, dw = grid_w * patch;
  const double scale = std::min((double)dh / h, (double)dw / w) * scale_mult;
  const int sh_full = (int)(h * scale), sw_full = (int)(w * scale);
  const int sh = std::min(sh_full - off_y, dh);
  const int sw = std::min(sw_full - off_x, dw);
  const size_t out_elems = (size_t)grid_h * grid_w * patch * patch * 3;
  std::memset(out, 0, out_elems * sizeof(float));
  if (sh <= 0 || sw <= 0 || sh_full <= 0 || sw_full <= 0) return;

  MnCoeffs cx, cy;
  mn_precompute(kernel, w, sw_full, off_x, sw, &cx);
  mn_precompute(kernel, h, sh_full, off_y, sh, &cy);

  int y_lo = h, y_hi = 0;
  for (int i = 0; i < sh; ++i) {
    y_lo = std::min(y_lo, cy.xmin[i]);
    y_hi = std::max(y_hi, cy.xmin[i] + cy.xlen[i]);
  }

  // pass 1: horizontal resample of the needed source rows
  const int rows = y_hi - y_lo;
  std::vector<float> tmp((size_t)rows * sw * 3);
  for (int r = 0; r < rows; ++r) {
    const uint8_t* src = rgb + (size_t)(y_lo + r) * w * 3;
    float* dst = &tmp[(size_t)r * sw * 3];
    for (int i = 0; i < sw; ++i) {
      const double* ww = &cx.w[(size_t)i * cx.max_len];
      const uint8_t* p = src + cx.xmin[i] * 3;
      float a0 = 0, a1 = 0, a2 = 0;
      for (int t = 0; t < cx.xlen[i]; ++t, p += 3) {
        const float wt = (float)ww[t];
        a0 += wt * p[0];
        a1 += wt * p[1];
        a2 += wt * p[2];
      }
      dst[i * 3 + 0] = a0;
      dst[i * 3 + 1] = a1;
      dst[i * 3 + 2] = a2;
    }
  }

  // pass 2: vertical + 1/255 + clamp + space_to_depth patchify.
  // Taps-outer / columns-inner: each tap streams one contiguous tmp row
  // into a row accumulator (vectorizable fma), then one scatter pass
  // performs the patchify layout write.
  constexpr float kInv255 = 1.0f / 255.0f;
  std::vector<float> acc((size_t)sw * 3);
  for (int y = 0; y < sh; ++y) {
    const double* wy = &cy.w[(size_t)y * cy.max_len];
    const int r0 = cy.xmin[y] - y_lo, n = cy.xlen[y];
    std::fill(acc.begin(), acc.end(), 0.0f);
    for (int t = 0; t < n; ++t) {
      const float wt = (float)wy[t];
      const float* p = &tmp[(size_t)(r0 + t) * sw * 3];
      float* a = acc.data();
      for (int i = 0; i < sw * 3; ++i) a[i] += wt * p[i];
    }
    const int gy = y / patch, py = y % patch;
    float* dst_row = out + ((size_t)gy * grid_w * patch * patch +
                            (size_t)py * patch) * 3;
    for (int x = 0; x < sw; ++x) {
      const int gx = x / patch, px = x % patch;
      float* dst = dst_row + ((size_t)gx * patch * patch + px) * 3;
      const auto cl = [](float v) {
        v *= kInv255;
        return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      };
      dst[0] = cl(acc[x * 3 + 0]);
      dst[1] = cl(acc[x * 3 + 1]);
      dst[2] = cl(acc[x * 3 + 2]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pillow's 8-bit resize (Image.resize on an "L" or "RGB" image): the same
// coefficient windows, each weight rounded to a fixed-point integer of
// MN_PREC bits, integer sums rounded and clipped to uint8 after each pass
// (horizontal first, over the rows the vertical pass reads). Gives Pillow's
// pixels bit for bit; the dataset tools store frames resized this way.
// ---------------------------------------------------------------------------

static constexpr int MN_PREC = 32 - 8 - 2;  // Pillow's PRECISION_BITS

static void mn_fixed_coeffs(const MnCoeffs& c, int n, std::vector<int32_t>* kk) {
  kk->assign(c.w.size(), 0);
  for (size_t i = 0; i < (size_t)n * c.max_len; ++i) {
    const double v = c.w[i] * (double)(1 << MN_PREC);
    (*kk)[i] = (int32_t)(v < 0 ? -0.5 + v : 0.5 + v);
  }
}

static inline uint8_t mn_clip8(int64_t v) {
  if (v >= ((int64_t)1 << MN_PREC << 8)) return 255;
  if (v <= 0) return 0;
  return (uint8_t)(v >> MN_PREC);
}

// [h, w, channels] uint8 -> [out_h, out_w, channels] uint8: Pillow's 8-bit
// bilinear resize.
extern "C" int mn_resize_u8(const uint8_t* src, int h, int w, int channels, int out_h,
                            int out_w, uint8_t* out) {
  if (h <= 0 || w <= 0 || out_h <= 0 || out_w <= 0 || channels <= 0) {
    mn_error = "resize: bad sizes";
    return 1;
  }
  const int kernel = 1;  // bilinear
  MnCoeffs cx, cy;
  mn_precompute(kernel, w, out_w, 0, out_w, &cx);
  mn_precompute(kernel, h, out_h, 0, out_h, &cy);
  std::vector<int32_t> kx, ky;
  mn_fixed_coeffs(cx, out_w, &kx);
  mn_fixed_coeffs(cy, out_h, &ky);
  const int y_lo = cy.xmin[0];
  const int y_hi = cy.xmin[out_h - 1] + cy.xlen[out_h - 1];
  const bool horizontal = out_w != w, vertical = out_h != h;
  // pass 1: horizontal, rows [y_lo, y_hi) (all rows when there is no
  // vertical pass)
  const int r0 = vertical ? y_lo : 0, rows = vertical ? y_hi - y_lo : h;
  std::vector<uint8_t> tmp;
  const uint8_t* mid = src + (size_t)r0 * w * channels;
  int mid_w = w;
  if (horizontal) {
    tmp.resize((size_t)rows * out_w * channels);
    for (int r = 0; r < rows; ++r) {
      const uint8_t* in = src + (size_t)(r0 + r) * w * channels;
      uint8_t* o = &tmp[(size_t)r * out_w * channels];
      for (int x = 0; x < out_w; ++x) {
        const int32_t* k = &kx[(size_t)x * cx.max_len];
        const uint8_t* p = in + (size_t)cx.xmin[x] * channels;
        for (int ch = 0; ch < channels; ++ch) {
          int64_t ss = (int64_t)1 << (MN_PREC - 1);
          for (int t = 0; t < cx.xlen[x]; ++t) ss += (int64_t)p[t * channels + ch] * k[t];
          o[x * channels + ch] = mn_clip8(ss);
        }
      }
    }
    mid = tmp.data();
    mid_w = out_w;
  }
  const size_t row_bytes = (size_t)mid_w * channels;
  if (!vertical) {
    std::memcpy(out, mid, (size_t)h * row_bytes);
    return 0;
  }
  // pass 2: vertical
  for (int y = 0; y < out_h; ++y) {
    const int32_t* k = &ky[(size_t)y * cy.max_len];
    const uint8_t* base = mid + (size_t)(cy.xmin[y] - r0) * row_bytes;
    uint8_t* o = out + (size_t)y * row_bytes;
    for (size_t i = 0; i < row_bytes; ++i) {
      int64_t ss = (int64_t)1 << (MN_PREC - 1);
      for (int t = 0; t < cy.xlen[y]; ++t) ss += (int64_t)base[t * row_bytes + i] * k[t];
      o[i] = mn_clip8(ss);
    }
  }
  return 0;
}
