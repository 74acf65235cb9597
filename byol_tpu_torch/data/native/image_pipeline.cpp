// Native host augmentation pipeline — the DALI-equivalent (C++).
//
// The reference offloads decode+augment to NVIDIA DALI (C++/CUDA) when the
// Python host pipeline can't feed the accelerators
// (reference main.py:356-382, README.md:90-93).  On TPU the augment
// math must stay on the host CPU (chips are fed via infeed, not CUDA), so
// the native escape hatch is a multithreaded C++ kernel over raw uint8
// batches: two independently-augmented float32 views per image, one pass,
// no Python/TF dispatch overhead per sample.
//
// Augmentation SPEC matches the canonical torchvision stack exactly
// (byol_tpu/data/augment.py; reference main.py:386-397):
//   RandomResizedCrop(size, scale=[.08,1], ratio=[3/4,4/3], bilinear)
//   HFlip(p=.5)
//   ColorJitter(brightness=.8s, contrast=.8s, saturation=.8s, hue=.2s) p=.8
//   RandomGrayscale(p=.2)
//   GaussianBlur(k=int(.1*size)|1>=3, sigma~U(.1,2), p=.5)
//   clip to [0,1]
// (unlike the reference's DALI path, which silently changed the
// hyperparameters — Quirk Q4 — this backend keeps the one canonical spec).
//
// Determinism: every (seed, sample_index, view) triple derives an
// independent splitmix64/xorshift PRNG stream, so epoch reshuffles are
// reproducible and views are decorrelated — same contract as the stateless
// TF path.
//
// JPEG path (BYOL_WITH_JPEG): the reference's DALI exists precisely for
// host-bound JPEG decode+augment at ImageNet scale (main.py:356-382,
// README.md:90-93).  Equivalent trick here, via libjpeg-turbo:
//   1. read ONLY the header for (h, w);
//   2. sample the RandomResizedCrop window in full-image coordinates;
//   3. decode ONLY that window — DCT-domain scaling (scale_num/8 chosen so
//      the decoded crop is ~>= the target size) + jpeg_crop_scanline column
//      cropping + jpeg_skip_scanlines row skipping, then abort the rest;
//   4. bilinear-resize the decoded window to (size, size) and run the same
//      post-crop augment chain as the array path (same PRNG draw order).
// This is the fused decode+crop DALI/tf.image.decode_and_crop_jpeg do; the
// DCT scaling trades a slight low-pass for O(crop*scale^2) work instead of
// O(image) — the standard ImageNet-pipeline tradeoff.
//
// Build: g++ -O3 -shared -fPIC -pthread -o libbyol_aug.so image_pipeline.cpp
// [-DBYOL_WITH_JPEG -ljpeg]
// (byol_tpu/data/native_aug.py compiles this lazily — first with libjpeg,
// falling back to no-JPEG, then to the tf.data path if no toolchain).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#ifdef BYOL_WITH_JPEG
#include <csetjmp>
#include <cstdio>
#include <jpeglib.h>
#endif

namespace {

// ---- PRNG: splitmix64 seeding + xoshiro-style stream ----------------------
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed) {
    next();  // decorrelate nearby seeds
    next();
  }
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  double uniform(double lo, double hi) { return lo + (hi - lo) * uniform(); }
};

struct CropWindow {
  double y0, x0, ch, cw;  // fractional source window
};

// torchvision RandomResizedCrop window sampling: 10 area/ratio attempts,
// then center fallback.
CropWindow sample_crop(Rng& rng, int h, int w) {
  const double area = static_cast<double>(h) * w;
  for (int attempt = 0; attempt < 10; ++attempt) {
    double target_area = rng.uniform(0.08, 1.0) * area;
    double log_ratio = rng.uniform(std::log(3.0 / 4.0), std::log(4.0 / 3.0));
    double ratio = std::exp(log_ratio);
    double cw = std::sqrt(target_area * ratio);
    double ch = std::sqrt(target_area / ratio);
    if (cw <= w && ch <= h) {
      double y0 = rng.uniform(0.0, h - ch);
      double x0 = rng.uniform(0.0, w - cw);
      return {y0, x0, ch, cw};
    }
  }
  // fallback: central crop at the clamped aspect ratio (torchvision)
  double in_ratio = static_cast<double>(w) / h;
  double cw, ch;
  if (in_ratio < 3.0 / 4.0) {
    cw = w;
    ch = cw / (3.0 / 4.0);
  } else if (in_ratio > 4.0 / 3.0) {
    ch = h;
    cw = ch * (4.0 / 3.0);
  } else {
    cw = w;
    ch = h;
  }
  return {(h - ch) / 2.0, (w - cw) / 2.0, ch, cw};
}

// bilinear sample from uint8 HWC source into float [0,1] RGB
inline void bilinear_rgb(const uint8_t* src, int h, int w, double sy,
                         double sx, float out[3]) {
  sy = std::min(std::max(sy, 0.0), h - 1.0);
  sx = std::min(std::max(sx, 0.0), w - 1.0);
  int y0 = static_cast<int>(sy), x0 = static_cast<int>(sx);
  int y1 = std::min(y0 + 1, h - 1), x1 = std::min(x0 + 1, w - 1);
  double fy = sy - y0, fx = sx - x0;
  const double inv = 1.0 / 255.0;
  for (int c = 0; c < 3; ++c) {
    double v00 = src[(y0 * w + x0) * 3 + c];
    double v01 = src[(y0 * w + x1) * 3 + c];
    double v10 = src[(y1 * w + x0) * 3 + c];
    double v11 = src[(y1 * w + x1) * 3 + c];
    double top = v00 + (v01 - v00) * fx;
    double bot = v10 + (v11 - v10) * fx;
    out[c] = static_cast<float>((top + (bot - top) * fy) * inv);
  }
}

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline float gray_of(const float* px) {
  return 0.2989f * px[0] + 0.587f * px[1] + 0.114f * px[2];
}

// steps 2-5 of one augmented view, applied in-place to the cropped+resized
// float32 (size, size, 3) buffer.  ONE implementation shared by the
// uint8-array and JPEG paths so both draw from the PRNG in the same order
// (crop draws happen in sample_crop before this is called).
void post_crop_augment(float* dst, int size, float cj_strength, Rng& rng) {
  const int n = size * size;

  // 2) HFlip p=.5
  if (rng.uniform() < 0.5) {
    for (int y = 0; y < size; ++y) {
      float* row = dst + y * size * 3;
      for (int x = 0; x < size / 2; ++x) {
        for (int c = 0; c < 3; ++c)
          std::swap(row[x * 3 + c], row[(size - 1 - x) * 3 + c]);
      }
    }
  }

  // 3) ColorJitter p=.8 — brightness, contrast, saturation (.8s), hue (.2s);
  // fixed order matching byol_tpu/data/augment.py (documented deviation from
  // torchvision's random order).
  const double b = 0.8 * cj_strength, c_ = 0.8 * cj_strength,
               s_ = 0.8 * cj_strength, hs = 0.2 * cj_strength;
  // draw the gate AND the sub-draws from independent streams so disabled
  // branches don't shift downstream randomness
  bool do_jitter = rng.uniform() < 0.8;
  double f_b = rng.uniform(std::max(0.0, 1.0 - b), 1.0 + b);
  double f_c = rng.uniform(std::max(0.0, 1.0 - c_), 1.0 + c_);
  double f_s = rng.uniform(std::max(0.0, 1.0 - s_), 1.0 + s_);
  double theta = rng.uniform(-hs, hs) * 2.0 * M_PI;
  if (do_jitter) {
    // brightness (multiplicative, torch semantics)
    for (int i = 0; i < n * 3; ++i)
      dst[i] = clampf(dst[i] * static_cast<float>(f_b), 0.f, 1.f);
    // contrast: blend with mean gray
    double mean_gray = 0.0;
    for (int i = 0; i < n; ++i) mean_gray += gray_of(dst + i * 3);
    mean_gray /= n;
    for (int i = 0; i < n * 3; ++i)
      dst[i] = clampf(static_cast<float>(f_c * dst[i] +
                                         (1.0 - f_c) * mean_gray), 0.f, 1.f);
    // saturation: blend with per-pixel gray
    for (int i = 0; i < n; ++i) {
      float g = gray_of(dst + i * 3);
      for (int c = 0; c < 3; ++c)
        dst[i * 3 + c] = clampf(
            static_cast<float>(f_s * dst[i * 3 + c] + (1.0 - f_s) * g), 0.f,
            1.f);
    }
    // hue: YIQ rotation (same math as the on-device path)
    if (hs > 0.0) {
      const double cos_t = std::cos(theta), sin_t = std::sin(theta);
      for (int i = 0; i < n; ++i) {
        float r = dst[i * 3], g = dst[i * 3 + 1], bl = dst[i * 3 + 2];
        double yy = 0.299 * r + 0.587 * g + 0.114 * bl;
        double ii = 0.596 * r - 0.274 * g - 0.322 * bl;
        double qq = 0.211 * r - 0.523 * g + 0.312 * bl;
        double i2 = ii * cos_t - qq * sin_t;
        double q2 = ii * sin_t + qq * cos_t;
        dst[i * 3] = clampf(
            static_cast<float>(yy + 0.956 * i2 + 0.621 * q2), 0.f, 1.f);
        dst[i * 3 + 1] = clampf(
            static_cast<float>(yy - 0.272 * i2 - 0.647 * q2), 0.f, 1.f);
        dst[i * 3 + 2] = clampf(
            static_cast<float>(yy - 1.106 * i2 + 1.703 * q2), 0.f, 1.f);
      }
    }
  }

  // 4) RandomGrayscale p=.2
  if (rng.uniform() < 0.2) {
    for (int i = 0; i < n; ++i) {
      float g = gray_of(dst + i * 3);
      dst[i * 3] = dst[i * 3 + 1] = dst[i * 3 + 2] = g;
    }
  }

  // 5) GaussianBlur p=.5 (separable; sigma and gate from independent draws)
  bool do_blur = rng.uniform() < 0.5;
  double sigma = rng.uniform(0.1, 2.0);
  if (do_blur) {
    int k = static_cast<int>(0.1 * size) | 1;
    if (k < 3) k = 3;
    int r = k / 2;
    std::vector<float> g(k);
    float sum = 0.f;
    for (int i = 0; i < k; ++i) {
      double x = i - r;
      g[i] = static_cast<float>(std::exp(-(x * x) / (2.0 * sigma * sigma)));
      sum += g[i];
    }
    for (int i = 0; i < k; ++i) g[i] /= sum;
    std::vector<float> tmp(n * 3);
    // reflect-101 border indexing (cv2 GaussianBlur convention; keeps the
    // two DALI-analog backends bit-consistent with data/augment.py's
    // REFLECT-padded depthwise conv)
    auto reflect101 = [](int v, int n) {
      if (v < 0) v = -v;
      if (v >= n) v = 2 * n - 2 - v;
      return v;
    };
    // horizontal
    for (int y = 0; y < size; ++y) {
      for (int x = 0; x < size; ++x) {
        float acc[3] = {0, 0, 0};
        for (int t = -r; t <= r; ++t) {
          int xx = reflect101(x + t, size);
          const float* px = dst + (y * size + xx) * 3;
          for (int c = 0; c < 3; ++c) acc[c] += g[t + r] * px[c];
        }
        for (int c = 0; c < 3; ++c) tmp[(y * size + x) * 3 + c] = acc[c];
      }
    }
    // vertical
    for (int y = 0; y < size; ++y) {
      for (int x = 0; x < size; ++x) {
        float acc[3] = {0, 0, 0};
        for (int t = -r; t <= r; ++t) {
          int yy = reflect101(y + t, size);
          const float* px = tmp.data() + (yy * size + x) * 3;
          for (int c = 0; c < 3; ++c) acc[c] += g[t + r] * px[c];
        }
        for (int c = 0; c < 3; ++c)
          dst[(y * size + x) * 3 + c] = clampf(acc[c], 0.f, 1.f);
      }
    }
  }
}

// one augmented view: src uint8 (h, w, 3) -> dst float32 (size, size, 3)
void augment_one(const uint8_t* src, int h, int w, float* dst, int size,
                 float cj_strength, Rng& rng) {
  // 1) RandomResizedCrop (bilinear)
  CropWindow win = sample_crop(rng, h, w);
  double step_y = win.ch / size, step_x = win.cw / size;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      bilinear_rgb(src, h, w, win.y0 + (y + 0.5) * step_y - 0.5,
                   win.x0 + (x + 0.5) * step_x - 0.5, dst + (y * size + x) * 3);
    }
  }
  post_crop_augment(dst, size, cj_strength, rng);
}

// test-only resize (bilinear, whole image -> size x size), matching the
// reference's Resize-only eval transform (main.py:398)
void resize_one(const uint8_t* src, int h, int w, float* dst, int size) {
  double step_y = static_cast<double>(h) / size;
  double step_x = static_cast<double>(w) / size;
  for (int y = 0; y < size; ++y)
    for (int x = 0; x < size; ++x)
      bilinear_rgb(src, h, w, (y + 0.5) * step_y - 0.5,
                   (x + 0.5) * step_x - 0.5, dst + (y * size + x) * 3);
}

#ifdef BYOL_WITH_JPEG
// ---- libjpeg(-turbo) fused decode ----------------------------------------
struct JpegErrorMgr {
  jpeg_error_mgr mgr;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}
void jpeg_silent(j_common_ptr, int) {}
void jpeg_silent_msg(j_common_ptr) {}

// RAII so longjmp error paths can't leak the decompress object
struct JpegDecoder {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  bool live = false;
  JpegDecoder() {
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    jerr.mgr.emit_message = jpeg_silent;
    jerr.mgr.output_message = jpeg_silent_msg;
    jpeg_create_decompress(&cinfo);
    live = true;
  }
  ~JpegDecoder() {
    if (live) jpeg_destroy_decompress(&cinfo);
  }
};

// Decode a rectangular window of a JPEG at DCT scale s/8.
//   win (fractional, FULL-RES coords) -> decoded uint8 RGB buffer `out`
//   covering at least the window at scale s/8; returns false on corrupt /
//   unsupported (CMYK etc.) input.  `bw/bh` = buffer dims; `by0/bx0` =
//   buffer origin in SCALED image coords.
bool jpeg_decode_window(const uint8_t* data, size_t len, const CropWindow& win,
                        int scale_num, std::vector<uint8_t>& out, int* bw,
                        int* bh, double* by0, double* bx0, double* sy_scale,
                        double* sx_scale) {
  JpegDecoder dec;
  jpeg_decompress_struct& cinfo = dec.cinfo;
  if (setjmp(dec.jerr.setjmp_buffer)) return false;
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) return false;
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = scale_num;
  cinfo.scale_denom = 8;
  cinfo.dct_method = JDCT_ISLOW;
  if (!jpeg_start_decompress(&cinfo)) return false;
  if (cinfo.output_components != 3) return false;  // CMYK etc.: caller falls back
  const int ow = cinfo.output_width, oh = cinfo.output_height;
  // full-res fractional window -> scaled coords (libjpeg scales by the
  // EXACT rational output_size/input_size, matching these factors)
  const double fy = static_cast<double>(oh) / cinfo.image_height;
  const double fx = static_cast<double>(ow) / cinfo.image_width;
  double y0s = win.y0 * fy, x0s = win.x0 * fx;
  double chs = win.ch * fy, cws = win.cw * fx;
  int y_lo = std::max(0, static_cast<int>(std::floor(y0s)));
  int y_hi = std::min(oh, static_cast<int>(std::ceil(y0s + chs)) + 1);
  JDIMENSION xoff = static_cast<JDIMENSION>(
      std::max(0, static_cast<int>(std::floor(x0s))));
  JDIMENSION xw = static_cast<JDIMENSION>(
      std::min(ow - static_cast<int>(xoff),
               static_cast<int>(std::ceil(cws)) + 2));
  // jpeg_crop_scanline rounds xoff DOWN to an iMCU boundary and widens xw
  // accordingly; it returns the adjusted values.
  jpeg_crop_scanline(&cinfo, &xoff, &xw);
  if (y_hi <= y_lo) y_hi = std::min(oh, y_lo + 1);
  out.resize(static_cast<size_t>(y_hi - y_lo) * xw * 3);
  if (y_lo > 0) jpeg_skip_scanlines(&cinfo, y_lo);
  JSAMPROW row;
  for (int y = y_lo; y < y_hi; ++y) {
    row = out.data() + static_cast<size_t>(y - y_lo) * xw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_abort_decompress(&cinfo);  // skip the remaining rows entirely
  *bw = static_cast<int>(xw);
  *bh = y_hi - y_lo;
  *by0 = y_lo;
  *bx0 = xoff;
  *sy_scale = fy;
  *sx_scale = fx;
  return true;
}

// pick the smallest DCT scale s/8 whose decoded window still has >= `size`
// pixels on its short side (never upscale past full resolution)
int pick_scale(double win_short, int size) {
  for (int s = 1; s <= 8; ++s) {
    if (win_short * s / 8.0 >= size) return s;
  }
  return 8;
}

// one augmented view straight from JPEG bytes; false -> caller must fall
// back (corrupt file / CMYK / not a JPEG)
bool jpeg_augment_one(const uint8_t* data, size_t len, float* dst, int size,
                      float cj_strength, Rng& rng) {
  // header-only pass for dimensions (cheap: no IDCT)
  int h, w;
  {
    JpegDecoder dec;
    if (setjmp(dec.jerr.setjmp_buffer)) return false;
    jpeg_mem_src(&dec.cinfo, const_cast<uint8_t*>(data),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&dec.cinfo, TRUE) != JPEG_HEADER_OK) return false;
    h = dec.cinfo.image_height;
    w = dec.cinfo.image_width;
  }
  if (h <= 0 || w <= 0) return false;
  // 1) sample the crop in full-res coords (same draw order as the array
  // path), then decode only that window
  CropWindow win = sample_crop(rng, h, w);
  int scale = pick_scale(std::min(win.ch, win.cw), size);
  std::vector<uint8_t> buf;
  int bw, bh;
  double by0, bx0, fy, fx;
  if (!jpeg_decode_window(data, len, win, scale, buf, &bw, &bh, &by0, &bx0,
                          &fy, &fx))
    return false;
  // window in buffer coords
  const double wy0 = win.y0 * fy - by0, wx0 = win.x0 * fx - bx0;
  const double step_y = win.ch * fy / size, step_x = win.cw * fx / size;
  for (int y = 0; y < size; ++y) {
    for (int x = 0; x < size; ++x) {
      bilinear_rgb(buf.data(), bh, bw, wy0 + (y + 0.5) * step_y - 0.5,
                   wx0 + (x + 0.5) * step_x - 0.5, dst + (y * size + x) * 3);
    }
  }
  post_crop_augment(dst, size, cj_strength, rng);
  return true;
}

// eval: full-frame decode at the coarsest sufficient DCT scale + resize
// (reference Resize-only test transform, main.py:398)
bool jpeg_resize_one(const uint8_t* data, size_t len, float* dst, int size) {
  int h, w;
  {
    JpegDecoder dec;
    if (setjmp(dec.jerr.setjmp_buffer)) return false;
    jpeg_mem_src(&dec.cinfo, const_cast<uint8_t*>(data),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&dec.cinfo, TRUE) != JPEG_HEADER_OK) return false;
    h = dec.cinfo.image_height;
    w = dec.cinfo.image_width;
  }
  CropWindow full{0.0, 0.0, static_cast<double>(h), static_cast<double>(w)};
  int scale = pick_scale(std::min(h, w), size);
  std::vector<uint8_t> buf;
  int bw, bh;
  double by0, bx0, fy, fx;
  if (!jpeg_decode_window(data, len, full, scale, buf, &bw, &bh, &by0, &bx0,
                          &fy, &fx))
    return false;
  resize_one(buf.data(), bh, bw, dst, size);
  return true;
}
#endif  // BYOL_WITH_JPEG

void run_threads(int n, int num_threads, const std::function<void(int)>& fn) {
  if (num_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> cursor{0};
  std::vector<std::thread> pool;
  pool.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&] {
      for (int i = cursor.fetch_add(1); i < n; i = cursor.fetch_add(1)) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Two independently-augmented views for a uint8 NHWC batch.
//   images: (n, h, w, 3) uint8; out1/out2: (n, size, size, 3) float32.
//   seed/index_base: deterministic per-sample streams (epoch reseed = new
//   index_base or seed, the set_all_epochs analog).
void byol_augment_two_views(const uint8_t* images, int n, int h, int w,
                            float* out1, float* out2, int size,
                            float cj_strength, uint64_t seed,
                            uint64_t index_base, int num_threads) {
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  run_threads(n, num_threads, [&](int i) {
    const uint8_t* src = images + i * in_stride;
    uint64_t base = seed * 0x9e3779b97f4a7c15ULL + (index_base + i);
    Rng r1(base * 2 + 0), r2(base * 2 + 1);
    augment_one(src, h, w, out1 + i * out_stride, size, cj_strength, r1);
    augment_one(src, h, w, out2 + i * out_stride, size, cj_strength, r2);
  });
}

// Resize-only eval batch (reference test transform, main.py:398).
void byol_resize_batch(const uint8_t* images, int n, int h, int w, float* out,
                       int size, int num_threads) {
  const size_t in_stride = static_cast<size_t>(h) * w * 3;
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  run_threads(n, num_threads,
              [&](int i) { resize_one(images + i * in_stride, h, w,
                                      out + i * out_stride, size); });
}

// 1 when this build fuses JPEG decode (libjpeg linked), else 0 — lets the
// Python side route image trees to tf.data when the toolchain lacked jpeg.
int byol_has_jpeg(void) {
#ifdef BYOL_WITH_JPEG
  return 1;
#else
  return 0;
#endif
}

#ifdef BYOL_WITH_JPEG
// Two augmented views per JPEG, fused decode+crop (the DALI-analog entry
// point for image trees).  blob = concatenated JPEG byte streams;
// offsets/sizes (n) delimit them.  ok[i]=0 flags images this decoder can't
// serve (corrupt / CMYK / non-JPEG) — their outputs are zeroed and the
// caller re-decodes those few via its fallback path.
void byol_jpeg_augment_two_views(const uint8_t* blob, const uint64_t* offsets,
                                 const uint64_t* sizes, int n, float* out1,
                                 float* out2, int size, float cj_strength,
                                 uint64_t seed, uint64_t index_base,
                                 int num_threads, int32_t* ok) {
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  run_threads(n, num_threads, [&](int i) {
    const uint8_t* data = blob + offsets[i];
    const size_t len = sizes[i];
    uint64_t base = seed * 0x9e3779b97f4a7c15ULL + (index_base + i);
    Rng r1(base * 2 + 0), r2(base * 2 + 1);
    bool ok1 = jpeg_augment_one(data, len, out1 + i * out_stride, size,
                                cj_strength, r1);
    bool ok2 = ok1 && jpeg_augment_one(data, len, out2 + i * out_stride, size,
                                       cj_strength, r2);
    ok[i] = (ok1 && ok2) ? 1 : 0;
    if (!ok[i]) {
      std::memset(out1 + i * out_stride, 0, out_stride * sizeof(float));
      std::memset(out2 + i * out_stride, 0, out_stride * sizeof(float));
    }
  });
}

// Resize-only eval batch from JPEG bytes.
void byol_jpeg_resize_batch(const uint8_t* blob, const uint64_t* offsets,
                            const uint64_t* sizes, int n, float* out, int size,
                            int num_threads, int32_t* ok) {
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  run_threads(n, num_threads, [&](int i) {
    ok[i] = jpeg_resize_one(blob + offsets[i], sizes[i], out + i * out_stride,
                            size)
                ? 1
                : 0;
    if (!ok[i]) std::memset(out + i * out_stride, 0, out_stride * sizeof(float));
  });
}
#endif  // BYOL_WITH_JPEG

}  // extern "C"
