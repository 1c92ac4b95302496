// Fast host-side data path: COCO RLE decode, mask bbox, crop/resize,
// CLIP normalization — the per-instance preprocessing the reference does
// with pycocotools + OpenCV python calls (provider/bop_test_dataset.py:
// 163-196, utils/data_utils.py:131-299; SURVEY.md hot loop #5).
//
// The port's copy of the JAX package's native/fastpath.cpp, exposed via
// ctypes (picopose_tpu_torch/native/fastpath.py).  The numpy paths of
// data/rle.py and data/crops.py are its oracle; they run only when
// PICOPOSE_NO_FASTPATH=1 asks for them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// COCO compressed RLE ("modified LEB128") -> run-length counts.
// Returns number of counts written (<= max_counts).
int rle_decode_counts(const char* s, int len, int64_t* counts, int max_counts) {
  int n = 0, i = 0;
  while (i < len && n < max_counts) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more && i < len) {
      int c = s[i] - 48;
      x |= (int64_t)(c & 0x1F) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k + 5);
      ++k;
    }
    if (n > 2) x += counts[n - 2];
    counts[n++] = x;
  }
  return n;
}

// Run-length counts (column-major, background first) -> (h, w) uint8 mask.
void rle_counts_to_mask(const int64_t* counts, int n_counts, int h, int w,
                        uint8_t* mask /* row-major (h, w) */) {
  std::memset(mask, 0, (size_t)h * w);
  int64_t pos = 0;
  const int64_t total = (int64_t)h * w;
  for (int i = 0; i < n_counts; ++i) {
    int64_t run = counts[i];
    if (i & 1) {  // odd runs are foreground
      int64_t end = std::min(pos + run, total);
      for (int64_t p = pos; p < end; ++p) {
        // column-major index p -> (row, col)
        mask[(p % h) * w + (p / h)] = 1;
      }
    }
    pos += run;
  }
}

// Mask bbox (row-major (h, w) uint8): writes y1, y2, x1, x2; returns 0 if
// the mask is empty.
int mask_bbox(const uint8_t* mask, int h, int w, int* bbox) {
  int y1 = h, y2 = -1, x1 = w, x2 = -1;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = mask + (size_t)y * w;
    for (int x = 0; x < w; ++x) {
      if (row[x]) {
        if (y < y1) y1 = y;
        if (y > y2) y2 = y;
        if (x < x1) x1 = x;
        if (x > x2) x2 = x;
      }
    }
  }
  if (y2 < 0) return 0;
  bbox[0] = y1;
  bbox[1] = y2 + 1;
  bbox[2] = x1;
  bbox[3] = x2 + 1;
  return 1;
}

// Crop a uint8 RGB image (row-major HWC), optional BGR flip, bilinear
// resize to (out, out), CLIP-normalize into float32 (out, out, 3).
// Matches cv2.INTER_LINEAR + the reference's mean/std
// (utils/data_utils.py:245-248, bop_test_dataset.py:40-42).
void crop_resize_normalize(
    const uint8_t* img, int H, int W,
    int y1, int y2, int x1, int x2,
    int out, int bgr_flip, int mask_rgb, const uint8_t* mask,
    const float* mean, const float* std_, float* dst) {
  const int ch = y2 - y1, cw = x2 - x1;
  const float sy = (float)ch / out, sx = (float)cw / out;
  for (int oy = 0; oy < out; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int iy0 = (int)std::floor(fy);
    float wy = fy - iy0;
    int iy1 = std::min(iy0 + 1, ch - 1);
    iy0 = std::max(iy0, 0);
    for (int ox = 0; ox < out; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int ix0 = (int)std::floor(fx);
      float wx = fx - ix0;
      int ix1 = std::min(ix0 + 1, cw - 1);
      ix0 = std::max(ix0, 0);
      for (int c = 0; c < 3; ++c) {
        int sc = bgr_flip ? 2 - c : c;
        auto at = [&](int yy, int xx) -> float {
          int gy = y1 + yy, gx = x1 + xx;
          float v = img[((size_t)gy * W + gx) * 3 + sc] / 255.0f;
          if (mask_rgb && mask && !mask[(size_t)gy * W + gx]) v = 0.0f;
          return v;
        };
        float v = (1 - wy) * ((1 - wx) * at(iy0, ix0) + wx * at(iy0, ix1)) +
                  wy * ((1 - wx) * at(iy1, ix0) + wx * at(iy1, ix1));
        dst[((size_t)oy * out + ox) * 3 + c] = (v - mean[c]) / std_[c];
      }
    }
  }
}

// Nearest-resize a uint8 mask crop to (out, out) float32
// (cv2.INTER_NEAREST / torch 'nearest' semantics: src = floor(dst * scale)).
void crop_mask_nearest(const uint8_t* mask, int H, int W,
                       int y1, int y2, int x1, int x2, int out, float* dst) {
  const int ch = y2 - y1, cw = x2 - x1;
  const float sy = (float)ch / out, sx = (float)cw / out;
  for (int oy = 0; oy < out; ++oy) {
    int iy = std::min((int)(oy * sy), ch - 1);
    for (int ox = 0; ox < out; ++ox) {
      int ix = std::min((int)(ox * sx), cw - 1);
      dst[(size_t)oy * out + ox] = mask[(size_t)(y1 + iy) * W + (x1 + ix)];
    }
  }
}

}  // extern "C"
