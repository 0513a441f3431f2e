// Native mask utilities: COCO-style RLE codec + binary-mask bbox.
//
// TPU-native replacement for the third-party native pieces the reference
// leans on (SURVEY.md §2 native inventory): pycocotools' C RLE codec
// (datasets/kitti_dataset.py:196, detectron2CustomDataset.py:67) and the
// cv2 findContours→boundingRect union used for GT boxes
// (datasets/kitti_dataset.py:178-193) — the union of per-contour boxes
// equals the global nonzero bounding box, computed here directly.
//
// RLE layout follows the public COCO mask spec: run lengths of alternating
// 0/1 pixels in column-major (Fortran) order, starting with the zero run.
// The string form uses the COCO 6-bit variable-length encoding with delta
// compression so encodings interoperate with COCO-format JSON.
//
// Build: g++ -O3 -shared -fPIC rle.cpp -o librle.so   (see __init__.py)

#include <cstdint>
#include <cstring>

extern "C" {

// Encode a column-major binary mask (h*w bytes, F-order: index = x*h + y)
// into run counts. Returns the number of runs written to `counts`
// (capacity must be >= h*w + 1).
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w, uint32_t* counts) {
  const int64_t n = h * w;
  int64_t m = 0;
  uint8_t prev = 0;  // runs start with zeros
  uint32_t run = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      counts[m++] = run;
      run = 0;
      prev = v;
    }
    ++run;
  }
  counts[m++] = run;
  return m;
}

// Decode run counts back into a column-major binary mask (h*w bytes).
void rle_decode(const uint32_t* counts, int64_t m, int64_t h, int64_t w,
                uint8_t* mask) {
  const int64_t n = h * w;
  int64_t pos = 0;
  uint8_t v = 0;
  for (int64_t i = 0; i < m && pos < n; ++i) {
    uint32_t run = counts[i];
    if (run > static_cast<uint32_t>(n - pos)) run = static_cast<uint32_t>(n - pos);
    std::memset(mask + pos, v, run);
    pos += run;
    v ^= 1;
  }
  if (pos < n) std::memset(mask + pos, 0, n - pos);
}

// COCO 6-bit varint string encoding with delta compression (public spec).
// `out` capacity must be >= 8*m. Returns string length (not NUL-terminated).
int64_t rle_to_string(const uint32_t* counts, int64_t m, char* out) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t x = static_cast<int64_t>(counts[i]);
    if (i > 2) x -= static_cast<int64_t>(counts[i - 2]);
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[p++] = static_cast<char>(c + 48);
    }
  }
  return p;
}

// Inverse of rle_to_string. `counts` capacity must be >= strlen(s).
int64_t rle_from_string(const char* s, int64_t len, uint32_t* counts) {
  int64_t m = 0, p = 0;
  while (p < len) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      const int64_t c = static_cast<int64_t>(s[p]) - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++p;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += static_cast<int64_t>(counts[m - 2]);
    counts[m++] = static_cast<uint32_t>(x);
  }
  return m;
}

// Bounding box of nonzero pixels in a ROW-major (C-order) mask.
// Writes [xmin, ymin, xmax, ymax] with exclusive max (matching the
// reference's x+w / y+h convention, kitti_dataset.py:184-193).
// All -1 if the mask is empty.
void mask_bbox(const uint8_t* mask, int64_t h, int64_t w, int32_t* bbox) {
  int32_t xmin = static_cast<int32_t>(w), ymin = static_cast<int32_t>(h);
  int32_t xmax = -1, ymax = -1;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = mask + y * w;
    int64_t x = 0;
    for (; x < w; ++x) {
      if (row[x]) break;
    }
    if (x == w) continue;  // empty row
    if (static_cast<int32_t>(x) < xmin) xmin = static_cast<int32_t>(x);
    if (static_cast<int32_t>(y) < ymin) ymin = static_cast<int32_t>(y);
    if (static_cast<int32_t>(y) >= ymax) ymax = static_cast<int32_t>(y) + 1;
    for (int64_t xr = w - 1; xr >= x; --xr) {
      if (row[xr]) {
        if (static_cast<int32_t>(xr) >= xmax) xmax = static_cast<int32_t>(xr) + 1;
        break;
      }
    }
  }
  if (xmax < 0) {
    bbox[0] = bbox[1] = bbox[2] = bbox[3] = -1;
  } else {
    bbox[0] = xmin;
    bbox[1] = ymin;
    bbox[2] = xmax;
    bbox[3] = ymax;
  }
}

// Union of several RLE-free masks: out |= each mask (row-major), used by the
// GT tooling to union the manually chosen moving instances
// (generate_mobile_gt_d2.py:173-187).
void mask_union(const uint8_t* masks, int64_t n, int64_t hw, uint8_t* out) {
  std::memset(out, 0, hw);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* m = masks + i * hw;
    for (int64_t j = 0; j < hw; ++j) out[j] |= (m[j] ? 1 : 0);
  }
}

// Greedy IoU NMS over score-sorted XYXY boxes (host-side path for the GT
// tooling; the on-device path is the JAX implementation in
// masks/maskrcnn.py). `order` must list box indices in descending score.
// Writes kept indices to `keep`, returns how many were kept.
int64_t nms(const float* boxes, const int64_t* order, int64_t n,
            float iou_threshold, int64_t max_keep, int64_t* keep) {
  int64_t kept = 0;
  for (int64_t oi = 0; oi < n && kept < max_keep; ++oi) {
    const int64_t i = order[oi];
    const float* bi = boxes + 4 * i;
    const float ai = (bi[2] - bi[0]) * (bi[3] - bi[1]);
    bool suppressed = false;
    for (int64_t kj = 0; kj < kept; ++kj) {
      const float* bj = boxes + 4 * keep[kj];
      const float xx1 = bi[0] > bj[0] ? bi[0] : bj[0];
      const float yy1 = bi[1] > bj[1] ? bi[1] : bj[1];
      const float xx2 = bi[2] < bj[2] ? bi[2] : bj[2];
      const float yy2 = bi[3] < bj[3] ? bi[3] : bj[3];
      const float w = xx2 - xx1 > 0 ? xx2 - xx1 : 0;
      const float h = yy2 - yy1 > 0 ? yy2 - yy1 : 0;
      const float inter = w * h;
      const float aj = (bj[2] - bj[0]) * (bj[3] - bj[1]);
      const float iou = inter / (ai + aj - inter + 1e-12f);
      if (iou > iou_threshold) {
        suppressed = true;
        break;
      }
    }
    if (!suppressed) keep[kept++] = i;
  }
  return kept;
}

}  // extern "C"
