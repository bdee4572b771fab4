// Native mask toolkit: RLE encode/decode, IoU, area, polygon rasterize.
//
// C++ replacement for the pycocotools C maskApi the reference depends on
// (RLE-encoded instance masks in COCO json, mask IoU for evaluation,
// `mmdet/core/evaluation/mean_ap_segm.py:12-69` decodes RLE via
// pycocotools) — pycocotools is not available in this environment, so
// the framework ships its own implementation, written from the COCO RLE
// format specification (column-major Fortran order, alternating runs of
// 0s/1s, LEB128-style char encoding with delta compression).
//
// Exposed via a C ABI for ctypes (attentionshift_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- RLE core
// Runs are counts of alternating 0/1 pixels in column-major (Fortran)
// order, starting with zeros.

// Encode a binary mask (h*w, Fortran scan: column by column) into runs.
// Returns number of runs written (caller provides cnts buffer of size
// h*w+1).
int64_t rle_from_mask(const uint8_t* mask, int64_t h, int64_t w,
                      uint32_t* cnts) {
  int64_t n = h * w;
  int64_t k = 0;
  uint32_t run = 0;
  uint8_t cur = 0;  // runs start with zeros
  for (int64_t i = 0; i < n; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != cur) {
      cnts[k++] = run;
      run = 0;
      cur = v;
    }
    ++run;
  }
  cnts[k++] = run;
  return k;
}

// Decode runs into a binary mask (Fortran order buffer of size h*w).
void rle_to_mask(const uint32_t* cnts, int64_t m, int64_t h, int64_t w,
                 uint8_t* mask) {
  int64_t pos = 0;
  uint8_t v = 0;
  int64_t n = h * w;
  for (int64_t j = 0; j < m && pos < n; ++j) {
    int64_t run = cnts[j];
    if (run > n - pos) run = n - pos;
    memset(mask + pos, v, run);
    pos += run;
    v = 1 - v;
  }
}

int64_t rle_area(const uint32_t* cnts, int64_t m) {
  int64_t a = 0;
  for (int64_t j = 1; j < m; j += 2) a += cnts[j];
  return a;
}

// IoU between two RLEs (merge-scan over runs, no decode). When `crowd`
// is set the denominator is area(a) instead of the union — pycocotools'
// maskApi `rleIou` crowd semantics (detections overlapping a crowd GT
// score intersection-over-detection-area).
double rle_iou(const uint32_t* a, int64_t ma, const uint32_t* b, int64_t mb,
               uint8_t crowd) {
  int64_t ia = 0, ib = 0;
  int64_t ca = ia < ma ? a[0] : 0, cb = ib < mb ? b[0] : 0;
  uint8_t va = 0, vb = 0;
  int64_t inter = 0, uni = 0;
  while (ia < ma && ib < mb) {
    int64_t step = std::min(ca, cb);
    if (va & vb) inter += step;
    if (va | vb) uni += step;
    ca -= step;
    cb -= step;
    if (ca == 0) {
      ++ia;
      if (ia < ma) ca = a[ia];
      va = 1 - va;
    }
    if (cb == 0) {
      ++ib;
      if (ib < mb) cb = b[ib];
      vb = 1 - vb;
    }
  }
  int64_t denom = crowd ? rle_area(a, ma) : uni;
  return denom > 0 ? double(inter) / double(denom) : 0.0;
}

// Pairwise IoU of N x M RLE sets packed as offsets into a flat cnts pool.
// crowd_b may be null (no crowd regions) or hold one flag per column.
void rle_iou_matrix(const uint32_t* cnts_a, const int64_t* off_a,
                    const int64_t* len_a, int64_t n, const uint32_t* cnts_b,
                    const int64_t* off_b, const int64_t* len_b, int64_t m,
                    const uint8_t* crowd_b, double* out) {
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j)
      out[i * m + j] = rle_iou(cnts_a + off_a[i], len_a[i],
                               cnts_b + off_b[j], len_b[j],
                               crowd_b ? crowd_b[j] : 0);
}

// COCO char-string compression of runs (LEB128 variant w/ delta coding).
int64_t rle_to_string(const uint32_t* cnts, int64_t m, char* s) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t x = int64_t(cnts[i]);
    if (i > 2) x -= int64_t(cnts[i - 2]);  // delta vs the same-value run
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      c += 48;
      s[p++] = char(c);
    }
  }
  s[p] = 0;
  return p;
}

int64_t rle_from_string(const char* s, uint32_t* cnts) {
  int64_t m = 0, p = 0;
  while (s[p]) {
    int64_t x = 0, k = 0;
    bool more = true;
    while (more) {
      int64_t c = int64_t(s[p]) - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++p;
      ++k;
      if (!more && (c & 0x10)) x |= int64_t(-1) << (5 * k);
    }
    if (m > 2) x += int64_t(cnts[m - 2]);
    cnts[m++] = uint32_t(x);
  }
  return m;
}

// --------------------------------------------------------- polygon raster
// Rasterise one polygon (xy list) into a binary mask (row-major h*w),
// even-odd rule with pixel-centre sampling at upscale 1 (COCO frPoly uses
// 5x upsampling; for evaluation-grade masks centre sampling matches
// closely; scanline even-odd like the classic algorithm).
void polygon_to_mask(const double* xy, int64_t npts, int64_t h, int64_t w,
                     uint8_t* mask) {
  std::vector<double> xs(npts), ys(npts);
  for (int64_t i = 0; i < npts; ++i) {
    xs[i] = xy[2 * i];
    ys[i] = xy[2 * i + 1];
  }
  std::vector<double> inter;
  for (int64_t row = 0; row < h; ++row) {
    double y = row + 0.5;
    inter.clear();
    for (int64_t i = 0; i < npts; ++i) {
      int64_t j = (i + 1) % npts;
      double y0 = ys[i], y1 = ys[j];
      if ((y0 <= y && y1 > y) || (y1 <= y && y0 > y)) {
        double t = (y - y0) / (y1 - y0);
        inter.push_back(xs[i] + t * (xs[j] - xs[i]));
      }
    }
    std::sort(inter.begin(), inter.end());
    for (size_t k = 0; k + 1 < inter.size(); k += 2) {
      int64_t x0 = (int64_t)std::ceil(inter[k] - 0.5);
      int64_t x1 = (int64_t)std::floor(inter[k + 1] - 0.5);
      x0 = std::max<int64_t>(x0, 0);
      x1 = std::min<int64_t>(x1, w - 1);
      for (int64_t x = x0; x <= x1; ++x) mask[row * w + x] = 1;
    }
  }
}

}  // extern "C"
