// Native host-side detection ops.
//
// The reference ships compiled native code for its hot non-NN ops:
// Cython CPU NMS (R:lib/cpu_nms.pyx), CUDA NMS (R:lib/nms_kernel.cu) and
// Cython bbox_overlaps (R:lib/bbox.pyx) — SURVEY.md §3.3.  The TPU rebuild
// runs those on-device (XLA/Pallas), so the native layer's role shifts to
// the host side: exact reference-semantics oracles for kernel-parity
// testing, and a fast CPU fallback for environments without an
// accelerator.  Same +1 pixel convention everywhere.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this toolchain).
// This is the PyTorch port's own copy of the JAX package's
// native/detection_ops.cc.  trcnn_torch/ops/native.py builds it at first
// use with this directory's Makefile into build/native/<source hash>/
// (make -C trcnn_torch/native OUT=<path of libdetops.so>).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Greedy NMS over score-DESCENDING-sorted boxes.
// boxes: n x 4 (x1,y1,x2,y2), must already be sorted by score.
// keep_out: caller-allocated n ints; returns number kept.
int nms_sorted(const float* boxes, int n, float thresh, int max_out,
               int* keep_out) {
  std::vector<float> area(n);
  std::vector<uint8_t> suppressed(n, 0);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    area[i] = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
  }
  int kept = 0;
  for (int i = 0; i < n && kept < max_out; ++i) {
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      float xx1 = std::max(bi[0], bj[0]);
      float yy1 = std::max(bi[1], bj[1]);
      float xx2 = std::min(bi[2], bj[2]);
      float yy2 = std::min(bi[3], bj[3]);
      float w = std::max(0.f, xx2 - xx1 + 1.f);
      float h = std::max(0.f, yy2 - yy1 + 1.f);
      float inter = w * h;
      float iou = inter / (area[i] + area[j] - inter);
      if (iou > thresh) suppressed[j] = 1;
    }
  }
  return kept;
}

// Pairwise IoU matrix: out[i*k + j] = IoU(boxes[i], query[j]).
void bbox_overlaps(const float* boxes, int n, const float* query, int k,
                   float* out) {
  for (int j = 0; j < k; ++j) {
    const float* q = query + 4 * j;
    float qa = (q[2] - q[0] + 1.f) * (q[3] - q[1] + 1.f);
    for (int i = 0; i < n; ++i) {
      const float* b = boxes + 4 * i;
      float xx1 = std::max(b[0], q[0]);
      float yy1 = std::max(b[1], q[1]);
      float xx2 = std::min(b[2], q[2]);
      float yy2 = std::min(b[3], q[3]);
      float w = std::max(0.f, xx2 - xx1 + 1.f);
      float h = std::max(0.f, yy2 - yy1 + 1.f);
      float inter = w * h;
      float ba = (b[2] - b[0] + 1.f) * (b[3] - b[1] + 1.f);
      float uni = ba + qa - inter;
      out[(int64_t)i * k + j] = uni > 0.f ? inter / uni : 0.f;
    }
  }
}

// Caffe ROIPooling forward (reference semantics of Chainer's
// roi_pooling_2d GPU kernel).  feat: h x w x c (HWC), rois: r x 4 in image
// coords, out: r x out_size x out_size x c.
void roi_max_pool(const float* feat, int h, int w, int c, const float* rois,
                  int r, float spatial_scale, int out_size, float* out) {
  auto rnd = [](float x) -> int {
    return (int)(x >= 0 ? std::floor(x + 0.5f) : -std::floor(-x + 0.5f));
  };
  for (int i = 0; i < r; ++i) {
    int sw = rnd(rois[4 * i + 0] * spatial_scale);
    int sh = rnd(rois[4 * i + 1] * spatial_scale);
    int ew = rnd(rois[4 * i + 2] * spatial_scale);
    int eh = rnd(rois[4 * i + 3] * spatial_scale);
    int rw = std::max(ew - sw + 1, 1);
    int rh = std::max(eh - sh + 1, 1);
    // float32 bin arithmetic — matches the Caffe/Chainer GPU kernel, whose
    // f32 quotient rounding decides ceil() at exact-multiple boundaries
    float bw = (float)rw / (float)out_size;
    float bh = (float)rh / (float)out_size;
    for (int ph = 0; ph < out_size; ++ph) {
      int hs = std::min(std::max(sh + (int)std::floor((float)ph * bh), 0), h);
      int he = std::min(std::max(sh + (int)std::ceil((float)(ph + 1) * bh), 0), h);
      for (int pw = 0; pw < out_size; ++pw) {
        int ws = std::min(std::max(sw + (int)std::floor((float)pw * bw), 0), w);
        int we = std::min(std::max(sw + (int)std::ceil((float)(pw + 1) * bw), 0), w);
        float* o = out + (((int64_t)i * out_size + ph) * out_size + pw) * c;
        if (he <= hs || we <= ws) {
          std::fill(o, o + c, 0.f);
          continue;
        }
        for (int ch = 0; ch < c; ++ch) o[ch] = -INFINITY;
        for (int y = hs; y < he; ++y)
          for (int x = ws; x < we; ++x) {
            const float* f = feat + ((int64_t)y * w + x) * c;
            for (int ch = 0; ch < c; ++ch) o[ch] = std::max(o[ch], f[ch]);
          }
      }
    }
  }
}

}  // extern "C"
