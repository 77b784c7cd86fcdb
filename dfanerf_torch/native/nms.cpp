// Greedy IoU non-maximum suppression on the host, bound with ctypes.
//
// The port's copy of dfanerf_tpu/native/nms.cpp, which mirrors the
// reference's native CPU NMS (data_util/face-alignment/lib/nms/cpu_nms.pyx);
// ops/nms.py holds the masked NMS that runs on a tensor's device.
//
// Semantics of cpu_nms: boxes are sorted by score here (a stable sort, so
// tied scores keep their index order); areas are +1 pixel-inclusive; a box
// is suppressed at IoU >= thresh by a kept box of higher rank.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// dets: [n, 5] (x1, y1, x2, y2, score) row-major float32.
// keep_out: caller-allocated [n] int32; returns the number of kept indices.
int32_t nms_cpu(const float* dets, int32_t n, float thresh, int32_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<int32_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<float> areas(n);
  for (int32_t i = 0; i < n; ++i) {
    const float* d = dets + i * 5;
    areas[i] = (d[2] - d[0] + 1.f) * (d[3] - d[1] + 1.f);
  }
  std::vector<uint8_t> suppressed(n, 0);
  int32_t n_keep = 0;
  for (int32_t a = 0; a < n; ++a) {
    const int32_t i = order[a];
    if (suppressed[i]) continue;
    keep_out[n_keep++] = i;
    const float* di = dets + i * 5;
    for (int32_t b = a + 1; b < n; ++b) {
      const int32_t j = order[b];
      if (suppressed[j]) continue;
      const float* dj = dets + j * 5;
      const float xx1 = std::max(di[0], dj[0]);
      const float yy1 = std::max(di[1], dj[1]);
      const float xx2 = std::min(di[2], dj[2]);
      const float yy2 = std::min(di[3], dj[3]);
      const float w = std::max(0.f, xx2 - xx1 + 1.f);
      const float h = std::max(0.f, yy2 - yy1 + 1.f);
      const float inter = w * h;
      const float ovr = inter / (areas[i] + areas[j] - inter);
      if (ovr >= thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

}  // extern "C"
