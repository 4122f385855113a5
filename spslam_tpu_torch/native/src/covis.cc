// Covisibility-graph accumulation in C++.
//
// ORB-SLAM2 maintains covisibility edges incrementally under mutexes
// (KeyFrame::UpdateConnections).  The map store computes them on demand;
// for large maps the gather-bincount over observation tables is the hot
// host loop, so it lives here.  Consumed via ctypes.  (A copy of
// spslam_tpu/native/src/covis.cc.)

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// For keyframe `kf`: count shared map points with every other keyframe.
//   kf_obs:      [n_kp] point ids of kf (-1 = none)
//   pt_obs_kf:   [n_points_total x obs_cap] flattened observation table
//   out_counts:  [n_keyframes] zero-initialized output
void covis_count(const int32_t* kf_obs, int32_t n_kp,
                 const int32_t* pt_obs_kf, int32_t obs_cap,
                 int32_t kf, int32_t* out_counts, int32_t n_keyframes) {
  for (int32_t i = 0; i < n_kp; ++i) {
    const int32_t p = kf_obs[i];
    if (p < 0) continue;
    const int32_t* row = pt_obs_kf + int64_t(p) * obs_cap;
    for (int32_t j = 0; j < obs_cap; ++j) {
      const int32_t k2 = row[j];
      if (k2 >= 0 && k2 != kf && k2 < n_keyframes) ++out_counts[k2];
    }
  }
}

}  // extern "C"
