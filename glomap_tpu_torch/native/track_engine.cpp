// Native host-side track engine: union-find concatenation + greedy
// coverage selection.
//
// The port's own copy of glomap_tpu/native/track_engine.cpp, the
// counterpart of the reference's C++ track engine
// (glomap/controllers/track_establishment.cc + colmap UnionFind): the
// O(total matches) passes stay native on the host, operating on dense
// global keypoint indices (kp_offset[image] + feature) instead of
// (image_id << 32 | feature_id) hash keys, so no hashing is needed at all.
// Built with g++ at first use and bound with ctypes
// (glomap_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <memory>
#include <numeric>
#include <unordered_map>
#include <vector>

namespace {

// Path-halving find on a flat parent array.
inline int64_t find_root(int64_t* parent, int64_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

// Per-(component, image) feature bounding box for the consistency-aware
// union: a component stays a valid track iff, per image, all its
// features fit in a box whose diagonal is <= thres_inconsistency.
struct Box {
  float minx, maxx, miny, maxy;
};

inline bool box_ok(const Box& b, double thres) {
  const double dx = b.maxx - b.minx;
  const double dy = b.maxy - b.miny;
  return dx * dx + dy * dy <= thres * thres;
}

using ImgMap = std::unordered_map<int64_t, Box>;

}  // namespace

extern "C" {

// Union-find over [0, num_kp) joined by match edges; writes a contiguous
// track id per keypoint into track_id_out (-1 for keypoints in no match).
// Returns the number of tracks (connected components with >= 2 members).
int64_t glomap_establish_tracks(int64_t num_kp, int64_t num_matches,
                                const int64_t* kp1, const int64_t* kp2,
                                int64_t* track_id_out) {
  std::vector<int64_t> parent(num_kp);
  std::iota(parent.begin(), parent.end(), 0);

  for (int64_t m = 0; m < num_matches; ++m) {
    int64_t a = find_root(parent.data(), kp1[m]);
    int64_t b = find_root(parent.data(), kp2[m]);
    if (a == b) continue;
    // smaller index becomes root (deterministic, mirrors the reference's
    // smallest-key-as-root union)
    if (a < b)
      parent[b] = a;
    else
      parent[a] = b;
  }

  // mark roots that appear in at least one match
  std::vector<uint8_t> touched(num_kp, 0);
  for (int64_t m = 0; m < num_matches; ++m) {
    touched[find_root(parent.data(), kp1[m])] = 1;
    touched[find_root(parent.data(), kp2[m])] = 1;
  }

  std::vector<int64_t> root_to_track(num_kp, -1);
  int64_t num_tracks = 0;
  for (int64_t i = 0; i < num_kp; ++i) {
    if (parent[i] == i && touched[i]) root_to_track[i] = num_tracks++;
  }
  for (int64_t i = 0; i < num_kp; ++i) {
    int64_t r = find_root(parent.data(), i);
    track_id_out[i] = root_to_track[r];
  }
  return num_tracks;
}

// Consistency-aware union-find (round-3 upgrade of
// glomap_establish_tracks): a union of two components is REJECTED when
// the merged component would hold two features of the same image whose
// bounding-box diagonal exceeds thres — i.e. when the joining match is a
// bridge between different physical points. The reference instead unions
// everything and DISCARDS inconsistent tracks wholesale
// (track_establishment.cc:107-146), which collapses in the
// percolation regime: a few thousand epipolar-consistent wrong matches
// fuse >90% of all keypoints into one giant component on dense scenes
// (measured: 3026 surviving wrong matches -> one 164k-keypoint
// component on a 100-frame / 8M-match synthetic). Preventive rejection
// keeps every true track alive while refusing exactly the bridges.
//
// kp_image: per-keypoint image index; kp_xy: per-keypoint pixel (2N).
// Smaller-map-into-larger merging bounds total map traffic at
// O(N log N). Deterministic for a fixed match order.
int64_t glomap_establish_tracks_consistent(
    int64_t num_kp, int64_t num_matches, const int64_t* kp1,
    const int64_t* kp2, const int64_t* kp_image, const double* kp_xy,
    double thres, int64_t* track_id_out) {
  std::vector<int64_t> parent(num_kp);
  std::iota(parent.begin(), parent.end(), 0);
  std::vector<std::unique_ptr<ImgMap>> maps(num_kp);

  auto singleton_box = [&](int64_t kp) {
    const float x = static_cast<float>(kp_xy[2 * kp]);
    const float y = static_cast<float>(kp_xy[2 * kp + 1]);
    return Box{x, x, y, y};
  };
  auto ensure_map = [&](int64_t root) -> ImgMap* {
    if (!maps[root]) {
      maps[root] = std::make_unique<ImgMap>();
      maps[root]->emplace(kp_image[root], singleton_box(root));
    }
    return maps[root].get();
  };

  for (int64_t m = 0; m < num_matches; ++m) {
    int64_t a = find_root(parent.data(), kp1[m]);
    int64_t b = find_root(parent.data(), kp2[m]);
    if (a == b) continue;
    ImgMap* ma = ensure_map(a);
    ImgMap* mb = ensure_map(b);
    if (mb->size() > ma->size()) {
      std::swap(a, b);
      std::swap(ma, mb);
    }
    // check pass: would any shared image's merged box break the bound?
    bool ok = true;
    for (const auto& [img, box] : *mb) {
      auto it = ma->find(img);
      if (it == ma->end()) continue;
      Box merged{std::min(it->second.minx, box.minx),
                 std::max(it->second.maxx, box.maxx),
                 std::min(it->second.miny, box.miny),
                 std::max(it->second.maxy, box.maxy)};
      if (!box_ok(merged, thres)) {
        ok = false;
        break;
      }
    }
    if (!ok) continue;  // bridge match: refuse the union
    // commit: fold the smaller map into the larger, relink the root
    for (const auto& [img, box] : *mb) {
      auto [it, inserted] = ma->emplace(img, box);
      if (!inserted) {
        it->second.minx = std::min(it->second.minx, box.minx);
        it->second.maxx = std::max(it->second.maxx, box.maxx);
        it->second.miny = std::min(it->second.miny, box.miny);
        it->second.maxy = std::max(it->second.maxy, box.maxy);
      }
    }
    maps[b].reset();
    parent[b] = a;
  }

  // mark roots that appear in at least one match AND have >= 2 members;
  // number tracks contiguously
  std::vector<int64_t> comp_size(num_kp, 0);
  for (int64_t i = 0; i < num_kp; ++i)
    comp_size[find_root(parent.data(), i)]++;
  std::vector<int64_t> root_to_track(num_kp, -1);
  int64_t num_tracks = 0;
  for (int64_t i = 0; i < num_kp; ++i) {
    if (parent[i] == i && comp_size[i] >= 2) root_to_track[i] = num_tracks++;
  }
  for (int64_t i = 0; i < num_kp; ++i) {
    int64_t r = find_root(parent.data(), i);
    track_id_out[i] = root_to_track[r];
  }
  return num_tracks;
}

// Greedy coverage selection (reference FindTracksForProblem semantics):
// tracks sorted longest-first; a track is selected if any of its images
// still needs tracks (counter <= min_tracks_per_view); selection stops
// when every image is covered or max_num_tracks is reached.
// min_tracks_per_view < 0 reproduces the reference's unsigned-compare
// behavior: every eligible track is selected (up to max_num_tracks).
//
// Inputs: per-obs track id and image id (obs of ineligible tracks may be
// included; they are skipped via track_eligible). track_num_images must
// hold the number of DISTINCT images per track.
// Output: selected[t] in {0,1}. Returns number selected.
int64_t glomap_select_tracks(int64_t num_tracks, int64_t num_obs,
                             const int64_t* obs_track, const int64_t* obs_image,
                             const uint8_t* track_eligible,
                             const int64_t* track_num_images,
                             int64_t num_images, int64_t min_tracks_per_view,
                             int64_t max_num_tracks, uint8_t* selected) {
  // bucket observations by track (CSR)
  std::vector<int64_t> offsets(num_tracks + 1, 0);
  for (int64_t o = 0; o < num_obs; ++o) offsets[obs_track[o] + 1]++;
  for (int64_t t = 0; t < num_tracks; ++t) offsets[t + 1] += offsets[t];
  std::vector<int64_t> obs_by_track(num_obs);
  {
    std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
    for (int64_t o = 0; o < num_obs; ++o)
      obs_by_track[cursor[obs_track[o]]++] = o;
  }

  // order tracks by (num_images desc, track id desc) — mirrors the
  // reference's reverse sort of (length, id) pairs
  std::vector<int64_t> order(num_tracks);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (track_num_images[a] != track_num_images[b])
      return track_num_images[a] > track_num_images[b];
    return a > b;
  });

  std::vector<int64_t> per_image(num_images, 0);
  int64_t images_left = num_images;
  int64_t num_selected = 0;

  for (int64_t k = 0; k < num_tracks; ++k) {
    int64_t t = order[k];
    if (!track_eligible[t]) continue;
    bool added = false;
    for (int64_t p = offsets[t]; p < offsets[t + 1]; ++p) {
      int64_t img = obs_image[obs_by_track[p]];
      if (min_tracks_per_view >= 0 && per_image[img] > min_tracks_per_view)
        continue;
      per_image[img]++;
      if (min_tracks_per_view >= 0 && per_image[img] > min_tracks_per_view)
        images_left--;
      if (!added) {
        selected[t] = 1;
        added = true;
        num_selected++;
      }
    }
    if (min_tracks_per_view >= 0 && images_left <= 0) break;
    if (num_selected > max_num_tracks) break;
  }
  return num_selected;
}

// Connected components over an edge list (used for view-graph components
// and strong-cluster analysis). Writes component label per node.
int64_t glomap_connected_components(int64_t num_nodes, int64_t num_edges,
                                    const int64_t* ei, const int64_t* ej,
                                    int64_t* label_out) {
  std::vector<int64_t> parent(num_nodes);
  std::iota(parent.begin(), parent.end(), 0);
  for (int64_t e = 0; e < num_edges; ++e) {
    int64_t a = find_root(parent.data(), ei[e]);
    int64_t b = find_root(parent.data(), ej[e]);
    if (a == b) continue;
    if (a < b)
      parent[b] = a;
    else
      parent[a] = b;
  }
  std::vector<int64_t> root_to_label(num_nodes, -1);
  int64_t n_comp = 0;
  for (int64_t i = 0; i < num_nodes; ++i) {
    int64_t r = find_root(parent.data(), i);
    if (root_to_label[r] < 0) root_to_label[r] = n_comp++;
    label_out[i] = root_to_label[r];
  }
  return n_comp;
}

}  // extern "C"
