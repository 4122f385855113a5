// Native BoW inverted index + candidate retrieval.
//
// C++ replacement for the host-side hot path of ORB-SLAM2's
// KeyFrameDatabase + DBoW2 L1 scoring: word -> keyframe inverted lists,
// common-word gating (>= 0.8 * best), sparse L1 similarity, ranked
// candidate return.  The device owns descriptor quantization (one Hamming
// matmul, loop/vocab.py); this index is the pointer-chasing part that
// Python dicts do slowly.  (A copy of spslam_tpu/native/src/bow_index.cc,
// with ties in the candidate ranking broken by keyframe id.)
//
// Exposed as a tiny C ABI consumed via ctypes
// (spslam_tpu_torch/native/bindings.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct BowVec {
  std::vector<int32_t> words;   // sorted ascending
  std::vector<float> weights;
};

struct Index {
  int32_t n_words = 0;
  std::vector<std::vector<int32_t>> inverted;  // word -> kf ids
  std::unordered_map<int32_t, BowVec> vecs;
};

float pair_score(const BowVec& a, const BowVec& b) {
  // L1 score as in DBoW2: s = 1 - 0.5 * |va - vb|_1 over the union, which
  // for L1-normalized vectors reduces to the sparse sum below.
  float s = 0.f;
  size_t i = 0, j = 0;
  while (i < a.words.size() && j < b.words.size()) {
    if (a.words[i] == b.words[j]) {
      const float va = a.weights[i], vb = b.weights[j];
      s += std::abs(va) + std::abs(vb) - std::abs(va - vb);
      ++i;
      ++j;
    } else if (a.words[i] < b.words[j]) {
      ++i;
    } else {
      ++j;
    }
  }
  return 0.5f * s;
}

}  // namespace

extern "C" {

void* bow_new(int32_t n_words) {
  auto* idx = new Index();
  idx->n_words = n_words;
  idx->inverted.resize(n_words);
  return idx;
}

void bow_free(void* h) { delete static_cast<Index*>(h); }

void bow_add(void* h, int32_t kf, const int32_t* words, const float* wts,
             int32_t n) {
  auto* idx = static_cast<Index*>(h);
  BowVec v;
  v.words.assign(words, words + n);
  v.weights.assign(wts, wts + n);
  // ensure sorted by word id
  std::vector<size_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](size_t a, size_t b) { return v.words[a] < v.words[b]; });
  BowVec sorted;
  sorted.words.reserve(n);
  sorted.weights.reserve(n);
  for (size_t o : order) {
    sorted.words.push_back(v.words[o]);
    sorted.weights.push_back(v.weights[o]);
  }
  for (int32_t w : sorted.words)
    if (w >= 0 && w < idx->n_words) idx->inverted[w].push_back(kf);
  idx->vecs[kf] = std::move(sorted);
}

void bow_erase(void* h, int32_t kf) {
  auto* idx = static_cast<Index*>(h);
  auto it = idx->vecs.find(kf);
  if (it == idx->vecs.end()) return;
  for (int32_t w : it->second.words) {
    auto& lst = idx->inverted[w];
    lst.erase(std::remove(lst.begin(), lst.end(), kf), lst.end());
  }
  idx->vecs.erase(it);
}

float bow_pair_score(void* h, int32_t a, int32_t b) {
  auto* idx = static_cast<Index*>(h);
  auto ia = idx->vecs.find(a);
  auto ib = idx->vecs.find(b);
  if (ia == idx->vecs.end() || ib == idx->vecs.end()) return 0.f;
  return pair_score(ia->second, ib->second);
}

// Returns number of candidates written to out_ids/out_scores (ranked by
// score descending).
int32_t bow_query(void* h, const int32_t* words, const float* wts, int32_t n,
                  const int32_t* excl, int32_t n_excl, float min_score,
                  int32_t* out_ids, float* out_scores, int32_t max_out) {
  auto* idx = static_cast<Index*>(h);
  std::unordered_set<int32_t> excluded(excl, excl + n_excl);

  BowVec q;
  q.words.assign(words, words + n);
  q.weights.assign(wts, wts + n);
  std::vector<size_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](size_t a, size_t b) { return q.words[a] < q.words[b]; });
  BowVec qs;
  for (size_t o : order) {
    qs.words.push_back(q.words[o]);
    qs.weights.push_back(q.weights[o]);
  }

  std::unordered_map<int32_t, int32_t> common;
  for (int32_t w : qs.words) {
    if (w < 0 || w >= idx->n_words) continue;
    for (int32_t kf : idx->inverted[w]) {
      if (!excluded.count(kf)) ++common[kf];
    }
  }
  if (common.empty()) return 0;
  int32_t max_common = 0;
  for (auto& kv : common) max_common = std::max(max_common, kv.second);
  const int32_t th = std::max(int32_t(0.8f * max_common), 1);

  std::vector<std::pair<float, int32_t>> scored;
  for (auto& kv : common) {
    if (kv.second < th) continue;
    const float s = pair_score(qs, idx->vecs[kv.first]);
    if (s >= min_score) scored.emplace_back(s, kv.first);
  }
  // equal scores in keyframe order (the reference's copy leaves them in
  // hash-map order, which varies with the standard library)
  std::sort(scored.begin(), scored.end(), [](const auto& a, const auto& b) {
    return a.first > b.first || (a.first == b.first && a.second < b.second);
  });
  const int32_t m = std::min<int32_t>(scored.size(), max_out);
  for (int32_t i = 0; i < m; ++i) {
    out_ids[i] = scored[i].second;
    out_scores[i] = scored[i].first;
  }
  return m;
}

}  // extern "C"
