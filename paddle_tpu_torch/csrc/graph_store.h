// paddle_tpu_torch's own copy of paddle_tpu/csrc/graph_store.h, which
// ps_service.cc includes. The port binds none of the graph commands.
//
// Server-side property graph for graph learning.
//
// Native counterpart of the reference's common_graph_table.{h,cc}
// (sharded adjacency + node features + weighted neighbor sampling,
// served over the PS transport the way the graph brpc service serves
// GraphTable). Sampling returns FIXED-SIZE padded buffers — the
// TPU-first contract: trainers feed the results straight into jitted
// programs, so the ragged byte buffers of the reference become
// [n, k] id + mask arrays.
#pragma once

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <unordered_map>
#include <vector>

namespace pstpu {

struct GraphStore {
  struct Node {
    std::vector<uint64_t> nbrs;
    std::vector<float> weights;
    std::vector<float> feat;
  };

  struct Shard {
    std::unordered_map<uint64_t, Node> nodes;
    std::mutex mu;
  };

  explicit GraphStore(int shard_num = 16, uint64_t seed = 0)
      : shards_(shard_num), seed_(seed) {}

  Shard& shard_of(uint64_t id) { return shards_[id % shards_.size()]; }

  void add_nodes(const uint64_t* ids, int64_t n, const float* feats,
                 int feat_dim) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(s.mu);
      Node& node = s.nodes[ids[i]];
      if (feat_dim > 0 && feats != nullptr)
        node.feat.assign(feats + i * feat_dim, feats + (i + 1) * feat_dim);
    }
  }

  // edges live on the SRC node's shard (common_graph_table partitioning);
  // dst registration is the caller's job (the distributed client routes
  // dst ids to their own servers)
  void add_edges(const uint64_t* src, const uint64_t* dst, const float* w,
                 int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard_of(src[i]);
      std::lock_guard<std::mutex> g(s.mu);
      Node& node = s.nodes[src[i]];
      node.nbrs.push_back(dst[i]);
      node.weights.push_back(w ? w[i] : 1.0f);
    }
  }

  void degrees(const uint64_t* ids, int64_t n, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(s.mu);
      auto it = s.nodes.find(ids[i]);
      out[i] = it == s.nodes.end()
                   ? 0
                   : static_cast<int32_t>(it->second.nbrs.size());
    }
  }

  // random_sample_neighbors: per node up to k neighbors, weighted
  // without replacement via Efraimidis–Sampling keys u^(1/w) (exact for
  // the reference's WeightedSampler semantics), uniform partial shuffle
  // otherwise. out_nbrs/[n*k] u64, out_mask [n*k] u8.
  void sample_neighbors(const uint64_t* ids, int64_t n, int k, bool weighted,
                        uint64_t* out_nbrs, uint8_t* out_mask) {
    std::mt19937_64 rng(seed_ ^ (sample_counter_.fetch_add(1) * 0x9E3779B97F4A7C15ULL));
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    std::memset(out_nbrs, 0, sizeof(uint64_t) * n * k);
    std::memset(out_mask, 0, sizeof(uint8_t) * n * k);
    std::vector<std::pair<double, uint64_t>> keyed;
    std::vector<uint64_t> pool;
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard_of(ids[i]);
      std::unique_lock<std::mutex> g(s.mu);
      auto it = s.nodes.find(ids[i]);
      if (it == s.nodes.end() || it->second.nbrs.empty()) continue;
      const Node& node = it->second;
      bool use_weights = weighted;
      if (use_weights) {
        keyed.clear();
        for (size_t j = 0; j < node.nbrs.size(); ++j) {
          float w = node.weights[j];
          if (w <= 0.0f) continue;  // unsamplable without replacement
          keyed.emplace_back(std::pow(uni(rng), 1.0 / w), node.nbrs[j]);
        }
        // all-zero weights: fall back to uniform over ALL edges — the
        // local GraphTable oracle's `w.sum() > 0` fallback
        if (keyed.empty()) use_weights = false;
      }
      if (use_weights) {
        g.unlock();
        int kk = std::min<int>(k, keyed.size());
        std::partial_sort(keyed.begin(), keyed.begin() + kk, keyed.end(),
                          [](const auto& a, const auto& b) {
                            return a.first > b.first;
                          });
        for (int j = 0; j < kk; ++j) {
          out_nbrs[i * k + j] = keyed[j].second;
          out_mask[i * k + j] = 1;
        }
      } else {
        pool.assign(node.nbrs.begin(), node.nbrs.end());
        g.unlock();
        int kk = std::min<int>(k, pool.size());
        for (int j = 0; j < kk; ++j) {  // partial Fisher–Yates
          std::uniform_int_distribution<size_t> pick(j, pool.size() - 1);
          std::swap(pool[j], pool[pick(rng)]);
          out_nbrs[i * k + j] = pool[j];
          out_mask[i * k + j] = 1;
        }
      }
    }
  }

  void node_feat(const uint64_t* ids, int64_t n, int feat_dim, float* out) {
    std::memset(out, 0, sizeof(float) * n * feat_dim);
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(s.mu);
      auto it = s.nodes.find(ids[i]);
      if (it == s.nodes.end()) continue;
      const auto& f = it->second.feat;
      std::memcpy(out + i * feat_dim, f.data(),
                  sizeof(float) * std::min<size_t>(feat_dim, f.size()));
    }
  }

  // returns false if any id is unknown (set_node_feat NotFound parity)
  bool set_node_feat(const uint64_t* ids, int64_t n, int feat_dim,
                     const float* feats) {
    for (int64_t i = 0; i < n; ++i) {
      Shard& s = shard_of(ids[i]);
      std::lock_guard<std::mutex> g(s.mu);
      auto it = s.nodes.find(ids[i]);
      if (it == s.nodes.end()) return false;
      it->second.feat.assign(feats + i * feat_dim,
                             feats + (i + 1) * feat_dim);
    }
    return true;
  }

  // uniform over this server's node set — WITHOUT replacement when the
  // population covers the request, with replacement only beyond it
  // (GraphTable.sample_nodes' replace=len(all)<size semantics)
  int64_t sample_nodes(int64_t count, uint64_t* out) {
    std::vector<uint64_t> all;
    for (Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      for (const auto& kv : s.nodes) all.push_back(kv.first);
    }
    if (all.empty()) return 0;
    std::mt19937_64 rng(seed_ ^ (sample_counter_.fetch_add(1) * 0xD1B54A32D192ED03ULL));
    if (static_cast<size_t>(count) <= all.size()) {
      for (int64_t j = 0; j < count; ++j) {  // partial Fisher–Yates
        std::uniform_int_distribution<size_t> pick(j, all.size() - 1);
        std::swap(all[j], all[pick(rng)]);
        out[j] = all[j];
      }
    } else {
      std::uniform_int_distribution<size_t> pick(0, all.size() - 1);
      for (int64_t j = 0; j < count; ++j) out[j] = all[pick(rng)];
    }
    return count;
  }

  void stats(int64_t* nodes, int64_t* edges) {
    *nodes = 0;
    *edges = 0;
    for (Shard& s : shards_) {
      std::lock_guard<std::mutex> g(s.mu);
      *nodes += static_cast<int64_t>(s.nodes.size());
      for (const auto& kv : s.nodes)
        *edges += static_cast<int64_t>(kv.second.nbrs.size());
    }
  }

 private:
  std::vector<Shard> shards_;
  uint64_t seed_;
  std::atomic<uint64_t> sample_counter_{0};
};

}  // namespace pstpu
