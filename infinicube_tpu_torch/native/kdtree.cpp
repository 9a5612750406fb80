// Host-side KD-tree KNN for the data converters; counterpart of
// infinicube_tpu/native/kdtree.cpp (the same tree: median splits cycling
// x, y, z, leaves of at most 16 points, a max-heap of the k best).
//
// ops/knn_host.py builds it at first use with
//   g++ -O2 -shared -fPIC -o _build/libkdtree.so native/kdtree.cpp
// and binds it with ctypes. The device KNN is ops/knn.py; this tree serves
// the host-side converters (data_process), where points live in numpy.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Node {
  int32_t axis = -1;      // -1 = leaf
  float split = 0.f;
  int32_t left = -1, right = -1;
  int32_t begin = 0, end = 0;  // leaf point range
};

struct Tree {
  std::vector<float> pts;      // [n, 3] reordered
  std::vector<int32_t> index;  // reordered -> original
  std::vector<Node> nodes;
  int32_t root = -1;

  int32_t build(float* p, int32_t* idx, int32_t begin, int32_t end,
                int depth) {
    Node n;
    int32_t id = static_cast<int32_t>(nodes.size());
    nodes.push_back(n);
    if (end - begin <= 16) {
      nodes[id].begin = begin;
      nodes[id].end = end;
      return id;
    }
    int axis = depth % 3;
    int32_t mid = (begin + end) / 2;
    // median split via nth_element over joint (point, index) records
    std::vector<int32_t> order(end - begin);
    for (int32_t i = 0; i < end - begin; ++i) order[i] = begin + i;
    std::nth_element(order.begin(), order.begin() + (mid - begin),
                     order.end(), [&](int32_t a, int32_t b) {
                       return p[3 * a + axis] < p[3 * b + axis];
                     });
    // apply permutation to the [begin, end) slice
    std::vector<float> tmp_p(3 * (end - begin));
    std::vector<int32_t> tmp_i(end - begin);
    for (int32_t i = 0; i < end - begin; ++i) {
      for (int d = 0; d < 3; ++d) tmp_p[3 * i + d] = p[3 * order[i] + d];
      tmp_i[i] = idx[order[i]];
    }
    std::copy(tmp_p.begin(), tmp_p.end(), p + 3 * begin);
    std::copy(tmp_i.begin(), tmp_i.end(), idx + begin);

    nodes[id].axis = axis;
    nodes[id].split = p[3 * mid + axis];
    nodes[id].left = build(p, idx, begin, mid, depth + 1);
    nodes[id].right = build(p, idx, mid, end, depth + 1);
    return id;
  }

  void query(const float* q, int k, float* out_d, int32_t* out_i) const {
    // max-heap of (dist, idx)
    std::priority_queue<std::pair<float, int32_t>> heap;
    struct Item { int32_t node; float dist; };
    std::vector<Item> stack;
    stack.push_back({root, 0.f});
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      if ((int)heap.size() == k && it.dist > heap.top().first) continue;
      const Node& n = nodes[it.node];
      if (n.axis < 0) {
        for (int32_t i = n.begin; i < n.end; ++i) {
          float dx = pts[3 * i] - q[0];
          float dy = pts[3 * i + 1] - q[1];
          float dz = pts[3 * i + 2] - q[2];
          float d = dx * dx + dy * dy + dz * dz;
          if ((int)heap.size() < k) heap.push({d, index[i]});
          else if (d < heap.top().first) { heap.pop(); heap.push({d, index[i]}); }
        }
        continue;
      }
      float diff = q[n.axis] - n.split;
      int32_t near = diff <= 0 ? n.left : n.right;
      int32_t far = diff <= 0 ? n.right : n.left;
      stack.push_back({far, diff * diff});
      stack.push_back({near, 0.f});
    }
    int m = static_cast<int>(heap.size());
    for (int i = m - 1; i >= 0; --i) {
      out_d[i] = heap.top().first;
      out_i[i] = heap.top().second;
      heap.pop();
    }
    for (int i = m; i < k; ++i) { out_d[i] = 1e30f; out_i[i] = -1; }
  }
};

}  // namespace

extern "C" {

void* kdtree_build(const float* points, int64_t n) {
  auto* t = new Tree();
  t->pts.assign(points, points + 3 * n);
  t->index.resize(n);
  for (int64_t i = 0; i < n; ++i) t->index[i] = static_cast<int32_t>(i);
  t->root = t->build(t->pts.data(), t->index.data(), 0,
                     static_cast<int32_t>(n), 0);
  return t;
}

void kdtree_query(void* h, const float* queries, int64_t m, int32_t k,
                  float* out_d, int32_t* out_i) {
  auto* t = static_cast<Tree*>(h);
  for (int64_t i = 0; i < m; ++i)
    t->query(queries + 3 * i, k, out_d + i * k, out_i + i * k);
}

void kdtree_free(void* h) { delete static_cast<Tree*>(h); }

}  // extern "C"
