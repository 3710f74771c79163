// Filtered path-candidate enumeration on the host (C ABI, loaded via ctypes).
//
// A copy of the DFS of differt_tpu/native/_native.cpp (count_filtered_paths,
// fill_filtered_paths), for the PyTorch port, which cannot import that
// package. The unfiltered candidate space is decoded on the device from a
// closed-form index mapping; once visibility masks prune the graph, the
// number of surviving paths has no closed form, and a DFS that never visits
// a pruned branch keeps memory at the size of the result.
//
// Nodes are primitives 0..num_nodes-1 of a complete graph with loop-free
// paths (no two consecutive equal nodes). A path of length `depth` is kept
// iff from_adj[path[0]] and to_adj[path[depth-1]] are nonzero and every node
// passes node_mask (any filter pointer may be null = no filtering).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

static void dfs_paths(
    int num_nodes,
    int depth,
    const uint8_t* from_adj,
    const uint8_t* to_adj,
    const uint8_t* node_mask,
    int level,
    int prev,
    int32_t* prefix,
    int32_t* out,
    int64_t max_paths,
    int64_t* count) {
  if (level == depth) {
    if (out != nullptr && *count < max_paths) {
      std::memcpy(out + (*count) * depth, prefix, depth * sizeof(int32_t));
    }
    ++(*count);
    return;
  }
  for (int node = 0; node < num_nodes; ++node) {
    if (node == prev) continue;
    if (node_mask != nullptr && !node_mask[node]) continue;
    if (level == 0 && from_adj != nullptr && !from_adj[node]) continue;
    if (level == depth - 1 && to_adj != nullptr && !to_adj[node]) continue;
    prefix[level] = node;
    dfs_paths(num_nodes, depth, from_adj, to_adj, node_mask, level + 1, node,
              prefix, out, max_paths, count);
  }
}

// Count loop-free filtered paths of length `depth`.
int64_t count_filtered_paths(
    int num_nodes,
    int depth,
    const uint8_t* from_adj,
    const uint8_t* to_adj,
    const uint8_t* node_mask) {
  if (depth <= 0 || num_nodes <= 0) return depth == 0 ? 1 : 0;
  std::vector<int32_t> prefix(depth);
  int64_t count = 0;
  dfs_paths(num_nodes, depth, from_adj, to_adj, node_mask, 0, -1,
            prefix.data(), nullptr, 0, &count);
  return count;
}

// Fill `out` (row-major [max_paths, depth]) with filtered paths; returns the
// number of paths written (at most max_paths: size `out` from
// count_filtered_paths).
int64_t fill_filtered_paths(
    int num_nodes,
    int depth,
    const uint8_t* from_adj,
    const uint8_t* to_adj,
    const uint8_t* node_mask,
    int32_t* out,
    int64_t max_paths) {
  if (depth <= 0 || num_nodes <= 0) return 0;
  std::vector<int32_t> prefix(depth);
  int64_t count = 0;
  dfs_paths(num_nodes, depth, from_adj, to_adj, node_mask, 0, -1,
            prefix.data(), out, max_paths, &count);
  return count < max_paths ? count : max_paths;
}

}  // extern "C"
