// Filtered path-candidate enumeration and Wavefront OBJ parsing on the host
// (C ABI, loaded via ctypes).
//
// A copy of differt_tpu/native/_native.cpp (count_filtered_paths,
// fill_filtered_paths, obj_counts, obj_parse), for the PyTorch port, which
// cannot import that package.
//
// The unfiltered candidate space is decoded on the device from a closed-form
// index mapping; once visibility masks prune the graph, the number of
// surviving paths has no closed form, and a DFS that never visits a pruned
// branch keeps memory at the size of the result. The OBJ parser reads a
// multi-MB city mesh about 50x faster than a Python line loop.
//
// Nodes are primitives 0..num_nodes-1 of a complete graph with loop-free
// paths (no two consecutive equal nodes). A path of length `depth` is kept
// iff from_adj[path[0]] and to_adj[path[depth-1]] are nonzero and every node
// passes node_mask (any filter pointer may be null = no filtering).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
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

// ---------------------------------------------------------------------------
// Wavefront OBJ geometry parsing.
//
// Pass 1 (obj_counts): number of vertices and fan-triangulated faces.
// Pass 2 (obj_parse): fill vertex coordinates [num_vertices, 3], triangle
// indices [num_triangles, 3], and per-triangle section ids (incremented on
// every `usemtl` line; -1 before the first). Handles v/vt/vn index forms and
// negative (relative) indices.
// ---------------------------------------------------------------------------

namespace {

struct ObjCounts {
  int64_t vertices = 0;
  int64_t triangles = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Count whitespace-separated tokens after the tag on a face line.
inline int count_face_tokens(const char* p, const char* end) {
  int tokens = 0;
  while (p < end && *p != '\n') {
    p = skip_ws(p, end);
    if (p >= end || *p == '\n') break;
    ++tokens;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
  }
  return tokens;
}

}  // namespace

int obj_counts(const char* path, int64_t* num_vertices, int64_t* num_triangles) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size);
  if (size > 0 && std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  ObjCounts counts;
  const char* p = buf.data();
  const char* end = p + size;
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      ++counts.vertices;
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      int corners = count_face_tokens(p + 1, end);
      if (corners >= 3) counts.triangles += corners - 2;
    }
    p = next_line(p, end);
  }
  *num_vertices = counts.vertices;
  *num_triangles = counts.triangles;
  return 0;
}

int obj_parse(
    const char* path,
    float* vertices,         // [num_vertices * 3]
    int32_t* triangles,      // [num_triangles * 3]
    int32_t* face_sections,  // [num_triangles]
    int64_t max_vertices,
    int64_t max_triangles) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size);
  if (size > 0 && std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);

  int64_t vi = 0;
  int64_t ti = 0;
  int32_t section = -1;
  std::vector<int32_t> corner_idx;

  const char* p = buf.data();
  const char* end = p + size;
  while (p < end) {
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      if (vi >= max_vertices) return -2;
      const char* q = p + 1;
      char* next = nullptr;
      for (int c = 0; c < 3; ++c) {
        vertices[vi * 3 + c] = std::strtof(q, &next);
        q = next;
      }
      ++vi;
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      corner_idx.clear();
      const char* q = p + 1;
      while (q < end && *q != '\n') {
        q = skip_ws(q, end);
        if (q >= end || *q == '\n') break;
        char* next = nullptr;
        long idx = std::strtol(q, &next, 10);
        if (next == q) break;
        q = next;
        // Skip the /vt/vn part of the token.
        while (q < end && *q != ' ' && *q != '\t' && *q != '\n' && *q != '\r') ++q;
        corner_idx.push_back(
            idx > 0 ? static_cast<int32_t>(idx - 1)
                    : static_cast<int32_t>(vi + idx));
      }
      for (size_t c = 1; c + 1 < corner_idx.size(); ++c) {
        if (ti >= max_triangles) return -2;
        triangles[ti * 3 + 0] = corner_idx[0];
        triangles[ti * 3 + 1] = corner_idx[c];
        triangles[ti * 3 + 2] = corner_idx[c + 1];
        face_sections[ti] = section;
        ++ti;
      }
    } else if (p + 6 < end && std::strncmp(p, "usemtl", 6) == 0) {
      ++section;
    }
    p = next_line(p, end);
  }
  return 0;
}

}  // extern "C"
