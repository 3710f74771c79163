// Device functions shared by the any-hit, closest-hit and fused trace kernels:
// Möller–Trumbore, the conservative slab test, and the any-hit and
// closest-hit traversals of the mesh's BVH.
//
// Float semantics follow the JAX reference op for op (differt_tpu/ops/
// _pallas_rt.py::_mt_chunk and ::_slab_overlap): the library is built with
// --fmad=false, so `a*b + c` rounds the product and the sum separately, and
// `inv = 1/det; u = inv*(s.h)` is kept as written rather than `(s.h)/det`.
//
// The BVH, built once per mesh by differt_tpu_torch/ops/_bvh.py::build_bvh:
//   tris   [num_records][12] float: v0 xyz, e1 xyz, e2 xyz, active (1 or 0),
//          the triangle's Morton position (int bits), 0. First the tree's
//          triangles in Morton order, leaf by leaf (the last leaf padded with
//          inactive zeros), then the large-triangle list at large_begin.
//   nodes  [num_nodes][8]: min xyz, link (int bits), max xyz, flags (int
//          bits); 32 bytes, one sector. A complete binary tree in heap order
//          (root 0). link: an inner node's first child (the second follows
//          it), a leaf's first triangle record. flags: kLeaf, kAlive (holds an
//          active triangle), and a leaf's triangle count from bit 2. Boxes
//          carry a relative margin, so rounding never culls a hit.
//
// The traversals test the large list (the ground of a city: triangles
// whose box is a large share of the mesh's) first, then walk the tree
// with a stack, entering a node only if it holds an active triangle and
// the inclusive slab test (tnear <= tfar) passes over [0, t_hi]: t_hi is
// the threshold for any-hit, the best t so far for closest-hit. The top
// of the tree sits in shared memory (stage_top), the rest is read through
// the read-only cache; a mesh of 20,000 triangles is about 1 MB and stays
// in L2. SubtreeWalk is the any-hit walk started at any node and taken one
// node at a time, for the any-hit kernel's work items.
//
// Tensor cores do not apply: a ray-triangle test is a handful of cross and
// dot products per pair, with no matrix product to feed them.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace differt {

constexpr float kSlabTiny = 1e-30f;  // |d| below this counts as +-1e-30.
constexpr int kMaxDepth = 30;        // Stack of the walk; the wrapper checks the tree's depth.
constexpr int kLeaf = 1;             // Node flag: a leaf.
constexpr int kAlive = 2;            // Node flag: holds an active triangle.
constexpr int kTieChunk = 64;        // Chunk of Morton positions in the closest-hit tie key.

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 load3(const float* p) { return {p[0], p[1], p[2]}; }

__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ float dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ bool finite3(Vec3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}

// Non-finite coordinates become 0 (the reference sanitizes segments so).
__device__ __forceinline__ Vec3 sanitize(Vec3 a) {
  return {isfinite(a.x) ? a.x : 0.0f, isfinite(a.y) ? a.y : 0.0f, isfinite(a.z) ? a.z : 0.0f};
}

// jnp.sign: sign(0) = 0 and NaN stays NaN (so NaN never compares equal).
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// Möller–Trumbore: true when o + t d hits the triangle (v0, e1, e2) inside,
// with |det| > eps and t > eps. Writes t.
__device__ __forceinline__ bool mt_hit(Vec3 o, Vec3 d, Vec3 v0, Vec3 e1, Vec3 e2, float eps,
                                       float* t_out) {
  const Vec3 h = cross(d, e2);
  const float det = dot(h, e1);
  const float inv = det == 0.0f ? 0.0f : 1.0f / det;
  const Vec3 s = sub(o, v0);
  const float u = inv * dot(s, h);
  const Vec3 q = cross(s, e1);
  const float v = inv * dot(q, d);
  const float t = inv * dot(q, e2);
  *t_out = t;
  return fabsf(det) > eps && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t > eps;
}

// Möller–Trumbore against one triangle record; false for an inactive one.
// Writes t and the triangle's Morton position.
__device__ __forceinline__ bool record_hit(Vec3 o, Vec3 d, const float4* __restrict__ rec,
                                           float eps, float* t, int* pos) {
  const float4 c = __ldg(rec + 2);
  if (c.y == 0.0f) return false;
  const float4 a = __ldg(rec);
  const float4 b = __ldg(rec + 1);
  *pos = __float_as_int(c.z);
  return mt_hit(o, d, {a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, eps, t);
}

// Reciprocal of a direction component with the reference's tiny-value clamp.
__device__ __forceinline__ float slab_inv(float dc) {
  const float denom = fabsf(dc) < kSlabTiny ? (dc < 0.0f ? -kSlabTiny : kSlabTiny) : dc;
  return 1.0f / denom;
}

__device__ __forceinline__ Vec3 slab_inv3(Vec3 d) {
  return {slab_inv(d.x), slab_inv(d.y), slab_inv(d.z)};
}

// Conservative segment-vs-box test over t in [0, t_hi]: never a false miss.
// Writes the entry t (tnear), which orders and culls the walk.
__device__ __forceinline__ bool slab_overlap(Vec3 o, Vec3 inv_d, float4 lo, float4 hi, float t_hi,
                                             float* t_enter) {
  float tnear = 0.0f;
  float tfar = t_hi;
  float t1 = (lo.x - o.x) * inv_d.x, t2 = (hi.x - o.x) * inv_d.x;
  tnear = fmaxf(tnear, fminf(t1, t2));
  tfar = fminf(tfar, fmaxf(t1, t2));
  t1 = (lo.y - o.y) * inv_d.y;
  t2 = (hi.y - o.y) * inv_d.y;
  tnear = fmaxf(tnear, fminf(t1, t2));
  tfar = fminf(tfar, fmaxf(t1, t2));
  t1 = (lo.z - o.z) * inv_d.z;
  t2 = (hi.z - o.z) * inv_d.z;
  tnear = fmaxf(tnear, fminf(t1, t2));
  tfar = fminf(tfar, fmaxf(t1, t2));
  *t_enter = tnear;
  return tnear <= tfar;
}

struct Bvh {
  const float4* __restrict__ nodes;  // [num_nodes][2]
  const float4* __restrict__ tris;   // [num_records][3]
  int num_nodes;
  int large_begin;  // First record of the large-triangle list.
  int num_large;
};

// Copies the first `count` nodes of the tree into shared memory with
// cp.async (16 bytes a copy) and waits for them. Every thread of the block
// calls it.
__device__ inline void stage_top(float4* top, const float4* __restrict__ nodes, int count) {
  for (int i = threadIdx.x; i < 2 * count; i += blockDim.x) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(top + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(nodes + i));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// A node: from shared memory if it is among the first `num_top`.
__device__ __forceinline__ void fetch_node(const Bvh& bvh, const float4* top, int num_top, int i,
                                           float4* lo, float4* hi) {
  if (i < num_top) {
    *lo = top[2 * i];
    *hi = top[2 * i + 1];
  } else {
    *lo = __ldg(bvh.nodes + 2 * i);
    *hi = __ldg(bvh.nodes + 2 * i + 1);
  }
}

// Walks the tree for o + t d, t in [0, t_hi], calling visit_leaf(first
// record, count) on each leaf reached; a true return ends the walk. With
// kNearFirst the child entered first is the one the ray enters first. The
// stack keeps (link, flags, entry t) of the nodes still to visit, so a node
// is read once; an entry whose t has passed t_hi (closest-hit's best t,
// which only shrinks) is dropped when popped, as its slab test would now
// fail.
template <bool kNearFirst, typename LeafFn>
__device__ __forceinline__ void walk_tree(Vec3 o, Vec3 inv_d, const Bvh& bvh, const float4* top,
                                          int num_top, const float& t_hi, LeafFn&& visit_leaf) {
  int stack_link[kMaxDepth];
  int stack_flags[kMaxDepth];
  float stack_t[kMaxDepth];
  int sp = 0;
  float4 lo, hi;
  fetch_node(bvh, top, num_top, 0, &lo, &hi);
  int flags = __float_as_int(hi.w);
  float t_enter;
  if (!(flags & kAlive) || !slab_overlap(o, inv_d, lo, hi, t_hi, &t_enter)) return;
  int link = __float_as_int(lo.w);
  while (true) {
    if (flags & kLeaf) {
      if (visit_leaf(link, flags >> 2)) return;
    } else {
      float4 alo, ahi, blo, bhi;
      fetch_node(bvh, top, num_top, link, &alo, &ahi);
      fetch_node(bvh, top, num_top, link + 1, &blo, &bhi);
      const int fa = __float_as_int(ahi.w);
      const int fb = __float_as_int(bhi.w);
      float ta, tb;
      const bool ha = (fa & kAlive) && slab_overlap(o, inv_d, alo, ahi, t_hi, &ta);
      const bool hb = (fb & kAlive) && slab_overlap(o, inv_d, blo, bhi, t_hi, &tb);
      if (ha && hb) {
        const bool b_first = kNearFirst && tb < ta;
        stack_link[sp] = __float_as_int(b_first ? alo.w : blo.w);
        stack_flags[sp] = b_first ? fa : fb;
        stack_t[sp] = b_first ? ta : tb;
        ++sp;
        link = __float_as_int(b_first ? blo.w : alo.w);
        flags = b_first ? fb : fa;
        continue;
      }
      if (ha || hb) {
        link = __float_as_int(ha ? alo.w : blo.w);
        flags = ha ? fa : fb;
        continue;
      }
    }
    bool found = false;
    while (sp > 0 && !found) {
      --sp;
      if (stack_t[sp] <= t_hi) {
        link = stack_link[sp];
        flags = stack_flags[sp];
        found = true;
      }
    }
    if (!found) return;
  }
}

// Does o + t d hit one of the large-list triangles with eps < t < thresh?
// (any_hit keeps its own copy of this loop: calling this one from it moves
// the fused trace kernel's register allocation into a spill.)
__device__ __forceinline__ bool large_hit(Vec3 o, Vec3 d, float thresh, const Bvh& bvh,
                                          float eps) {
  float t;
  int pos;
  for (int i = 0; i < bvh.num_large; ++i) {
    if (record_hit(o, d, bvh.tris + 3 * (bvh.large_begin + i), eps, &t, &pos) && t < thresh) {
      return true;
    }
  }
  return false;
}

// Does o + t d hit any active triangle with eps < t < thresh? Returns at
// the first hit.
__device__ inline bool any_hit(Vec3 o, Vec3 d, float thresh, const Bvh& bvh, const float4* top,
                               int num_top, float eps) {
  float t;
  int pos;
  for (int i = 0; i < bvh.num_large; ++i) {
    if (record_hit(o, d, bvh.tris + 3 * (bvh.large_begin + i), eps, &t, &pos) && t < thresh) {
      return true;
    }
  }
  bool hit = false;
  walk_tree<false>(o, slab_inv3(d), bvh, top, num_top, thresh, [&](int first, int count) {
    for (int j = 0; j < count; ++j) {
      if (record_hit(o, d, bvh.tris + 3 * (first + j), eps, &t, &pos) && t < thresh) {
        hit = true;
        return true;
      }
    }
    return false;
  });
  return hit;
}

enum WalkStep { kWalkOn, kWalkHit, kWalkEnd };

// The any-hit walk of walk_tree<false>, started at any node of the tree and
// taken one node a call, so that a thread can end one walk and start
// another between two steps (anyhit.cu). Entered at the root it visits the
// nodes walk_tree<false> visits, in the same order. A walk started below
// the root skips its ancestors' slab tests, which is sound: a child's box
// lies inside its parent's, so it reaches every leaf under that node that
// the whole walk would reach. The bound t_hi is the fixed threshold, so no
// stacked node can fall past it (its tnear <= tfar <= thresh) and the stack
// keeps no entry t.
struct SubtreeWalk {
  int link;
  int flags;
  int sp;
  int stack_link[kMaxDepth];
  int stack_flags[kMaxDepth];

  // Enters the node (lo, hi): false if it holds no active triangle or the
  // segment misses its box, and the walk is then over.
  __device__ __forceinline__ bool start(Vec3 o, Vec3 inv_d, float thresh, float4 lo, float4 hi) {
    flags = __float_as_int(hi.w);
    link = __float_as_int(lo.w);
    sp = 0;
    float t_enter;
    return (flags & kAlive) && slab_overlap(o, inv_d, lo, hi, thresh, &t_enter);
  }

  // Visits the current node: tests a leaf's triangles, or enters an inner
  // node's children that pass (the second is stacked when both do).
  // fetch(i, &lo, &hi) reads node i.
  template <typename FetchFn>
  __device__ __forceinline__ WalkStep step(Vec3 o, Vec3 d, Vec3 inv_d, float thresh,
                                           const Bvh& bvh, float eps, FetchFn&& fetch) {
    if (flags & kLeaf) {
      float t;
      int pos;
      for (int j = 0; j < (flags >> 2); ++j) {
        if (record_hit(o, d, bvh.tris + 3 * (link + j), eps, &t, &pos) && t < thresh) {
          return kWalkHit;
        }
      }
    } else {
      float4 alo, ahi, blo, bhi;
      fetch(link, &alo, &ahi);
      fetch(link + 1, &blo, &bhi);
      const int fa = __float_as_int(ahi.w);
      const int fb = __float_as_int(bhi.w);
      float ta, tb;
      const bool ha = (fa & kAlive) && slab_overlap(o, inv_d, alo, ahi, thresh, &ta);
      const bool hb = (fb & kAlive) && slab_overlap(o, inv_d, blo, bhi, thresh, &tb);
      if (ha && hb) {
        stack_link[sp] = __float_as_int(blo.w);
        stack_flags[sp] = fb;
        ++sp;
      }
      if (ha || hb) {
        link = __float_as_int(ha ? alo.w : blo.w);
        flags = ha ? fa : fb;
        return kWalkOn;
      }
    }
    if (sp == 0) return kWalkEnd;
    --sp;
    link = stack_link[sp];
    flags = stack_flags[sp];
    return kWalkOn;
  }
};

// The closest-hit tie key. A smaller t wins; on an equal t, the larger
// Morton chunk (pos / 64), then the smaller position: the rule of the
// reference kernel (_pallas_rt.py::_closest_kernel), which walks 64-triangle
// chunks in Morton order, keeps the first minimum within a chunk and lets an
// equal t in a later chunk win. A key makes the result independent of the
// walk's order. A hit at t = inf never counts, as in the reference.
__device__ __forceinline__ bool closer(float t, int pos, float best_t, int best) {
  if (t < best_t) return true;
  if (!(t == best_t) || best < 0) return false;
  const int chunk = pos / kTieChunk;
  const int best_chunk = best / kTieChunk;
  return chunk > best_chunk || (chunk == best_chunk && pos < best);
}

// Nearest active triangle hit by o + t d with t > eps: returns its Morton
// position and writes its t, or returns -1 and writes +inf. Nodes whose
// box the ray enters after the best t so far are skipped; the large list,
// tested first, gives most rays an early best t.
__device__ inline int closest_hit(Vec3 o, Vec3 d, const Bvh& bvh, const float4* top, int num_top,
                                  float eps, float* t_out) {
  float best_t = CUDART_INF_F;
  int best = -1;
  auto test = [&](int rec) {
    float t;
    int pos;
    if (record_hit(o, d, bvh.tris + 3 * rec, eps, &t, &pos) && closer(t, pos, best_t, best)) {
      best_t = t;
      best = pos;
    }
  };
  for (int i = 0; i < bvh.num_large; ++i) test(bvh.large_begin + i);
  walk_tree<true>(o, slab_inv3(d), bvh, top, num_top, best_t, [&](int first, int count) {
    for (int j = 0; j < count; ++j) test(first + j);
    return false;
  });
  *t_out = best_t;
  return best;
}

}  // namespace differt
