// Device functions shared by the any-hit, closest-hit and fused trace kernels:
// Möller–Trumbore, the conservative slab test, and the any-hit and closest-hit
// sweeps over a Morton-sorted mesh with two levels of AABB culling.
//
// Float semantics follow the JAX reference op for op (differt_tpu/ops/
// _pallas_rt.py::_mt_chunk and ::_slab_overlap): the library is built with
// --fmad=false, so `a*b + c` rounds the product and the sum separately, and
// `inv = 1/det; u = inv*(s.h)` is kept as written rather than `(s.h)/det`.
//
// Mesh layout, built by differt_tpu_torch/ops/_rt.py::prepare_mesh:
//   mesh       [num_chunks * kChunk][12] float: v0 xyz, e1 xyz, e2 xyz,
//              active (1 or 0), 2 pad. Triangles sorted along a Morton curve,
//              padded with inactive zeros to a whole chunk.
//   chunk_box  [num_chunks][8] float: min xyz, any-active flag, max xyz, pad.
//              Boxes carry a relative margin, so rounding never culls a hit.
//   tile_box   [ceil(num_chunks / kChunksPerTile)][8], the same per tile.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace differt {

constexpr int kChunk = 64;          // Triangles per culling chunk.
constexpr int kChunksPerTile = 8;   // Chunks per first-level culling tile.
constexpr float kSlabTiny = 1e-30f; // |d| below this counts as +-1e-30.

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

// Reciprocal of a direction component with the reference's tiny-value clamp.
__device__ __forceinline__ float slab_inv(float dc) {
  const float denom = fabsf(dc) < kSlabTiny ? (dc < 0.0f ? -kSlabTiny : kSlabTiny) : dc;
  return 1.0f / denom;
}

// Conservative segment-vs-box test over t in [0, t_hi]: never a false miss.
__device__ __forceinline__ bool slab_overlap(Vec3 o, Vec3 inv_d, const float4* box, float t_hi) {
  const float4 lo = box[0];
  const float4 hi = box[1];
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
  return tnear <= tfar;
}

// Does o + t d hit any active triangle with eps < t < thresh? Walks tiles,
// then chunks, skipping every box with no active triangle or no overlap,
// and returns at the first hit.
__device__ inline bool any_hit(Vec3 o, Vec3 d, float thresh, const float4* __restrict__ mesh,
                               const float4* __restrict__ chunk_box,
                               const float4* __restrict__ tile_box, int num_chunks, float eps) {
  const Vec3 inv_d = {slab_inv(d.x), slab_inv(d.y), slab_inv(d.z)};
  const int num_tiles = (num_chunks + kChunksPerTile - 1) / kChunksPerTile;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const float4* tb = tile_box + 2 * tile;
    if (__ldg(&tb[0].w) == 0.0f || !slab_overlap(o, inv_d, tb, thresh)) continue;
    const int chunk_end = min(num_chunks, (tile + 1) * kChunksPerTile);
    for (int chunk = tile * kChunksPerTile; chunk < chunk_end; ++chunk) {
      const float4* cb = chunk_box + 2 * chunk;
      if (__ldg(&cb[0].w) == 0.0f || !slab_overlap(o, inv_d, cb, thresh)) continue;
      const float4* tri = mesh + 3 * kChunk * chunk;
      for (int j = 0; j < kChunk; ++j, tri += 3) {
        const float4 a = __ldg(tri);
        const float4 b = __ldg(tri + 1);
        const float4 c = __ldg(tri + 2);
        if (c.y == 0.0f) continue;  // Inactive or padding.
        float t;
        const bool hit = mt_hit(o, d, {a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, eps, &t);
        if (hit && t < thresh) return true;
      }
    }
  }
  return false;
}

// Nearest active triangle hit by o + t d with t > eps: returns its position in
// the sorted mesh and writes its t, or returns -1 and writes +inf. Tiles and
// chunks whose box lies beyond the best t so far are skipped. The contract of
// the reference kernel (_pallas_rt.py::_closest_kernel): within a chunk the
// first minimum wins; across chunks an equal t in the later chunk wins.
__device__ inline int closest_hit(Vec3 o, Vec3 d, const float4* __restrict__ mesh,
                                  const float4* __restrict__ chunk_box,
                                  const float4* __restrict__ tile_box, int num_chunks, float eps,
                                  float* t_out) {
  const Vec3 inv_d = {slab_inv(d.x), slab_inv(d.y), slab_inv(d.z)};
  const int num_tiles = (num_chunks + kChunksPerTile - 1) / kChunksPerTile;
  float best_t = CUDART_INF_F;
  int best = -1;
  for (int tile = 0; tile < num_tiles; ++tile) {
    const float4* tb = tile_box + 2 * tile;
    if (__ldg(&tb[0].w) == 0.0f || !slab_overlap(o, inv_d, tb, best_t)) continue;
    const int chunk_end = min(num_chunks, (tile + 1) * kChunksPerTile);
    for (int chunk = tile * kChunksPerTile; chunk < chunk_end; ++chunk) {
      const float4* cb = chunk_box + 2 * chunk;
      if (__ldg(&cb[0].w) == 0.0f || !slab_overlap(o, inv_d, cb, best_t)) continue;
      const float4* tri = mesh + 3 * kChunk * chunk;
      float chunk_t = CUDART_INF_F;
      int chunk_arg = -1;
      for (int j = 0; j < kChunk; ++j, tri += 3) {
        const float4 a = __ldg(tri);
        const float4 b = __ldg(tri + 1);
        const float4 c = __ldg(tri + 2);
        if (c.y == 0.0f) continue;  // Inactive or padding.
        float t;
        const bool hit = mt_hit(o, d, {a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, eps, &t);
        if (hit && t < chunk_t) {
          chunk_t = t;
          chunk_arg = kChunk * chunk + j;
        }
      }
      if (chunk_arg >= 0 && chunk_t <= best_t) {
        best_t = chunk_t;
        best = chunk_arg;
      }
    }
  }
  *t_out = best_t;
  return best;
}

}  // namespace differt
