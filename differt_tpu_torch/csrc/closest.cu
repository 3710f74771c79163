// Closest-hit ray casting kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel differt_tpu/ops/_pallas_rt.py::_closest_kernel
// (launched by _run_closest, entry pallas_first_triangle_hit_by_ray).
//
// Per ray: the Morton position and the t of the nearest active triangle with
// |det| > eps and t > eps, or (-1, +inf). The wrapper
// (differt_tpu_torch/ops/_closest.py) maps positions back to triangle indices
// through the BVH's permutation. Ties keep the reference's rule, as a key on
// the Morton position (mt.cuh::closer).
//
// What bounds it on the H100: the bytes a launch must move are a few MB
// (rays in, index and t out, the 0.4 MB mesh once), a few microseconds; what
// takes the time is the Möller–Trumbore tests and box tests a ray cannot
// cull and the divergence between the rays of one warp. A flat walk over
// the boxes of the mesh's Morton chunks, in order, never skips a box, starts
// culling against the best t only after a late hit, and sends every
// downward ray into the chunk that holds the city-wide ground. So: one thread
// per ray down the mesh's BVH (mt.cuh::closest_hit). The ground sits in the
// large-triangle list, tested first, which gives most rays an early best t;
// the walk enters the nearer child first and drops every node the ray
// enters after its best t; the top ten levels of the tree sit in shared
// memory, staged once per block with cp.async, the rest is read through the
// read-only cache from L2.
//
// Visibility (lattice_closest_kernel) replaces no other TPU kernel: it is
// _closest_kernel with the visibility lattice of differt_tpu/rt/_scan.py
// (fibonacci_lattice over each vertex's frustum, then the scatter of the first
// hits) moved into it. Each thread makes its ray from its vertex's frustum
// terms and its lattice slot (differt_tpu_torch/geometry/_lattice.py::
// lattice_slots: step, 1 - step, frac, 1 - frac), with fibonacci_lattice's
// operations in its order (no FMA: --fmad=false), so each direction, and so
// each hit, is the one the rays' tensor would give. It then stores 1 at the
// hit's triangle (or the spare column T on a miss) in the vertex's visibility
// row: no ray, position or t reaches device memory. The bound is the same as
// above, the box and Möller–Trumbore tests and the divergence of a warp's rays,
// and two things in the design answer it. The slot order: lattice index i sets
// cos(polar) linearly and the azimuth by the golden fraction of i, so 32
// consecutive indices lie on a thin ring at 32 azimuths over the whole span
// and walk 32 unrelated parts of the tree; slots sort the indices by bands of
// isqrt(32 pi n), then by azimuth, so a warp's 32 rays are a compact patch of
// the sphere and walk the tree together (a mark is an OR: the order of the
// rays cannot change the result). Persistent warps: one grid of as many blocks
// as the card holds, each warp taking the next 32 rays from a counter, so a
// warp whose patch walks little takes another instead of idling its block.

#include "mt.cuh"

namespace differt {

constexpr int kClosestThreads = 256;
constexpr int kClosestTop = 1023;  // Top ten levels of the tree: 32 KB of shared memory.

__global__ void __launch_bounds__(kClosestThreads)
    closest_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                   Bvh bvh, int num_rays, float eps, int* __restrict__ pos_out,
                   float* __restrict__ t_out) {
  __shared__ float4 top[2 * kClosestTop];
  const int num_top = min(bvh.num_nodes, kClosestTop);
  stage_top(top, bvh.nodes, num_top);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  float t;
  pos_out[i] = closest_hit(load3(origins + 3 * i), load3(directions + 3 * i), bvh, top, num_top,
                           eps, &t);
  t_out[i] = t;
}

// The closest hit of each (vertex, lattice slot) ray of the launch, marked in
// the vertex's row of visible [num_vertices][num_triangles + 1]; positions map
// back to triangles through perm (the BVH's permutation). Persistent warps:
// each takes the next 32 rays (ray i: vertex i / num_rays, slot i % num_rays)
// from *next (zero at launch) until none are left.
__global__ void __launch_bounds__(kClosestThreads)
    lattice_closest_kernel(const float* __restrict__ vertices, const float4* __restrict__ frusta,
                           const float4* __restrict__ slots, int num_rays, int total_rays,
                           Bvh bvh, float eps, const long long* __restrict__ perm,
                           int num_triangles, unsigned char* visible, int* next) {
  __shared__ float4 top[2 * kClosestTop];
  const int num_top = min(bvh.num_nodes, kClosestTop);
  stage_top(top, bvh.nodes, num_top);
  const int lane = threadIdx.x & 31;
  while (true) {
    int first = 0;
    if (lane == 0) first = atomicAdd(next, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= total_rays) return;
    const int i = first + lane;
    if (i < total_rays) {
      const int v = i / num_rays;
      // cos(polar_lo), cos(polar_hi), azim_lo, azim_hi; step, 1 - step, frac, 1 - frac.
      const float4 f = __ldg(frusta + v);
      const float4 s = __ldg(slots + (i - v * num_rays));
      const float polar = acosf(f.x * s.y + f.y * s.x);
      const float azimuth = f.z * s.w + f.w * s.z;
      const float sin_polar = sinf(polar);
      const Vec3 d = {sin_polar * cosf(azimuth), sin_polar * sinf(azimuth), cosf(polar)};
      float t;
      const int pos = closest_hit(load3(vertices + 3 * v), d, bvh, top, num_top, eps, &t);
      const int col = pos >= 0 ? static_cast<int>(__ldg(perm + pos)) : num_triangles;
      unsigned char* mark = visible + static_cast<long long>(v) * (num_triangles + 1) + col;
      // One store for each distinct mark of the warp: the rays of a street
      // vertex that point down all hit the ground's two triangles.
      const unsigned peers =
          __match_any_sync(__activemask(), reinterpret_cast<unsigned long long>(mark));
      if (lane == __ffs(peers) - 1) *mark = 1;
    }
    __syncwarp();
  }
}

}  // namespace differt

extern "C" int differt_closest(const float* origins, const float* directions, const float* nodes,
                               const float* tris, int num_nodes, int large_begin, int num_large,
                               int num_rays, float epsilon, int* pos_out, float* t_out,
                               void* stream) {
  const differt::Bvh bvh{reinterpret_cast<const float4*>(nodes),
                         reinterpret_cast<const float4*>(tris), num_nodes, large_begin, num_large};
  const int blocks = (num_rays + differt::kClosestThreads - 1) / differt::kClosestThreads;
  differt::closest_kernel<<<blocks, differt::kClosestThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(origins, directions, bvh,
                                                                 num_rays, epsilon, pos_out, t_out);
  return static_cast<int>(cudaGetLastError());
}

// next: one int, zero. The grid is as many blocks as the card holds at once.
extern "C" int differt_lattice_closest(const float* vertices, const float* frusta,
                                       const float* slots, int num_vertices, int num_rays,
                                       const float* nodes, const float* tris, int num_nodes,
                                       int large_begin, int num_large, float epsilon,
                                       const long long* perm, int num_triangles,
                                       unsigned char* visible, int* next, void* stream) {
  const differt::Bvh bvh{reinterpret_cast<const float4*>(nodes),
                         reinterpret_cast<const float4*>(tris), num_nodes, large_begin, num_large};
  const int total_rays = num_vertices * num_rays;  // at most 2**30 (the wrapper checks)
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, differt::lattice_closest_kernel,
                                                differt::kClosestThreads, 0);
  const int needed = (total_rays + differt::kClosestThreads - 1) / differt::kClosestThreads;
  const int blocks = max(1, min(sms * per_sm, needed));
  differt::lattice_closest_kernel<<<blocks, differt::kClosestThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      vertices, reinterpret_cast<const float4*>(frusta), reinterpret_cast<const float4*>(slots),
      num_rays, total_rays, bvh, epsilon, perm, num_triangles, visible, next);
  return static_cast<int>(cudaGetLastError());
}
