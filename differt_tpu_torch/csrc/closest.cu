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
