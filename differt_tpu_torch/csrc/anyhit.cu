// Any-hit occlusion kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel differt_tpu/ops/_pallas_rt.py::_anyhit_kernel
// (driver _run_anyhit, entry pallas_ray_intersect_any_triangle).
//
// Per ray: does o + t d hit any active triangle with eps < t < thresh[ray]?
// A negative (or NaN) threshold marks an inactive ray, which returns at once.
//
// What bounds it on the H100: the Möller–Trumbore tests a ray cannot cull,
// and the divergence between rays of one warp that walk different branches.
// The mesh is small next to the 50 MB L2 (20,738 triangles are 1 MB), so
// device memory traffic is not the limit. The design: one thread per ray
// down the mesh's BVH (mt.cuh::any_hit: the large-triangle list first, then
// the tree, with its top staged in shared memory once per block), exiting
// at the first hit.

#include "mt.cuh"

namespace differt {

constexpr int kAnyhitThreads = 256;
constexpr int kAnyhitTop = 1023;  // Top ten levels of the tree: 32 KB of shared memory.

__global__ void __launch_bounds__(kAnyhitThreads)
    anyhit_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                  const float* __restrict__ thresh, Bvh bvh, int num_rays, float eps,
                  unsigned char* __restrict__ out) {
  __shared__ float4 top[2 * kAnyhitTop];
  const int num_top = min(bvh.num_nodes, kAnyhitTop);
  stage_top(top, bvh.nodes, num_top);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const float th = thresh[i];
  bool hit = false;
  if (th >= 0.0f) {
    hit = any_hit(load3(origins + 3 * i), load3(directions + 3 * i), th, bvh, top, num_top, eps);
  }
  out[i] = hit ? 1 : 0;
}

}  // namespace differt

extern "C" int differt_anyhit(const float* origins, const float* directions, const float* thresh,
                              const float* nodes, const float* tris, int num_nodes,
                              int large_begin, int num_large, int num_rays, float epsilon,
                              unsigned char* out, void* stream) {
  const differt::Bvh bvh{reinterpret_cast<const float4*>(nodes),
                         reinterpret_cast<const float4*>(tris), num_nodes, large_begin, num_large};
  const int blocks = (num_rays + differt::kAnyhitThreads - 1) / differt::kAnyhitThreads;
  differt::anyhit_kernel<<<blocks, differt::kAnyhitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, thresh, bvh, num_rays, epsilon, out);
  return static_cast<int>(cudaGetLastError());
}
