// Closest-hit ray casting kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel differt_tpu/ops/_pallas_rt.py::_closest_kernel
// (launched by _run_closest, entry pallas_first_triangle_hit_by_ray).
//
// Per ray: the position in the Morton-sorted mesh and the t of the nearest
// active triangle with |det| > eps and t > eps, or (-1, +inf). The wrapper
// (differt_tpu_torch/ops/_closest.py) maps positions back to triangle indices
// through the Morton permutation.
//
// What bounds it on the H100: the Möller–Trumbore tests a ray cannot cull and
// the divergence between the rays of one warp. Unlike any-hit there is no
// early exit: each ray walks every chunk whose box starts before its best t so
// far, and incoherent rays (a Fibonacci lattice, or rays after a bounce) walk
// different chunks within a warp. The mesh is small next to the 50 MB L2
// (9,218 triangles are 0.44 MB at 48 bytes each), so device memory traffic is
// not the limit. The design: one thread per ray, the two-level walk of
// mt.cuh::closest_hit over 64-triangle chunks in tiles of 8, each box tested
// against [0, best t], so geometry behind the first hits is skipped.

#include "mt.cuh"

namespace differt {

__global__ void __launch_bounds__(128)
    closest_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                   const float4* __restrict__ mesh, const float4* __restrict__ chunk_box,
                   const float4* __restrict__ tile_box, int num_rays, int num_chunks, float eps,
                   int* __restrict__ idx_out, float* __restrict__ t_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rays) return;
  const Vec3 o = load3(origins + 3 * i);
  const Vec3 d = load3(directions + 3 * i);
  float t;
  idx_out[i] = closest_hit(o, d, mesh, chunk_box, tile_box, num_chunks, eps, &t);
  t_out[i] = t;
}

}  // namespace differt

extern "C" int differt_closest(const float* origins, const float* directions, const float* mesh,
                               const float* chunk_box, const float* tile_box, int num_rays,
                               int num_chunks, float epsilon, int* idx_out, float* t_out,
                               void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  differt::closest_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      origins, directions, reinterpret_cast<const float4*>(mesh),
      reinterpret_cast<const float4*>(chunk_box), reinterpret_cast<const float4*>(tile_box),
      num_rays, num_chunks, epsilon, idx_out, t_out);
  return static_cast<int>(cudaGetLastError());
}
