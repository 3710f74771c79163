// Any-hit occlusion kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel differt_tpu/ops/_pallas_rt.py::_anyhit_kernel
// (driver _run_anyhit, entry pallas_ray_intersect_any_triangle).
//
// Per ray: does o + t d hit any active triangle with eps < t < thresh[ray]?
// A negative (or NaN) threshold marks an inactive ray, never blocked.
//
// What bounds it on the H100. The bytes are tiny (29 bytes a ray and the
// mesh, which sits in the 50 MB L2), so neither memory nor arithmetic is the
// limit; the walk of the mesh's BVH is a chain of dependent node and
// triangle fetches at L2 latency.
// - Few live rays (the main path's order-0 call: 128 segments; the unfused
//   pipeline's chunks, where about 1 ray in 1,000 survived the cheap
//   checks): one walk per ray fills a block or a few, on a few of 132 SMs,
//   and the call lasts as long as the longest walk down the 13 levels of a
//   city's tree.
// - Many live rays (262,144 segments): the card is full, and a warp runs
//   until its slowest ray ends while rays that ended early leave its lanes
//   idle.
//
// The design, two kernels on the wrapper's stream after a memset of two
// counters:
// 1. compact_kernel reads each threshold once, zeroes each result flag, and
//    lists the live rays (one atomicAdd per block that has any).
// 2. anyhit_kernel splits each live ray's walk into work items, pairs (ray,
//    subtree root at level L of the complete tree: roots 2^L - 1 ...
//    2^(L+1) - 2), plus, when L > 0, one item per ray for the
//    large-triangle list (at L = 0 a ray's one item tests the list, then
//    walks the whole tree). L is the least level with live * 2^L at or
//    above split_items (about one item for each thread the card holds),
//    capped at the tree's depth; each block applies that rule
//    (ops/_rt.py::anyhit_split) to the live count, on the device, with no
//    host sync. So few live rays make enough short walks to fill the card:
//    at 128 rays each item walks the last 2-3 levels. Items run in
//    subtree-major order (consecutive items: consecutive live rays at one
//    root), so a warp's lanes share their first node and the large-list
//    items come first. Persistent warps (as many as fit on the card)
//    balance the load dynamically, in the manner of Aila and Laine's
//    persistent while-while traversal: each warp takes 32 items at a time,
//    its first batch fixed by its index and every later one from a global
//    counter (atomicAdd, skipped once a plain read shows the queue empty);
//    the walk (mt.cuh::SubtreeWalk) goes one node a step, and after every
//    step the lanes whose item ended take the warp's next items, so a warp
//    never waits for its slowest lane. An item first reads its ray's
//    result flag (a volatile load): a ray already blocked skips the item.
// The result is an OR: every writer stores 1 into a flag zeroed before the
// walk, so it does not depend on the order of the items or of the list,
// and equals the one-walk-per-ray result bit for bit.
//
// Shared memory: every block stages, with cp.async, the levels of the tree
// from L down as far as 1,023 nodes (32 KB) hold them, the nodes that every
// item starts in. At L = 0 that is the top ten levels, which every walk
// reads; at L >= 10 not even level L fits, and with at most 128 live rays a
// block reads each of its roots less than once, so nothing is staged and
// the items read their nodes through the read-only cache.

#include "mt.cuh"

namespace differt {

constexpr int kAnyhitThreads = 256;
constexpr int kAnyhitWindow = 1023;  // Nodes staged: 32 KB of shared memory.
constexpr int kBatch = 32;           // Items a warp takes at once: one a lane.
constexpr unsigned kAllLanes = 0xffffffffu;

// counters[0]: live rays listed so far; counters[1]: the walk's queue.
__global__ void __launch_bounds__(kAnyhitThreads)
    compact_kernel(const float* __restrict__ thresh, int num_rays, int* __restrict__ counters,
                   int* __restrict__ live_rays, unsigned char* __restrict__ out) {
  __shared__ int warp_base[kAnyhitThreads / 32];
  __shared__ int block_base;
  const int i = blockIdx.x * kAnyhitThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const bool live = i < num_rays && thresh[i] >= 0.0f;
  if (i < num_rays) out[i] = 0;
  const unsigned votes = __ballot_sync(kAllLanes, live);
  if (lane == 0) warp_base[warp] = __popc(votes);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kAnyhitThreads / 32; ++w) {
      const int n = warp_base[w];
      warp_base[w] = sum;
      sum += n;
    }
    block_base = sum > 0 ? atomicAdd(counters, sum) : 0;
  }
  __syncthreads();
  if (live) live_rays[block_base + warp_base[warp] + __popc(votes & ((1u << lane) - 1u))] = i;
}

__global__ void __launch_bounds__(kAnyhitThreads)
    anyhit_kernel(const float* __restrict__ origins, const float* __restrict__ directions,
                  const float* __restrict__ thresh, Bvh bvh, int forced_split, int split_items,
                  float eps, const int* __restrict__ live_rays, int* counters,
                  unsigned char* out) {
  __shared__ float4 window[2 * kAnyhitWindow];
  const int num_live = counters[0];
  int split = forced_split;
  if (split < 0) {
    const int depth = 30 - __clz(bvh.num_nodes + 1);  // num_nodes = 2^(depth + 1) - 1
    split = 0;
    while (split < depth && (static_cast<long long>(num_live) << split) < split_items) ++split;
  }
  const int total = num_live * ((1 << split) + (split > 0 ? 1 : 0));
  const int warps_per_block = kAnyhitThreads / 32;
  if (blockIdx.x * warps_per_block * kBatch >= total) return;  // No item for this block.

  // Whole levels from level `split` down, as far as the window holds them.
  const int first = (1 << split) - 1;
  int count = 0;
  for (int size = 1 << split; count + size <= kAnyhitWindow && first + count < bvh.num_nodes;
       size <<= 1) {
    count += size;
  }
  stage_top(window, bvh.nodes + 2 * first, count);
  auto fetch = [&](int i, float4* lo, float4* hi) {
    const unsigned w = static_cast<unsigned>(i - first);
    if (w < static_cast<unsigned>(count)) {
      *lo = window[2 * w];
      *hi = window[2 * w + 1];
    } else {
      *lo = __ldg(bvh.nodes + 2 * i);
      *hi = __ldg(bvh.nodes + 2 * i + 1);
    }
  };

  const int lane = threadIdx.x % 32;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const int static_items = gridDim.x * warps_per_block * kBatch;
  // The warp's items [next, end): first its fixed batch, then the queue's.
  int next = (blockIdx.x * warps_per_block + threadIdx.x / 32) * kBatch;
  int end = min(next + kBatch, total);
  bool queue_open = static_items < total;
  volatile int* queue = counters + 1;

  SubtreeWalk walk;
  int ray = 0;
  Vec3 o{}, d{}, inv_d{};
  float th = 0.0f;
  bool busy = false;

  // Starts item `item`: true if it goes on to a walk.
  auto start = [&](int item) {
    const int sub = item / num_live;
    ray = live_rays[item - sub * num_live];
    const unsigned char blocked = *reinterpret_cast<volatile const unsigned char*>(out + ray);
    th = thresh[ray];
    o = load3(origins + 3 * ray);
    d = load3(directions + 3 * ray);
    float4 lo{}, hi{};
    if (sub > 0 || split == 0) fetch(split == 0 ? 0 : first + sub - 1, &lo, &hi);
    if (blocked) return false;
    if (sub == 0 && large_hit(o, d, th, bvh, eps)) {
      out[ray] = 1;
      return false;
    }
    if (sub == 0 && split > 0) return false;
    inv_d = slab_inv3(d);
    return walk.start(o, inv_d, th, lo, hi);
  };

  while (true) {
    // Lanes without an item take the warp's next ones.
    while (true) {
      const unsigned idle = __ballot_sync(kAllLanes, !busy);
      if (idle == 0) break;
      if (next >= end) {
        if (!queue_open) break;
        int base = total;
        if (lane == 0 && *queue + static_items < total) {
          base = static_items + atomicAdd(counters + 1, kBatch);
        }
        base = __shfl_sync(kAllLanes, base, 0);
        if (base >= total) {
          queue_open = false;
          break;
        }
        next = base;
        end = min(base + kBatch, total);
      }
      const int taken = min(__popc(idle), end - next);
      const int rank = __popc(idle & lower_lanes);
      if (!busy && rank < taken) busy = start(next + rank);
      next += taken;
    }
    if (__ballot_sync(kAllLanes, busy) == 0) return;  // The queue is empty and every walk over.
    if (busy) {
      const WalkStep s = walk.step(o, d, inv_d, th, bvh, eps, fetch);
      if (s == kWalkHit) out[ray] = 1;
      busy = s == kWalkOn;
    }
  }
}

}  // namespace differt

// scratch: [2 + num_rays] ints, the two counters, then the live-ray list.
// split < 0 picks the level from the live count (split_items), on the device.
extern "C" int differt_anyhit(const float* origins, const float* directions, const float* thresh,
                              const float* nodes, const float* tris, int num_nodes,
                              int large_begin, int num_large, int num_rays, int split,
                              int split_items, float epsilon, int* scratch, unsigned char* out,
                              void* stream) {
  if (num_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The counters start at 0 on the stream at every launch: a count left by
  // an earlier launch, finished or not, cannot leak in.
  const cudaError_t status = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), s);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int threads = differt::kAnyhitThreads;
  differt::compact_kernel<<<(num_rays + threads - 1) / threads, threads, 0, s>>>(
      thresh, num_rays, scratch, scratch + 2, out);
  // Persistent blocks: as many as the card holds at once (found once, for
  // the device current at the first launch: the grid's size changes how
  // well the items fill the card, never the result), or fewer when even
  // every ray live could not make that many items.
  static const long long resident = [] {
    int per_sm = 0;
    int device = 0;
    int sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, differt::anyhit_kernel,
                                                  differt::kAnyhitThreads, 0);
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return static_cast<long long>(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }();
  const int most_split = split >= 0 ? split : 30 - __builtin_clz(num_nodes + 1);
  const long long items = static_cast<long long>(num_rays) * ((1ll << most_split) + 1);
  const long long needed = (items + threads - 1) / threads;
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  const differt::Bvh bvh{reinterpret_cast<const float4*>(nodes),
                         reinterpret_cast<const float4*>(tris), num_nodes, large_begin, num_large};
  differt::anyhit_kernel<<<blocks, threads, 0, s>>>(origins, directions, thresh, bvh, split,
                                                    split_items, epsilon, scratch + 2, scratch,
                                                    out);
  return static_cast<int>(cudaGetLastError());
}
