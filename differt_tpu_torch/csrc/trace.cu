// Fused specular trace kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel differt_tpu/ops/_pallas_trace.py::_trace_kernel
// (driver _pallas_trace_specular_impl, entry pallas_trace_specular), which
// is generic in the order.
//
// Per (TX, candidate, RX) path: the mirror images of the TX (forward), the
// plane intersections back from the RX, the checks (inside one of the
// mirror's triangles, same side, no segment shorter than min_len, finite,
// not parallel), then, for the paths that passed, an any-hit test of all
// k+1 segments against the mesh's BVH. The geometry follows the reference's
// formulas in the reference's order (_trace_kernel, geometry phase).
// Outputs are vertices [num_tx, num_cand, num_rx, k+2, 3] and mask
// [num_tx, num_cand, num_rx]; invalid paths keep their raw (possibly
// non-finite) vertices.
//
// What bounds it on the H100: bytes. Each path writes (k+2)*12 bytes of
// vertices and reads next to nothing (the candidate's mirrors and
// triangles are shared by all receivers), about 180 flops a path at order
// 2, so at 3.35 TB/s the store is the floor. At city scale nearly every
// path fails the cheap checks; the few that survive walk the BVH,
// divergently.
//
// The design:
// - A block is one TX, kCandTile candidates (one warp each) and kRxTile
//   receivers (one lane each). Its candidates' mirrors and triangles go to
//   shared memory once, and one thread a candidate computes the TX's
//   mirror images there, once per (TX, candidate) rather than once per path.
// - Each path's chain of vertices is staged in shared memory, where a
//   warp's paths form the contiguous run of the output that it then writes
//   with 16-byte stores. Orders 1-4 are templates (KT = order): every loop
//   over the chain is unrolled and the chain also stays in registers. Every
//   higher order runs one instantiation (KT = 0) that takes the order as an
//   argument: its loops are not unrolled and its chain lives in the staging
//   buffer alone. Both do the same operations in the same order, so the
//   bits do not depend on the instantiation.
// - The paths that pass the checks are queued per block (__ballot_sync and
//   a shared counter), and their segments are spread over the block's
//   threads, so that whole warps walk the BVH for blockage instead of a
//   live lane or two in 32. Only a block with a queued path stages the top
//   of the tree into shared memory.
// - Shared memory holds the top of the tree (16 KB), then per candidate its
//   mirrors, triangles and TX images, per thread its path's vertices, and
//   the queue: static arrays for a template order, one dynamic buffer sized
//   for the order for the runtime one (trace_smem_bytes). With quads that is
//   20,452 + 1,968 k bytes, so the orders a block can hold end at
//   kMaxOrder = 107 (Hopper's 227 KB opt-in); above 48 KB (k >= 15) the
//   launch opts in (cudaFuncSetAttribute).

#include <cstdint>

#include "mt.cuh"

namespace differt {

constexpr int kRxTile = 32;   // Receivers of a block: one lane each.
constexpr int kCandTile = 4;  // Candidates of a block: one warp each.
constexpr int kTraceThreads = kRxTile * kCandTile;
constexpr int kTraceTop = 511;  // Top nine levels of the tree: 16 KB of shared memory.
constexpr int kTemplateOrders = 4;        // Orders 1-4 have their own instantiation.
constexpr long long kSmemOptin = 232448;  // The most a block may opt into on sm_90 (227 KB).
constexpr long long kSmemDefault = 49152;  // Above this a kernel must opt in.

// Bytes of a block's shared memory at order k with tpm triangles a mirror.
__host__ __device__ constexpr long long trace_smem_bytes(int k, int tpm) {
  return 16LL * 2 * kTraceTop                              // s_top
         + 4LL * kCandTile * (6 * k + 9 * tpm * k + 3 * k)  // s_mirror, s_tris, s_images
         + 4LL * kTraceThreads * 3 * (k + 2)                // s_verts
         + 4LL * (2 * kTraceThreads + 1);                   // s_queue, s_blocked, s_count
}

// The highest order whose quad layout fits the opt-in limit.
constexpr int kMaxOrder = static_cast<int>(
    (kSmemOptin - trace_smem_bytes(0, 2)) / (trace_smem_bytes(1, 2) - trace_smem_bytes(0, 2)));
static_assert(trace_smem_bytes(kMaxOrder, 2) <= kSmemOptin, "kMaxOrder overflows shared memory");
static_assert(trace_smem_bytes(kMaxOrder + 1, 2) > kSmemOptin, "kMaxOrder is not the largest");

// A path's chain of k+2 vertices: in registers and the staging buffer for a
// template order (KT > 0), in the staging buffer alone for the runtime order.
template <int KT>
struct Chain {
  Vec3 v[KT + 2];
  float* staged;
  __device__ __forceinline__ void set(int l, Vec3 p) { v[l] = p; }
  __device__ __forceinline__ Vec3 get(int l) const { return v[l]; }
  __device__ __forceinline__ void stage() {
#pragma unroll
    for (int l = 0; l < KT + 2; ++l) {
      staged[3 * l] = v[l].x;
      staged[3 * l + 1] = v[l].y;
      staged[3 * l + 2] = v[l].z;
    }
  }
};

template <>
struct Chain<0> {
  float* staged;
  __device__ __forceinline__ void set(int l, Vec3 p) {
    staged[3 * l] = p.x;
    staged[3 * l + 1] = p.y;
    staged[3 * l + 2] = p.z;
  }
  __device__ __forceinline__ Vec3 get(int l) const { return load3(staged + 3 * l); }
  __device__ __forceinline__ void stage() {}
};

// KT: the order, or 0 for the runtime order `order` (KT > 0 ignores it).
template <int KT, int TPM>
__global__ void __launch_bounds__(kTraceThreads)
    trace_kernel(const float* __restrict__ tx, const float* __restrict__ rx,
                 const float* __restrict__ mirrors,    // [C][K][6]: vertex xyz, normal xyz
                 const float* __restrict__ cand_tris,  // [C][TPM*K][9]: v0, e1, e2
                 Bvh bvh, int order, int num_cand, int num_rx, long long block0, float eps,
                 float hit_tol, float thresh, float min_len, float* __restrict__ verts,
                 unsigned char* __restrict__ mask) {
  const int K = KT > 0 ? KT : order;
  const int kVerts = 3 * (K + 2);  // Floats of a path's vertices.
  const int kMirror = 6 * K;       // Floats of a candidate's mirrors.
  const int kTris = 9 * TPM * K;   // Floats of a candidate's triangles.
  float4* s_top;
  float *s_mirror, *s_tris, *s_images, *s_verts;
  int *s_queue, *s_blocked, *s_count;
  if constexpr (KT > 0) {
    // A template order: static arrays, which ptxas sizes (and allocates
    // registers for). Their order sets their layout, and with it the time
    // of the order-1 tiles: keep the top of the tree last.
    __shared__ float mirror_buf[kCandTile * 6 * KT];
    __shared__ float tris_buf[kCandTile * 9 * TPM * KT];
    __shared__ float images_buf[kCandTile * 3 * KT];
    __shared__ float verts_buf[kTraceThreads * 3 * (KT + 2)];
    __shared__ int queue_buf[kTraceThreads];
    __shared__ int blocked_buf[kTraceThreads];
    __shared__ int count_buf;
    __shared__ float4 top[2 * kTraceTop];
    s_top = top;
    s_mirror = mirror_buf;
    s_tris = tris_buf;
    s_images = images_buf;
    s_verts = verts_buf;
    s_queue = queue_buf;
    s_blocked = blocked_buf;
    s_count = &count_buf;
  } else {
    // The runtime order: one dynamic buffer in the order of trace_smem_bytes.
    extern __shared__ float4 smem[];
    s_top = smem;
    s_mirror = reinterpret_cast<float*>(smem + 2 * kTraceTop);
    s_tris = s_mirror + kCandTile * kMirror;
    s_images = s_tris + kCandTile * kTris;
    s_verts = s_images + kCandTile * 3 * K;
    s_queue = reinterpret_cast<int*>(s_verts + kTraceThreads * kVerts);
    s_blocked = s_queue + kTraceThreads;
    s_count = s_blocked + kTraceThreads;
  }

  const int warp = threadIdx.x / kRxTile;
  const int lane = threadIdx.x % kRxTile;
  // Blocks in order of (TX, RX tile, candidate tile), candidate tiles fastest.
  const long long cand_blocks = (static_cast<long long>(num_cand) + kCandTile - 1) / kCandTile;
  const long long rx_blocks = (static_cast<long long>(num_rx) + kRxTile - 1) / kRxTile;
  const long long block = block0 + blockIdx.x;
  const int c0 = static_cast<int>(block % cand_blocks) * kCandTile;
  const int r0 = static_cast<int>((block / cand_blocks) % rx_blocks) * kRxTile;
  const int a = static_cast<int>(block / (cand_blocks * rx_blocks));
  const int num_c = min(kCandTile, num_cand - c0);
  const int c = c0 + warp;
  const int r = r0 + lane;

  for (int i = threadIdx.x; i < num_c * kMirror; i += blockDim.x) {
    s_mirror[i] = mirrors[static_cast<long long>(c0) * kMirror + i];
  }
  for (int i = threadIdx.x; i < num_c * kTris; i += blockDim.x) {
    s_tris[i] = cand_tris[static_cast<long long>(c0) * kTris + i];
  }
  if (threadIdx.x == 0) *s_count = 0;
  s_blocked[threadIdx.x] = 0;
  __syncthreads();

  const Vec3 tx_v = load3(tx + 3 * a);
  if (threadIdx.x < num_c) {
    // Forward pass: consecutive mirror images of the TX, once per candidate.
    const float* mir = s_mirror + threadIdx.x * kMirror;
    float* images = s_images + threadIdx.x * 3 * K;
    Vec3 img = tx_v;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const Vec3 mv = load3(mir + 6 * b);
      const Vec3 n = load3(mir + 6 * b + 3);
      const float d = dot(sub(img, mv), n);
      const float d2 = 2.0f * d;
      img = {img.x - d2 * n.x, img.y - d2 * n.y, img.z - d2 * n.z};
      images[3 * b] = img.x;
      images[3 * b + 1] = img.y;
      images[3 * b + 2] = img.z;
    }
  }
  __syncthreads();

  const bool live = warp < num_c && r < num_rx;
  bool geom = false;
  if (live) {
    const float* mir = s_mirror + warp * kMirror;
    const float* images = s_images + warp * 3 * K;
    const Vec3 rx_v = load3(rx + 3 * r);

    // Backward pass: intersect toward the images, last mirror first.
    Chain<KT> chain;
    chain.staged = s_verts + threadIdx.x * kVerts;
    chain.set(0, tx_v);
    chain.set(K + 1, rx_v);
    Vec3 point = rx_v;
    bool invalid = false;
#pragma unroll
    for (int b = K - 1; b >= 0; --b) {
      const Vec3 mv = load3(mir + 6 * b);
      const Vec3 n = load3(mir + 6 * b + 3);
      const Vec3 direction = sub(load3(images + 3 * b), point);
      const float dn = dot(direction, n);
      const float vn = dot(sub(mv, point), n);
      const bool parallel = dn == 0.0f;
      const float tt = vn / (parallel ? 1.0f : dn);
      invalid = invalid || (parallel && vn != 0.0f);
      point = {point.x + direction.x * tt, point.y + direction.y * tt, point.z + direction.z * tt};
      chain.set(b + 1, point);
    }
    chain.stage();

    // Segment checks: finiteness and minimal squared length.
    bool finite = !invalid;
    bool seg_valid = true;
#pragma unroll
    for (int s = 0; s <= K; ++s) {
      const Vec3 p = chain.get(s);
      const Vec3 d = sub(chain.get(s + 1), p);
      finite = finite && finite3(p) && finite3(d);
      seg_valid = seg_valid && !(dot(d, d) < min_len);
    }

    // Inside check: segment b hits one of its mirror's TPM triangles.
    bool inside = true;
    const float* tris = s_tris + warp * kTris;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const Vec3 o = chain.get(b);
      const Vec3 d = sub(chain.get(b + 1), o);
      bool hit_any = false;
#pragma unroll
      for (int j = 0; j < TPM; ++j) {
        const float* tri = tris + 9 * (TPM * b + j);
        float t;
        hit_any = mt_hit(o, d, load3(tri), load3(tri + 3), load3(tri + 6), eps, &t) || hit_any;
      }
      inside = inside && hit_any;
    }

    // Same-side check per mirror.
    bool same_side = true;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const Vec3 mv = load3(mir + 6 * b);
      const Vec3 n = load3(mir + 6 * b + 3);
      const float dot_prev = dot(sub(chain.get(b), mv), n);
      const float dot_next = dot(sub(chain.get(b + 2), mv), n);
      same_side = same_side && (sign_of(dot_prev) == sign_of(dot_next));
    }
    geom = inside && same_side && seg_valid && finite;
  }

  // Queue the paths that passed the checks.
  const unsigned ballot = __ballot_sync(0xffffffffu, geom);
  int base = 0;
  if (lane == 0 && ballot != 0u) base = atomicAdd(s_count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (geom) s_queue[base + __popc(ballot & ((1u << lane) - 1u))] = threadIdx.x;
  __syncthreads();

  // Vertices: a warp's paths are one contiguous run of the output; store it
  // with 16-byte stores from the first 16-byte boundary on.
  if (warp < num_c) {
    const int n = min(kRxTile, num_rx - r0) * kVerts;
    const long long g0 = ((static_cast<long long>(a) * num_cand + c) * num_rx + r0) * kVerts;
    const float* src = s_verts + warp * kRxTile * kVerts;
    float* dst = verts + g0;
    const int head = min(n, static_cast<int>((4 - (g0 & 3)) & 3));
    const int quads = (n - head) / 4;
    if (lane < head) dst[lane] = src[lane];
    float4* dst4 = reinterpret_cast<float4*>(dst + head);
    for (int q = lane; q < quads; q += kRxTile) {
      const float* s = src + head + 4 * q;
      dst4[q] = make_float4(s[0], s[1], s[2], s[3]);
    }
    for (int i = head + 4 * quads + lane; i < n; i += kRxTile) dst[i] = src[i];
  }

  // Blockage of the queued paths, one segment a thread: the mask is an AND
  // of all checks, so a path already found blocked skips its other segments.
  const int count = *s_count;
  if (count > 0) {
    const int num_top = min(bvh.num_nodes, kTraceTop);
    stage_top(s_top, bvh.nodes, num_top);
    for (int i = threadIdx.x; i < count * (K + 1); i += blockDim.x) {
      const int path = s_queue[i / (K + 1)];
      const int s = i % (K + 1);
      if (reinterpret_cast<volatile int*>(s_blocked)[path]) continue;
      const float* pv = s_verts + path * kVerts;
      const Vec3 p0 = load3(pv + 3 * s);
      const Vec3 o = sanitize(p0);
      const Vec3 d = sanitize(sub(load3(pv + 3 * (s + 1)), p0));
      const Vec3 o_off = {o.x + d.x * hit_tol, o.y + d.y * hit_tol, o.z + d.z * hit_tol};
      if (any_hit(o_off, d, thresh, bvh, s_top, num_top, eps)) s_blocked[path] = 1;
    }
    __syncthreads();
  }
  if (live) {
    const long long p = (static_cast<long long>(a) * num_cand + c) * num_rx + r;
    mask[p] = (geom && !s_blocked[threadIdx.x]) ? 1 : 0;
  }
}

template <int KT, int TPM>
int launch(const float* tx, const float* rx, const float* mirrors, const float* cand_tris,
           const Bvh& bvh, int order, int num_tx, int num_cand, int num_rx, float eps,
           float hit_tol, float thresh, float min_len, float* verts, unsigned char* mask,
           cudaStream_t stream) {
  if (reinterpret_cast<std::uintptr_t>(verts) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long smem = KT > 0 ? 0 : trace_smem_bytes(order, TPM);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        trace_kernel<KT, TPM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long cand_blocks = (static_cast<long long>(num_cand) + kCandTile - 1) / kCandTile;
  const long long rx_blocks = (static_cast<long long>(num_rx) + kRxTile - 1) / kRxTile;
  const long long blocks = cand_blocks * rx_blocks * num_tx;
  // One launch per 2^31 - 1 blocks (grid.x's limit), so that no shape is refused.
  for (long long block0 = 0; block0 < blocks; block0 += 0x7fffffffLL) {
    const unsigned grid = static_cast<unsigned>(blocks - block0 < 0x7fffffffLL ? blocks - block0
                                                                                : 0x7fffffffLL);
    trace_kernel<KT, TPM><<<grid, kTraceThreads, smem, stream>>>(
        tx, rx, mirrors, cand_tris, bvh, order, num_cand, num_rx, block0, eps, hit_tol, thresh,
        min_len, verts, mask);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace differt

// The highest order the kernel takes (what one block's shared memory holds).
extern "C" int differt_trace_max_order() { return differt::kMaxOrder; }

// Orders 1 to kMaxOrder, with 1 (triangles) or 2 (quads) triangles per mirror.
extern "C" int differt_trace(const float* tx, const float* rx, const float* mirrors,
                             const float* cand_tris, const float* nodes, const float* tris,
                             int order, int tris_per_mirror, int num_tx, int num_cand, int num_rx,
                             int num_nodes, int large_begin, int num_large, float epsilon,
                             float hit_tol, float thresh, float min_len, float* verts,
                             unsigned char* mask, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const differt::Bvh bvh{reinterpret_cast<const float4*>(nodes),
                         reinterpret_cast<const float4*>(tris), num_nodes, large_begin, num_large};
  if (order < 1 || order > differt::kMaxOrder) return static_cast<int>(cudaErrorInvalidValue);
  const int kt = order <= differt::kTemplateOrders ? order : 0;
#define DIFFERT_TRACE_CASE(KT, TPM)                                                            \
  if (kt == KT && tris_per_mirror == TPM)                                                      \
    return differt::launch<KT, TPM>(tx, rx, mirrors, cand_tris, bvh, order, num_tx, num_cand, \
                                    num_rx, epsilon, hit_tol, thresh, min_len, verts, mask, s);
  DIFFERT_TRACE_CASE(1, 1)
  DIFFERT_TRACE_CASE(1, 2)
  DIFFERT_TRACE_CASE(2, 1)
  DIFFERT_TRACE_CASE(2, 2)
  DIFFERT_TRACE_CASE(3, 1)
  DIFFERT_TRACE_CASE(3, 2)
  DIFFERT_TRACE_CASE(4, 1)
  DIFFERT_TRACE_CASE(4, 2)
  DIFFERT_TRACE_CASE(0, 1)
  DIFFERT_TRACE_CASE(0, 2)
#undef DIFFERT_TRACE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
