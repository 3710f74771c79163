// Fused specular trace kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel differt_tpu/ops/_pallas_trace.py::_trace_kernel
// (driver _pallas_trace_specular_impl, entry pallas_trace_specular).
//
// One thread per (TX, candidate, RX) path: the mirror images of the TX
// (forward), the plane intersections back from the RX, the checks (inside
// one of the mirror's triangles, same side, no segment shorter than
// min_len, finite, not parallel), then, for the paths that passed, an
// any-hit test of all k+1 segments against the Morton-sorted mesh. The
// geometry phase runs in registers with the reference's formulas in the
// reference's order (_trace_kernel, geometry phase). Outputs go straight to
// vertices [num_tx, num_cand, num_rx, k+2, 3] and mask [num_tx, num_cand,
// num_rx]; invalid paths keep their raw (possibly non-finite) vertices.
//
// What bounds it on the H100: at city scale almost every path fails the
// cheap checks, so the cost is the geometry phase (tens of flops a path)
// and the vertex store ((k+2)*12 bytes a path), and then the blockage walk
// of the few surviving paths, which is divergent inside a warp. The design
// keeps neighbouring threads on neighbouring receivers of one candidate, so
// a warp reads the same candidate data (broadcast loads) and writes one
// contiguous run of vertices, and only surviving paths enter the walk.

#include "mt.cuh"

namespace differt {

template <int K, int TPM>
__global__ void __launch_bounds__(128)
    trace_kernel(const float* __restrict__ tx, const float* __restrict__ rx,
                 const float* __restrict__ mirrors,    // [C][K][6]: vertex xyz, normal xyz
                 const float* __restrict__ cand_tris,  // [C][TPM*K][9]: v0, e1, e2
                 const float4* __restrict__ mesh, const float4* __restrict__ chunk_box,
                 const float4* __restrict__ tile_box, int num_tx, int num_cand, int num_rx,
                 int num_chunks, float eps, float hit_tol, float thresh, float min_len,
                 float* __restrict__ verts, unsigned char* __restrict__ mask) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(num_tx) * num_cand * num_rx;
  if (p >= total) return;
  const int r = static_cast<int>(p % num_rx);
  const long long tc = p / num_rx;
  const int c = static_cast<int>(tc % num_cand);
  const int a = static_cast<int>(tc / num_cand);

  const Vec3 tx_v = load3(tx + 3 * a);
  const Vec3 rx_v = load3(rx + 3 * r);
  const float* mir = mirrors + static_cast<long long>(c) * K * 6;

  // Forward pass: consecutive mirror images of the TX.
  Vec3 images[K];
  Vec3 img = tx_v;
#pragma unroll
  for (int b = 0; b < K; ++b) {
    const Vec3 mv = load3(mir + 6 * b);
    const Vec3 n = load3(mir + 6 * b + 3);
    const float d = dot(sub(img, mv), n);
    const float d2 = 2.0f * d;
    img = {img.x - d2 * n.x, img.y - d2 * n.y, img.z - d2 * n.z};
    images[b] = img;
  }

  // Backward pass: intersect toward the images, last mirror first.
  Vec3 chain[K + 2];
  chain[0] = tx_v;
  chain[K + 1] = rx_v;
  Vec3 point = rx_v;
  bool invalid = false;
#pragma unroll
  for (int b = K - 1; b >= 0; --b) {
    const Vec3 mv = load3(mir + 6 * b);
    const Vec3 n = load3(mir + 6 * b + 3);
    const Vec3 direction = sub(images[b], point);
    const float dn = dot(direction, n);
    const float vn = dot(sub(mv, point), n);
    const bool parallel = dn == 0.0f;
    const float tt = vn / (parallel ? 1.0f : dn);
    invalid = invalid || (parallel && vn != 0.0f);
    point = {point.x + direction.x * tt, point.y + direction.y * tt, point.z + direction.z * tt};
    chain[b + 1] = point;
  }

  float* out = verts + p * (3 * (K + 2));
#pragma unroll
  for (int l = 0; l < K + 2; ++l) {
    out[3 * l] = chain[l].x;
    out[3 * l + 1] = chain[l].y;
    out[3 * l + 2] = chain[l].z;
  }

  // Segment checks: finiteness and minimal squared length.
  bool finite = !invalid;
  bool seg_valid = true;
#pragma unroll
  for (int s = 0; s <= K; ++s) {
    const Vec3 d = sub(chain[s + 1], chain[s]);
    finite = finite && finite3(chain[s]) && finite3(d);
    seg_valid = seg_valid && !(dot(d, d) < min_len);
  }

  // Inside check: segment b hits one of its mirror's TPM triangles.
  bool inside = true;
  const float* tris = cand_tris + static_cast<long long>(c) * TPM * K * 9;
#pragma unroll
  for (int b = 0; b < K; ++b) {
    const Vec3 o = chain[b];
    const Vec3 d = sub(chain[b + 1], chain[b]);
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
    const float dot_prev = dot(sub(chain[b], mv), n);
    const float dot_next = dot(sub(chain[b + 2], mv), n);
    same_side = same_side && (sign_of(dot_prev) == sign_of(dot_next));
  }

  const bool geom = inside && same_side && seg_valid && finite;
  // Blockage only for paths that survived: the mask is an AND of all checks.
  bool blocked = !geom;
  for (int s = 0; s <= K && !blocked; ++s) {
    const Vec3 o = sanitize(chain[s]);
    const Vec3 d = sanitize(sub(chain[s + 1], chain[s]));
    const Vec3 o_off = {o.x + d.x * hit_tol, o.y + d.y * hit_tol, o.z + d.z * hit_tol};
    blocked = any_hit(o_off, d, thresh, mesh, chunk_box, tile_box, num_chunks, eps);
  }
  mask[p] = (geom && !blocked) ? 1 : 0;
}

template <int K, int TPM>
int launch(const float* tx, const float* rx, const float* mirrors, const float* cand_tris,
           const float* mesh, const float* chunk_box, const float* tile_box, int num_tx,
           int num_cand, int num_rx, int num_chunks, float eps, float hit_tol, float thresh,
           float min_len, float* verts, unsigned char* mask, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const long long total = static_cast<long long>(num_tx) * num_cand * num_rx;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  trace_kernel<K, TPM><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      tx, rx, mirrors, cand_tris, reinterpret_cast<const float4*>(mesh),
      reinterpret_cast<const float4*>(chunk_box), reinterpret_cast<const float4*>(tile_box),
      num_tx, num_cand, num_rx, num_chunks, eps, hit_tol, thresh, min_len, verts, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace differt

// Orders 1-4, with 1 (triangles) or 2 (quads) triangles per mirror.
extern "C" int differt_trace(const float* tx, const float* rx, const float* mirrors,
                             const float* cand_tris, const float* mesh, const float* chunk_box,
                             const float* tile_box, int order, int tris_per_mirror, int num_tx,
                             int num_cand, int num_rx, int num_chunks, float epsilon,
                             float hit_tol, float thresh, float min_len, float* verts,
                             unsigned char* mask, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DIFFERT_TRACE_CASE(K, TPM)                                                           \
  if (order == K && tris_per_mirror == TPM)                                                  \
    return differt::launch<K, TPM>(tx, rx, mirrors, cand_tris, mesh, chunk_box, tile_box,    \
                                   num_tx, num_cand, num_rx, num_chunks, epsilon, hit_tol,   \
                                   thresh, min_len, verts, mask, s);
  DIFFERT_TRACE_CASE(1, 1)
  DIFFERT_TRACE_CASE(1, 2)
  DIFFERT_TRACE_CASE(2, 1)
  DIFFERT_TRACE_CASE(2, 2)
  DIFFERT_TRACE_CASE(3, 1)
  DIFFERT_TRACE_CASE(3, 2)
  DIFFERT_TRACE_CASE(4, 1)
  DIFFERT_TRACE_CASE(4, 2)
#undef DIFFERT_TRACE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
