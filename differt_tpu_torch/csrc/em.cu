// EM tile kernel for Hopper (sm_90a): a coverage tile's Jones chain and its
// per-pixel sum in one pass, for tiles that need no gradient.
//
// Replaces no TPU kernel. The JAX package leaves the chain
// (differt_tpu/coverage.py::complex_amplitudes) to XLA, which fuses it. The
// port's plain chain (differt_tpu_torch/coverage.py::complex_amplitudes) runs
// as some 700 elementwise launches a tile, each reading and writing a whole
// [T, R, C] intermediate in device memory. This kernel computes what
// complex_amplitudes(...).sum(-1) computes per [tx, rx] pixel (or, for an
// incoherent map, the sum of |a|^2), from the trace's vertices and mask, and
// writes nothing per path.
//
// Per valid path (t, c, r): each segment's direction and length; per bounce
// whose interaction type is 0, the spherical frames, the (s, p) directions
// with their normal-incidence fallback and the slab reflection coefficients
// (the half-space where the thickness is negative); then the last frame, 1/s,
// the propagation phase and lambda / 4 pi. The operations are the plain
// chain's, in its order, built without fused multiply-adds (--fmad=false).
// Complex products and quotients follow c10::complex, the complex root and
// exponential thrust's csqrtf and cexpf, which PyTorch's CUDA build calls;
// real scalars divide as PyTorch divides a tensor by a Python number on the
// card (times the reciprocal). So the phase, which reaches 10^4 radians,
// matches to the bit, and the rest to float32 rounding. A path whose
// geometry is non-finite or has a segment of squared length 1e-12 or less
// weighs 0, as the plain chain's dummy paths do.
//
// What bounds it on the H100: bytes, and the special functions of the paths
// that survive. A path needs its mask byte and, if it is valid, its
// (k+2)*12 bytes of vertices; an invalid path's vertices are never read. At
// city scale most paths are invalid, so a tile reads little more than its
// mask.
//
// The design:
// - A block is one TX, kRx receivers (one lane each: the trace writes
//   [Ntx, C, Nrx, k+2, 3], so neighbouring lanes read neighbouring mask bytes
//   and vertices) and a range of candidates shared by kWarps warps, warp w
//   taking every kWarps-th candidate. Each lane sums its paths in candidate
//   order; the state carried from bounce to bounce is two complex numbers
//   and one direction, so every order runs the same loop.
// - Each candidate's rows (per bounce: the face's normal, its material's
//   refractive index and thickness, whether it reflects) are staged in
//   shared memory once per block, up to kMaxStage candidates at a time, from
//   the [C, k] objects and types, the mesh's normals and face materials and
//   the [M, 3] material table; the expanded [T, R, C, k+2] objects are never
//   read.
// - The sum over candidates has a fixed order: each lane in candidate order,
//   then the warps in order, through shared memory; where the candidates are
//   split over several blocks to fill the card, a second kernel sums the
//   splits in order. Every launch gives the same bits.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace differt {
namespace {

constexpr int kRx = 32;      // Receivers of a block: one lane each.
constexpr int kWarps = 8;    // Warps of a block, sharing its candidates.
constexpr int kEmThreads = kRx * kWarps;
constexpr int kRowBytes = 32;  // A staged bounce: normal, n_r (re, im), thickness, reflects, pad.
// The rows' stage: what a block takes without opting in (48 KB), less the warps' sums.
constexpr int kStageBytes = 49152 - kWarps * kRx * 2 * 4;
constexpr int kMaxStage = 256;      // Candidates staged at once.
constexpr int kTargetBlocks = 132 * 8;  // Blocks that fill the card (132 SMs).
constexpr int kMinSplit = 64;       // Candidates a block takes at least where they are split.

// Python numbers as PyTorch's CUDA kernels take them: a factor cast to
// float32, a divisor as its reciprocal, taken in double and cast.
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kC = 299792458.0f;
constexpr float kInvC = static_cast<float>(1.0 / 299792458.0);               // x / c
constexpr float kInvFourPi = static_cast<float>(1.0 / 12.566370614359172);  // x / (4 pi)

struct Cx {
  float re, im;
};

__device__ __forceinline__ Cx cadd(Cx a, Cx b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ Cx csub(Cx a, Cx b) { return {a.re - b.re, a.im - b.im}; }
// c10::complex's product.
__device__ __forceinline__ Cx cmul(Cx a, Cx b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// A real tensor times a complex one: PyTorch takes the real as x + 0i, which
// for finite values gives this product.
__device__ __forceinline__ Cx scale(float x, Cx a) { return {x * a.re, x * a.im}; }

// c10::complex's quotient (numpy's).
__device__ Cx cdiv(Cx x, Cx y) {
  const float a = x.re, b = x.im, c = y.re, d = y.im;
  const float abs_c = fabsf(c), abs_d = fabsf(d);
  if (abs_c >= abs_d) {
    if (abs_c == 0.0f && abs_d == 0.0f) return {a / abs_c, b / abs_d};
    const float rat = d / c;
    const float scl = 1.0f / (c + d * rat);
    return {(a + b * rat) * scl, (b - a * rat) * scl};
  }
  const float rat = c / d;
  const float scl = 1.0f / (d + c * rat);
  return {(a * rat + b) * scl, (b * rat - a) * scl};
}

// utils.safe_divide on complex numbers: 0 where the denominator is 0.
__device__ __forceinline__ Cx csafe_div(Cx num, Cx den) {
  const bool zero = den.re == 0.0f && den.im == 0.0f;
  const Cx out = cdiv(num, zero ? Cx{1.0f, 0.0f} : den);
  return zero ? Cx{0.0f, 0.0f} : out;
}

// thrust's csqrtf (Algorithm 312, CACM vol. 10, 1967, with its scaling).
__device__ Cx csqrt(Cx z) {
  float a = z.re, b = z.im;
  if (a == 0.0f && b == 0.0f) return {0.0f, b};
  if (isinf(b)) return {CUDART_INF_F, b};
  if (isnan(a)) {
    const float t = (b - b) / (b - b);
    return {a, t};
  }
  if (isinf(a)) {
    if (signbit(a)) return {fabsf(b - b), copysignf(a, b)};
    return {a, copysignf(b - b, b)};
  }
  constexpr float kThresh = 1.40949553037932e+38f;  // FLT_MAX / (1 + sqrt(2))
  constexpr float kLowThresh = 2.35098870164458e-38f;  // FLT_MIN * 2
  int scaled = 0;
  if (fabsf(a) >= kThresh || fabsf(b) >= kThresh) {
    a *= 0.25f;
    b *= 0.25f;
    scaled = 1;
  } else if (fabsf(a) <= kLowThresh && fabsf(b) <= kLowThresh) {
    a *= 4.0f;
    b *= 4.0f;
    scaled = 2;
  }
  Cx result;
  if (a >= 0.0f) {
    const float t = sqrtf((a + hypotf(a, b)) * 0.5f);
    result = {t, b / (2.0f * t)};
  } else {
    const float t = sqrtf((-a + hypotf(a, b)) * 0.5f);
    result = {fabsf(b) / (2.0f * t), copysignf(t, b)};
  }
  if (scaled == 1) return {result.re * 2.0f, result.im * 2.0f};
  if (scaled == 2) return {result.re * 0.5f, result.im * 0.5f};
  return result;
}

// thrust's cexpf, less its rescaling of real parts in [88.7, 192] (the slab
// branch's real part, 2 k t Im(sqrt(n^2 - sin^2)), is not positive for a
// lossy or lossless medium).
__device__ Cx cexp(Cx z) {
  const float x = z.re, y = z.im;
  if (y == 0.0f) return {expf(x), y};
  if (x == 0.0f) return {cosf(y), sinf(y)};
  const float exp_x = expf(x);
  return {exp_x * cosf(y), exp_x * sinf(y)};
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
// utils.dot3 and utils.cross3, in their order of operations.
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// utils.normalize3: the unit vector and the length (0, and the vector itself, where it is 0).
__device__ __forceinline__ V3 normalize3(V3 a, float* length) {
  const float sq = dot3(a, a);
  const bool zero = sq == 0.0f;
  const float n = sqrtf(sq + (zero ? 1.0f : 0.0f));
  *length = zero ? sq : n;
  return {a.x / n, a.y / n, a.z / n};
}

__device__ __forceinline__ V3 unit3(V3 a) {
  float length;
  return normalize3(a, &length);
}

// utils.spherical3: theta_hat and phi_hat of a direction.
struct Frame {
  V3 th, ph;
};

__device__ Frame spherical3(V3 k) {
  const float s_sq = k.x * k.x + k.y * k.y;
  const bool degenerate = s_sq < 1e-12f;
  const float s = sqrtf(degenerate ? 1.0f : s_sq);
  const float cos_p = degenerate ? 1.0f : k.x / s;
  const float sin_p = degenerate ? 0.0f : k.y / s;
  const float s_out = degenerate ? 0.0f : s;
  return {{k.z * cos_p, k.z * sin_p, -s_out}, {-sin_p, cos_p, 0.0f}};
}

// utils.perpendicular3.
__device__ V3 perpendicular3(V3 u) {
  const bool pick_a = fabsf(u.x) > fabsf(u.y);
  const V3 cand = {pick_a ? -u.y : 0.0f, pick_a ? u.x : -u.z, pick_a ? 0.0f : u.y};
  return unit3(cross3(u, cand));
}

// em._fresnel.slab_reflection_coefficients at one bounce.
__device__ void slab_reflection(Cx n_r, float cos_i, float thickness, float wavelength, Cx* r_s,
                                Cx* r_p) {
  const float ci = fabsf(cos_i);
  const Cx n_sq = cmul(n_r, n_r);
  const Cx ct = csqrt({(n_sq.re + ci * ci) - 1.0f, n_sq.im});
  Cx rs = csafe_div({ci - ct.re, -ct.im}, {ci + ct.re, ct.im});
  const Cx incident_p = scale(ci, n_sq);
  Cx rp = csafe_div(csub(incident_p, ct), cadd(incident_p, ct));
  if (thickness >= 0.0f) {
    const float sin_sq = 1.0f - cos_i * cos_i;
    const Cx a = csqrt({n_sq.re - sin_sq, n_sq.im});
    const Cx q = scale((kTwoPi * thickness) / wavelength, a);
    const Cx phase = cexp(cmul(q, {-0.0f, -2.0f}));
    const Cx one_less = {1.0f - phase.re, -phase.im};
    const Cx rs_sq = cmul(cmul(rs, rs), phase);
    const Cx rp_sq = cmul(cmul(rp, rp), phase);
    rs = csafe_div(cmul(rs, one_less), {1.0f - rs_sq.re, -rs_sq.im});
    rp = csafe_div(cmul(rp, one_less), {1.0f - rp_sq.re, -rp_sq.im});
  }
  *r_s = rs;
  *r_p = rp;
}

// A path's point l, read through the read-only cache.
__device__ __forceinline__ V3 point(const float* __restrict__ v, int l) {
  return {__ldg(v + 3 * l), __ldg(v + 3 * l + 1), __ldg(v + 3 * l + 2)};
}

__device__ __forceinline__ bool usable(V3 p) { return isfinite(p.x) && isfinite(p.y) && isfinite(p.z); }

// The amplitude of one path (coverage.complex_amplitudes); *ok is false where
// its geometry is not usable (the plain chain's dummy path, of weight 0).
__device__ Cx path_amplitude(const float* __restrict__ v, int order, const float4* rows,
                             float p1, float wavelength, float amp_scale, bool* ok) {
  V3 prev = point(v, 0);
  bool good = usable(prev);
  V3 next = point(v, 1);
  good = good && usable(next);
  V3 d = sub3(next, prev);
  good = good && (d.x * d.x + d.y * d.y + d.z * d.z) > 1e-12f;
  float s_tot;
  V3 k_in = normalize3(d, &s_tot);
  Frame f_in = spherical3(k_in);
  Cx e_theta = {1.0f, 0.0f}, e_phi = {0.0f, 0.0f};
  for (int b = 0; b < order; ++b) {
    prev = next;
    next = point(v, b + 2);
    good = good && usable(next);
    d = sub3(next, prev);
    good = good && (d.x * d.x + d.y * d.y + d.z * d.z) > 1e-12f;
    float s_len;
    const V3 k_out = normalize3(d, &s_len);
    s_tot = s_tot + s_len;
    const Frame f_out = spherical3(k_out);
    const float4 r0 = rows[2 * b], r1 = rows[2 * b + 1];
    if (r1.z != 0.0f) {  // a reflection: the Jones chain's bounce
      const V3 normal = {r0.x, r0.y, r0.z};
      V3 e_i_s;
      {
        float norm;
        e_i_s = normalize3(cross3(k_in, normal), &norm);
        if (norm == 0.0f) e_i_s = perpendicular3(k_in);
      }
      const V3 e_i_p = unit3(cross3(e_i_s, k_in));
      const V3 e_r_p = unit3(cross3(e_i_s, k_out));
      const float cos_i = -dot3(normal, k_in);
      Cx r_s, r_p;
      slab_reflection({r0.w, r1.x}, cos_i, r1.y, wavelength, &r_s, &r_p);
      const Cx f_s = cmul(r_s, cadd(scale(dot3(e_i_s, f_in.th), e_theta),
                                    scale(dot3(e_i_s, f_in.ph), e_phi)));
      const Cx f_p = cmul(r_p, cadd(scale(dot3(e_i_p, f_in.th), e_theta),
                                    scale(dot3(e_i_p, f_in.ph), e_phi)));
      e_theta = cadd(scale(dot3(f_out.th, e_i_s), f_s), scale(dot3(f_out.th, e_r_p), f_p));
      e_phi = cadd(scale(dot3(f_out.ph, e_i_s), f_s), scale(dot3(f_out.ph, e_r_p), f_p));
    }
    k_in = k_out;
    f_in = f_out;
  }
  const Frame f_neg = spherical3({-k_in.x, -k_in.y, -k_in.z});
  Cx a = scale(dot3(f_in.th, f_neg.th), e_theta);
  a = scale(1.0f / s_tot, a);
  const float phase = (p1 * s_tot) * kInvC;
  a = cmul(a, {cosf(phase), sinf(phase)});
  *ok = good;
  return scale(amp_scale, a);
}

__global__ void __launch_bounds__(kEmThreads)
    em_kernel(const float* __restrict__ verts, const unsigned char* __restrict__ mask,
              const long long* __restrict__ objects, const int* __restrict__ types,
              const float* __restrict__ normals, const long long* __restrict__ face_materials,
              const float* __restrict__ materials, int num_materials,
              const float* __restrict__ frequency, int order, int num_tx, int num_cand,
              int num_rx, long long vs_t, long long vs_c, long long vs_r, long long ms_t,
              long long ms_c, long long ms_r, int coherent, int splits, int stage,
              long long block0, float* __restrict__ out) {
  extern __shared__ float4 s_rows[];  // [stage][order][2]
  __shared__ float s_red[kWarps][kRx][2];
  const int groups = (num_rx + kRx - 1) / kRx;
  const long long block = block0 + blockIdx.x;
  const int g = static_cast<int>(block % groups);
  const int split = static_cast<int>((block / groups) % splits);
  const int t = static_cast<int>(block / (static_cast<long long>(groups) * splits));
  const int lane = threadIdx.x % kRx, warp = threadIdx.x / kRx;
  const int r = g * kRx + lane;
  const int per_split = (num_cand + splits - 1) / splits;
  const int c_begin = split * per_split;
  const int c_end = min(num_cand, c_begin + per_split);

  // Scalars as complex_amplitudes computes them from the frequency.
  const float f = __ldg(frequency);
  const float wavelength = (1.0f / f) * kC;  // c / frequency: reciprocal, then times c
  const float amp_scale = wavelength * kInvFourPi;
  const float p1 = -kTwoPi * f;  // -2 pi * frequency

  float acc_re = 0.0f, acc_im = 0.0f;
  for (int s0 = c_begin; s0 < c_end; s0 += stage) {
    const int n = min(stage, c_end - s0);
    __syncthreads();  // the last stage's rows are read
    for (int i = threadIdx.x; i < n * order; i += kEmThreads) {
      const long long row = static_cast<long long>(s0) * order + i;
      float4 r0 = {0.0f, 0.0f, 0.0f, 0.0f}, r1 = {0.0f, 0.0f, 0.0f, 0.0f};
      if (types[row] == 0) {
        // A padded bounce's object (-1) reads row 0, as complex_amplitudes' gather does.
        const long long obj = max(objects[row], 0LL);
        long long mat = 0;
        if (face_materials != nullptr) {
          mat = min(max(face_materials[obj], 0LL), static_cast<long long>(num_materials - 1));
        }
        r0 = {normals[3 * obj], normals[3 * obj + 1], normals[3 * obj + 2], materials[3 * mat]};
        r1 = {materials[3 * mat + 1], materials[3 * mat + 2], 1.0f, 0.0f};
      }
      s_rows[2 * i] = r0;
      s_rows[2 * i + 1] = r1;
    }
    __syncthreads();
    if (r < num_rx) {
      for (int j = warp; j < n; j += kWarps) {
        const int c = s0 + j;
        if (!mask[t * ms_t + c * ms_c + r * ms_r]) continue;
        bool ok;
        const Cx a = path_amplitude(verts + t * vs_t + c * vs_c + r * vs_r, order,
                                    s_rows + 2 * j * order, p1, wavelength, amp_scale, &ok);
        if (!ok) continue;
        if (coherent) {
          acc_re += a.re;
          acc_im += a.im;
        } else {
          const float h = hypotf(a.re, a.im);
          acc_re += h * h;
        }
      }
    }
  }
  s_red[warp][lane][0] = acc_re;
  s_red[warp][lane][1] = acc_im;
  __syncthreads();
  if (warp == 0 && r < num_rx) {
    float re = s_red[0][lane][0], im = s_red[0][lane][1];
    for (int w = 1; w < kWarps; ++w) {
      re += s_red[w][lane][0];
      im += s_red[w][lane][1];
    }
    const long long pixel = (static_cast<long long>(split) * num_tx + t) * num_rx + r;
    if (coherent) {
      out[2 * pixel] = re;
      out[2 * pixel + 1] = im;
    } else {
      out[pixel] = re;
    }
  }
}

// The splits' partial sums, added in split order.
__global__ void em_splits_kernel(const float* __restrict__ partial, int splits, long long size,
                                 float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float sum = partial[i];
  for (int s = 1; s < splits; ++s) sum += partial[s * size + i];
  out[i] = sum;
}

int split_count(int num_tx, int num_cand, int num_rx) {
  const long long groups = std::max(1LL, static_cast<long long>(num_tx) * ((num_rx + kRx - 1) / kRx));
  const long long want = (kTargetBlocks + groups - 1) / groups;
  const long long most = (static_cast<long long>(num_cand) + kMinSplit - 1) / kMinSplit;
  return static_cast<int>(std::max(1LL, std::min(want, most)));
}

}  // namespace
}  // namespace differt

// Blocks a tile's candidates are split over: the partial sums the wrapper
// allocates ([splits, num_tx, num_rx], complex or real) where it is above 1.
extern "C" int differt_em_splits(int num_tx, int num_cand, int num_rx) {
  return differt::split_count(num_tx, num_cand, num_rx);
}

// A tile's per-pixel sums: out [num_tx, num_rx] complex (coherent) or real.
// verts [num_tx, *, *, order + 2, 3] and mask [num_tx, *, *] take the strides
// (in elements) of their TX, candidate and receiver axes; objects and types
// are [num_cand, order], normals [num_tri, 3], face_materials [num_tri] or
// null, materials [num_materials, 3] (n_r real and imaginary, thickness),
// frequency one float on the device. partial holds [splits, num_tx, num_rx]
// sums where splits (differt_em_splits) is above 1, and may be null otherwise.
extern "C" int differt_em(const float* verts, const unsigned char* mask, const long long* objects,
                          const int* types, const float* normals, const long long* face_materials,
                          const float* materials, int num_materials, const float* frequency,
                          int order, int num_tx, int num_cand, int num_rx, long long vs_t,
                          long long vs_c, long long vs_r, long long ms_t, long long ms_c,
                          long long ms_r, int coherent, float* partial, float* out, void* stream) {
  using namespace differt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (order < 0 || num_materials < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = kRowBytes * order;
  const int stage = order == 0 ? kMaxStage : std::min(kMaxStage, kStageBytes / row_bytes);
  if (stage < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = split_count(num_tx, num_cand, num_rx);
  if (splits > 1 && partial == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* sums = splits > 1 ? partial : out;
  const long long groups = (num_rx + kRx - 1) / kRx;
  const long long blocks = groups * splits * num_tx;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(stage) * row_bytes;
  // One launch per 2^31 - 1 blocks (grid.x's limit), so that no shape is refused.
  for (long long block0 = 0; block0 < blocks; block0 += 0x7fffffffLL) {
    const unsigned grid = static_cast<unsigned>(blocks - block0 < 0x7fffffffLL ? blocks - block0
                                                                                : 0x7fffffffLL);
    em_kernel<<<grid, kEmThreads, smem, s>>>(
        verts, mask, objects, types, normals, face_materials, materials, num_materials, frequency,
        order, num_tx, num_cand, num_rx, vs_t, vs_c, vs_r, ms_t, ms_c, ms_r, coherent, splits,
        stage, block0, sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (splits > 1) {
    const long long size = static_cast<long long>(num_tx) * num_rx * (coherent ? 2 : 1);
    const unsigned grid = static_cast<unsigned>((size + 255) / 256);
    em_splits_kernel<<<grid, 256, 0, s>>>(partial, splits, size, out);
  }
  return static_cast<int>(cudaGetLastError());
}
