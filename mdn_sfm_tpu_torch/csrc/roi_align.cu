// Multilevel ROIAlign-v2 over P2..P5 — Hopper (sm_90a) counterpart of
// mdn_sfm_tpu/masks/maskrcnn.py::multilevel_roi_align, whose arithmetic its
// gather form multilevel_roi_align_gather and _roi_sample_box define (XLA
// code in the JAX package, not a Pallas kernel).
//
// For image i, box r (image coordinates, XYXY) and output bin (by, bx):
//     level = clip(floor(4 + log2(sqrt(area) / 224 + 1e-8)), 2, 5)
//     b     = box / 2^level   (feature coordinates, aligned=True)
//     for each of the sampling × sampling sub-bin centres (ys, xs):
//         ys = y1 + (k + 0.5)·max(y2 − y1, 1e-6) / (S·sampling) − 0.5
//         4-tap bilinear blend of the taps at floor(·) and floor(·)+1,
//         each tap index clipped to the level's [0, H−1] / [0, W−1]
//     out = mean of the sub-bin blends
// in the JAX package's operation order, accumulated in float32 (bf16 features
// are widened as they are read), written in the features' type.
//
// What bounds it on this card. Its byte bound is the feature pixels the taps
// touch, the boxes and the output (at the provider's box head, B = 4, R = 256,
// 7×7, C = 256 bf16: 47 MB, 0.014 ms at 3.35 TB/s); its operation bound about
// a third of that. The first design (a thread per output value) reached 0.03-
// 0.04 of it: held back by instructions and latency, not bytes. Each thread did
// three 64-bit divisions for its indices, recomputed its box's level and
// sample coordinates (a square root, a logarithm and six IEEE divisions under
// --fmad=false), and read 16 taps as 2-byte loads, 64 B a warp a load.
// What this design does about it:
// - A block per (image, box, group of bin rows): a group holds about 1024
//   (bin, vector) tasks (4 rows of the bf16 box head, 2 of its mask head), so
//   that even the mask head (32 boxes an image) fills the card.
//   Its prologue computes the box's level and, once, every sample row's and
//   column's clipped tap indices and blend weight into shared memory, in
//   exactly the operation order above, so the result stays bit-identical.
// - The body gives each thread one bin × 16 bytes of channels (8 bf16 or 4
//   f32): each tap is one 16-byte load and each output one 16-byte store, and
//   32 threads cover C = 256. A warp reads 512 contiguous bytes a tap.
// - The index arithmetic inside an image's level and a box's output is
//   32-bit: the wrapper refuses one image's level, or one box's output, of
//   2^31 elements or more. Only the bases of the image and the box are 64-bit.
// - A channel count that is not a multiple of the vector, or a level pointer
//   that is not 16-byte aligned, takes a scalar path inside the same kernel.
// Not used: TMA, wgmma, clusters. The work is a data-dependent gather with no
// tile product: the taps' addresses come from each box's coordinates.
// Reached (chip_smoke.py phase 8, H100 80GB HBM3 at 700 W): 0.052-0.055 ms at
// the box head, about a quarter of its byte bound (the one-thread-an-output
// design: 0.347 ms), 0.026-0.027 ms at the mask head, about a fifth of its
// operation bound (0.173 ms). What holds it there, estimated from the shapes
// and not measured apart: the taps are read again for every sub-bin (16
// 16-byte loads a task, 410 MB from L1 and L2 at the box head for its 47 MB of
// distinct bytes), and the blend is 12 unfused f32 operations a channel and
// sub-bin under --fmad=false.
//
// Built with --fmad=false: the coordinates and weights round as the plain
// version's separate PyTorch operations round them.
//
// The layout of Levels is mirrored field for field by a ctypes.Structure in
// ops/roi_align.py; the static_asserts below pin it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

struct Levels {
  const void* feat[4];  // P2..P5, each (N, H, W, C) contiguous
  int32_t height[4];
  int32_t width[4];
};
static_assert(sizeof(Levels) == 64, "Levels layout");
static_assert(offsetof(Levels, height) == 32, "Levels layout");
static_assert(offsetof(Levels, width) == 48, "Levels layout");

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 128;  // out_size · sampling a side (the wrapper checks it)
constexpr int kTasksPerBlock = 1024;  // about four (bin, vector) tasks a thread

__device__ __forceinline__ int clip_index(float v, int hi) {
  int i = (int)v;  // v is already floored: the cast truncates to it
  return min(max(i, 0), hi - 1);
}

// W consecutive channels as float, and back in the output's type (W = 1: the
// scalar path; otherwise one 16-byte access).
template <typename T, int W>
struct Vec;

template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* f) { f[0] = *p; }
  __device__ static void store(float* p, const float* f) { *p = f[0]; }
};

template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* f) { f[0] = __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, const float* f) { *p = __float2bfloat16_rn(f[0]); }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// One box's sample rows and columns, from the prologue. Static arrays: the
// body reads them at constant offsets from one base.
struct Taps {
  int ya[kMaxSamples], yb[kMaxSamples];  // clipped tap rows, times the level's width
  int xa[kMaxSamples], xb[kMaxSamples];  // clipped tap columns
  float wy[kMaxSamples], wx[kMaxSamples];
};

// Bins of rows [row0, row1) of one box: W channels a task, tasks strided over
// the block. feat: the box's level at its image; out: the box's first bin.
template <typename T, int W>
__device__ __forceinline__ void bins(const Taps& tp, const T* __restrict__ feat, T* __restrict__ out, int channels,
                                     int out_size, int sampling, int row0, int row1) {
  const int groups = channels / W;
  const int per_row = out_size * groups;
  const int tasks = (row1 - row0) * per_row;
  const float count = (float)(sampling * sampling);
  // x / 2^k and x · 2^-k are one real number, so they round to one float: a
  // power-of-two count (sampling 2: 4) divides as a multiply, exactly
  const bool pow2 = (sampling & (sampling - 1)) == 0;
  const float inv = 1.0f / count;
  for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
    const int by = row0 + task / per_row;
    const int rest = task - (by - row0) * per_row;
    const int bx = rest / groups;
    const int c = (rest - bx * groups) * W;
    float acc[W];
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = 0.0f;
    for (int sy = 0; sy < sampling; ++sy) {
      const int ky = by * sampling + sy;
      const int ya = tp.ya[ky], yb = tp.yb[ky];
      const float wy = tp.wy[ky];
      for (int sx = 0; sx < sampling; ++sx) {
        const int kx = bx * sampling + sx;
        const int xa = tp.xa[kx], xb = tp.xb[kx];
        const float wx = tp.wx[kx];
        float g00[W], g01[W], g10[W], g11[W];
        Vec<T, W>::load(feat + (ya + xa) * channels + c, g00);
        Vec<T, W>::load(feat + (ya + xb) * channels + c, g01);
        Vec<T, W>::load(feat + (yb + xa) * channels + c, g10);
        Vec<T, W>::load(feat + (yb + xb) * channels + c, g11);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const float v = g00[e] * (1.0f - wy) * (1.0f - wx) + g01[e] * (1.0f - wy) * wx +
                          g10[e] * wy * (1.0f - wx) + g11[e] * wy * wx;
          acc[e] = acc[e] + v;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) acc[e] = pow2 ? acc[e] * inv : acc[e] / count;
    Vec<T, W>::store(out + (by * out_size + bx) * channels + c, acc);
  }
}

// blockIdx.x: image · num_boxes + box; blockIdx.y: the group of bin rows.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const __grid_constant__ Levels lv, const float* __restrict__ boxes, int num_boxes, int channels,
                 int out_size, int sampling, int rows_per_block, bool vectorized, T* __restrict__ out) {
  __shared__ Taps tp;
  const int box_id = blockIdx.x;
  const int img = box_id / num_boxes;
  const float* box = boxes + (size_t)box_id * 4;
  const float area = fmaxf(box[2] - box[0], 0.0f) * fmaxf(box[3] - box[1], 0.0f);
  float lvl = floorf(4.0f + log2f(sqrtf(area) / 224.0f + 1e-8f));
  lvl = fminf(fmaxf(lvl, 2.0f), 5.0f);
  const int li = (int)lvl - 2;
  const int h = lv.height[li], w = lv.width[li];
  const int ns = out_size * sampling;
  for (int t = threadIdx.x; t < 2 * ns; t += blockDim.x) {
    const float scale = (float)(4 << li);
    const float n = (float)ns;
    const bool row = t < ns;
    const int k = row ? t : t - ns;
    const float lo = (row ? box[1] : box[0]) / scale;
    const float hi = (row ? box[3] : box[2]) / scale;
    const float span = fmaxf(hi - lo, 1e-6f);
    const float s = lo + ((float)k + 0.5f) * span / n - 0.5f;
    const float s0 = floorf(s);
    if (row) {
      tp.ya[k] = clip_index(s0, h) * w;
      tp.yb[k] = clip_index(s0 + 1.0f, h) * w;
      tp.wy[k] = s - s0;
    } else {
      tp.xa[k] = clip_index(s0, w);
      tp.xb[k] = clip_index(s0 + 1.0f, w);
      tp.wx[k] = s - s0;
    }
  }
  __syncthreads();
  const T* feat = static_cast<const T*>(lv.feat[li]) + (size_t)img * h * w * channels;
  T* o = out + (size_t)box_id * out_size * out_size * channels;
  const int row0 = blockIdx.y * rows_per_block;
  const int row1 = min(row0 + rows_per_block, out_size);
  if (vectorized)
    bins<T, W>(tp, feat, o, channels, out_size, sampling, row0, row1);
  else
    bins<T, 1>(tp, feat, o, channels, out_size, sampling, row0, row1);
}

template <typename T, int W>
int launch(const Levels* lv, const float* boxes, int batch, int num_boxes, int channels, int out_size,
           int sampling, T* out, void* stream) {
  const long long blocks = (long long)batch * num_boxes;
  if (blocks == 0 || channels == 0 || out_size == 0) return 0;
  if (out_size * sampling > kMaxSamples || sampling < 1 || blocks > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  bool vectorized = channels % W == 0;
  for (int l = 0; l < 4; ++l) vectorized = vectorized && (reinterpret_cast<uintptr_t>(lv->feat[l]) % 16 == 0);
  vectorized = vectorized && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int per_row = out_size * (vectorized ? channels / W : channels);
  const int rows = max(1, min(out_size, kTasksPerBlock / per_row));
  const dim3 grid((unsigned)blocks, (unsigned)((out_size + rows - 1) / rows));
  roi_align_kernel<T, W><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      *lv, boxes, num_boxes, channels, out_size, sampling, rows, vectorized, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lv: P2..P5 (batch, H_l, W_l, channels) contiguous, of the output's type,
// each image's level under 2^31 elements; boxes (batch, num_boxes, 4) float32
// contiguous, image coordinates; out (batch, num_boxes, out_size, out_size,
// channels), each box's under 2^31 elements, written whole. batch · num_boxes
// < 2^31; 1 ≤ sampling, out_size · sampling ≤ 128.
int roi_align_f32(const Levels* lv, const float* boxes, int batch, int num_boxes, int channels, int out_size,
                  int sampling, float* out, void* stream) {
  return launch<float, 4>(lv, boxes, batch, num_boxes, channels, out_size, sampling, out, stream);
}

int roi_align_bf16(const Levels* lv, const float* boxes, int batch, int num_boxes, int channels, int out_size,
                   int sampling, __nv_bfloat16* out, void* stream) {
  return launch<__nv_bfloat16, 8>(lv, boxes, batch, num_boxes, channels, out_size, sampling, out, stream);
}

}  // extern "C"
