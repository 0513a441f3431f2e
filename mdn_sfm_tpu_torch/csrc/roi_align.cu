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
// What bounds it on this card: bytes. Each output value reads 4 taps per
// sub-bin (16 at sampling 2) of 2 or 4 bytes, mostly from L2 (neighbouring bins
// share taps), and does ~60 FLOP; the least it must move is the output and the
// boxes. At the provider's shapes (B = 4, R = 256 at 7×7, R = 32 at 14×14,
// 256 channels) that is 25.7 MB and 6.4 MB of f32 output.
// What the design does about it:
// - One thread per (image, box, bin, channel), channel fastest, so a warp's
//   32 taps are 32 neighbouring channels of one feature pixel: every tap load
//   is coalesced (the features are channels-last, as the FPN leaves them).
// - The level is assigned per box in the kernel, and each box reads only its
//   own level (the TPU code resamples every box against all four levels and
//   selects; that is a matmul workaround this card does not need).
// - The box, its level and its sample coordinates are recomputed by each
//   thread: a few dozen FLOP against 16 loads, and no shared memory or
//   barrier is needed.
// Not used: TMA, wgmma, clusters. The work is a gather with no reuse pattern
// a tile copy could capture.
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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ int clip_index(float v, int hi) {
  int i = (int)v;  // v is already floored: the cast truncates to it
  return min(max(i, 0), hi - 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const __grid_constant__ Levels lv, const float* __restrict__ boxes, int num_boxes, int channels,
                 int out_size, int sampling, T* __restrict__ out, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total; idx += stride) {
    const int c = (int)(idx % channels);
    long long t = idx / channels;
    const int bx = (int)(t % out_size);
    t /= out_size;
    const int by = (int)(t % out_size);
    t /= out_size;  // t = image · num_boxes + box
    const int img = (int)(t / num_boxes);

    const float* box = boxes + t * 4;
    const float area = fmaxf(box[2] - box[0], 0.0f) * fmaxf(box[3] - box[1], 0.0f);
    float lvl = floorf(4.0f + log2f(sqrtf(area) / 224.0f + 1e-8f));
    lvl = fminf(fmaxf(lvl, 2.0f), 5.0f);
    const int li = (int)lvl - 2;
    const float scale = (float)(4 << li);
    const float x1 = box[0] / scale, y1 = box[1] / scale;
    const float x2 = box[2] / scale, y2 = box[3] / scale;
    const float bw = fmaxf(x2 - x1, 1e-6f);
    const float bh = fmaxf(y2 - y1, 1e-6f);
    const int h = lv.height[li], w = lv.width[li];
    const float n = (float)(out_size * sampling);
    const T* feat = static_cast<const T*>(lv.feat[li]) + (size_t)img * h * w * channels + c;

    float acc = 0.0f;
    for (int sy = 0; sy < sampling; ++sy) {
      const float ys = y1 + ((float)(by * sampling + sy) + 0.5f) * bh / n - 0.5f;
      const float y0 = floorf(ys);
      const float wy = ys - y0;
      const int ya = clip_index(y0, h), yb = clip_index(y0 + 1.0f, h);
      for (int sx = 0; sx < sampling; ++sx) {
        const float xs = x1 + ((float)(bx * sampling + sx) + 0.5f) * bw / n - 0.5f;
        const float x0 = floorf(xs);
        const float wx = xs - x0;
        const int xa = clip_index(x0, w), xb = clip_index(x0 + 1.0f, w);
        const float g00 = load_f(feat + ((size_t)ya * w + xa) * channels);
        const float g01 = load_f(feat + ((size_t)ya * w + xb) * channels);
        const float g10 = load_f(feat + ((size_t)yb * w + xa) * channels);
        const float g11 = load_f(feat + ((size_t)yb * w + xb) * channels);
        const float v = g00 * (1.0f - wy) * (1.0f - wx) + g01 * (1.0f - wy) * wx +
                        g10 * wy * (1.0f - wx) + g11 * wy * wx;
        acc = acc + v;
      }
    }
    store_f(out + idx, acc / (float)(sampling * sampling));
  }
}

template <typename T>
int launch(const Levels* lv, const float* boxes, int batch, int num_boxes, int channels, int out_size,
           int sampling, T* out, void* stream) {
  const long long total = (long long)batch * num_boxes * out_size * out_size * channels;
  if (total == 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1ll << 30)) blocks = 1ll << 30;  // the loop covers the rest
  roi_align_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *lv, boxes, num_boxes, channels, out_size, sampling, out, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lv: P2..P5 (batch, H_l, W_l, channels) contiguous, of the output's type;
// boxes (batch, num_boxes, 4) float32 contiguous, image coordinates; out
// (batch, num_boxes, out_size, out_size, channels), written whole.
int roi_align_f32(const Levels* lv, const float* boxes, int batch, int num_boxes, int channels, int out_size,
                  int sampling, float* out, void* stream) {
  return launch<float>(lv, boxes, batch, num_boxes, channels, out_size, sampling, out, stream);
}

int roi_align_bf16(const Levels* lv, const float* boxes, int batch, int num_boxes, int channels, int out_size,
                   int sampling, __nv_bfloat16* out, void* stream) {
  return launch<__nv_bfloat16>(lv, boxes, batch, num_boxes, channels, out_size, sampling, out, stream);
}

}  // extern "C"
