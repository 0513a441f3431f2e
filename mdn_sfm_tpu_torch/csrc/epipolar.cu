// |epipolar residual| map — Hopper (sm_90a) port of the Pallas TPU kernel
// mdn_sfm_tpu/ops/pallas_epipolar.py::_kernel, launched there by
// epipolar_abs_residual_pallas.
//
// For each pixel, with p1 = (x, y, 1), l = F·p1 and p2 = p1 + (u, v):
//     out = |l·p2| / (sqrt(l0² + l1² + 1e-10) + 1e-10)
// F = inv_Kᵀ [t]ₓ R inv_K (B, 9) is built by the caller on the device.
//
// What bounds it on this card: each pixel reads 8 B of flow and writes 4 B,
// at about 20 FLOP, so it is bound by memory and by launches. At the main
// path's four scales (B = 4, 192×640 … 24×80, two reference frames) that is
// about 15.7 MB a step, some 4.7 µs at 3.35 TB/s, so the 8 launches a step
// cost more than their bytes.
// What the design does about it: one pass over the flow, no intermediates —
// one thread per output pixel, coordinates from the thread index, F held in
// registers. The flow comes in as a (B, H, W, 2) view with four strides, so
// any layout (dense NHWC, or a permuted view of NCHW) is read in place. On
// the main path the loss first scales the networks' normalized flow by
// [W, H], which writes a dense NHWC copy before each launch; folding that
// scale into the kernel, and batching the 8 launches into one, are left for
// later.
// It is built with --fmad=false and evaluates the terms in the plain
// version's order (ops/epipolar.py), so each value rounds exactly as the
// plain PyTorch ops round it; near the epipole, where l0 and l1 cancel, a
// contracted multiply-add would otherwise move the residual by up to the
// flow's size. The map is memory-bound, so the FMAs buy nothing here.
//
// Grid: (ceil(H·W / 256), B); each block belongs to one batch row. The ragged
// edge is masked, so any H and W work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
epipolar_abs_residual_kernel(const float* __restrict__ F,
                             const float* __restrict__ flow,
                             int64_t sb, int64_t sh, int64_t sw, int64_t sc,
                             float* __restrict__ out, int H, int W) {
  const int b = blockIdx.y;
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;

  const float* f = F + 9 * b;
  const float f0 = __ldg(f + 0), f1 = __ldg(f + 1), f2 = __ldg(f + 2);
  const float f3 = __ldg(f + 3), f4 = __ldg(f + 4), f5 = __ldg(f + 5);
  const float f6 = __ldg(f + 6), f7 = __ldg(f + 7), f8 = __ldg(f + 8);

  const int yi = (int)(p / W);
  const int xi = (int)(p - (int64_t)yi * W);
  const float x = (float)xi;
  const float y = (float)yi;

  const float* fl = flow + b * sb + yi * sh + xi * sw;
  const float u = __ldg(fl);
  const float v = __ldg(fl + sc);

  const float l0 = f0 * x + f1 * y + f2;
  const float l1 = f3 * x + f4 * y + f5;
  const float l2 = f6 * x + f7 * y + f8;
  const float num = l0 * (x + u) + l1 * (y + v) + l2;
  const float den = sqrtf(l0 * l0 + l1 * l1 + 1e-10f) + 1e-10f;
  out[b * hw + p] = fabsf(num / den);
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; strides are
// in elements of the (B, H, W, 2) flow view. Returns cudaGetLastError().
extern "C" int epipolar_abs_residual_f32(const void* F, const void* flow,
                                         int64_t sb, int64_t sh, int64_t sw,
                                         int64_t sc, void* out, int B, int H,
                                         int W, void* stream) {
  const int64_t hw = (int64_t)H * W;
  if (B > 0 && hw > 0) {
    dim3 grid((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)B);
    epipolar_abs_residual_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)F, (const float*)flow, sb, sh, sw, sc, (float*)out, H, W);
  }
  return (int)cudaGetLastError();
}
