// Batched greedy NMS with a static output size — Hopper (sm_90a) counterpart
// of mdn_sfm_tpu/masks/maskrcnn.py::nms_fixed, which the JAX package writes as
// an XLA fori_loop of max_out argmax/suppress rounds (not a Pallas kernel).
//
// For each image of the batch, over n boxes (already offset by level or class
// by the callers) and their scores:
//     alive = all; for each of max_out rounds:
//         j = argmax over alive scores (ties to the lower index);
//         if that score is not > -inf: this and every later slot is (0, false);
//         keep j; alive &= IoU(j, ·) <= thresh   (this retires j itself,
//                                                  unless box j has no area)
// keep (N, max_out) int32 and valid (N, max_out) uint8 are IDENTICAL to
// nms_fixed's: IoU is computed as iou_matrix computes it (max(·, 0) areas,
// +1e-12, the same operation order, no contracted multiply-adds under
// --fmad=false), and a box survives at IoU <= thresh.
//
// What bounds it on this card: neither bytes (n·20 B in, max_out·5 B out) nor
// operations (≤ max_out·n IoUs, ~20 FLOP each): the rounds are sequential, so
// it is bound by the latency of one round (two block barriers). In eager
// PyTorch each round is ~6 launches; here the whole stage is one launch.
// What the design does about it:
// - One block per image, one launch per NMS stage for the whole batch.
// - The block sorts (score, index) keys once, descending score and ascending
//   index (a bitonic sort of up to 8192 64-bit keys in shared memory), so
//   "argmax of the alive scores, ties to the lower index" becomes "the first
//   alive position in sorted order". A NaN score sorts first, as jnp.argmax
//   takes a NaN for the maximum; -0.0 is read as +0.0, which it equals.
// - The boxes are gathered into shared memory in sorted order, and the alive
//   set is a bitmask there (one bit a box). Each round, warp 0 finds the first
//   alive bit with ballots over 32 words at a time, starting from the last
//   round's word (the first alive position never moves back); then every
//   thread computes the IoU of the chosen box against its share of the later
//   positions and clears their bits with a shared-memory atomicAnd.
// - A box with no area keeps itself alive (IoU 0/1e-12 = 0 <= thresh) and is
//   chosen again every later round, exactly as nms_fixed repeats it.
// Not used: TMA, wgmma, clusters — nothing here is a tile product or a stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBoxes = 8192;  // one block's shared memory: keys, boxes, bitmask

__host__ __device__ constexpr size_t smem_bytes(int padded, int n) {
  return (size_t)padded * sizeof(unsigned long long) + (size_t)n * 4 * sizeof(float) +
         (size_t)((n + 31) / 32) * sizeof(uint32_t);
}

// Ascending order of the key = descending score, then ascending index.
__device__ __forceinline__ unsigned long long sort_key(float s, int i) {
  uint32_t asc;
  if (s != s) {
    asc = 0xFFFFFFFFu;  // NaN above +inf
  } else {
    uint32_t b = s == 0.0f ? 0u : __float_as_uint(s);  // -0.0 ties with +0.0
    asc = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return ((unsigned long long)(~asc) << 32) | (uint32_t)i;
}

__device__ __forceinline__ float box_area(const float* b) {
  return fmaxf(b[2] - b[0], 0.0f) * fmaxf(b[3] - b[1], 0.0f);
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int n, int padded,
           int max_out, float thresh, int32_t* __restrict__ keep, uint8_t* __restrict__ valid) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;                                    // [padded]
  float* sbox = reinterpret_cast<float*>(keys + padded);              // [n][4], sorted order
  uint32_t* alive = reinterpret_cast<uint32_t*>(sbox + 4 * (size_t)n);  // [ceil(n / 32)]
  __shared__ int s_pos;
  __shared__ int s_word;

  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int nwords = (n + 31) / 32;
  const float* ib = boxes + (size_t)img * n * 4;
  const float* is = scores + (size_t)img * n;
  int32_t* ok = keep + (size_t)img * max_out;
  uint8_t* ov = valid + (size_t)img * max_out;

  for (int i = tid; i < padded; i += blockDim.x)
    keys[i] = i < n ? sort_key(is[i], i) : ~0ull;
  for (int w = tid; w < nwords; w += blockDim.x)
    alive[w] = (w + 1) * 32 <= n ? 0xFFFFFFFFu : (1u << (n - w * 32)) - 1u;
  if (tid == 0) s_word = 0;
  __syncthreads();

  // bitonic sort, ascending
  for (int k = 2; k <= padded; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < padded; i += blockDim.x) {
        int p = i ^ j;
        if (p > i) {
          unsigned long long a = keys[i], b = keys[p];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += blockDim.x) {
    const float* src = ib + (size_t)(uint32_t)keys[i] * 4;
    sbox[4 * i + 0] = src[0];
    sbox[4 * i + 1] = src[1];
    sbox[4 * i + 2] = src[2];
    sbox[4 * i + 3] = src[3];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int r = 0; r < max_out; ++r) {
    if (warp == 0) {
      int w = s_word, pos = -1;
      while (w < nwords) {
        uint32_t word = (w + lane < nwords) ? alive[w + lane] : 0u;
        unsigned ball = __ballot_sync(0xFFFFFFFFu, word != 0u);
        if (ball) {
          int l = __ffs(ball) - 1;
          uint32_t wd = __shfl_sync(0xFFFFFFFFu, word, l);
          w += l;
          pos = w * 32 + __ffs(wd) - 1;
          break;
        }
        w += 32;
      }
      if (lane == 0) {
        s_pos = pos;
        s_word = w;
      }
    }
    __syncthreads();
    const int pos = s_pos;
    const int idx = pos >= 0 ? (int)(uint32_t)keys[pos] : 0;
    const float sc = pos >= 0 ? is[idx] : -INFINITY;
    if (!(sc > -INFINITY)) {  // nothing alive, or the best is -inf or NaN
      for (int i = r + tid; i < max_out; i += blockDim.x) {
        ok[i] = 0;
        ov[i] = 0;
      }
      return;
    }
    if (tid == 0) {
      ok[r] = idx;
      ov[r] = 1;
    }
    const float* a = sbox + 4 * pos;
    const float area_a = box_area(a);
    // positions before pos are dead; pos itself is tested (its self-IoU)
    for (int k = pos + tid; k < n; k += blockDim.x) {
      const float* b = sbox + 4 * k;
      float w = fmaxf(fminf(a[2], b[2]) - fmaxf(a[0], b[0]), 0.0f);
      float h = fmaxf(fminf(a[3], b[3]) - fmaxf(a[1], b[1]), 0.0f);
      float inter = w * h;
      float iou = inter / (area_a + box_area(b) - inter + 1e-12f);
      if (!(iou <= thresh)) atomicAnd(&alive[k >> 5], ~(1u << (k & 31)));
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) float32, scores (batch, n) float32, both contiguous;
// keep (batch, max_out) int32 and valid (batch, max_out) uint8, written whole.
// Launches on `stream` and returns cudaGetLastError() of the launch (or
// cudaErrorInvalidValue for arguments it does not take).
int nms_fixed_f32(const float* boxes, const float* scores, int batch, int n, int max_out, float thresh,
                  int32_t* keep, uint8_t* valid, void* stream) {
  if (batch <= 0 || max_out <= 0) return 0;
  if (n < 1 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(kMaxBoxes, kMaxBoxes));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  int padded = 1;
  while (padded < n) padded <<= 1;
  nms_kernel<<<batch, kThreads, smem_bytes(padded, n), (cudaStream_t)stream>>>(
      boxes, scores, n, padded, max_out, thresh, keep, valid);
  return (int)cudaGetLastError();
}

int nms_max_boxes() { return kMaxBoxes; }

}  // extern "C"
