// |epipolar residual| maps — Hopper (sm_90a) port of the Pallas TPU kernel
// mdn_sfm_tpu/ops/pallas_epipolar.py::_kernel, launched there by
// epipolar_abs_residual_pallas.
//
// For each pixel of each map, with p1 = (x, y, 1), l = F·p1 and
// p2 = p1 + (sx·u, sy·v):
//     out = |l·p2| / (sqrt(l0² + l1² + 1e-10) + 1e-10)
// F = inv_Kᵀ [t]ₓ R inv_K per image, and (sx, sy) turns the networks'
// normalized flow into pixels. The TPU kernel computes one map per call;
// this one computes every map of a train step (2 reference frames × 4
// scales on the main path) in one launch.
//
// What bounds it on this card: each pixel reads 8 B of flow and writes 4 B,
// at about 26 FLOP, so it is bound by memory. At the main path's 8 maps
// (B = 4, 192×640 … 24×80) that is about 15.7 MB a step, some 4.7 µs at
// 3.35 TB/s — less than the launch floor of the three smaller scales if each
// map had a launch of its own.
// What the design does about it:
// - One launch over a table of segments (one segment = one map). The table
//   is one __grid_constant__ struct in the kernel's parameter space, so the
//   call copies nothing to the device. No block straddles two images: a
//   block finds its segment by a binary search of the segments' first
//   blocks, then its image and its tile within the image.
// - F is built in the block's prologue from each segment's inv_K, R and t,
//   read in place through their strides (R and t may be views into a 4×4
//   pose). Nine threads each compute one entry into shared memory, in
//   geometry.fundamental_matrix's order; the flow loads are issued before
//   the prologue, so their latency hides the prologue's.
// - The scale to pixels is a multiply on the flow as it is read: no scaled
//   copy of the flow is written before the launch.
// - A segment whose flow has two pixels' (u, v) contiguous and 16-byte
//   aligned (w-stride 2, c-stride 1, even W: the networks' channels-last
//   output, even as a deinterleaved view) takes the vector path: one
//   float4 load and one float2 store for two pixels. Any other strides take
//   the scalar path, one pixel an item; both mask the ragged edge.
// - Each thread issues kItems loads before it waits on any, so a block keeps
//   many bytes in flight and lives long enough to amortize its prologue (at
//   one pixel pair a thread the blocks were short and latency-bound; 2 and
//   8 items, F built per warp without the barrier, streaming cache hints
//   and 128-thread blocks all timed slower than 4 items on the H100).
// - The per-pixel arithmetic (IEEE division and square root, no contracted
//   multiply-adds) takes issue slots that a plain streaming pass does not,
//   so the segment lookup is a binary search. A pixel's row is p / W on a
//   64-bit index, so a map may have any H·W.
// Not used: TMA, wgmma and clusters. The map is a streaming elementwise pass
// (about 26 FLOP per 12 bytes) with nothing to stage or reuse.
//
// It is built with --fmad=false and evaluates F and the map in the plain
// version's order (ops/epipolar.py, geometry.py), so each value rounds as the
// plain PyTorch ops round it; near the epipole, where l0 and l1 cancel, a
// contracted multiply-add would otherwise move the residual by up to the
// flow's size. Built with contracted multiply-adds, the kernel timed no
// faster with its flow cold on the H100.
//
// The layout of Segment and Table is mirrored field for field by a
// ctypes.Structure in ops/epipolar.py; the static_asserts below pin it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 16;
constexpr int kThreads = 256;
constexpr int kVecPixels = 2;  // pixels of one item on the vector path (one float4)
constexpr int kItems = 4;      // items a thread: float4 loads, or pixels on the scalar path

struct Segment {
  const float* flow;         // (B, H, W, 2) normalized flow
  const float* inv_K;        // (B, 3+, 3+); the 3×3 block is read
  const float* rot;          // (B, 3, 3)
  const float* trans;        // (B, 3)
  int64_t flow_stride[4];    // b, h, w, c (elements)
  int64_t inv_K_stride[3];   // b, row, col
  int64_t rot_stride[3];     // b, row, col
  int64_t trans_stride[2];   // b, i
  int64_t out_offset;        // of the (B, H, W) map in Table::out
  float scale_x, scale_y;    // u, v multipliers to pixels
  int32_t height, width;
  int32_t vec;               // 1: the float4 path
  int32_t block0;            // first block of the segment
  int32_t blocks_per_image;
};

struct Table {
  float* out;
  int32_t n;
  int32_t total_blocks;
  Segment seg[kMaxSegments];
};

static_assert(offsetof(Segment, flow) == 0, "layout");
static_assert(offsetof(Segment, inv_K) == 8, "layout");
static_assert(offsetof(Segment, rot) == 16, "layout");
static_assert(offsetof(Segment, trans) == 24, "layout");
static_assert(offsetof(Segment, flow_stride) == 32, "layout");
static_assert(offsetof(Segment, inv_K_stride) == 64, "layout");
static_assert(offsetof(Segment, rot_stride) == 88, "layout");
static_assert(offsetof(Segment, trans_stride) == 112, "layout");
static_assert(offsetof(Segment, out_offset) == 128, "layout");
static_assert(offsetof(Segment, scale_x) == 136, "layout");
static_assert(offsetof(Segment, scale_y) == 140, "layout");
static_assert(offsetof(Segment, height) == 144, "layout");
static_assert(offsetof(Segment, width) == 148, "layout");
static_assert(offsetof(Segment, vec) == 152, "layout");
static_assert(offsetof(Segment, block0) == 156, "layout");
static_assert(offsetof(Segment, blocks_per_image) == 160, "layout");
static_assert(sizeof(Segment) == 168, "layout");
static_assert(offsetof(Table, out) == 0, "layout");
static_assert(offsetof(Table, n) == 8, "layout");
static_assert(offsetof(Table, total_blocks) == 12, "layout");
static_assert(offsetof(Table, seg) == 16, "layout");
static_assert(sizeof(Table) == 2704, "layout");
// kernel parameters are limited to 4 KB on every architecture before CUDA 12.1
static_assert(sizeof(Table) <= 4096, "the table must fit the parameter space");

// F[i][j] of image b: E = skew(t)·R, then inv_Kᵀ·(E·inv_K), each product
// summed over k from left to right, as geometry._mm3 sums it.
__device__ float fundamental_entry(const Segment& sg, int b, int i, int j) {
  const float* K = sg.inv_K + b * sg.inv_K_stride[0];
  const float* R = sg.rot + b * sg.rot_stride[0];
  const float* t = sg.trans + b * sg.trans_stride[0];
  const int64_t kr = sg.inv_K_stride[1], kc = sg.inv_K_stride[2];
  const int64_t rr = sg.rot_stride[1], rc = sg.rot_stride[2];
  const int64_t ti = sg.trans_stride[1];

  const float t0 = __ldg(t), t1 = __ldg(t + ti), t2 = __ldg(t + 2 * ti);
  const float S[3][3] = {{0.0f, -t2, t1}, {t2, 0.0f, -t0}, {-t1, t0, 0.0f}};
  float Rm[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) Rm[r][c] = __ldg(R + r * rr + c * rc);

  float ek[3];  // column j of E·inv_K
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) e[c] = S[r][0] * Rm[0][c] + S[r][1] * Rm[1][c] + S[r][2] * Rm[2][c];
    ek[r] = e[0] * __ldg(K + 0 * kr + j * kc) + e[1] * __ldg(K + 1 * kr + j * kc) +
            e[2] * __ldg(K + 2 * kr + j * kc);
  }
  return __ldg(K + 0 * kr + i * kc) * ek[0] + __ldg(K + 1 * kr + i * kc) * ek[1] +
         __ldg(K + 2 * kr + i * kc) * ek[2];
}

__device__ __forceinline__ float abs_residual(const float (&F)[9], float x, float y, float u,
                                              float v) {
  const float l0 = F[0] * x + F[1] * y + F[2];
  const float l1 = F[3] * x + F[4] * y + F[5];
  const float l2 = F[6] * x + F[7] * y + F[8];
  const float num = l0 * (x + u) + l1 * (y + v) + l2;
  const float den = sqrtf(l0 * l0 + l1 * l1 + 1e-10f) + 1e-10f;
  return fabsf(num / den);
}

__global__ void __launch_bounds__(kThreads)
epipolar_abs_residual_maps_kernel(const __grid_constant__ Table table) {
  __shared__ float sF[9];

  const int bid = blockIdx.x;
  // the last segment whose first block is at or before this one (a binary
  // search: block0 does not decrease along the table)
  int s = 0;
#pragma unroll
  for (int step = kMaxSegments / 2; step > 0; step >>= 1)
    if (s + step < table.n && bid >= table.seg[s + step].block0) s += step;
  const Segment& sg = table.seg[s];
  const int local = bid - sg.block0;
  const int b = local / sg.blocks_per_image;
  const int tile = local - b * sg.blocks_per_image;
  const int W = sg.width;
  const int64_t hw = (int64_t)sg.height * W;
  const float* flow = sg.flow + b * sg.flow_stride[0];
  float* out = table.out + sg.out_offset + b * hw;

  // issue this thread's kItems flow loads first (item k of thread t covers
  // the pixels at (k·kThreads + t)·px of the tile, so each warp's loads are
  // contiguous), then build F while they are in flight
  const int px = sg.vec ? kVecPixels : 1;
  const int64_t base = (int64_t)tile * (kThreads * kItems * px);
  int64_t p[kItems];
  int xs[kItems], ys[kItems];
  float4 f[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    p[k] = base + (k * kThreads + (int)threadIdx.x) * px;
    ys[k] = 0;
    xs[k] = 0;
    f[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (p[k] < hw) {
      ys[k] = (int)(p[k] / W);
      xs[k] = (int)(p[k] - (int64_t)ys[k] * W);
      const float* fl = flow + ys[k] * sg.flow_stride[1];
      if (sg.vec) {  // (u, v) of pixels x and x + 1, one 16-byte load
        f[k] = __ldg(reinterpret_cast<const float4*>(fl + 2 * xs[k]));
      } else {
        fl += xs[k] * sg.flow_stride[2];
        f[k].x = __ldg(fl);
        f[k].y = __ldg(fl + sg.flow_stride[3]);
      }
    }
  }
  if (threadIdx.x < 9) sF[threadIdx.x] = fundamental_entry(sg, b, threadIdx.x / 3, threadIdx.x % 3);
  __syncthreads();

  float F[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) F[k] = sF[k];
  const float sx = sg.scale_x, sy = sg.scale_y;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (p[k] >= hw) continue;
    const float x = (float)xs[k], y = (float)ys[k];
    if (sg.vec) {
      float2 r;
      r.x = abs_residual(F, x, y, f[k].x * sx, f[k].y * sy);
      r.y = abs_residual(F, x + 1.0f, y, f[k].z * sx, f[k].w * sy);
      *reinterpret_cast<float2*>(out + p[k]) = r;
    } else {
      out[p[k]] = abs_residual(F, x, y, f[k].x * sx, f[k].y * sy);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. ``table`` points to a host Table whose
// pointers are device pointers; the launch copies it by value into the
// kernel's parameter space. Returns cudaGetLastError().
extern "C" int epipolar_abs_residual_maps_f32(const void* table, void* stream) {
  const Table& t = *static_cast<const Table*>(table);
  if (t.n < 1 || t.n > kMaxSegments || t.total_blocks < 0) return (int)cudaErrorInvalidValue;
  if (t.total_blocks > 0) {
    epipolar_abs_residual_maps_kernel<<<t.total_blocks, kThreads, 0, (cudaStream_t)stream>>>(t);
  }
  return (int)cudaGetLastError();
}
