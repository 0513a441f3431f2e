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
// +1e-12, the same operation order, NaN propagated by max and min as
// jnp.maximum and jnp.minimum propagate it, no contracted multiply-adds under
// --fmad=false), and a box survives at IoU <= thresh.
//
// What bounds it on this card: neither bytes (n·20 B in, max_out·5 B out) nor
// operations (at most n²/2 IoUs, ~20 FLOP each): the rounds are a chain, each
// depending on the last, so latency bounds it. The first design ran the whole
// stage in one 1024-thread block an image (4 of 132 SMs at B = 4): a bitonic
// sort with a block barrier a stage, then max_out rounds of two block barriers
// and a dependent global load each, about 1.3 µs a round.
// What this design does about it, in three launches a stage:
// 1. nms_sort_kernel, a grid over (image, 32 boxes): each box's rank among
//    the (score, index) keys — descending score, ascending index, NaN first
//    (jnp.argmax takes a NaN for the maximum), -0.0 read as +0.0, which it
//    equals — counted by 8 threads over the image's keys in shared memory;
//    the box goes to its rank. No barrier beyond the keys' load. "Argmax of
//    the alive scores" becomes "the first alive position". The image's first
//    block also writes how many scores lie above -inf (0 if any is NaN: that
//    box ranks first and ends the run), so the scan never reads a score.
// 2. nms_mask_kernel, a grid over (image, 32 rows, 32 words): bit k of row i
//    is !(IoU(i, k) <= thresh) over the sorted order, with box i first in
//    iou_matrix's order, for the words k/32 >= i/32 (the scan reads no other).
//    The self bit is set unless box i has no area. A warp computes one row's
//    32 words: each lane one IoU, a ballot makes the word, and the 32 words go
//    out in one coalesced store. The tile's column boxes sit in shared memory;
//    the division runs only where some lane's boxes intersect.
// 3. nms_scan_kernel, a block an image: walks the sorted positions 32 at a
//    time (a word); the removed set lives in shared memory. Warp 0 decides a
//    word's greedy rounds in parallel from its diagonal 32×32 block (fetched a
//    word ahead, transposed with ballots so that each lane holds which earlier
//    positions suppress its own): in rounds of two ballots a position is kept
//    once no earlier suppressor is undecided or kept, and out once a kept one
//    suppresses it. A few such rounds settle a word whose greedy rounds would
//    be a chain of dependent steps, one a kept box. Then every thread ORs the
//    kept rows' bits of one later word into the set: about one L2 round trip
//    and two block barriers a word, none inside a word's rounds. A kept box
//    whose self bit is clear (no area) fills every remaining slot, as
//    nms_fixed keeps choosing it; past the count of scores above -inf the run
//    ends with (0, false).
// Scratch (the sorted boxes, the order, the counts and the (N, n, ⌈n/32⌉)
// mask) comes from the wrapper, so the three launches capture in a CUDA graph.
// Reached (chip_smoke.py phase 8, H100 80GB HBM3 at 700 W): 0.038-0.040 ms at
// the provider's RPN stage (4 × 1280 → 256; the one-block design: 0.335 ms),
// 0.012-0.013 ms at its class stage (0.039 ms), 0.125 ms at the 640×2048
// backend's RPN stage (1 × 4960 → 1000; 2.33 ms). That is still under 0.01 of the
// bound, which counts only the IoUs the kept boxes need: the scan's words
// remain a chain, and the mask computes every row's IoUs before the scan
// knows how far it will walk.
// Not used: TMA, wgmma, clusters — nothing here is a tile product or a stream.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 8192;            // an image's keys, order and rows in one block's shared memory
constexpr int kMaxWords = kMaxBoxes / 32;
constexpr int kRankBoxes = 32;             // boxes a sort block ranks
constexpr int kRankSplit = 8;              // threads that count a box's rank
constexpr int kRankThreads = kRankBoxes * kRankSplit;
constexpr int kMaskRows = 32;              // rows of a mask block
constexpr int kMaskWords = 32;             // words of a mask block: 1024 column boxes
constexpr int kMaskThreads = kMaskRows * 32;  // a warp a row
constexpr int kScanThreads = kMaxWords;  // a thread for each later word of a word
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// jnp.maximum / jnp.minimum: a NaN operand gives NaN (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float box_area(float4 b) {
  return nan_max(b.z - b.x, 0.0f) * nan_max(b.w - b.y, 0.0f);
}

// grid (batch, ⌈n / 32⌉), 256 threads; shared memory: the image's n keys.
// (The batch is on x, the only axis of 2^31 - 1 blocks, here and in the mask.)
__global__ void __launch_bounds__(kRankThreads)
nms_sort_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int n,
                int32_t* __restrict__ order, float4* __restrict__ sboxes, int32_t* __restrict__ limits) {
  extern __shared__ unsigned long long keys[];  // [n]
  __shared__ int s_above, s_nan;
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const float* is = scores + (size_t)img * n;
  if (tid == 0) s_above = s_nan = 0;
  int above = 0;
  bool nan = false;
  for (int i = tid; i < n; i += kRankThreads) {
    const float s = is[i];
    keys[i] = sort_key(s, i);
    above += s > -INFINITY;  // false for NaN
    nan |= s != s;
  }
  __syncthreads();
  if (blockIdx.y == 0) {  // the count of scores above -inf, or 0 after a NaN
    above = __reduce_add_sync(kFull, above);
    nan = __any_sync(kFull, nan);
    if ((tid & 31) == 0) {
      atomicAdd(&s_above, above);
      if (nan) atomicOr(&s_nan, 1);
    }
    __syncthreads();
    if (tid == 0) limits[img] = s_nan ? 0 : s_above;
  }
  // box e's rank: the keys below its own, counted by its 8 threads over
  // interleaved eighths (neighbouring 8-byte keys: no bank conflict)
  const int e = blockIdx.y * kRankBoxes + tid / kRankSplit;
  const unsigned long long mine = e < n ? keys[e] : ~0ull;
  int rank = 0;
#pragma unroll 8
  for (int j = tid % kRankSplit; j < n; j += kRankSplit) rank += keys[j] < mine;
  rank += __shfl_xor_sync(kFull, rank, 1);
  rank += __shfl_xor_sync(kFull, rank, 2);
  rank += __shfl_xor_sync(kFull, rank, 4);
  if (e < n && tid % kRankSplit == 0) {
    order[(size_t)img * n + rank] = e;
    sboxes[(size_t)img * n + rank] = reinterpret_cast<const float4*>(boxes)[(size_t)img * n + e];
  }
}

// grid (batch, ⌈n / 32⌉, ⌈nwords / 32⌉), a warp a row: rows [32·y, 32·y + 32)
// against words [32·z, 32·z + 32) of the sorted order.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ sboxes, int n, int nwords, float thresh, uint32_t* __restrict__ mask) {
  __shared__ float4 cbox[kMaskWords * 32];
  __shared__ float carea[kMaskWords * 32];
  const int img = blockIdx.x;
  const int row0 = blockIdx.y * kMaskRows;
  const int word0 = blockIdx.z * kMaskWords;
  if (word0 + kMaskWords - 1 < row0 / 32) return;  // below the diagonal: never read
  const float4* b = sboxes + (size_t)img * n;
  const int col0 = word0 * 32;
  for (int t = threadIdx.x; t < kMaskWords * 32; t += blockDim.x) {
    if (col0 + t < n) {
      const float4 c = b[col0 + t];
      cbox[t] = c;
      carea[t] = box_area(c);
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = min(kMaskWords, nwords - word0);
  const int i = row0 + warp;
  if (i < n) {
    const float4 a = b[i];
    const float area_a = box_area(a);
    uint32_t mine = 0;
#pragma unroll 4
    for (int u = max(0, i / 32 - word0); u < words; ++u) {
      const int k = (word0 + u) * 32 + lane;
      bool hit = false;
      if (k < n) {
        const float4 c = cbox[u * 32 + lane];
        const float w = nan_max(nan_min(a.z, c.z) - nan_max(a.x, c.x), 0.0f);
        const float h = nan_max(nan_min(a.w, c.w) - nan_max(a.y, c.y), 0.0f);
        const float inter = w * h;
        const float den = area_a + carea[u * 32 + lane] - inter + 1e-12f;
        // 0 / den is 0 for den > 0 or inf, NaN for a NaN den (den >= 1e-12
        // otherwise): the division runs only where the boxes intersect
        float iou = den != den ? den : 0.0f;
        if (inter != 0.0f) iou = inter / den;  // a NaN inter divides too
        hit = !(iou <= thresh);
      }
      const uint32_t word = __ballot_sync(kFull, hit);
      if (lane == u) mine = word;
    }
    if (lane < words && word0 + lane >= i / 32) mask[((size_t)img * n + i) * nwords + word0 + lane] = mine;
  }
}

// Shared memory of the scan: the removed set and the kept positions.
__host__ __device__ constexpr size_t scan_smem_bytes(int nwords, int kept) { return (size_t)(nwords + kept) * 4; }

// A block an image. Warp 0 decides each word; all threads OR the kept rows
// into the later words, a word each.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint32_t* __restrict__ mask, const int32_t* __restrict__ order,
                const int32_t* __restrict__ limits, int n, int nwords, int max_out, int32_t* __restrict__ keep,
                uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t smem[];
  uint32_t* removed = smem;                                        // [nwords]
  int32_t* kept_pos = reinterpret_cast<int32_t*>(removed + nwords);  // [min(max_out, n)]
  __shared__ uint32_t s_kept;
  __shared__ int s_done, s_count, s_fill;
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const bool decider = tid < 32;
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t* m = mask + (size_t)img * n * nwords;
  for (int u = tid; u < nwords; u += kScanThreads) removed[u] = 0u;
  const int limit = limits[img];
  const int words = (limit + 31) / 32;  // the positions above -inf; none past them is kept
  // warp 0's lane j holds row 32·w + j's word w: the diagonal block of word w
  uint32_t diag = decider && words > 0 && lane < n ? __ldg(m + (size_t)lane * nwords) : 0u;
  __syncthreads();

  int count = 0;   // slots filled (warp 0)
  int fill = -1;   // the position that fills every later slot, or none (warp 0)
  for (int w = 0; w < words; ++w) {
    const int base = 32 * w;
    if (decider) {
      const uint32_t d = diag;
      if (w + 1 < words) {  // the next word's diagonal block, a word ahead
        const int row = base + 32 + lane;
        diag = row < n ? __ldg(m + (size_t)row * nwords + w + 1) : 0u;
      }
      uint32_t alive = ~removed[w];
      if (limit - base < 32) alive &= (1u << (limit - base)) - 1u;
      // the transposed diagonal block: the word's earlier positions whose box suppresses mine
      uint32_t sup = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t c = __ballot_sync(kFull, (d >> i) & 1u);
        if (lane == i) sup = c;
      }
      sup &= below;
      // the greedy rounds within the word, decided in parallel: a position is
      // kept once no earlier one that would suppress it is undecided or kept,
      // and out once an earlier kept one suppresses it
      uint32_t undecided = alive, kept = 0;
      while (undecided) {
        const bool mine = (undecided >> lane) & 1u;
        const bool out = mine && (sup & kept);
        const bool in = mine && !out && !(sup & undecided);
        kept |= __ballot_sync(kFull, in);
        undecided &= ~__ballot_sync(kFull, in || out);
      }
      bool done = false;
      // a kept box without area is chosen again in every later round
      const uint32_t again = kept & ~__ballot_sync(kFull, (d >> lane) & 1u);
      if (again) {
        const int f = __ffs(again) - 1;
        kept &= (2u << f) - 1u;
        fill = base + f;
        done = true;
      }
      const int room = max_out - count;
      if (__popc(kept) >= room) {  // the last slots
        kept &= (2u << __fns(kept, 0, room)) - 1u;
        done = true;
      }
      if ((kept >> lane) & 1u) kept_pos[count + __popc(kept & below)] = base + lane;
      count += __popc(kept);
      if (lane == 0) {
        s_kept = kept;
        s_done = done;
      }
    }
    __syncthreads();
    if (s_done) break;
    // the kept rows' bits of word w + 1 + tid into the set
    const uint32_t kept = s_kept;
    const int u = w + 1 + tid;
    if (kept && u < words) {
      const uint32_t* col = m + (size_t)base * nwords + u;
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if ((kept >> j) & 1u) acc |= __ldg(col + (size_t)j * nwords);
      removed[u] |= acc;
    }
    __syncthreads();
  }
  if (tid == 0) {
    s_count = count;
    s_fill = fill;
  }
  __syncthreads();
  int32_t* ok = keep + (size_t)img * max_out;
  uint8_t* ov = valid + (size_t)img * max_out;
  const int32_t* io = order + (size_t)img * n;
#pragma unroll 4
  for (int r = tid; r < max_out; r += kScanThreads) {
    const int pos = r < s_count ? kept_pos[r] : s_fill;
    ok[r] = pos >= 0 ? io[pos] : 0;
    ov[r] = pos >= 0 ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// boxes (batch, n, 4) float32, 16-byte aligned, and scores (batch, n) float32,
// both contiguous; keep (batch, max_out) int32 and valid (batch, max_out)
// uint8, written whole. Scratch, contiguous: order (batch, n) int32, sboxes
// (batch, n, 4) float32 (16-byte aligned), limits (batch) int32, mask
// (batch, n, ⌈n / 32⌉) uint32. Launches the three kernels on `stream` and
// returns the first error of a launch (or cudaErrorInvalidValue for arguments
// it does not take).
int nms_fixed_f32(const float* boxes, const float* scores, int batch, int n, int max_out, float thresh,
                  int32_t* keep, uint8_t* valid, int32_t* order, float* sboxes, int32_t* limits, uint32_t* mask,
                  void* stream) {
  if (batch <= 0 || max_out <= 0) return 0;
  if (n < 1 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(nms_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(kMaxBoxes * sizeof(unsigned long long)));
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int nwords = (n + 31) / 32;
  float4* sb = reinterpret_cast<float4*>(sboxes);
  const dim3 sort_grid(batch, (n + kRankBoxes - 1) / kRankBoxes);
  nms_sort_kernel<<<sort_grid, kRankThreads, n * sizeof(unsigned long long), s>>>(boxes, scores, n, order, sb,
                                                                                  limits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 mask_grid(batch, (n + kMaskRows - 1) / kMaskRows, (nwords + kMaskWords - 1) / kMaskWords);
  nms_mask_kernel<<<mask_grid, kMaskThreads, 0, s>>>(sb, n, nwords, thresh, mask);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int kept = max_out < n ? max_out : n;
  nms_scan_kernel<<<batch, kScanThreads, scan_smem_bytes(nwords, kept), s>>>(mask, order, limits, n, nwords,
                                                                             max_out, keep, valid);
  return (int)cudaGetLastError();
}

int nms_max_boxes() { return kMaxBoxes; }

}  // extern "C"
