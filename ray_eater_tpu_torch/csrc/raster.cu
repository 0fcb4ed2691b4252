// K6 — dense triangle raster fold, K7 — the same fold over each tile's
// binned rows, and K8 — the winner-feature fetch of binned draws.
//
// K6 replaces the TPU kernel ray_eater_tpu/ops/raster.py _raster_kernel
// (:250), launched by _raster_call (:647). K7 replaces
// _raster_kernel_binned (:434), launched by _raster_call_binned (:588); K8
// replaces _shade_fetch_kernel (:511), launched by _shade_fetch_call
// (:544). The TPU walked a (tile, chunk) grid with a running winner in the
// output block (K6) or scalar-prefetched (tile, block, lo, hi) steps (K7);
// here each 32x128 tile is shared by four CTAs, one 64x16 region each,
// and each CTA folds all the tile's rows in order — every setup column
// below ncols (K6), or the tile's packed rows [row_begin, row_end) (K7) —
// staging 128 rows at a time in shared memory. K7 leaves tiles with no
// rows unwritten (the wrapper fills them by the visited
// mask, as the TPU path does). The TPU's K8 is a one-hot MXU matmul per
// step (a workaround for gathers in Mosaic); here it is a plain gather, one
// CTA per 128-pixel run.
//
// Per pixel and row (ray_eater_tpu_torch/ops/raster.py _fold_plain):
//   λ0 = a0 px + b0 py + c0, λ1 likewise, z likewise;
//   covered = λ0 >= 0, λ1 >= 0, λ0 + λ1 <= 1, px < W, py < H, 0 <= z <= 1,
//             and under the static test z < (<=) the incoming depth;
//   key = covered ? (last-wins ? -gid : z) : inf;
//   update when key < cur (LESS_EQUAL: key <= cur).
// Built with --fmad=false, each multiply and add rounds as the plain
// PyTorch version's do, so coverage at λ = 0 decides the same winner.
//
// Layout. A CTA has 128 threads; each of its 4 warps owns a footprint of
// 32 columns by 8 rows of the CTA's region (lane l column l, all 8 rows),
// so a thread keeps 8 pixels' running key, λ0, λ1 and winner (K7: the
// winning pack slot; its GID is read back from the pack at the end) in
// registers, at most 80 of them with six CTAs an SM. Splitting a tile's
// pixels, not its rows, over CTAs needs no merge of partial folds, and
// spreads the tiles with the most rows over four SMs. Rows are staged 128
// at a time in one row-major layout, double-buffered with cp.async: while
// one chunk folds, the next one's copy is in flight (K7: the pack rows,
// four 16-byte copies each; K6: the ten used setup fields of 128 columns,
// one 4-byte copy each, transposed on the way). The entry point
// raster_fold_shape reports this geometry. Each kernel has one
// instantiation a mode (the last-wins, LESS_EQUAL and static-test bits, 8
// in all), so the pixel loop holds no mode select: reading those bits at
// run time made K7 22% slower on the grid10k frame (PERF.md §6).
//
// The per-footprint cull. Lane l tests row g + l of each group of 32
// staged rows against the warp's footprint, and the warp evaluates, in
// row order, only the live rows its ballot keeps; the decision is uniform
// over the warp. A row is skipped only when the test proves that the
// kernel's own float evaluation covers no pixel of the rectangle of pixel
// centres x in [x0, x1], y in [y0, y1] (all positive). For a
// plane λ = a x + b y + c the test evaluates the corners chosen by the
// signs of a and b, hi (the maximum) and lo (the minimum), by the
// kernel's own operations fl(fl(fl(a x) + fl(b y)) + c), and widens each
// by
//   E = fl(fl(fl(|a| x1) + fl(|b| y1)) + |c|) * 2^-20 + 2^-126.
// A row is skipped when
//   hi0 < -E0 or hi1 < -E1          (λ0 < 0 or λ1 < 0 at every pixel),
//   (lo0 - E0) + (lo1 - E1) > 1     (λ0 + λ1 > 1 at every pixel),
//   hiz < -Ez or loz - Ez > 1       (z < 0 or z > 1 at every pixel).
// Why each holds for the computed values at every pixel of the rectangle:
//   * each rounded operation is monotone, so the computed λ is monotone in
//     x and in y: the computed corner values bound every pixel's computed
//     λ, and the rounded sum of the two minima bounds every pixel's rounded
//     λ0 + λ1; comparisons are exact. That alone makes the test exact
//     while the test and the fold round the same operations;
//   * E keeps it exact if they ever round differently (a contracted
//     multiply-add, another operand order). With S = |a| x1 + |b| y1 + |c|
//     and u = 2^-24, any such evaluation of λ at a point of the rectangle
//     is within 3u S (+ O(u^2)) of its exact value, plus at most 2^-150 a
//     product that underflows; two evaluations, the corner's and the
//     pixel's, differ by at most 6.1u S. E is at least 16u S (1 - 3u) +
//     2^-126, which covers that with more than twice the margin, also
//     after the test's own subtraction and sum (each within u of its
//     result, 2u S in all; a sum above 1 by more than 8u (S0 + S1) >= 8u
//     rounds above 1), and 2^-126 covers the underflow terms.
// An infinite or NaN coefficient makes S, E or a corner infinite or NaN,
// and then no comparison holds: such a row is never skipped. A sliver
// (|area2| just above the setup's 1e-12) has huge a and b, and its λ is
// noise: the bbox alone would not prove a miss, but the plane test stays
// exact.
//
// The LESS_EQUAL repair. Under LESS_EQUAL an uncovered row (key inf)
// takes every pixel whose running key is still inf, so a skipped row
// would miss that update. The fold here applies covered rows only, and at
// the end a pixel whose key is inf takes the tile's last live row (the
// last VALID column below ncols for K6, the last VALID row of the range
// for K7), with its λ0 and λ1 evaluated at the pixel by the same float
// operations and, for K7, its slot. This is exact: the running key never
// rises, so a final inf means every live row took the pixel; a finite
// final key means the last update came from a covered row, after which no
// inf row can take the pixel. Under LESS an inf key never updates.
//
// Bound on an H100 SXM: bytes, 64 B a row read and, a pixel, the incoming
// depth read and the planes written (K6: 4 B + 4 planes = 20 B; K7: 4 B
// + 5 planes = 24 B). The dense fold's work, about 14 f32 operations per
// (row, pixel) pair, is what the cull avoids. K8 bytes: each live pack
// row read once, the slot plane read and the (H, W, F) plane written.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 256;                       // K8's CTA
constexpr int kFootW = 32;                          // a warp's footprint:
constexpr int kFootH = 8;                           //   32 columns x 8 rows
constexpr int kCtaW = 64;                           // a CTA's region of
constexpr int kCtaH = 16;                           //   its tile: 2 x 2
constexpr int kSplit = (kTileW / kCtaW) * (kTileH / kCtaH);   // footprints
constexpr int kFoldWarps = (kCtaW / kFootW) * (kCtaH / kFootH);
constexpr int kFoldThreads = 32 * kFoldWarps;       // 128
constexpr int kChunk = 128;                         // rows staged at a time
constexpr int kRows = 16;                           // setup row width
// staged row stride in floats: 16-byte aligned, and the rows that eight
// lanes read with one 16-byte load fall in distinct bank groups
constexpr int kStride = 20;
constexpr int kFields = 10;                         // a0 .. VALID
constexpr int kGid = 14;
constexpr int kDepthTest = 1, kLastWins = 2, kLessEqual = 4, kStatic = 8;
constexpr int kMinBlocks = 6;   // CTAs an SM: at most 80 registers a thread

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A rectangle of pixel centres.
struct Rect {
  float x0, x1, y0, y1;
};

// The header's test for one plane: its computed extremes over r and E.
struct Range {
  float lo, hi, e;
};

__device__ __forceinline__ Range plane_range(float a, float b, float c,
                                             const Rect& r) {
  Range g;
  g.hi = a * (a > 0.0f ? r.x1 : r.x0) + b * (b > 0.0f ? r.y1 : r.y0) + c;
  g.lo = a * (a > 0.0f ? r.x0 : r.x1) + b * (b > 0.0f ? r.y0 : r.y1) + c;
  g.e = (fabsf(a) * r.x1 + fabsf(b) * r.y1 + fabsf(c)) * 0x1p-20f + 0x1p-126f;
  return g;
}

// True when the row (a0 b0 c0 a1 | b1 c1 az bz | cz) provably covers no
// pixel of r (the header's derivation).
__device__ __forceinline__ bool misses(const float4 q0, const float4 q1,
                                       float cz, const Rect& r) {
  const Range g0 = plane_range(q0.x, q0.y, q0.z, r);
  const Range g1 = plane_range(q0.w, q1.x, q1.y, r);
  const Range gz = plane_range(q1.z, q1.w, cz, r);
  return g0.hi < -g0.e || g1.hi < -g1.e ||
         (g0.lo - g0.e) + (g1.lo - g1.e) > 1.0f || gz.hi < -gz.e ||
         gz.lo - gz.e > 1.0f;
}

// A lane's pixels: column x, rows y0 .. y0 + 7 of the image, and its
// warp's footprint, in the CTA's region at (rx, ry).
struct Lane {
  int x, y0;
  float px, py0;
  bool in_x;
  Rect foot;
};

__device__ __forceinline__ Lane lane_pixels(int rx, int ry, float width) {
  const int w = threadIdx.x >> 5;
  const int fx = rx + (w % (kCtaW / kFootW)) * kFootW;
  const int fy = ry + (w / (kCtaW / kFootW)) * kFootH;
  Lane l;
  l.x = fx + (threadIdx.x & 31);
  l.y0 = fy;
  l.px = (float)l.x + 0.5f;
  l.py0 = (float)fy + 0.5f;
  l.in_x = l.px < width;
  l.foot = Rect{(float)fx + 0.5f, (float)(fx + kFootW - 1) + 0.5f,
                (float)fy + 0.5f, (float)(fy + kFootH - 1) + 0.5f};
  return l;
}

// Rows [r0, r0 + n) of src into dst, as one cp.async group. kBinned: pack
// rows (16 floats each), four 16-byte copies a row; else setup columns
// (field f of column c at src[f * ld + c]), fields a0 .. VALID, one 4-byte
// copy each, consecutive threads on consecutive columns.
template <bool kBinned>
__device__ __forceinline__ void stage(float (*dst)[kStride],
                                      const float* __restrict__ src, int ld,
                                      int r0, int n) {
  if constexpr (kBinned) {
    for (int i = threadIdx.x; i < 4 * n; i += kFoldThreads) {
      cp_async16(&dst[i >> 2][(i & 3) * 4],
                 src + (size_t)(r0 + (i >> 2)) * kRows + (i & 3) * 4);
    }
  } else {
    for (int i = threadIdx.x; i < kFields * kChunk; i += kFoldThreads) {
      const int f = i / kChunk, c = i - f * kChunk;
      if (c < n) cp_async4(&dst[c][f], src + (size_t)f * ld + r0 + c);
    }
  }
  cp_async_commit();
}

// The fold state of a thread's 8 pixels under mode M (the mode bits but
// kDepthTest). win holds the winner's gid (K6) or pack slot (K7); din is
// kept only for the static test.
template <int M>
struct Fold {
  static constexpr bool kStaticTest = (M & kStatic) != 0;
  static constexpr bool kLastWinsKey = (M & kLastWins) != 0;
  static constexpr bool kLessOrEqual = (M & kLessEqual) != 0;
  float cur[kFootH], l0[kFootH], l1[kFootH];
  int win[kFootH];
  float din[kStaticTest ? kFootH : 1];

  __device__ __forceinline__ void init(const Lane& l,
                                       const float* __restrict__ depth_init,
                                       int wp, int mode) {
    const bool from_init = (mode & kDepthTest) && !kStaticTest;
#pragma unroll
    for (int k = 0; k < kFootH; ++k) {
      float d = INFINITY;
      if (from_init || kStaticTest) {
        d = depth_init[(size_t)(l.y0 + k) * wp + l.x];
      }
      if constexpr (kStaticTest) din[k] = d;
      cur[k] = from_init ? d : INFINITY;
      win[k] = -1;
      l0[k] = 0.0f;
      l1[k] = 0.0f;
    }
  }

  // One row q (16-byte aligned, fields a0 .. cz) at the lane's pixels;
  // the winner records `id`. Only covered rows update (the header's
  // LESS_EQUAL repair supplies the rest).
  __device__ __forceinline__ void row(const float* q, int gid, int id,
                                      const Lane& l, float height) {
    const float4 q0 = *reinterpret_cast<const float4*>(q);
    const float4 q1 = *reinterpret_cast<const float4*>(q + 4);
    const float cz = q[8];
    const float a0x = q0.x * l.px, a1x = q0.w * l.px, azx = q1.z * l.px;
    const float gkey = -(float)gid;
#pragma unroll
    for (int k = 0; k < kFootH; ++k) {
      const float py = l.py0 + (float)k;
      const float lam0 = a0x + q0.y * py + q0.z;
      const float lam1 = a1x + q1.x * py + q1.y;
      const float z = azx + q1.w * py + cz;
      bool covered = lam0 >= 0.0f && lam1 >= 0.0f && lam0 + lam1 <= 1.0f &&
                     l.in_x && py < height && z >= 0.0f && z <= 1.0f;
      if constexpr (kStaticTest) {
        covered = covered && (kLessOrEqual ? z <= din[k] : z < din[k]);
      }
      const float key = kLastWinsKey ? gkey : z;
      if (covered && (kLessOrEqual ? key <= cur[k] : key < cur[k])) {
        cur[k] = key;
        win[k] = id;
        l0[k] = lam0;
        l1[k] = lam1;
      }
    }
  }

  // Fold staged rows [0, n) of s, source rows [r0, r0 + n), in order,
  // culled per footprint (lane l tests row g + l of each group of 32). The
  // last live row goes to `last`; the winner records the source row (K6's
  // column, K7's slot), and the key of last-wins is -gid: K6's column or
  // K7's GID field.
  template <bool kBinned>
  __device__ __forceinline__ void fold(const float (*s)[kStride], int n,
                                       int r0, int& last, const Lane& l,
                                       float height) {
    const int lane = threadIdx.x & 31;
    for (int g = 0; g < n; g += 32) {
      const int i = g + lane;
      bool live = false, keep = false;
      if (i < n) {
        const float4* q = reinterpret_cast<const float4*>(s[i]);
        const float4 q2 = q[2];
        live = q2.y > 0.5f;
        keep = live && !misses(q[0], q[1], q2.x, l.foot);
      }
      const unsigned lm = __ballot_sync(~0u, live);
      if (lm) last = r0 + g + 31 - __clz(lm);
      unsigned m = __ballot_sync(~0u, keep);
      while (m) {
        const int c = g + __ffs(m) - 1;
        m &= m - 1;
        row(s[c], kBinned ? (int)s[c][kGid] : r0 + c, r0 + c, l, height);
      }
    }
  }

  // Init, then fold source rows [begin, end) of src (see stage()) staged
  // 128 at a time into the two buffers of s. Returns the last live row,
  // or -1.
  template <bool kBinned>
  __device__ __forceinline__ int run(float (*s)[kChunk][kStride],
                                     const float* __restrict__ src, int ld,
                                     int begin, int end, const Lane& l,
                                     const float* __restrict__ depth_init,
                                     int wp, int mode, float height) {
    stage<kBinned>(s[0], src, ld, begin, min(kChunk, end - begin));
    init(l, depth_init, wp, mode);
    int last = -1;
    for (int r0 = begin, ci = 0; r0 < end; r0 += kChunk, ++ci) {
      cp_async_wait_all();
      __syncthreads();               // chunk ci landed; the other is folded
      if (r0 + kChunk < end) {
        stage<kBinned>(s[(ci + 1) & 1], src, ld, r0 + kChunk,
                       min(kChunk, end - r0 - kChunk));
      }
      this->template fold<kBinned>(s[ci & 1], min(kChunk, end - r0), r0,
                                   last, l, height);
    }
    return last;
  }

  // The LESS_EQUAL repair with the tile's last live row, `last` (the id
  // row() records for it: K6's column, K7's slot), whose fields a0 .. c1
  // are q[0], q[stride], ...; then the stores.
  __device__ __forceinline__ void finish(const Lane& l, int wp, int last,
                                         const float* q, int stride,
                                         float* __restrict__ depth,
                                         float* __restrict__ l0_out,
                                         float* __restrict__ l1_out,
                                         int* __restrict__ win_out) {
    if (kLessOrEqual && last >= 0) {
      const float a0 = q[0], b0 = q[stride], c0 = q[2 * stride];
      const float a1 = q[3 * stride], b1 = q[4 * stride], c1 = q[5 * stride];
#pragma unroll
      for (int k = 0; k < kFootH; ++k) {
        if (cur[k] == INFINITY) {
          const float py = l.py0 + (float)k;
          l0[k] = a0 * l.px + b0 * py + c0;
          l1[k] = a1 * l.px + b1 * py + c1;
          win[k] = last;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kFootH; ++k) {
      const size_t o = (size_t)(l.y0 + k) * wp + l.x;
      depth[o] = cur[k];
      l0_out[o] = l0[k];
      l1_out[o] = l1[k];
      win_out[o] = win[k];
    }
  }
};

// K6: CTA (blockIdx.x, blockIdx.y) folds setup columns [0, ncols) of the
// (16, ld) table into the 64x16 region at (64 blockIdx.x, 16 blockIdx.y);
// gid = the column. M: the mode bits but kDepthTest.
template <int M>
__global__ void __launch_bounds__(kFoldThreads, kMinBlocks)
raster_dense_kernel(const float* __restrict__ rows, int ld, int ncols,
                    const float* __restrict__ depth_init, int wp, float width,
                    float height, int mode, float* __restrict__ depth,
                    int* __restrict__ tri, float* __restrict__ l0_out,
                    float* __restrict__ l1_out) {
  __shared__ __align__(16) float s[2][kChunk][kStride];
  const Lane l = lane_pixels(blockIdx.x * kCtaW, blockIdx.y * kCtaH, width);
  Fold<M> f;
  const int last = f.template run<false>(s, rows, ld, 0, ncols, l,
                                         depth_init, wp, mode, height);
  f.finish(l, wp, last, rows + (last >= 0 ? last : 0), ld, depth, l0_out,
           l1_out, tri);
}

// K7: CTA blockIdx.x folds tile t = blockIdx.x / kSplit's pack rows
// [row_begin[t], row_end[t]) into region blockIdx.x % kSplit of it; gid =
// the row's GID field, slot = the row index. Tiles with no rows are left
// unwritten. M: the mode bits but kDepthTest.
template <int M>
__global__ void __launch_bounds__(kFoldThreads, kMinBlocks)
raster_binned_kernel(const float* __restrict__ pack,
                     const int* __restrict__ row_begin,
                     const int* __restrict__ row_end, int ntx,
                     const float* __restrict__ depth_init, int wp, float width,
                     float height, int mode, float* __restrict__ depth,
                     int* __restrict__ tri, float* __restrict__ l0_out,
                     float* __restrict__ l1_out, int* __restrict__ slot_out) {
  __shared__ __align__(16) float s[2][kChunk][kStride];
  const int t = blockIdx.x / kSplit, part = blockIdx.x % kSplit;
  const int begin = row_begin[t], end = row_end[t];
  if (begin >= end) return;          // unvisited: masked by the wrapper
  const int per_row = kTileW / kCtaW;
  const Lane l = lane_pixels((t % ntx) * kTileW + (part % per_row) * kCtaW,
                             (t / ntx) * kTileH + (part / per_row) * kCtaH,
                             width);
  Fold<M> f;
  const int last = f.template run<true>(s, pack, 0, begin, end, l,
                                        depth_init, wp, mode, height);
  f.finish(l, wp, last, pack + (size_t)(last >= 0 ? last : 0) * kRows, 1,
           depth, l0_out, l1_out, slot_out);
#pragma unroll
  for (int k = 0; k < kFootH; ++k) {          // the winners' GIDs
    const int sl = f.win[k];
    tri[(size_t)(l.y0 + k) * wp + l.x] =
        sl >= 0 ? (int)pack[(size_t)sl * kRows + kGid] : -1;
  }
}

// The instantiation of K6 or K7 that runs `mode`: one a mode M = mode &
// (kLastWins | kLessEqual | kStatic), indexed by M >> 1.
using DenseKernel = decltype(&raster_dense_kernel<0>);
using BinnedKernel = decltype(&raster_binned_kernel<0>);

DenseKernel dense_kernel(int mode) {
  static const DenseKernel k[8] = {
      raster_dense_kernel<0>,  raster_dense_kernel<2>,  raster_dense_kernel<4>,
      raster_dense_kernel<6>,  raster_dense_kernel<8>,  raster_dense_kernel<10>,
      raster_dense_kernel<12>, raster_dense_kernel<14>};
  return k[(mode >> 1) & 7];
}

BinnedKernel binned_kernel(int mode) {
  static const BinnedKernel k[8] = {
      raster_binned_kernel<0>,  raster_binned_kernel<2>,  raster_binned_kernel<4>,
      raster_binned_kernel<6>,  raster_binned_kernel<8>,  raster_binned_kernel<10>,
      raster_binned_kernel<12>, raster_binned_kernel<14>};
  return k[(mode >> 1) & 7];
}

// out[p, f] = fpack[slot[p], f] where the pixel's tile was visited and its
// slot is a row, else 0. One CTA per 128-pixel run of an image row (one
// tile's width, so one visited flag): its threads read the run's slots
// once into shared memory, then copy the run's 128 x nfeat floats with
// consecutive threads on consecutive output floats.
constexpr int kFetchPix = kTileW;

__global__ void __launch_bounds__(kThreads)
shade_fetch_kernel(const int* __restrict__ slot, const float* __restrict__ fpack,
                   const unsigned char* __restrict__ visited, int ntx, int wp,
                   int nfeat, float* __restrict__ out) {
  __shared__ int s_slot[kFetchPix];
  const size_t p0 = (size_t)blockIdx.x * kFetchPix;
  const int y = (int)(p0 / wp), tx = (int)(p0 - (size_t)y * wp) / kTileW;
  const bool vis = visited[(y / kTileH) * ntx + tx];
  if (threadIdx.x < kFetchPix) {
    s_slot[threadIdx.x] = vis ? slot[p0 + threadIdx.x] : -1;
  }
  __syncthreads();
  float* o = out + p0 * nfeat;
  for (int i = threadIdx.x; i < kFetchPix * nfeat; i += kThreads) {
    const int p = i / nfeat, f = i - p * nfeat;
    const int sl = s_slot[p];
    o[i] = sl >= 0 ? fpack[(size_t)sl * nfeat + f] : 0.0f;
  }
}


}  // namespace

extern "C" int raster_dense(const void* setup, int tpad, int ncols,
                            const void* depth_init, int hp, int wp, float width,
                            float height, int mode, void* depth, void* tri,
                            void* l0, void* l1, void* stream) {
  if (hp > 0 && wp > 0) {
    const dim3 grid(wp / kCtaW, hp / kCtaH);
    const auto k = dense_kernel(mode);
    k<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
        (const float*)setup, tpad, ncols, (const float*)depth_init, wp, width,
        height, mode, (float*)depth, (int*)tri, (float*)l0, (float*)l1);
  }
  return (int)cudaGetLastError();
}

// K7's pack must be 16-byte aligned (cp.async).
extern "C" int raster_binned(const void* pack, const void* row_begin,
                             const void* row_end, int ntiles, int ntx,
                             const void* depth_init, int hp, int wp, float width,
                             float height, int mode, void* depth, void* tri,
                             void* l0, void* l1, void* slot, void* stream) {
  (void)hp;
  if ((uintptr_t)pack % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (ntiles > 0) {
    const auto k = binned_kernel(mode);
    k<<<ntiles * kSplit, kFoldThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pack, (const int*)row_begin, (const int*)row_end, ntx,
        (const float*)depth_init, wp, width, height, mode, (float*)depth,
        (int*)tri, (float*)l0, (float*)l1, (int*)slot);
  }
  return (int)cudaGetLastError();
}

// The geometry of K6 (kernel 6) or K7 (kernel 7) as it runs `mode`: a
// warp's footprint, *foot_w x *foot_h pixels (the unit of each cull
// decision); a CTA's region of a tile, *cta_w x *cta_h; *ctas CTAs a
// tile, *threads a CTA; and *resident, the CTAs the card holds at once.
// Returns a CUDA error code.
extern "C" int raster_fold_shape(int kernel, int mode, int* foot_w,
                                 int* foot_h, int* cta_w, int* cta_h,
                                 int* ctas, int* threads, int* resident) {
  if (kernel != 6 && kernel != 7) return (int)cudaErrorInvalidValue;
  const void* k = kernel == 6 ? (const void*)dense_kernel(mode)
                              : (const void*)binned_kernel(mode);
  *foot_w = kFootW;
  *foot_h = kFootH;
  *cta_w = kCtaW;
  *cta_h = kCtaH;
  *ctas = kSplit;
  *threads = kFoldThreads;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                        kFoldThreads, 0);
  *resident = per_sm * sms;
  return (int)err;
}

extern "C" int shade_fetch(const void* slot, const void* fpack,
                           const void* visited, int ntx, int hp, int wp,
                           int nfeat, void* out, void* stream) {
  const long long runs = (long long)hp * wp / kFetchPix;   // wp % 128 == 0
  if (runs > 0 && nfeat > 0) {
    shade_fetch_kernel<<<(unsigned)runs, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)slot, (const float*)fpack, (const unsigned char*)visited,
        ntx, wp, nfeat, (float*)out);
  }
  return (int)cudaGetLastError();
}
