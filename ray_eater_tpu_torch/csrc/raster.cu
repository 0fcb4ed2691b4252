// K6 — dense triangle raster fold, K7 — the same fold over each tile's
// binned rows, and K8 — the winner-feature fetch of binned draws.
//
// K6 replaces the TPU kernel ray_eater_tpu/ops/raster.py _raster_kernel
// (:250), launched by _raster_call (:647). K7 replaces
// _raster_kernel_binned (:434), launched by _raster_call_binned (:588); K8
// replaces _shade_fetch_kernel (:511), launched by _shade_fetch_call
// (:544). The TPU walked a (tile, chunk) grid with a running winner in the
// output block (K6) or scalar-prefetched (tile, block, lo, hi) steps (K7);
// here one CTA owns one 32x128 tile and folds its rows in order — every
// setup column below ncols (K6), or the tile's packed rows [row_begin,
// row_end) (K7) — staging 128 rows at a time in shared memory. Each of the
// 256 threads keeps 16 pixels' running key, winner, λ0 and λ1 (and K7's
// winning pack slot) in registers; the sequential fold keeps the draw
// order and with it the tie rule. K7 leaves tiles with no rows unwritten
// (the wrapper fills them by the visited mask, as the TPU path does). The
// TPU's K8 is a one-hot MXU matmul per step (a workaround for gathers in
// Mosaic); here it is a plain gather, one CTA per 128-pixel run.
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
// Bound on an H100 SXM: K6/K7 operations, about 14 f32 operations per
// executed (row, pixel) pair against 64 B a row read and, a pixel, the
// incoming depth read and the planes written (K6: 4 B + 4 planes = 20 B;
// K7: 4 B + 5 planes = 24 B). K8 bytes: each live pack row read once,
// the slot plane read and the (H, W, F) plane written.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kPPT = kTileH * kTileW / kThreads;   // 16 pixels a thread
constexpr int kChunk = 128;                         // rows staged at a time
constexpr int kRows = 16;                           // setup row width
constexpr int kValid = 9;
constexpr int kGid = 14;
constexpr int kDepthTest = 1, kLastWins = 2, kLessEqual = 4, kStatic = 8;

// Thread t owns column t & 127 and rows (t >> 7) + 2k, k < 16.
// Dense (K6): rows is the (16, ld) setup table, columns [0, ncols) folded
// into tile (blockIdx.y, blockIdx.x), gid = column. Binned (K7): rows is
// the (cap, 16) pack, tile blockIdx.x folds [row_begin, row_end), gid =
// the row's GID, slot = the row index.
template <bool kBinned>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ rows, int ld, int ncols,
              const int* __restrict__ row_begin, const int* __restrict__ row_end,
              int ntx, const float* __restrict__ depth_init, int wp, float width,
              float height, int mode, float* __restrict__ depth,
              int* __restrict__ tri, float* __restrict__ l0_out,
              float* __restrict__ l1_out, int* __restrict__ slot_out) {
  __shared__ float s[kChunk][kRows + 1];
  int tx, ty, begin, end;
  if (kBinned) {
    tx = blockIdx.x % ntx;
    ty = blockIdx.x / ntx;
    begin = row_begin[blockIdx.x];
    end = row_end[blockIdx.x];
    if (begin >= end) return;        // unvisited: masked by the wrapper
  } else {
    tx = blockIdx.x;
    ty = blockIdx.y;
    begin = 0;
    end = ncols;
  }
  const bool last_wins = mode & kLastWins;
  const bool less_equal = mode & kLessEqual;
  const bool static_test = mode & kStatic;
  const bool from_init = (mode & kDepthTest) && !static_test;
  const int col = threadIdx.x & (kTileW - 1);
  const int row0 = threadIdx.x >> 7;
  const float px = ((float)(tx * kTileW) + (float)col) + 0.5f;
  const bool in_x = px < width;
  float cur[kPPT], din[kPPT], l0[kPPT], l1[kPPT];
  int win[kPPT], slot[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const int y = ty * kTileH + row0 + 2 * k;
    din[k] = depth_init[(size_t)y * wp + tx * kTileW + col];
    cur[k] = from_init ? din[k] : INFINITY;
    win[k] = -1;
    slot[k] = -1;
    l0[k] = 0.0f;
    l1[k] = 0.0f;
  }
  for (int r0 = begin; r0 < end; r0 += kChunk) {
    const int n = min(kChunk, end - r0);
    __syncthreads();                 // the previous chunk is consumed
    for (int i = threadIdx.x; i < n * kRows; i += kThreads) {
      if (kBinned) {
        s[i / kRows][i % kRows] = rows[(size_t)r0 * kRows + i];
      } else {
        const int f = i / n, c = i - f * n;
        s[c][f] = rows[(size_t)f * ld + r0 + c];
      }
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float* q = s[c];
      if (!(q[kValid] > 0.5f)) continue;        // uniform over the block
      const float a0 = q[0], b0 = q[1], c0 = q[2];
      const float a1 = q[3], b1 = q[4], c1 = q[5];
      const float az = q[6], bz = q[7], cz = q[8];
      const int gid = kBinned ? (int)q[kGid] : r0 + c;
      const float gkey = -(float)gid;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const float py =
            ((float)(ty * kTileH) + (float)(row0 + 2 * k)) + 0.5f;
        const float lam0 = a0 * px + b0 * py + c0;
        const float lam1 = a1 * px + b1 * py + c1;
        const float z = az * px + bz * py + cz;
        bool covered = lam0 >= 0.0f && lam1 >= 0.0f && lam0 + lam1 <= 1.0f &&
                       in_x && py < height && z >= 0.0f && z <= 1.0f;
        if (static_test) covered = covered && (less_equal ? z <= din[k] : z < din[k]);
        const float key = covered ? (last_wins ? gkey : z) : INFINITY;
        const bool upd = less_equal ? key <= cur[k] : key < cur[k];
        if (upd) {
          cur[k] = key;
          win[k] = gid;
          slot[k] = r0 + c;
          l0[k] = lam0;
          l1[k] = lam1;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const size_t o = (size_t)(ty * kTileH + row0 + 2 * k) * wp + tx * kTileW + col;
    depth[o] = cur[k];
    tri[o] = win[k];
    l0_out[o] = l0[k];
    l1_out[o] = l1[k];
    if (kBinned) slot_out[o] = slot[k];
  }
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
    const dim3 grid(wp / kTileW, hp / kTileH);
    raster_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)setup, tpad, ncols, nullptr, nullptr, wp / kTileW,
        (const float*)depth_init, wp, width, height, mode, (float*)depth,
        (int*)tri, (float*)l0, (float*)l1, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int raster_binned(const void* pack, const void* row_begin,
                             const void* row_end, int ntiles, int ntx,
                             const void* depth_init, int hp, int wp, float width,
                             float height, int mode, void* depth, void* tri,
                             void* l0, void* l1, void* slot, void* stream) {
  (void)hp;
  if (ntiles > 0) {
    raster_kernel<true><<<ntiles, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)pack, kRows, 0, (const int*)row_begin,
        (const int*)row_end, ntx, (const float*)depth_init, wp, width, height,
        mode, (float*)depth, (int*)tri, (float*)l0, (float*)l1, (int*)slot);
  }
  return (int)cudaGetLastError();
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
