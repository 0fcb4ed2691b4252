// K2 — front-to-back tile composite — K3, the same composite on a
// decimated grid for the LOD's decimated tail, and K4, K2 plus entry-T
// checkpoints for the training backward (K5, gs_composite_bwd.cu).
//
// K2 replaces the TPU kernel ray_eater_tpu/ops/gs.py _composite_kernel
// (:1239) with its chunk body _composite_chunk (:1306), launched by
// _composite_call (:1375). K3 replaces _composite_tail_kernel (:1416),
// launched by _composite_tail_call (:1474). K4 replaces
// _composite_kernel_ckpt (:1528), launched by _composite_call_ckpt (:1556):
// at the top of every chunk it runs, the tile writes its samples' T into
// the chunk's checkpoint slot ckpt[ck_off[tile] + j] (j counts the tile's
// chunks from its first), one (pixd,) row per executed chunk; chunks after
// saturation write nothing and K5 never reads them. The TPU ran a
// sequential grid over scalar-prefetched steps and a doubling-scan
// transmittance prefix; here a tile walks its rows [row_begin, row_end) of
// the layout in order, so the prefix becomes a running product (a
// reassociation of the same sum). K3's 8-chunk grid steps reduce to the
// same per-chunk walk: tile bases are 128-row aligned and the TPU kernel
// re-checked saturation between its sub-chunks.
//
// K2 and K3 stage each row through its splat id: row r of the layout is
// record idx[r] of the (N, 12) record table, so no packed copy of the
// records is ever made (the ids are the binning's, read in the staging,
// where the double buffer hides their latency as it hides the rows'). K4
// reads the rows the training frame packed (row r is record r), whose
// gather autograd differentiates.
//
// Semantics kept because they decide the image or the stats:
//   * chunks are cut at absolute multiples of 128 rows of the layout;
//   * a tile whose every sample enters below T = 1e-4 runs nothing (K3: a
//     tail behind a saturated head is skipped; K2 and K4 enter at T = 1);
//   * after each chunk, and only then, the tile stops when every sample of
//     it (the padded rows below the image included) has T < 1e-4 — a
//     tile-wide vote, no per-pixel early exit;
//   * exec counts the rows of every chunk that ran, before that check;
//   * every tile's outputs are written: rgb from 0, T from the entry T.
//
// Sample i of a tile sits at the centre of its decim x decim pixel quad:
// x = (i mod tile_w/decim)*decim + tx0 + decim/2, and likewise for y
// (decim 1 for K2 and K4).
//
// Bound on an H100 SXM: operations. Each executed pair-sample costs about
// 12 f32 flops and one expf, which goes through the SFU (MUFU.EX2, 16 a
// clock per SM); the records are read once (36 B of used columns a row)
// and the four planes written once (K4 also writes one (pixd,) f32
// checkpoint row per executed chunk).
//
// The per-pair code, shared by all three (composite_rows), is built to
// spend few instructions: at one sample a thread a pair-sample would cost
// nine scalar shared loads and the full quadratic, and every (warp, row)
// pair would run whether or not the row reaches the warp's pixels. So:
//   * a thread owns PPT samples and reads a row's nine values as three
//     broadcast 16-byte shared loads, applied to all its samples;
//   * a warp covers a footprint of 8 columns by 4*PPT rows of the (decimated)
//     sample grid (lane l at column l mod 8, row l / 8; sample k 4k rows
//     further down; the entry point gs_composite_footprint reports K2's),
//     so a thread's samples share one column: dx, ca*dx*dx and cbq*dx are
//     computed once a row, the rest of the quadratic per sample;
//   * the warp row cull: a warp skips a row when every one of its samples
//     has power < cull_threshold(op), which proves alpha < 1/255 for each
//     (see there). It is exact: such a row changes neither colour nor T,
//     and exec counts the rows of chunks run, not live rows. Footprints
//     nearer a square than whole tile rows let more rows miss a warp;
//   * the records are double-buffered: while one chunk composites, cp.async
//     copies the next one's rows (three 16-byte copies per 48-byte row,
//     each row's id read first; rows are 16-byte aligned, the entry points
//     check) into the other buffer; a tile that stops at the vote drops
//     that copy;
//   * a row's cull threshold is computed once for each group of 32 rows
//     (lane l that of the group's row l, then shuffled), and a sample below
//     1/255 takes the update with alpha 0, so the loop has no per-row test
//     and no branch around the update.
// Every value that decides a sample's alpha, its T, exec or the vote is the
// same float32 operation on the same operands as in the plain version
// (--fmad=false, IEEE expf); only the colour sums fuse their multiply-add
// (see composite_rows). What bounds the per-pair work then is its
// instruction count. K4's loop (2 samples a thread, sm_90a SASS) spends 25
// instructions a row on the loads, the column terms, the quadratic and the
// vote, then 39 on two samples' expf (eight each), alpha and weighted
// update: ~32 a live pair-sample, 13 a culled one.
//
// How the tiles spread over the card:
//   * K2 (tile_composite_kernel, CLUSTER 1): one CTA a tile, 256 threads at
//     tile_w 32 (4 samples each) and 64 (8 each), 1024 at 128 (4 each).
//   * K4 (tile_composite_kernel, CLUSTER > 1): one tile over a thread-block
//     cluster of CLUSTER CTAs, split by samples: 128 threads of 2 samples a
//     CTA, so 16 CTAs a tile at tile_w 128 (a non-portable cluster size,
//     which Hopper allows), 8 at 64, 4 at 32. A frame with few busy tiles
//     (the training frame: ~100 of 510 at tile_w 128) would otherwise run
//     each busy tile's walk on one SM while the rest idle. Every CTA walks
//     the same rows over its own samples, so each sample sees the
//     sequential walk's float operations. At each chunk's end a CTA takes
//     __syncthreads_and of its samples, stores that bit into every CTA of
//     the cluster (distributed shared memory, slot = its rank, buffer = the
//     chunk's parity), and the cluster meets at its barrier; all CTAs then
//     AND the same bits and stop together. The first remote store waits on
//     a relaxed arrive made at entry, so every CTA of the cluster has
//     started. A tile with no rows makes no cluster barrier in any of its
//     CTAs. The hardware puts a cluster's CTAs on distinct SMs and all busy
//     clusters are resident at once, so an SM's work is the sum of the rows
//     of the tiles whose clusters it hosts; that sum, not one tile's walk,
//     now sets the time. Smaller CTAs, more a tile, even it out: in tuning
//     builds clusters of 8 CTAs of 4 samples ran slower, and so did
//     persistent clusters that take tiles from a counter.
//   * K3 (tail_chunk_kernel, then tail_merge_kernel): a tile's tail split
//     by chunks over the whole card, then merged in order. A tail tile
//     holds few samples (128 at tile_w 64, decim 4) and long lists (up to
//     ~41 chunks), so one CTA's walk would be one warp's dependent chain
//     over every row. The first pass runs kTailSplit CTAs a tile; CTA s
//     composites the tile's chunks s, s + kTailSplit, ... each from T = 1
//     into local (r, g, b, T_loc) partials in global scratch (CTAs past the
//     tile's chunk count exit at once). The second pass runs one CTA a
//     tile: from the entry T it merges the chunks in order, sample by
//     sample, C <- C + T*C_loc, T <- T*T_loc, counts each chunk's rows into
//     exec and takes the tile-wide vote after each; the first chunk after
//     which every sample has T < 1e-4 ends the tile. This is sound because
//     whether a row is live (1/255 <= alpha, the 0.99 clamp) does not
//     depend on T: the merge reassociates the transmittance product, so
//     the planes are no longer the sequential walk's to the digit. Both
//     passes read the whole entry T and skip a tile that enters saturated.
//     The first pass composites every chunk of a tile it runs, those past
//     the stop included. In tuning builds a cluster of CTAs a tile, one
//     chunk each a round and rank 0 merging over distributed shared
//     memory, ran slower: its CTAs hold their slots through the round's
//     barriers while the tile's other chunks run, and the tail's mean tile
//     holds ~5 chunks.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kChunk = 128;
constexpr int kTileH = 32;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
// columns of a warp's footprint (of 8 x 4*PPT samples), lane rows in it
constexpr int kFootW = 8;
constexpr int kLanesY = 32 / kFootW;
// warp row cull: a row is skipped by a warp when every sample's power is
// below cull_threshold(op) (see there)
constexpr float kCullMargin = 1e-3f;
constexpr float kCullCap = 80.0f;
// CTAs of a cluster that every sm_90 card can schedule
constexpr int kPortableCluster = 8;

// K2's samples a thread by tile width (see the note at the top)
__host__ __device__ constexpr int head_ppt(int tw) {
  return tw == 128 ? 4 : tw == 64 ? 8 : 4;
}
// K4: 2 samples a thread, 128 threads (256 samples) a CTA
constexpr int kCkptPpt = 2;
constexpr int kCkptThreads = 128;
__host__ __device__ constexpr int ckpt_cluster(int tw) {
  return kTileH * tw / (kCkptPpt * kCkptThreads);
}
// K3: samples a thread by tile width and decim (footprints of 8 x 4*PPT on
// the decimated grid), and the first pass's CTAs a tile
__host__ __device__ constexpr int tail_ppt(int tw, int d) {
  return d == 4 ? 2 : d == 2 ? (tw == 128 ? 4 : 2) : 4;
}
constexpr int kTailSplit = 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Thread-block cluster barrier halves (every thread of every CTA of the
// cluster arrives; .aligned: the whole warp executes them together) and
// the generic address of p's counterpart in the cluster's CTA `rank`.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(r);
}

// Rows [lo, lo + n) of the layout into dst, three 16-byte copies a row, as
// one cp.async group: row r is record idx[r] of the table rec4 (K2, K3), or
// record r where idx is null (K4's packed rows).
template <int THREADS>
__device__ __forceinline__ void stage_rows(float4 (*dst)[3], const float4* __restrict__ rec4,
                                           const int* __restrict__ idx, int lo, int n) {
  for (int q = threadIdx.x; q < 3 * n; q += THREADS) {
    const int r = lo + q / 3;
    const size_t rec = idx ? (size_t)idx[r] : (size_t)r;
    cp_async16(&dst[0][0] + q, rec4 + rec * 3 + q % 3);
  }
  cp_async_commit();
}

// The power below which a row of opacity op leaves a sample untouched:
// with L = ln(kAlphaMin / op), power < min(L, 80) - 1e-3 gives
// op * expf(power) < kAlphaMin. The true exp is below
// (kAlphaMin / op) e^-0.001 there; expf's 2-ulp error, the division's and
// logf's rounding (under 1e-5 in L up to 80) and the product's rounding
// stay far inside that factor. Where L exceeds the cap, op * e^80 is below
// kAlphaMin itself (op = 0 included: expf stays finite below 80). A NaN or
// negative op gives a NaN threshold, and no sample compares below it.
// ops/gs.py _cull_threshold is its plain twin.
__device__ __forceinline__ float cull_threshold(float op) {
  const float L = logf(kAlphaMin / op);
  return (L >= kCullCap ? kCullCap : L) - kCullMargin;
}

// The n staged rows over a thread's PPT samples (column px, rows py[k]):
// colour and T updated in place, rows skipped by the warp row cull. The
// whole warp calls it with the same rows. A sample below 1/255 takes the
// update with alpha 0: it adds colour * 0 and multiplies T by 1, which
// leave both as they are (finite colours), so the update needs no branch.
// The colour sums take a fused multiply-add: one rounding where the plain
// version's einsum rounds twice, and in another order anyway.
template <int PPT>
__device__ __forceinline__ void composite_rows(const float4* rows, int n, float px,
                                               const float (&py)[PPT], float (&T)[PPT],
                                               float (&cr)[PPT], float (&cg)[PPT],
                                               float (&cb)[PPT]) {
  const int lane = threadIdx.x & 31;
  for (int g = 0; g < n; g += 32) {        // groups of 32 rows
    const int m = min(32, n - g);
    // lane l: the cull threshold of the group's row l
    const float thr = lane < m ? cull_threshold(rows[3 * lane + 1].y) : 0.0f;
    for (int rr = 0; rr < m; ++rr, rows += 3) {
      const float pthr = __shfl_sync(0xffffffffu, thr, rr);
      const float4 r0 = rows[0], r1 = rows[1];
      const float ca = r0.z, cbq = r0.w, cc = r1.x;
      // the terms of the column, then of each row
      const float dx = px - r0.x;
      const float caxx = ca * dx * dx;
      const float cbdx = cbq * dx;
      float power[PPT];
      bool live = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float dy = py[k] - r0.y;
        // -0.5 (ca dx dx + cc dy dy) - cbq dx dy, in the plain version's order
        power[k] = -0.5f * (caxx + cc * dy * dy) - cbdx * dy;
        live |= !(power[k] < pthr);
      }
      // the warp row cull: no sample of the warp can reach 1/255
      if (!__any_sync(0xffffffffu, live)) continue;
      const float op = r1.y, red = r1.z, green = r1.w, blue = rows[2].x;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float alpha = fminf(op * expf(power[k]), kAlphaMax);
        const float a = alpha >= kAlphaMin ? alpha : 0.0f;
        const float wgt = a * T[k];
        cr[k] = __fmaf_rn(red, wgt, cr[k]);
        cg[k] = __fmaf_rn(green, wgt, cg[k]);
        cb[k] = __fmaf_rn(blue, wgt, cb[k]);
        T[k] = T[k] * (1.0f - a);
      }
    }
  }
}

// K2 (CLUSTER 1, no checkpoints) and K4 (CLUSTER > 1, CKPT). A tile's
// 32*TW samples over CLUSTER CTAs of 32*TW/(PPT*CLUSTER) threads; warp g of
// the tile (g = rank * warps a CTA + warp) covers the footprint of kFootW
// columns by 4*PPT rows at column (g mod TW/8)*8, row (g div TW/8)*4*PPT.
template <int TW, int PPT, int CLUSTER, bool CKPT>
__global__ void __launch_bounds__(kTileH * TW / (PPT * CLUSTER))
tile_composite_kernel(const float4* __restrict__ rec4, const int* __restrict__ idx, int nrows,
                      const int* __restrict__ row_begin, const int* __restrict__ row_end,
                      const int* __restrict__ ck_off, float* __restrict__ out,
                      int* __restrict__ exec_out, float* __restrict__ ckpt, int ntiles,
                      int ntx) {
  constexpr int kPix = kTileH * TW;
  constexpr int kThreads = kPix / (PPT * CLUSTER);
  constexpr int kFootH = kLanesY * PPT;
  constexpr int kWarpsX = TW / kFootW;
  __shared__ float4 s[2][kChunk][3];
  __shared__ int votes[2][CLUSTER];   // K4: each CTA's chunk-end bit, by chunk parity
  const int tile = blockIdx.x / CLUSTER;
  const int rank = blockIdx.x % CLUSTER;
  const int warp = rank * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int x = (warp % kWarpsX) * kFootW + lane % kFootW;
  const int y0 = (warp / kWarpsX) * kFootH + lane / kFootW;
  const int tx0 = (tile % ntx) * TW;
  const int ty0 = (tile / ntx) * kTileH;
  const float px = (float)(x + tx0) + 0.5f;
  float py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    py[k] = (float)(y0 + kLanesY * k + ty0) + 0.5f;
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
  }
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  int executed = 0;
  // K2 and K4 enter at T = 1, so no tile is skipped at entry
  if (e > b) {
    if constexpr (CLUSTER > 1) cluster_arrive_relaxed();   // this CTA has started
    const int first = (b / kChunk) * kChunk;
    float* ck = nullptr;
    if constexpr (CKPT) ck = ckpt + (size_t)ck_off[tile] * kPix;
    stage_rows<kThreads>(s[0], rec4, idx, b, min(e, first + kChunk) - b);
    int buf = 0;
    for (int base = first; base < e; base += kChunk, buf ^= 1) {
      const int lo = max(b, base);
      const int n = min(e, base + kChunk) - lo;
      const int next = base + kChunk;
      if constexpr (CKPT) {   // the chunk's entry T
#pragma unroll
        for (int k = 0; k < PPT; ++k) ck[(y0 + kLanesY * k) * TW + x] = T[k];
        ck += kPix;
      }
      if (next < e) {
        // buf ^ 1 was last read before the previous chunk's vote
        stage_rows<kThreads>(s[buf ^ 1], rec4, idx, next, min(e, next + kChunk) - next);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      composite_rows<PPT>(&s[buf][0][0], n, px, py, T, cr, cg, cb);
      executed += n;
      int sat = 1;
#pragma unroll
      for (int k = 0; k < PPT; ++k) sat &= (T[k] < kTEps);
      // also the barrier before the next prefetch overwrites this buffer
      sat = __syncthreads_and(sat);
      if constexpr (CLUSTER > 1) {
        // the tile-wide vote: this CTA's bit into slot `rank` of every CTA
        int* slot = votes[buf];
        if (base == first) cluster_wait();   // every CTA of the cluster has started
        if (threadIdx.x < CLUSTER) *cluster_map(slot + rank, threadIdx.x) = sat;
        cluster_sync();
        sat = 1;
#pragma unroll
        for (int c = 0; c < CLUSTER; ++c) sat &= slot[c];
      }
      if (sat) break;
    }
    cp_async_wait<0>();                   // a dropped prefetch lands before exit
  }
  const size_t plane = (size_t)ntiles * kPix;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t o = (size_t)tile * kPix + (size_t)(y0 + kLanesY * k) * TW + x;
    out[o] = cr[k];
    out[plane + o] = cg[k];
    out[2 * plane + o] = cb[k];
    out[3 * plane + o] = T[k];
  }
  if (rank == 0 && threadIdx.x == 0) exec_out[tile] = executed;
}

// The sample grid of K3 at tile width TW and decim D: (32/D) x (TW/D)
// samples, PPT a thread, in warp footprints of 8 x 4*PPT.
template <int TW, int D>
struct TailGrid {
  static constexpr int kPpt = tail_ppt(TW, D);
  static constexpr int kTwd = TW / D;
  static constexpr int kPix = (kTileH / D) * kTwd;
  static constexpr int kThreads = kPix / kPpt;
  static constexpr int kFootH = kLanesY * kPpt;
  static_assert(kTwd % kFootW == 0 && (kTileH / D) % kFootH == 0, "footprint");
};

// K3's first pass: chunk-local composites. CTA s of tile t composites the
// tile's chunks j = s, s + kTailSplit, ... each from T = 1 and stores its
// (r, g, b, T_loc) into part[slot(t, j)] (4 planes of pixd floats), slot(t,
// j) = first_t/128 + t + j, first_t the 128-row block holding row_begin[t]:
// distinct for every (t, j) of row ranges that ascend with t and do not
// overlap (every layout of the port), and below ceil(nrows/128) + ntiles.
// A tile that enters saturated composites nothing.
template <int TW, int D>
__global__ void __launch_bounds__(TailGrid<TW, D>::kThreads)
tail_chunk_kernel(const float4* __restrict__ rec4, const int* __restrict__ idx, int nrows,
                  const int* __restrict__ row_begin, const int* __restrict__ row_end,
                  const float* __restrict__ t_entry, float* __restrict__ part, int ntx) {
  using G = TailGrid<TW, D>;
  constexpr int PPT = G::kPpt;
  constexpr int kPix = G::kPix;
  constexpr int kWarpsX = G::kTwd / kFootW;
  __shared__ float4 s[2][kChunk][3];
  const int tile = blockIdx.x / kTailSplit;
  const int first_j = blockIdx.x % kTailSplit;
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  const int first = (b / kChunk) * kChunk;
  const int nch = e > b ? (e - first + kChunk - 1) / kChunk : 0;
  if (first_j >= nch) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = (warp % kWarpsX) * kFootW + lane % kFootW;
  const int y0 = (warp / kWarpsX) * G::kFootH + lane / kFootW;
  const float half = 0.5f * (float)D;
  const float px = (float)(x * D + (tile % ntx) * TW) + half;
  int at[PPT];
  float py[PPT];
  int sat = 1;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int y = y0 + kLanesY * k;
    at[k] = y * G::kTwd + x;
    py[k] = (float)(y * D + (tile / ntx) * kTileH) + half;
    sat &= (t_entry[(size_t)tile * kPix + at[k]] < kTEps);
  }
  if (__syncthreads_and(sat)) return;   // entry skip
  auto rows = [&](int j, int& lo) {     // rows [lo, lo + n) of chunk j
    lo = max(b, first + j * kChunk);
    return min(e, first + (j + 1) * kChunk) - lo;
  };
  int lo;
  int n = rows(first_j, lo);
  stage_rows<G::kThreads>(s[0], rec4, idx, lo, n);
  float* dst = part + ((size_t)(first / kChunk) + tile) * 4 * kPix;
  int buf = 0;
  for (int j = first_j; j < nch; j += kTailSplit, buf ^= 1) {
    n = rows(j, lo);
    if (j + kTailSplit < nch) {
      int nlo;
      const int nn = rows(j + kTailSplit, nlo);
      stage_rows<G::kThreads>(s[buf ^ 1], rec4, idx, nlo, nn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float T[PPT], cr[PPT], cg[PPT], cb[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      T[k] = 1.0f;
      cr[k] = cg[k] = cb[k] = 0.0f;
    }
    composite_rows<PPT>(&s[buf][0][0], n, px, py, T, cr, cg, cb);
    float* o = dst + (size_t)j * 4 * kPix;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      o[at[k]] = cr[k];
      o[kPix + at[k]] = cg[k];
      o[2 * kPix + at[k]] = cb[k];
      o[3 * kPix + at[k]] = T[k];
    }
    __syncthreads();   // before the next prefetch overwrites this buffer
  }
}

// K3's second pass: one CTA a tile merges its chunks' partials in order,
// sample by sample, C <- C + T*C_loc, T <- T*T_loc from the entry T,
// counts each chunk's rows into exec and stops after the first chunk that
// leaves every sample below T = 1e-4. Writes every tile's outputs.
template <int TW, int D>
__global__ void __launch_bounds__(TailGrid<TW, D>::kThreads)
tail_merge_kernel(int nrows, const int* __restrict__ row_begin, const int* __restrict__ row_end,
                  const float* __restrict__ t_entry, const float* __restrict__ part,
                  float* __restrict__ out, int* __restrict__ exec_out, int ntiles) {
  using G = TailGrid<TW, D>;
  constexpr int PPT = G::kPpt;
  constexpr int kPix = G::kPix;
  const int tile = blockIdx.x;
  float T[PPT], cr[PPT], cg[PPT], cb[PPT];
  int sat = 1;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    T[k] = t_entry[(size_t)tile * kPix + threadIdx.x + k * G::kThreads];
    cr[k] = cg[k] = cb[k] = 0.0f;
    sat &= (T[k] < kTEps);
  }
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  int executed = 0;
  if (e > b && !__syncthreads_and(sat)) {
    const int first = (b / kChunk) * kChunk;
    const float* p = part + ((size_t)(first / kChunk) + tile) * 4 * kPix + threadIdx.x;
    const int nch = (e - first + kChunk - 1) / kChunk;
    // the partials of kBatch chunks are loaded together, so one memory
    // latency is spent a batch, not a chunk; slots past the stop are loaded
    // and not used
    constexpr int kBatch = 8 / PPT;
    for (int j0 = 0; j0 < nch; j0 += kBatch, p += kBatch * 4 * kPix) {
      float q[kBatch][4][PPT];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < PPT; ++k)
            q[jj][c][k] = j0 + jj < nch ? p[(jj * 4 + c) * kPix + k * G::kThreads] : 0.0f;
      int stop = 0;
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        if (stop || j0 + jj >= nch) break;
        int all = 1;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          cr[k] = cr[k] + T[k] * q[jj][0][k];
          cg[k] = cg[k] + T[k] * q[jj][1][k];
          cb[k] = cb[k] + T[k] * q[jj][2][k];
          T[k] = T[k] * q[jj][3][k];
          all &= (T[k] < kTEps);
        }
        const int base = first + (j0 + jj) * kChunk;
        executed += min(e, base + kChunk) - max(b, base);
        stop = __syncthreads_and(all);
      }
      if (stop) break;
    }
  }
  const size_t plane = (size_t)ntiles * kPix;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t o = (size_t)tile * kPix + threadIdx.x + k * G::kThreads;
    out[o] = cr[k];
    out[plane + o] = cg[k];
    out[2 * plane + o] = cb[k];
    out[3 * plane + o] = T[k];
  }
  if (threadIdx.x == 0) exec_out[tile] = executed;
}

// K4 at one tile width: a cluster of kCluster CTAs of kThreads a tile.
template <int TW>
struct Ckpt {
  static constexpr int kCluster = ckpt_cluster(TW);
  static constexpr int kThreads = kCkptThreads;
  static auto kernel() { return tile_composite_kernel<TW, kCkptPpt, kCluster, true>; }
};

// f(Ckpt<tile_w>{}) for tile_w 32, 64 or 128, else cudaErrorInvalidValue.
template <typename F>
int with_ckpt(int tile_w, F&& f) {
  switch (tile_w) {
    case 32: return f(Ckpt<32>{});
    case 64: return f(Ckpt<64>{});
    case 128: return f(Ckpt<128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// A launch configuration of ntiles clusters of `cluster` CTAs of `threads`
// along x; a cluster of more than 8 CTAs needs the non-portable size.
template <typename... A>
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;
  ClusterLaunch(void (*kern)(A...), int ntiles, int threads, int cluster, cudaStream_t st) {
    if (cluster > kPortableCluster)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg.gridDim = dim3((unsigned)(ntiles * cluster), 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// K3 at one tile width and decim: the first pass's kSplit CTAs a tile and
// both passes' threads.
template <int TW, int D>
struct Tail {
  static constexpr int kSplit = kTailSplit;
  static constexpr int kThreads = TailGrid<TW, D>::kThreads;
  static auto chunk() { return tail_chunk_kernel<TW, D>; }
  static auto merge() { return tail_merge_kernel<TW, D>; }
};

template <int TW, typename F>
int with_tail_d(int decim, F&& f) {
  switch (decim) {
    case 1: return f(Tail<TW, 1>{});
    case 2: return f(Tail<TW, 2>{});
    case 4: return f(Tail<TW, 4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(Tail<tile_w, decim>{}), tile_w 32/64/128 and decim 1/2/4, else
// cudaErrorInvalidValue.
template <typename F>
int with_tail(int tile_w, int decim, F&& f) {
  switch (tile_w) {
    case 32: return with_tail_d<32>(decim, std::forward<F>(f));
    case 64: return with_tail_d<64>(decim, std::forward<F>(f));
    case 128: return with_tail_d<128>(decim, std::forward<F>(f));
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int TW>
void launch_head(const float4* r, const int* idx, int nrows, const int* rb, const int* re,
                 float* o, int* ex, int ntiles, int ntx, cudaStream_t st) {
  constexpr int ppt = head_ppt(TW);
  tile_composite_kernel<TW, ppt, 1, false><<<ntiles, kTileH * TW / ppt, 0, st>>>(
      r, idx, nrows, rb, re, nullptr, o, ex, nullptr, ntiles, ntx);
}

}  // namespace

// K2. rec (N, 12) f32 record table, 16-byte aligned; idx (nrows,) i32, the
// layout: row r is record idx[r], every id below N; row_begin/row_end
// (ntiles,) i32 rows of the layout; out (4, ntiles, 32*tile_w) f32 = r, g,
// b, T planes; exec (ntiles,) i32. tile_w must be 32, 64 or 128. Returns
// cudaGetLastError() after the launch.
extern "C" int gs_composite(const void* rec, const void* idx, int nrows, const void* row_begin,
                            const void* row_end, void* out, void* exec, int ntiles,
                            int ntx, int tile_w, void* stream) {
  if ((uintptr_t)rec % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (ntiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float4* r = (const float4*)rec;
    const int* ix = (const int*)idx;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    float* o = (float*)out;
    int* ex = (int*)exec;
    switch (tile_w) {
      case 32:
        launch_head<32>(r, ix, nrows, rb, re, o, ex, ntiles, ntx, st);
        break;
      case 64:
        launch_head<64>(r, ix, nrows, rb, re, o, ex, ntiles, ntx, st);
        break;
      case 128:
        launch_head<128>(r, ix, nrows, rb, re, o, ex, ntiles, ntx, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// K2's warp footprint at tile_w (32, 64 or 128): *cols columns by *rows
// rows of samples, as tile_composite_kernel lays a warp out, for counting
// what its warp row cull skips (chip_smoke.py). Returns
// cudaErrorInvalidValue for another tile_w.
extern "C" int gs_composite_footprint(int tile_w, int* cols, int* rows) {
  if (tile_w != 32 && tile_w != 64 && tile_w != 128) return (int)cudaErrorInvalidValue;
  *cols = kFootW;
  *rows = kLanesY * head_ppt(tile_w);
  return 0;
}

// How K4 (kernel 4, at tile_w; decim ignored) or K3's first pass (kernel
// 3, at tile_w and decim) spreads a tile: *ctas CTAs a tile (K4: its
// cluster), *threads a CTA, and *resident, the CTAs of it that the card
// holds at once (K4: cudaOccupancyMaxActiveClusters times the cluster).
// Returns a CUDA error code.
extern "C" int gs_composite_shape(int kernel, int tile_w, int decim, int* ctas, int* threads,
                                  int* resident) {
  if (kernel == 4)
    return with_ckpt(tile_w, [&](auto k) {
      using K = decltype(k);
      *ctas = K::kCluster;
      *threads = K::kThreads;
      ClusterLaunch l(K::kernel(), 1, K::kThreads, K::kCluster, nullptr);
      int clusters = 0;
      if (l.err == cudaSuccess)
        l.err = cudaOccupancyMaxActiveClusters(&clusters, K::kernel(), &l.cfg);
      *resident = clusters * K::kCluster;
      return (int)l.err;
    });
  if (kernel == 3)
    return with_tail(tile_w, decim, [&](auto k) {
      using K = decltype(k);
      *ctas = K::kSplit;
      *threads = K::kThreads;
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K::chunk(), K::kThreads, 0);
      *resident = per_sm * sms;
      return (int)err;
    });
  return (int)cudaErrorInvalidValue;
}

// K3. As K2 (records fetched through idx), at decim 1, 2 or 4, entered at
// t_entry (ntiles, pixd) f32; out (4, ntiles, pixd) f32 with absolute T,
// pixd = (32/decim)*(tile_w/decim). Row ranges ascend with the tile index
// and do not overlap. scratch holds (ceil(nrows/128) + ntiles, 4, pixd) f32
// of chunk partials between the two launches. Returns the first launch's
// error, else cudaGetLastError() after the second.
extern "C" int gs_composite_tail(const void* rec, const void* idx, int nrows,
                                 const void* row_begin, const void* row_end,
                                 const void* t_entry, void* out, void* exec, int ntiles,
                                 int ntx, int tile_w, int decim, void* stream, void* scratch) {
  if ((uintptr_t)rec % 16 != 0) return (int)cudaErrorMisalignedAddress;
  return with_tail(tile_w, decim, [&](auto k) {
    using K = decltype(k);
    if (ntiles == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    const float* te = (const float*)t_entry;
    float* part = (float*)scratch;
    K::chunk()<<<ntiles * K::kSplit, K::kThreads, 0, st>>>(
        (const float4*)rec, (const int*)idx, nrows, rb, re, te, part, ntx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    K::merge()<<<ntiles, K::kThreads, 0, st>>>(nrows, rb, re, te, part, (float*)out,
                                               (int*)exec, ntiles);
    return (int)cudaGetLastError();
  });
}

// K4. As K2 on packed records: rec (nrows, 12) f32, row r of the layout is
// record r. At the top of every chunk it runs, tile t writes its T
// into ckpt row ck_off[t] + j (j: the chunk's index among the tile's
// chunks, counted from the 128-row block holding row_begin[t]).
// ck_off (ntiles,) i32; ckpt (nslots, 32*tile_w) f32. Returns the launch's
// error, else cudaGetLastError().
extern "C" int gs_composite_ckpt(const void* rec, int nrows, const void* row_begin,
                                 const void* row_end, const void* ck_off, void* out,
                                 void* exec, void* ckpt, int ntiles, int ntx,
                                 int tile_w, void* stream) {
  if ((uintptr_t)rec % 16 != 0) return (int)cudaErrorMisalignedAddress;
  return with_ckpt(tile_w, [&](auto k) {
    using K = decltype(k);
    if (ntiles == 0) return (int)cudaGetLastError();
    ClusterLaunch l(K::kernel(), ntiles, K::kThreads, K::kCluster, (cudaStream_t)stream);
    if (l.err == cudaSuccess)
      l.err = cudaLaunchKernelEx(&l.cfg, K::kernel(), (const float4*)rec, (const int*)nullptr,
                                 nrows, (const int*)row_begin, (const int*)row_end,
                                 (const int*)ck_off, (float*)out, (int*)exec, (float*)ckpt,
                                 ntiles, ntx);
    const cudaError_t last = cudaGetLastError();
    return (int)(l.err != cudaSuccess ? l.err : last);
  });
}
