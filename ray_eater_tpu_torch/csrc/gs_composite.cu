// K2 — front-to-back tile composite, one CTA per tile — K3, the same
// composite on a decimated grid for the LOD's decimated tail, and K4, K2
// plus entry-T checkpoints for the training backward (K5,
// gs_composite_bwd.cu).
//
// K2 replaces the TPU kernel ray_eater_tpu/ops/gs.py _composite_kernel
// (:1239) with its chunk body _composite_chunk (:1306), launched by
// _composite_call (:1375). K3 replaces _composite_tail_kernel (:1416),
// launched by _composite_tail_call (:1474). K4 replaces
// _composite_kernel_ckpt (:1528), launched by _composite_call_ckpt (:1556):
// at the top of every chunk it runs, the block writes its samples' T into
// the chunk's checkpoint slot ckpt[ck_off[tile] + j] (j counts the tile's
// chunks from its first), one (pixd,) row per executed chunk; chunks after
// saturation write nothing and K5 never reads them. The TPU ran a sequential grid
// over scalar-prefetched steps and a doubling-scan transmittance prefix;
// here each CTA owns one tile and walks its packed rows [row_begin,
// row_end) in order, so the prefix becomes a running product (a
// reassociation of the same sum). K3's 8-chunk grid steps reduce to the
// same per-chunk walk: tile bases are 128-row aligned and the TPU kernel
// re-checked saturation between its sub-chunks.
//
// Semantics kept because they decide the image or the stats:
//   * chunks are cut at absolute multiples of 128 rows of the packed array;
//   * a tile whose every sample enters below T = 1e-4 runs nothing (K3: a
//     tail behind a saturated head is skipped; K2 enters at T = 1);
//   * after each chunk, and only then, the tile stops when every sample of
//     it (the padded rows below the image included) has T < 1e-4 — a
//     block-wide vote, no per-pixel early exit;
//   * exec counts the live rows of every chunk that ran, before that check;
//   * every tile's outputs are written: rgb from 0, T from the entry T.
//
// Sample i of a tile sits at the centre of its decim x decim pixel quad:
// x = (i mod tile_w/decim)*decim + tx0 + decim/2, and likewise for y
// (decim 1 for K2).
//
// Bound on an H100 SXM: operations. Each executed pair-sample costs about
// 12 f32 flops and one expf; the records are read once (36 B of used
// columns a row) and the four planes written once (K4 also writes one
// (pixd,) f32 checkpoint row per executed chunk). Making it fast (wgmma,
// TMA, persistent CTAs) is later work: this version stages each chunk's
// nine used record columns in shared memory and lets each thread own PPT
// samples in registers — min(pixd, 1024) threads a tile, where
// pixd = (32/decim)*(tile_w/decim), so K3 at decim 4 and tile_w 64 runs
// 128 threads with one sample each.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kTileH = 32;
constexpr int kMaxThreads = 1024;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

// blockDim.x threads each own PPT of the tile's pixd = PPT * blockDim.x
// samples. t_entry (ntiles, pixd) or nullptr for T = 1; ckpt (nslots,
// pixd) with per-tile slot offsets ck_off (ntiles,), or nullptr (K2, K3).
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
composite_kernel(const float* __restrict__ rec, int nrows,
                 const int* __restrict__ row_begin, const int* __restrict__ row_end,
                 const float* __restrict__ t_entry, float* __restrict__ out,
                 int* __restrict__ exec_out, const int* __restrict__ ck_off,
                 float* __restrict__ ckpt, int ntiles, int ntx, int tile_w,
                 int decim) {
  __shared__ float s[9][kChunk];
  const int nthreads = blockDim.x;
  const int tile = blockIdx.x;
  const int pixd = PPT * nthreads;
  const int twd = tile_w / decim;
  const int shift = __ffs(twd) - 1;
  const int tx0 = (tile % ntx) * tile_w;
  const int ty0 = (tile / ntx) * kTileH;
  const float half = 0.5f * (float)decim;
  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT];
  int sat = 1;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * nthreads;
    px[k] = (float)((i & (twd - 1)) * decim + tx0) + half;
    py[k] = (float)((i >> shift) * decim + ty0) + half;
    T[k] = t_entry ? t_entry[(size_t)tile * pixd + i] : 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
    sat &= (T[k] < kTEps);
  }
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  int executed = 0;
  // entry skip: a tile entering saturated runs nothing
  if (e > b && !__syncthreads_and(sat)) {
    const int first = (b / kChunk) * kChunk;
    for (int base = first; base < e; base += kChunk) {
      const int lo = max(b, base);
      const int n = min(e, base + kChunk) - lo;
      if (ckpt) {   // K4: the chunk's entry T
        float* dst = ckpt + ((size_t)ck_off[tile] + (base - first) / kChunk) * pixd;
#pragma unroll
        for (int k = 0; k < PPT; ++k) dst[threadIdx.x + k * nthreads] = T[k];
      }
      for (int idx = threadIdx.x; idx < n * 9; idx += nthreads) {
        const int rr = idx / 9;
        const int col = idx - rr * 9;
        s[col][rr] = rec[(size_t)(lo + rr) * 12 + col];
      }
      __syncthreads();
      for (int rr = 0; rr < n; ++rr) {
        const float mx = s[0][rr], my = s[1][rr];
        const float ca = s[2][rr], cbq = s[3][rr], cc = s[4][rr];
        const float op = s[5][rr];
        const float red = s[6][rr], green = s[7][rr], blue = s[8][rr];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float dx = px[k] - mx;
          const float dy = py[k] - my;
          const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbq * dx * dy;
          const float alpha = fminf(op * expf(power), kAlphaMax);
          if (alpha >= kAlphaMin) {
            const float wgt = alpha * T[k];
            cr[k] += red * wgt;
            cg[k] += green * wgt;
            cb[k] += blue * wgt;
            T[k] = T[k] * (1.0f - alpha);
          }
        }
      }
      executed += n;
      sat = 1;
#pragma unroll
      for (int k = 0; k < PPT; ++k) sat &= (T[k] < kTEps);
      // also the barrier before the next chunk overwrites shared memory
      if (__syncthreads_and(sat)) break;
    }
  }
  const size_t plane = (size_t)ntiles * pixd;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t o = (size_t)tile * pixd + threadIdx.x + k * nthreads;
    out[o] = cr[k];
    out[plane + o] = cg[k];
    out[2 * plane + o] = cb[k];
    out[3 * plane + o] = T[k];
  }
  if (threadIdx.x == 0) exec_out[tile] = executed;
}

int launch(const void* rec, int nrows, const void* row_begin, const void* row_end,
           const void* t_entry, void* out, void* exec, const void* ck_off,
           void* ckpt, int ntiles, int ntx, int tile_w, int decim, void* stream) {
  if (tile_w != 32 && tile_w != 64 && tile_w != 128) return (int)cudaErrorInvalidValue;
  if (decim != 1 && decim != 2 && decim != 4) return (int)cudaErrorInvalidValue;
  if (ntiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float* r = (const float*)rec;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    const float* te = (const float*)t_entry;
    float* o = (float*)out;
    int* ex = (int*)exec;
    const int* co = (const int*)ck_off;
    float* ck = (float*)ckpt;
    const int pixd = (kTileH / decim) * (tile_w / decim);
    const int threads = pixd < kMaxThreads ? pixd : kMaxThreads;
    switch (pixd / threads) {
      case 1:
        composite_kernel<1><<<ntiles, threads, 0, st>>>(r, nrows, rb, re, te, o, ex, co, ck, ntiles, ntx, tile_w, decim);
        break;
      case 2:
        composite_kernel<2><<<ntiles, threads, 0, st>>>(r, nrows, rb, re, te, o, ex, co, ck, ntiles, ntx, tile_w, decim);
        break;
      case 4:
        composite_kernel<4><<<ntiles, threads, 0, st>>>(r, nrows, rb, re, te, o, ex, co, ck, ntiles, ntx, tile_w, decim);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K2. rec (nrows, 12) f32 packed records; row_begin/row_end (ntiles,) i32;
// out (4, ntiles, 32*tile_w) f32 = r, g, b, T planes; exec (ntiles,) i32.
// tile_w must be 32, 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int gs_composite(const void* rec, int nrows, const void* row_begin,
                            const void* row_end, void* out, void* exec, int ntiles,
                            int ntx, int tile_w, void* stream) {
  return launch(rec, nrows, row_begin, row_end, nullptr, out, exec, nullptr,
                nullptr, ntiles, ntx, tile_w, 1, stream);
}

// K3. As K2, at decim 1, 2 or 4, entered at t_entry (ntiles, pixd) f32;
// out (4, ntiles, pixd) f32 with absolute T, pixd = (32/decim)*(tile_w/decim).
extern "C" int gs_composite_tail(const void* rec, int nrows, const void* row_begin,
                                 const void* row_end, const void* t_entry, void* out,
                                 void* exec, int ntiles, int ntx, int tile_w,
                                 int decim, void* stream) {
  return launch(rec, nrows, row_begin, row_end, t_entry, out, exec, nullptr,
                nullptr, ntiles, ntx, tile_w, decim, stream);
}

// K4. As K2, and at the top of every chunk it runs, tile t writes its T
// into ckpt row ck_off[t] + j (j: the chunk's index among the tile's
// chunks, counted from the 128-row block holding row_begin[t]).
// ck_off (ntiles,) i32; ckpt (nslots, 32*tile_w) f32.
extern "C" int gs_composite_ckpt(const void* rec, int nrows, const void* row_begin,
                                 const void* row_end, const void* ck_off, void* out,
                                 void* exec, void* ckpt, int ntiles, int ntx,
                                 int tile_w, void* stream) {
  return launch(rec, nrows, row_begin, row_end, nullptr, out, exec, ck_off, ckpt,
                ntiles, ntx, tile_w, 1, stream);
}
