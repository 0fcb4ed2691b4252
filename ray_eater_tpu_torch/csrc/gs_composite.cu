// K2 — front-to-back tile composite, one CTA per tile.
//
// Replaces the TPU kernel ray_eater_tpu/ops/gs.py _composite_kernel (:1239)
// with its chunk body _composite_chunk (:1306), launched by _composite_call
// (:1375). The TPU ran a sequential grid over scalar-prefetched steps and a
// doubling-scan transmittance prefix; here each CTA owns one tile and walks
// its packed rows [row_begin, row_end) in order, so the prefix becomes a
// running product (a reassociation of the same sum).
//
// Semantics kept because they decide the image or the stats:
//   * chunks are cut at absolute multiples of 128 rows of the packed array;
//   * after each chunk, and only then, the tile stops when every pixel of it
//     (the padded rows below the image included) has T < 1e-4 — a block-wide
//     vote, no per-pixel early exit;
//   * exec counts the live rows of every chunk that ran, before that check;
//   * every tile's outputs are written, so unvisited tiles read r=g=b=0, T=1.
//
// Bound on an H100 SXM: operations. Each executed pair-pixel costs about 12
// f32 flops and one expf; the records are read once (36 B of used columns a
// row) and the four planes written once. Making it fast (wgmma, TMA,
// persistent CTAs) is later work: this version stages each chunk's nine used
// record columns in shared memory and lets 1024 threads each own 32*tile_w/1024
// pixels in registers.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kTileH = 32;
constexpr int kThreads = 1024;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;

template <int PPT>
__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ rec, int nrows,
                 const int* __restrict__ row_begin, const int* __restrict__ row_end,
                 float* __restrict__ out, int* __restrict__ exec_out, int ntiles,
                 int ntx, int tile_w) {
  __shared__ float s[9][kChunk];
  const int tile = blockIdx.x;
  const int pix = kTileH * tile_w;
  const int shift = __ffs(tile_w) - 1;
  const int tx0 = (tile % ntx) * tile_w;
  const int ty0 = (tile / ntx) * kTileH;
  float px[PPT], py[PPT], T[PPT], cr[PPT], cg[PPT], cb[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * kThreads;
    px[k] = (float)((i & (tile_w - 1)) + tx0) + 0.5f;
    py[k] = (float)((i >> shift) + ty0) + 0.5f;
    T[k] = 1.0f;
    cr[k] = cg[k] = cb[k] = 0.0f;
  }
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  int executed = 0;
  if (e > b) {
    for (int base = (b / kChunk) * kChunk; base < e; base += kChunk) {
      const int lo = max(b, base);
      const int n = min(e, base + kChunk) - lo;
      for (int idx = threadIdx.x; idx < n * 9; idx += kThreads) {
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
      int sat = 1;
#pragma unroll
      for (int k = 0; k < PPT; ++k) sat &= (T[k] < kTEps);
      // also the barrier before the next chunk overwrites shared memory
      if (__syncthreads_and(sat)) break;
    }
  }
  const size_t plane = (size_t)ntiles * pix;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const size_t o = (size_t)tile * pix + threadIdx.x + k * kThreads;
    out[o] = cr[k];
    out[plane + o] = cg[k];
    out[2 * plane + o] = cb[k];
    out[3 * plane + o] = T[k];
  }
  if (threadIdx.x == 0) exec_out[tile] = executed;
}

}  // namespace

// rec (nrows, 12) f32 packed records; row_begin/row_end (ntiles,) i32;
// out (4, ntiles, 32*tile_w) f32 = r, g, b, T planes; exec (ntiles,) i32.
// tile_w must be 32, 64 or 128. Returns cudaGetLastError() after the launch.
extern "C" int gs_composite(const void* rec, int nrows, const void* row_begin,
                            const void* row_end, void* out, void* exec, int ntiles,
                            int ntx, int tile_w, void* stream) {
  if (ntiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float* r = (const float*)rec;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    float* o = (float*)out;
    int* ex = (int*)exec;
    switch (tile_w) {
      case 32:
        composite_kernel<1><<<ntiles, kThreads, 0, st>>>(r, nrows, rb, re, o, ex, ntiles, ntx, tile_w);
        break;
      case 64:
        composite_kernel<2><<<ntiles, kThreads, 0, st>>>(r, nrows, rb, re, o, ex, ntiles, ntx, tile_w);
        break;
      case 128:
        composite_kernel<4><<<ntiles, kThreads, 0, st>>>(r, nrows, rb, re, o, ex, ntiles, ntx, tile_w);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
