// K5 — backward of the tile composite, one CTA per tile.
//
// Replaces the TPU kernel ray_eater_tpu/ops/gs.py _composite_bwd_kernel
// (:1593), launched by _composite_bwd_call (:1709). Given dL/d(r, g, b, T)
// planes, it returns dL/d(packed row) for every row of the chunks that the
// forward (K4, gs_composite.cu) ran, in the columns mx, my, conic a, conic
// b, conic c, opacity, r, g, b, then three zeros. The wrapper zero-fills
// the output; the kernel writes every row of every executed chunk.
//
// The standard 3DGS backward, per sample and row i of the tile's list:
//   w_i = a_i T_i,  dL/dc_i += w_i dC,
//   dL/da_i = (c_i . dC) T_i - (S_i + dT T_final) / (1 - a_i),
// where S_i = sum over later rows j (this chunk and later chunks) of
// (c_j . dC) w_j. No gradient flows through a where it was clamped at 0.99
// or floored below 1/255; rows outside [row_begin, row_end) get none.
//
// Design. The TPU kernel's reverse sweep, doubling-scan prefix,
// strictly-triangular MXU matmuls and pixel-span slices were TPU
// workarounds and are not carried over. The sum of (c_j . dC) w_j over
// every executed row is already known: it is K4's colour planes dotted
// with dC. So S_i = C . dC - prefix_incl(i), and each CTA walks its tile's
// executed rows FIRST to last (rows b .. b+exec-1, from K4's exec), with
// the same sample-to-thread map as K2 (min(pixd, 1024) threads, PPT
// samples each) and S carried per sample in a register. T_i is never
// recovered by dividing the exit T by (1 - a): with a up to 0.99 that
// product underflows inside a chunk. Each chunk starts from its K4
// checkpoint and rebuilds T_i by K2's own running product. A row's
// gradient is a sum over the tile's samples: each warp reduces it with
// shuffles (skipped when no lane of the warp touched the row) and one lane
// adds it into a (9, 128) shared-memory row block with shared atomics. Each
// packed row belongs to one tile in both layouts, so no global atomics.
//
// Bound on an H100 SXM: operations. Counted from this source, an executed
// pair-sample costs 14 f32 operations and one expf to find its alpha (dx,
// dy, the quadratic, the opacity, the clamp, the floor test); one with
// alpha >= 1/255 adds 17 (w, the colour terms, c . dC, S, the T update,
// the clamp test); one whose alpha was not clamped adds 30 more (dL/da
// with its division, the opacity and five geometric terms): 61 and one
// expf for most live pairs. The warp reductions are not counted: they are
// this kernel's way to sum over samples, not work the function needs.
// chip_smoke.py counts each class of pair-sample in its run. Bytes are small
// beside that: the executed rows (36 B each, read, and 48 B written), one
// (pixd,) checkpoint row per executed chunk, and eight (ntiles, pixd)
// planes read once (the forward's r, g, b, T and the cotangents).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;
constexpr int kTileH = 32;
constexpr int kMaxThreads = 1024;
constexpr int kCols = 12;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// planes (4, ntiles, pix) = K4's r, g, b, T; dplanes (4, ntiles, pix) =
// dL/d(r, g, b, T); ckpt rows ck_off[tile] + j as written by K4.
template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
composite_bwd_kernel(const float* __restrict__ rec, int nrows,
                     const int* __restrict__ row_begin, const int* __restrict__ row_end,
                     const int* __restrict__ exec, const int* __restrict__ ck_off,
                     const float* __restrict__ ckpt, const float* __restrict__ planes,
                     const float* __restrict__ dplanes, float* __restrict__ grad,
                     int ntiles, int ntx, int tile_w) {
  __shared__ float s[9][kChunk];
  __shared__ float sg[9][kChunk];
  const int nthreads = blockDim.x;
  const int tile = blockIdx.x;
  const int pix = PPT * nthreads;
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  const int ex = exec[tile];
  if (ex <= 0 || e <= b) return;          // uniform over the block
  const int first = (b / kChunk) * kChunk;
  const int last = b + ex;                // one past the last executed row
  const int shift = __ffs(tile_w) - 1;
  const int tx0 = (tile % ntx) * tile_w;
  const int ty0 = (tile / ntx) * kTileH;
  const size_t plane = (size_t)ntiles * pix;
  const int lane = threadIdx.x & 31;

  float px[PPT], py[PPT], dr[PPT], dg[PPT], db[PPT], dtt[PPT], S[PPT];
  float T[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = threadIdx.x + k * nthreads;
    px[k] = (float)((i & (tile_w - 1)) + tx0) + 0.5f;
    py[k] = (float)((i >> shift) + ty0) + 0.5f;
    const size_t o = (size_t)tile * pix + i;
    dr[k] = dplanes[o];
    dg[k] = dplanes[plane + o];
    db[k] = dplanes[2 * plane + o];
    dtt[k] = dplanes[3 * plane + o] * planes[3 * plane + o];
    // S before the first row: every executed row's (c . dC) w
    S[k] = planes[o] * dr[k] + planes[plane + o] * dg[k] + planes[2 * plane + o] * db[k];
  }

  for (int base = first, j = 0; base < last; base += kChunk, ++j) {
    const int lo = max(b, base);
    const int n = min(last, base + kChunk) - lo;
    for (int idx = threadIdx.x; idx < n * 9; idx += nthreads) {
      const int rr = idx / 9;
      const int col = idx - rr * 9;
      s[col][rr] = rec[(size_t)(lo + rr) * kCols + col];
    }
    for (int idx = threadIdx.x; idx < 9 * kChunk; idx += nthreads)
      (&sg[0][0])[idx] = 0.0f;
    const float* te = ckpt + ((size_t)ck_off[tile] + j) * pix;
#pragma unroll
    for (int k = 0; k < PPT; ++k) T[k] = te[threadIdx.x + k * nthreads];
    __syncthreads();

    for (int rr = 0; rr < n; ++rr) {
      const float mx = s[0][rr], my = s[1][rr];
      const float ca = s[2][rr], cbq = s[3][rr], cc = s[4][rr];
      const float op = s[5][rr];
      const float red = s[6][rr], green = s[7][rr], blue = s[8][rr];
      float g[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) g[c] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float dx = px[k] - mx;
        const float dy = py[k] - my;
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cbq * dx * dy;
        const float ep = expf(power);
        const float araw = op * ep;
        const float alpha = fminf(araw, kAlphaMax);
        if (alpha >= kAlphaMin) {
          touched = true;
          const float ti = T[k];
          const float w = alpha * ti;
          g[6] += w * dr[k];
          g[7] += w * dg[k];
          g[8] += w * db[k];
          const float a_dot = red * dr[k] + green * dg[k] + blue * db[k];
          S[k] -= a_dot * w;              // now the later rows' sum
          const float om = 1.0f - alpha;
          if (araw < kAlphaMax) {
            const float d_alpha = a_dot * ti - (S[k] + dtt[k]) / fmaxf(om, 1e-6f);
            const float gp = alpha * d_alpha;
            g[0] += gp * (ca * dx + cbq * dy);
            g[1] += gp * (cbq * dx + cc * dy);
            g[2] += gp * (-0.5f) * dx * dx;
            g[3] += gp * (-dx * dy);
            g[4] += gp * (-0.5f) * dy * dy;
            g[5] += ep * d_alpha;
          }
          T[k] = ti * om;
        }
      }
      if (__any_sync(0xffffffffu, touched)) {
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const float v = warp_sum(g[c]);
          if (lane == 0) atomicAdd(&sg[c][rr], v);
        }
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n * kCols; idx += nthreads) {
      const int rr = idx / kCols;
      const int col = idx - rr * kCols;
      grad[(size_t)(lo + rr) * kCols + col] = col < 9 ? sg[col][rr] : 0.0f;
    }
    // the next chunk overwrites s and sg
    __syncthreads();
  }
}

}  // namespace

// K5. rec (nrows, 12) f32 packed records; row_begin/row_end/exec (ntiles,)
// i32 as K4 read and returned them; ck_off (ntiles,) i32 and ckpt (nslots,
// 32*tile_w) f32 as K4 wrote them; planes (4, ntiles, 32*tile_w) f32, K4's
// r, g, b, T planes; dplanes (4, ntiles, 32*tile_w) f32; grad (nrows, 12)
// f32, zeroed by the caller. tile_w must be 32, 64 or 128. Returns
// cudaGetLastError().
extern "C" int gs_composite_bwd(const void* rec, int nrows, const void* row_begin,
                                const void* row_end, const void* exec,
                                const void* ck_off, const void* ckpt,
                                const void* planes, const void* dplanes, void* grad,
                                int ntiles, int ntx, int tile_w, void* stream) {
  if (tile_w != 32 && tile_w != 64 && tile_w != 128) return (int)cudaErrorInvalidValue;
  if (ntiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float* r = (const float*)rec;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    const int* ex = (const int*)exec;
    const int* co = (const int*)ck_off;
    const float* ck = (const float*)ckpt;
    const float* pl = (const float*)planes;
    const float* dp = (const float*)dplanes;
    float* g = (float*)grad;
    const int pix = kTileH * tile_w;
    const int threads = pix < kMaxThreads ? pix : kMaxThreads;
    switch (pix / threads) {
      case 1:
        composite_bwd_kernel<1><<<ntiles, threads, 0, st>>>(r, nrows, rb, re, ex, co, ck, pl, dp, g, ntiles, ntx, tile_w);
        break;
      case 2:
        composite_bwd_kernel<2><<<ntiles, threads, 0, st>>>(r, nrows, rb, re, ex, co, ck, pl, dp, g, ntiles, ntx, tile_w);
        break;
      case 4:
        composite_bwd_kernel<4><<<ntiles, threads, 0, st>>>(r, nrows, rb, re, ex, co, ck, pl, dp, g, ntiles, ntx, tile_w);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
