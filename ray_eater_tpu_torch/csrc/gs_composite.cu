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
// 12 f32 flops and one expf, which goes through the SFU (MUFU.EX2, 16 a
// clock per SM); the records are read once (36 B of used columns a row)
// and the four planes written once (K4 also writes one (pixd,) f32
// checkpoint row per executed chunk).
//
// K3 and K4 run composite_kernel: each chunk's nine used record columns
// staged in shared memory, each thread owning PPT samples in registers —
// min(pixd, 1024) threads a tile, where
// pixd = (32/decim)*(tile_w/decim), so K3 at decim 4 and tile_w 64 runs
// 128 threads with one sample each.
//
// K2 runs head_composite_kernel, built to spend fewer instructions: at one
// sample a thread a pair-sample costs nine scalar shared loads and the full
// quadratic, and every (warp, row) pair runs whether or not the row
// reaches the warp's pixels. So:
//   * fewer threads own more samples: 256 threads a tile at tile_w 32 (4
//     samples each) and 64 (8 each); 1024 at 128 (4 each), where a frame
//     has few busy tiles (the training frame: ~100 of 510), so a busy tile
//     needs a whole SM's warps. A thread reads a row's nine values as three
//     broadcast 16-byte shared loads and applies them to all its samples;
//   * a warp covers a footprint of 8 columns by 4*PPT rows (lane l at
//     column l mod 8, row l / 8; sample k 4k rows further down; the entry
//     point gs_composite_footprint reports it), so a thread's samples
//     share one column: dx, ca*dx*dx and cbq*dx are computed once a row,
//     the rest of the quadratic per sample;
//   * the warp row cull: a warp skips a row when every one of its samples
//     has power < cull_threshold(op), which proves alpha < 1/255 for each
//     (see there). It is exact: such a row changes neither colour nor T,
//     and exec counts the rows of chunks run, not live rows. Footprints
//     nearer a square than whole tile rows let more rows miss a warp;
//   * the records are double-buffered: while chunk j composites, cp.async
//     copies chunk j+1's rows (three 16-byte copies per 48-byte row; rows
//     are 16-byte aligned, the entry point checks) into the other buffer; a
//     tile that stops at the vote drops that copy.
// Every value is the same float32 operation on the same operands as in
// composite_kernel and the plain version (--fmad=false, IEEE expf), so the
// planes and exec do not depend on the design. What bounds it then is the
// instruction count of the per-pair work: about 37 a live pair-sample
// (expf's eight, the quadratic, the alpha test, the weighted adds and the
// branch around them).

#include <cuda_runtime.h>

#include <cstdint>

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

// K2's samples a thread by tile width (see the note at the top)
constexpr int head_ppt(int tw) { return tw == 128 ? 4 : tw == 64 ? 8 : 4; }
// columns of a warp's footprint (of 8 x 4*PPT samples)
constexpr int kFootW = 8;
// warp row cull: a row is skipped by a warp when every sample's power is
// below cull_threshold(op) (see there)
constexpr float kCullMargin = 1e-3f;
constexpr float kCullCap = 80.0f;

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

// Rows [lo, lo + n) of the records into dst, three 16-byte copies a row,
// as one cp.async group.
template <int THREADS>
__device__ __forceinline__ void stage_rows(float4 (*dst)[3], const float4* __restrict__ rec4,
                                           int lo, int n) {
  for (int q = threadIdx.x; q < 3 * n; q += THREADS)
    cp_async16(&dst[0][0] + q, rec4 + (size_t)lo * 3 + q);
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

// K2: 32*TW/PPT threads a tile. A warp covers a footprint of kFootW = 8
// columns by 4*PPT rows of the tile: lane l sits in column l mod 8 and row
// l / 8 of it, and its sample k 4k rows further down, so a thread's PPT
// samples share one column.
template <int TW, int PPT>
__global__ void __launch_bounds__(kTileH * TW / PPT)
head_composite_kernel(const float4* __restrict__ rec4, int nrows,
                      const int* __restrict__ row_begin, const int* __restrict__ row_end,
                      float* __restrict__ out, int* __restrict__ exec_out, int ntiles,
                      int ntx) {
  constexpr int kPix = kTileH * TW;
  constexpr int kThreads = kPix / PPT;
  constexpr int kLanesY = 32 / kFootW;            // lane rows of a footprint
  constexpr int kFootH = kLanesY * PPT;
  constexpr int kWarpsX = TW / kFootW;
  __shared__ float4 s[2][kChunk][3];
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
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
  // K2 enters at T = 1, so no tile is skipped at entry
  if (e > b) {
    const int first = (b / kChunk) * kChunk;
    stage_rows<kThreads>(s[0], rec4, b, min(e, first + kChunk) - b);
    int buf = 0;
    for (int base = first; base < e; base += kChunk, buf ^= 1) {
      const int lo = max(b, base);
      const int n = min(e, base + kChunk) - lo;
      const int next = base + kChunk;
      if (next < e) {
        // buf ^ 1 was last read before the previous chunk's vote
        stage_rows<kThreads>(s[buf ^ 1], rec4, next, min(e, next + kChunk) - next);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float4* rows = &s[buf][0][0];
      float thr = 0.0f;     // lane l: the cull threshold of row (rr & ~31) + l
      for (int rr = 0; rr < n; ++rr, rows += 3) {
        if ((rr & 31) == 0 && rr + lane < n) thr = cull_threshold(rows[3 * lane + 1].y);
        const float pthr = __shfl_sync(0xffffffffu, thr, rr & 31);
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
      // also the barrier before the next prefetch overwrites this buffer
      if (__syncthreads_and(sat)) break;
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
  if (threadIdx.x == 0) exec_out[tile] = executed;
}

template <int TW>
void launch_head(const float4* r, int nrows, const int* rb, const int* re, float* o, int* ex,
                 int ntiles, int ntx, cudaStream_t st) {
  constexpr int ppt = head_ppt(TW);
  head_composite_kernel<TW, ppt><<<ntiles, kTileH * TW / ppt, 0, st>>>(r, nrows, rb, re, o, ex,
                                                                      ntiles, ntx);
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

// K2. rec (nrows, 12) f32 packed records, 16-byte aligned; row_begin/
// row_end (ntiles,) i32; out (4, ntiles, 32*tile_w) f32 = r, g, b, T
// planes; exec (ntiles,) i32. tile_w must be 32, 64 or 128. Returns
// cudaGetLastError() after the launch.
extern "C" int gs_composite(const void* rec, int nrows, const void* row_begin,
                            const void* row_end, void* out, void* exec, int ntiles,
                            int ntx, int tile_w, void* stream) {
  if ((uintptr_t)rec % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (ntiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float4* r = (const float4*)rec;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    float* o = (float*)out;
    int* ex = (int*)exec;
    switch (tile_w) {
      case 32:
        launch_head<32>(r, nrows, rb, re, o, ex, ntiles, ntx, st);
        break;
      case 64:
        launch_head<64>(r, nrows, rb, re, o, ex, ntiles, ntx, st);
        break;
      case 128:
        launch_head<128>(r, nrows, rb, re, o, ex, ntiles, ntx, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// K2's warp footprint at tile_w (32, 64 or 128): *cols columns by *rows
// rows of samples, as head_composite_kernel lays a warp out, for counting
// what its warp row cull skips (chip_smoke.py). Returns
// cudaErrorInvalidValue for another tile_w.
extern "C" int gs_composite_footprint(int tile_w, int* cols, int* rows) {
  if (tile_w != 32 && tile_w != 64 && tile_w != 128) return (int)cudaErrorInvalidValue;
  *cols = kFootW;
  *rows = (32 / kFootW) * head_ppt(tile_w);
  return 0;
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
