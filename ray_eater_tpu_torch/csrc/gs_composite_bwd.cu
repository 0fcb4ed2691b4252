// K5 — backward of the tile composite, each tile's samples spread over
// several CTAs.
//
// Replaces the TPU kernel ray_eater_tpu/ops/gs.py _composite_bwd_kernel
// (:1593), launched by _composite_bwd_call (:1709). Given dL/d(r, g, b, T)
// planes, it returns dL/d(packed row) for every row of the chunks that the
// forward (K4, gs_composite.cu) ran, in the columns mx, my, conic a, conic
// b, conic c, opacity, r, g, b, then three zeros. The wrapper zero-fills
// the output; the kernel adds into every row of every executed chunk.
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
// with dC. So S_i = C . dC - prefix_incl(i), and every sample walks its
// tile's executed rows FIRST to last (rows b .. b+exec-1, from K4's exec)
// with S carried in a register. Samples are independent, so a tile's
// 32*tile_w samples are cut into blocks of 256, one CTA each (16 CTAs a
// tile at tile_w 128, 8 at 64, 4 at 32); a CTA whose tile ran nothing
// returns at once. The grid is ntiles * blocks, with no host sync. A CTA
// is 4 warps of 32 threads, each thread owning 2 samples (of the shapes
// measured on the training frame, 1-8 warps by 1-8 samples, this one was
// the fastest): a warp covers 64 consecutive samples, so a thread's two
// samples share a row or a column of the tile, and the per-row terms that
// depend on one coordinate only (dx, ca*dx, cbq*dx, ...) are computed once
// per column or row. Every pair-sample's expressions keep the plain
// version's order (--fmad=false, IEEE expf and division). T_i is never
// recovered by dividing the exit T by (1 - a): with a up to 0.99 that
// product underflows inside a chunk. Each chunk starts from its K4
// checkpoint and rebuilds T_i by K2's own running product.
//
// A row's gradient is a sum over the tile's samples. Each warp reduces its
// nine terms with shuffles (skipped when no lane touched the row): a
// reduce-scatter that halves the slots a lane holds at each step, so the
// nine sums end on nine lanes after 12 shuffles (5 + 3 + 2 + 1 in the
// halving steps, then one; nine separate sums take 45), and those lanes
// store the warp's partials into part[warp][9][128] with plain stores.
// At the chunk's end the CTA sums the warps' partials per (row, column)
// and adds each nonzero sum into grad with one global atomicAdd. Each
// packed row belongs to one tile, so only that tile's CTAs contend. The
// order of those atomics is not fixed, so the sums are not bitwise
// deterministic from run to run; no deterministic cluster variant is
// shipped.
// A chunk's rows are staged in shared memory as three 16-byte loads per
// 48-byte record row (rows are 16-byte aligned; the entry point checks).
//
// Bound on an H100 SXM: operations. Counted from this source, an executed
// pair-sample costs 14 f32 operations and one expf to find its alpha (dx,
// dy, the quadratic, the opacity, the clamp, the floor test); one with
// alpha >= 1/255 adds 17 (w, the colour terms, c . dC, S, the T update,
// the clamp test); one whose alpha was not clamped adds 30 more (dL/da
// with its division, the opacity and five geometric terms): 61 and one
// expf for most live pairs. The expf goes through the SFU (MUFU.EX2, 16 a
// clock per SM), a bound of its own. The warp reductions are not counted:
// they are this kernel's way to sum over samples, not work the function
// needs. chip_smoke.py counts each class of pair-sample in its run. Bytes
// are small beside that: the executed rows (36 B each, read, and 48 B
// written), one (pixd,) checkpoint row per executed chunk, and eight
// (ntiles, pixd) planes read once (the forward's r, g, b, T and the
// cotangents). What bounds this design on the card is the instruction
// count: about 100 a pair-sample (the IEEE division and expf among them)
// plus the reduction's ~50 a (warp, row), half of that per pair-sample at
// 2 samples a thread; and the imbalance between CTAs: a tile runs 1 to
// 256 rows.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 128;
constexpr int kTileH = 32;
constexpr int kCols = 12;
constexpr int kPPT = 2;                    // samples a thread
constexpr int kWarps = 4;                  // warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = kPPT * kThreads;    // samples a CTA
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kAlphaMax = 0.99f;

// One halving step of the warp's reduce-scatter: lanes whose bit `offset`
// is clear keep slots [0, H) of v, the others slots [H, N) (padded with a
// zero), each adding its partner's copy of the slots it keeps.
template <int N>
__device__ __forceinline__ void halve(const float (&v)[N], float (&out)[(N + 1) / 2],
                                      int offset, bool upper) {
  constexpr int H = (N + 1) / 2;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float lo = v[j];
    const float hi = H + j < N ? v[H + j] : 0.0f;
    out[j] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, offset);
  }
}

// The warp's sums of g[0..8]: 9 -> 5 -> 3 -> 2 -> 1 slots over lane bits
// 4, 3, 2, 1, then a sum over bit 0 (5 + 3 + 2 + 1 + 1 = 12 shuffles
// instead of 45). Lane bits (b4, b3, b2, b1) hold channel
// 5 b4 + 3 b3 + 2 b2 + b1 where *channel is set to it; lanes holding
// padding (or bit 0 set) get -1.
__device__ __forceinline__ float warp_sum9(const float (&g)[9], int lane, int* channel) {
  float a5[5], a3[3], a2[2], a1[1];
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1,
            b1 = (lane >> 1) & 1;
  halve<9>(g, a5, 16, b4);
  halve<5>(a5, a3, 8, b3);
  halve<3>(a3, a2, 4, b2);
  halve<2>(a2, a1, 2, b1);
  const int slot = 3 * b3 + 2 * b2 + b1;   // of the 5 (b4 = 0) or 4 slots
  const bool real = (lane & 1) == 0 && b1 < (b2 ? 1 : 2) && 2 * b2 + b1 < (b3 ? 2 : 3) &&
                    slot < (b4 ? 4 : 5);
  *channel = real ? 5 * b4 + slot : -1;
  return a1[0] + __shfl_xor_sync(0xffffffffu, a1[0], 1);
}

// planes (4, ntiles, pix) = K4's r, g, b, T; dplanes (4, ntiles, pix) =
// dL/d(r, g, b, T); ckpt rows ck_off[tile] + j as written by K4. CTA
// blockIdx.x covers samples [blk*256, blk*256 + 256) of tile
// blockIdx.x / (pix/256); thread (warp, lane) owns samples
// warp*64 + 32k + lane of that block, k < 2.
template <int TW>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float4* __restrict__ rec4, int nrows,
                     const int* __restrict__ row_begin, const int* __restrict__ row_end,
                     const int* __restrict__ exec, const int* __restrict__ ck_off,
                     const float* __restrict__ ckpt, const float* __restrict__ planes,
                     const float* __restrict__ dplanes, float* __restrict__ grad,
                     int ntiles, int ntx) {
  constexpr int kPix = kTileH * TW;
  constexpr int kBlocks = kPix / kBlock;
  // a thread's samples: NX columns 32 apart times NY consecutive rows
  constexpr int NX = 32 * kPPT < TW ? kPPT : TW / 32;
  constexpr int NY = kPPT / NX;
  __shared__ float4 s[kChunk][3];
  __shared__ float part[kWarps][9][kChunk];

  const int tile = blockIdx.x / kBlocks;
  const int ex = exec[tile];
  if (ex <= 0) return;                    // uniform over the block
  const int b = row_begin[tile];
  const int e = min(row_end[tile], nrows);
  if (e <= b) return;
  const int first = (b / kChunk) * kChunk;
  const int last = b + ex;                // one past the last executed row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the warp's first sample; a multiple of 64, so of TW or inside a row
  const int span = (blockIdx.x - tile * kBlocks) * kBlock + warp * 32 * kPPT;
  const int tx0 = (tile % ntx) * TW;
  const int ty0 = (tile / ntx) * kTileH;
  const size_t plane = (size_t)ntiles * kPix;
  const size_t o0 = (size_t)tile * kPix + span + lane;

  float px[NX], py[NY];
#pragma unroll
  for (int jx = 0; jx < NX; ++jx) px[jx] = (float)(span % TW + 32 * jx + lane + tx0) + 0.5f;
#pragma unroll
  for (int jy = 0; jy < NY; ++jy) py[jy] = (float)(span / TW + jy + ty0) + 0.5f;

  float dr[kPPT], dg[kPPT], db[kPPT], dtt[kPPT], S[kPPT], T[kPPT];
#pragma unroll
  for (int k = 0; k < kPPT; ++k) {
    const size_t o = o0 + 32 * k;
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
    for (int q = threadIdx.x; q < 3 * n; q += kThreads)
      (&s[0][0])[q] = rec4[(size_t)lo * 3 + q];
    const float* te = ckpt + ((size_t)ck_off[tile] + j) * kPix + span + lane;
#pragma unroll
    for (int k = 0; k < kPPT; ++k) T[k] = te[32 * k];
    __syncthreads();

    for (int rr = 0; rr < n; ++rr) {
      const float4 r0 = s[rr][0], r1 = s[rr][1], r2 = s[rr][2];
      const float mx = r0.x, my = r0.y, ca = r0.z, cbq = r0.w;
      const float cc = r1.x, op = r1.y, red = r1.z, green = r1.w, blue = r2.x;
      // the terms of one coordinate: dx, ca*dx, (ca*dx)*dx, cbq*dx; and
      // dy, cc*dy, (cc*dy)*dy, cbq*dy
      float dxv[NX], cadx[NX], caxx[NX], cbdx[NX];
      float dyv[NY], ccdy[NY], ccyy[NY], cbdy[NY];
#pragma unroll
      for (int jx = 0; jx < NX; ++jx) {
        dxv[jx] = px[jx] - mx;
        cadx[jx] = ca * dxv[jx];
        caxx[jx] = cadx[jx] * dxv[jx];
        cbdx[jx] = cbq * dxv[jx];
      }
#pragma unroll
      for (int jy = 0; jy < NY; ++jy) {
        dyv[jy] = py[jy] - my;
        ccdy[jy] = cc * dyv[jy];
        ccyy[jy] = ccdy[jy] * dyv[jy];
        cbdy[jy] = cbq * dyv[jy];
      }
      float g[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) g[c] = 0.0f;
      bool touched = false;
#pragma unroll
      for (int k = 0; k < kPPT; ++k) {
        const int jx = k % NX, jy = k / NX;
        const float dx = dxv[jx], dy = dyv[jy];
        // -0.5 (ca dx dx + cc dy dy) - cbq dx dy, in the plain version's order
        const float power = -0.5f * (caxx[jx] + ccyy[jy]) - cbdx[jx] * dy;
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
            g[0] += gp * (cadx[jx] + cbdy[jy]);   // gp (ca dx + cbq dy)
            g[1] += gp * (cbdx[jx] + ccdy[jy]);   // gp (cbq dx + cc dy)
            g[2] += gp * (-0.5f) * dx * dx;
            g[3] += gp * (-dx * dy);
            g[4] += gp * (-0.5f) * dy * dy;
            g[5] += ep * d_alpha;
          }
          T[k] = ti * om;
        }
      }
      if (__any_sync(0xffffffffu, touched)) {
        int c;
        const float v = warp_sum9(g, lane, &c);
        if (c >= 0) part[warp][c][rr] = v;
      } else if (lane < 9) {
        part[warp][lane][rr] = 0.0f;
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < n * 9; q += kThreads) {
      const int rr = q / 9;
      const int c = q - rr * 9;
      float v = part[0][c][rr];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += part[w][c][rr];
      if (v != 0.0f) atomicAdd(&grad[(size_t)(lo + rr) * kCols + c], v);
    }
    // the next chunk overwrites s and part
    __syncthreads();
  }
}

template <int TW>
void launch_bwd(const float4* r, int nrows, const int* rb, const int* re, const int* ex,
                const int* co, const float* ck, const float* pl, const float* dp, float* g,
                int ntiles, int ntx, cudaStream_t st) {
  const int blocks = ntiles * (kTileH * TW / kBlock);
  composite_bwd_kernel<TW><<<blocks, kThreads, 0, st>>>(r, nrows, rb, re, ex, co, ck, pl,
                                                        dp, g, ntiles, ntx);
}

}  // namespace

// K5. rec (nrows, 12) f32 packed records, 16-byte aligned; row_begin/
// row_end/exec (ntiles,) i32 as K4 read and returned them; ck_off
// (ntiles,) i32 and ckpt (nslots, 32*tile_w) f32 as K4 wrote them; planes
// (4, ntiles, 32*tile_w) f32, K4's r, g, b, T planes; dplanes (4, ntiles,
// 32*tile_w) f32; grad (nrows, 12) f32, zeroed by the caller. tile_w must
// be 32, 64 or 128. Returns cudaGetLastError().
extern "C" int gs_composite_bwd(const void* rec, int nrows, const void* row_begin,
                                const void* row_end, const void* exec,
                                const void* ck_off, const void* ckpt,
                                const void* planes, const void* dplanes, void* grad,
                                int ntiles, int ntx, int tile_w, void* stream) {
  if (tile_w != 32 && tile_w != 64 && tile_w != 128) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)rec % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (ntiles > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float4* r = (const float4*)rec;
    const int* rb = (const int*)row_begin;
    const int* re = (const int*)row_end;
    const int* ex = (const int*)exec;
    const int* co = (const int*)ck_off;
    const float* ck = (const float*)ckpt;
    const float* pl = (const float*)planes;
    const float* dp = (const float*)dplanes;
    float* g = (float*)grad;
    switch (tile_w) {
      case 32:
        launch_bwd<32>(r, nrows, rb, re, ex, co, ck, pl, dp, g, ntiles, ntx, st);
        break;
      case 64:
        launch_bwd<64>(r, nrows, rb, re, ex, co, ck, pl, dp, g, ntiles, ntx, st);
        break;
      default:
        launch_bwd<128>(r, nrows, rb, re, ex, co, ck, pl, dp, g, ntiles, ntx, st);
        break;
    }
  }
  return (int)cudaGetLastError();
}
