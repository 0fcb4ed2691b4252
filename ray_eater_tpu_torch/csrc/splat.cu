// K10 — the particle splat's coverage mask, one launch, each word once.
//
// Replaces the TPU kernel ray_eater_tpu/ops/splat.py _splat_kernel (:42),
// launched by splat_mask (:79). Each particle p at (x, y) covers the
// half-open box [max(0, (int)x - r), min(W, (int)x + r)) x
// [max(0, (int)y - r), min(H, (int)y + r)) of a (Hp, Wp) f32 mask that is
// 0 elsewhere, the padding included ((int) truncates toward zero, as the
// TPU's astype(int32) does). A box wholly off the image is empty and
// covers nothing.
//
// Design: the gather form of the TPU kernel. One launch writes the whole
// (Hp, Wp) mask, padding included, with no memset; each word is stored
// exactly once, as a float4 by each lane of a warp (a warp stores 512
// contiguous bytes a row). A CTA of 256 threads owns a 64-row x 128-column
// region; each of its 8 warps owns 8 rows x 128 columns, a lane 8 rows x
// 4 columns, held as the 32 bits of one register. The CTA reads the
// positions a chunk of 2048 at a time (8 coalesced loads a thread, issued
// together, the next chunk's in flight while this one's boxes are folded),
// clamps each box and keeps those that meet its region (a ballot a warp
// for each of its 8 positions, then one shared atomic a warp reserves its
// slots), staged in shared memory as int4. Each warp then tests the kept
// boxes 32 at a time against its own footprint, one box a lane and one
// ballot a group, and ORs the hits into its lanes' bits, four at a time:
// the box's column run as a 4-bit mask, replicated over the nibbles of its
// row run. Covering is an OR, so the
// order of boxes does not matter and no atomics touch the mask; the result
// equals the plain version (ops/splat.py _splat_plain) bit for bit.
//
// Bound on an H100 SXM: bytes. The mask written once (Hp*Wp*4 B) and the
// positions read once (8 B a particle): 2,465,792 B, 0.00074 ms, at the
// compute_drawing sample's 900x600 with 1024 particles; 8,818,688 B,
// 0.00263 ms, at 65,536 particles over 1920x1080. One launch has a floor:
// an empty kernel (splat_launch_floor) takes 0.00087 ms of device time on
// an H100 80GB HBM3 at 700 W (time_splat.py, beside K10 in the same run),
// more than the sample's bytes bound, so at that size no single launch
// reaches the bound. Measured there (device ms under torch.profiler):
// 0.0034 at the sample's size, 0.0645 at 65,536 particles; the design it
// replaces (a memset, then one CTA a particle scattering 1.0 over its box,
// storing 4 B for every covered pixel of every box) took 0.0057 and 0.190.
// What costs beyond the bytes: every CTA reads and tests every position
// (8 B x N from L2 a CTA), so at 65,536 particles the cull, not the stores,
// sets the time; at that size more warps a CTA, and more, smaller CTAs,
// both measured slower (time_splat.py --tree on edited copies).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFootRows = 8;                    // a warp's rows
constexpr int kRegionRows = kWarps * kFootRows; // a CTA's rows: 64
constexpr int kRegionCols = 128;                // a CTA's and a warp's columns
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;   // positions staged at a time

// The bits [lo, hi) of a word, for 0 <= lo <= hi <= 32.
__device__ __forceinline__ unsigned bit_run(int lo, int hi) {
  return (unsigned)((1ull << hi) - (1ull << lo));
}

// The bits of box b (x0, x1, y0, y1) over a lane's 8 rows x 4 columns from
// (lx, fy): bit 4 * row + column.
__device__ __forceinline__ unsigned cover(int4 b, int lx, int fy) {
  const unsigned cols = bit_run(min(max(b.x - lx, 0), 4),
                                min(max(b.y - lx, 0), 4));
  const unsigned rows = bit_run(4 * min(max(b.z - fy, 0), kFootRows),
                                4 * min(max(b.w - fy, 0), kFootRows));
  return (cols * 0x11111111u) & rows;
}

// This thread's kPerThread positions of the chunk at ``base`` (coalesced:
// position base + k * kThreads + threadIdx.x; zeros past the end).
__device__ __forceinline__ void load_chunk(const float2* __restrict__ pos,
                                           int n, int base,
                                           float2 (&p)[kPerThread]) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = base + k * kThreads + threadIdx.x;
    p[k] = i < n ? __ldg(pos + i) : make_float2(0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
splat_gather_kernel(const float2* __restrict__ pos, int n, int radius,
                    int width, int height, int hp, int wp,
                    float* __restrict__ mask) {
  __shared__ int4 boxes[kChunk];
  __shared__ int kept;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  const int cx = blockIdx.x * kRegionCols;
  const int ry0 = blockIdx.y * kRegionRows;
  const int ry1 = min(ry0 + kRegionRows, hp);
  const int fy = ry0 + warp * kFootRows;        // this warp's first row
  const int lx = cx + 4 * lane;                 // this lane's first column
  unsigned bits = 0;                            // bit 4 * row + column
  float2 next[kPerThread];
  load_chunk(pos, n, 0, next);

  for (int base = 0; base < n; base += kChunk) {
    if (threadIdx.x == 0) kept = 0;
    __syncthreads();
    // clamp this thread's boxes; keep those that meet the CTA's region;
    // one shared atomic a warp reserves the warp's slots
    int4 bx[kPerThread];
    unsigned hits[kPerThread];
    int total = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool live = base + k * kThreads + (int)threadIdx.x < n;
      const int xi = (int)next[k].x, yi = (int)next[k].y;
      bx[k] = make_int4(max(0, xi - radius), min(width, xi + radius),
                        max(0, yi - radius), min(height, yi + radius));
      const bool keep = live && bx[k].x < bx[k].y && bx[k].z < bx[k].w &&
                        bx[k].x < cx + kRegionCols && bx[k].y > cx &&
                        bx[k].z < ry1 && bx[k].w > ry0;
      hits[k] = __ballot_sync(0xffffffffu, keep);
      total += __popc(hits[k]);
    }
    int at = 0;
    if (lane == 0 && total) at = atomicAdd(&kept, total);
    at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (hits[k] >> lane & 1u) boxes[at + __popc(hits[k] & below)] = bx[k];
      at += __popc(hits[k]);
    }
    __syncthreads();
    // the next chunk's loads fly while this chunk's boxes are folded in
    if (base + kChunk < n) load_chunk(pos, n, base + kChunk, next);
    const int m = kept;
    if (fy < ry1) {
      for (int g = 0; g < m; g += 32) {
        bool meets = false;
        if (g + lane < m) {
          const int4 b = boxes[g + lane];
          meets = b.x < cx + kRegionCols && b.y > cx &&
                  b.z < fy + kFootRows && b.w > fy;
        }
        unsigned hit = __ballot_sync(0xffffffffu, meets);
        // four hits at a time (a repeated box ORs in nothing new), read
        // from shared memory by every lane at once
        while (hit) {
          int s[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[j] = hit ? __ffs(hit) - 1 : s[0];
            hit &= hit - 1;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bits |= cover(boxes[g + s[j]], lx, fy);
        }
      }
    }
    __syncthreads();
  }
  if (fy >= ry1) return;
  float4* out = reinterpret_cast<float4*>(mask + (size_t)fy * wp + lx);
  const size_t stride = (size_t)wp / 4;
#pragma unroll
  for (int r = 0; r < kFootRows; ++r) {
    const unsigned q = bits >> (4 * r);
    out[r * stride] = make_float4((float)(q & 1u), (float)((q >> 1) & 1u),
                                  (float)((q >> 2) & 1u),
                                  (float)((q >> 3) & 1u));
  }
}

__global__ void empty_kernel() {}

}  // namespace

// The mask of n particles: one launch over (wp / 128, ceil(hp / 64)) CTAs.
// hp must be a multiple of 8 and wp of 128 (the wrapper pads to both).
extern "C" int splat_mask(const void* pos, int n, int radius, int width,
                          int height, int hp, int wp, void* mask,
                          void* stream) {
  if (hp <= 0 || wp <= 0 || hp % kFootRows || wp % kRegionCols) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(wp / kRegionCols, (hp + kRegionRows - 1) / kRegionRows);
  splat_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)pos, n, radius, width, height, hp, wp, (float*)mask);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel: the floor under any single launch, timed
// beside K10 (its bytes bound at the sample's size is below it).
extern "C" int splat_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
