// K10 — the particle splat's coverage mask.
//
// Replaces the TPU kernel ray_eater_tpu/ops/splat.py _splat_kernel (:42),
// launched by splat_mask (:79). Each particle p at (x, y) covers the
// half-open box [max(0, (int)x - r), min(W, (int)x + r)) x
// [max(0, (int)y - r), min(H, (int)y + r)) of a (Hp, Wp) f32 mask that is
// 0 elsewhere, the padding included ((int) truncates toward zero, as the
// TPU's astype(int32) does).
//
// The TPU gathered: a grid over (8, 128) mask tiles folded every particle
// into each tile behind a scalar tile-vs-box reject, because Mosaic cannot
// scatter. Writing 1.0 does not depend on order and two threads storing
// the same value is benign, so here the mask is cleared with
// cudaMemsetAsync (0.0f is all-zero bytes) and then scattered: one CTA
// per particle, its threads striding over the box's pixels row by row
// (consecutive threads on consecutive columns). No atomics; empty boxes
// (a particle wholly off the image) write nothing.
//
// Bound on an H100 SXM: bytes. The mask is written once (Hp*Wp*4 B) and
// the positions read once (8 B a particle): 2.46 MB, ~0.74 us, at the
// compute_drawing sample's 900x600 with 1024 particles. At that size the
// two launches (memset and scatter) cost more than the bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
splat_kernel(const float* __restrict__ pos, int radius, int width, int height,
             int wp, float* __restrict__ mask) {
  const int p = blockIdx.x;
  const int xi = (int)pos[2 * p];
  const int yi = (int)pos[2 * p + 1];
  const int x0 = max(0, xi - radius), x1 = min(width, xi + radius);
  const int y0 = max(0, yi - radius), y1 = min(height, yi + radius);
  const int bw = x1 - x0, bh = y1 - y0;
  if (bw <= 0 || bh <= 0) return;
  const int area = bw * bh;
  for (int i = threadIdx.x; i < area; i += kThreads) {
    const int y = y0 + i / bw, x = x0 + i % bw;
    mask[(size_t)y * wp + x] = 1.0f;
  }
}

}  // namespace

extern "C" int splat_mask(const void* pos, int n, int radius, int width,
                          int height, int hp, int wp, void* mask,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(mask, 0, (size_t)hp * wp * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    splat_kernel<<<n, kThreads, 0, s>>>((const float*)pos, radius, width,
                                        height, wp, (float*)mask);
  }
  return (int)cudaGetLastError();
}
