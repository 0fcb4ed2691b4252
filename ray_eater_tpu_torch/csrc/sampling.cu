// K9 — the subtile window sampler's two trilinear taps.
//
// Replaces the TPU kernel ray_eater_tpu/ops/sampling.py _subtile_kernel
// (:190), launched by _sample_subtile (:244). Per 16x16 subtile s and
// pixel p, each tap reads the 2x2 texels at window-local (ty, tx) of its
// 32x32 window (ty, tx already clipped to [0, 30], so the +1 neighbour
// stays in the window) from the channel-blocked (NWIN, 4*32, 32) f32
// window table and filters them bilinearly; the two taps are lerped by
// frac. The TPU built dense one-hot weight planes and contracted them
// against the window on the MXU (Mosaic cannot gather inside a kernel);
// with two nonzero weights per axis that contraction is the same bilinear
// sum, so here each thread reads its 8 texels a channel directly.
// Operands and order as the plain version
// (ray_eater_tpu_torch/ops/sampling.py _subtile_plain):
//   row_j = w[ty+j][tx] (1 - fx) + w[ty+j][tx+1] fx,
//   tap   = row_0 (1 - fy) + row_1 fy,
//   out   = tap_a (1 - frac) + tap_b frac.
//
// Windows come in float32 (the default) or bfloat16 (texture_from_array's
// window_dtype; the JAX package's RAYEATER_WIN_BF16). The bfloat16
// instantiation reads bf16 texels, rounds the x weights (1 - fx, fx) to
// bf16 as the TPU kernel's one-pass bf16 contraction does
// (wx.astype(bfloat16)), and accumulates in f32: a bf16 x bf16 product is
// exact in f32, so only the sums round, in the plain version's order.
//
// Bound on an H100 SXM: bytes. Per pixel it reads 9 coordinate planes
// (36 B) and writes 4 channels (16 B): ~52 B; the windows it reads are
// shared by the subtile's 256 pixels and stay in L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWin = 32;
constexpr int kSpix = 256;
constexpr int kC = 4;

__device__ __forceinline__ float texel(const float* q) { return __ldg(q); }

__device__ __forceinline__ float texel(const __nv_bfloat16* q) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(q));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// the x weight as the window's precision takes it
__device__ __forceinline__ float weight(float v, const float*) { return v; }

__device__ __forceinline__ float weight(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ void tap(const T* __restrict__ w, int ty, float fy,
                                    int tx, float fx, float* o) {
  const float gx = weight(1.0f - fx, w), wx = weight(fx, w);
  const float gy = 1.0f - fy;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const T* q = w + c * kWin * kWin + ty * kWin + tx;
    const float r0 = texel(q) * gx + texel(q + 1) * wx;
    const float r1 = texel(q + kWin) * gx + texel(q + kWin + 1) * wx;
    o[c] = r0 * gy + r1 * fy;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSpix)
subtile_kernel(const int* __restrict__ w0i, const int* __restrict__ w1i,
               const int* __restrict__ ty0, const float* __restrict__ fy0,
               const int* __restrict__ tx0, const float* __restrict__ fx0,
               const int* __restrict__ ty1, const float* __restrict__ fy1,
               const int* __restrict__ tx1, const float* __restrict__ fx1,
               const float* __restrict__ frac, const T* __restrict__ win,
               float* __restrict__ out) {
  const int s = blockIdx.x, p = threadIdx.x;
  const size_t i = (size_t)s * kSpix + p;
  const size_t wsz = (size_t)kC * kWin * kWin;
  float a[kC], b[kC];
  tap(win + (size_t)w0i[s] * wsz, ty0[i], fy0[i], tx0[i], fx0[i], a);
  tap(win + (size_t)w1i[s] * wsz, ty1[i], fy1[i], tx1[i], fx1[i], b);
  const float fr = frac[i], gr = 1.0f - fr;
#pragma unroll
  for (int c = 0; c < kC; ++c)
    out[((size_t)s * kC + c) * kSpix + p] = a[c] * gr + b[c] * fr;
}

template <typename T>
int launch(const void* w0i, const void* w1i, const void* ty0, const void* fy0,
           const void* tx0, const void* fx0, const void* ty1, const void* fy1,
           const void* tx1, const void* fx1, const void* frac, const void* win,
           void* out, int ns, void* stream) {
  if (ns > 0) {
    subtile_kernel<T><<<ns, kSpix, 0, (cudaStream_t)stream>>>(
        (const int*)w0i, (const int*)w1i, (const int*)ty0, (const float*)fy0,
        (const int*)tx0, (const float*)fx0, (const int*)ty1, (const float*)fy1,
        (const int*)tx1, (const float*)fx1, (const float*)frac,
        (const T*)win, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int subtile_sample(const void* w0i, const void* w1i, const void* ty0,
                              const void* fy0, const void* tx0, const void* fx0,
                              const void* ty1, const void* fy1, const void* tx1,
                              const void* fx1, const void* frac, const void* win,
                              void* out, int ns, void* stream) {
  return launch<float>(w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac,
                       win, out, ns, stream);
}

extern "C" int subtile_sample_bf16(const void* w0i, const void* w1i,
                                   const void* ty0, const void* fy0,
                                   const void* tx0, const void* fx0,
                                   const void* ty1, const void* fy1,
                                   const void* tx1, const void* fx1,
                                   const void* frac, const void* win, void* out,
                                   int ns, void* stream) {
  return launch<__nv_bfloat16>(w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1,
                               fx1, frac, win, out, ns, stream);
}
