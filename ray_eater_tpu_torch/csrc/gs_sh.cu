// View-dependent SH colour of degree-1, -2 and -3 splats, one pass.
//
// Replaces no TPU kernel: the JAX package evaluates SH colour in jnp
// (ray_eater_tpu/models/gaussians.py eval_sh_colors), and the port did the
// same in PyTorch, about 86 element-wise kernels a call at degree 3, each
// writing its (N, 1) or (N, 3) intermediate to device memory, fifteen of
// them reading strided (N, 3) slices of the (N, B, 3) coefficients. This
// kernel computes the same function, colour = clamp(DC + sum over bands of
// basis(d) * coefficient, 0, 1), d the unit direction from the eye to the
// splat, for B = 3, 8 or 15 higher-band coefficients a channel.
//
// Arithmetic: the plain version's float32 operations in its order
// (ray_eater_tpu_torch/models/gaussians.py _sh_colors_plain): the norm as
// d / max(sqrt((dx*dx + dy*dy) + dz*dz), 1e-12); each basis product left to
// right as the Python expression associates (((C * xy) * z) * sh); the
// bands' terms summed left to right in the JAX package's order (y, z, x);
// (DC - 0.5) + bands, then clamp(+ 0.5, 0, 1), NaN kept as torch.clamp
// keeps it. The library builds with --fmad=false and no fast math, so each
// multiply and add rounds as PyTorch's one-op kernels round it.
//
// Bound on an H100 SXM: bytes. A splat reads its mean, DC colour and 3B
// coefficients (24 + 12B bytes) and writes 12: 216 B at B = 15, 216 MB at
// 1M splats (0.065 ms at 3.35 TB/s), 1.30 GB at 6M (0.39 ms); its 153
// float operations a splat take 0.0023 ms at 1M at 67 TFLOP/s. Design for a
// streaming pass: one thread a splat, kSplats a CTA. The CTA stages its
// contiguous run of coefficients (23,040 B at B = 15), means and colours
// into shared memory with 16-byte cp.async copies, every lane of a warp on
// neighbouring addresses (the run's unaligned head and tail floats by plain
// loads), so every 32-byte sector fetched is used whole. Each thread then
// reads its own 3B coefficients at a stride of 3B words, odd at B = 3 and
// 15, so the 32 lanes of a warp fall in 32 different banks (at B = 8, a
// stride of 24, in four banks: a degree no benchmark cell renders). The
// output goes back through shared memory and is stored coalesced. 26 KB of
// shared memory a CTA at B = 15 leaves 8 CTAs an SM resident, ~27 MB of
// loads in flight over the card's 132 SMs, far above the few MB that keep
// HBM busy. Measured on an H100 80GB HBM3 at 700 W (device time under
// torch.profiler, degree 3): 0.0725 ms at 1M splats, 89% of the bound, and
// 0.4221 ms at 6M, 92%; the PyTorch expression it replaced took 0.963 and
// 5.490 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplats = 128;  // a CTA's splats, one a thread

// the real SH basis constants of the 3DGS convention, rounded to float32
// as PyTorch rounds a Python scalar for a float32 tensor
constexpr float kC1 = (float)0.4886025119029199;
constexpr float kC2a = (float)1.0925484305920792;
constexpr float kC2b = (float)-1.0925484305920792;
constexpr float kC2c = (float)0.31539156525252005;
constexpr float kC2d = (float)-1.0925484305920792;
constexpr float kC2e = (float)0.5462742152960396;
constexpr float kC3a = (float)-0.5900435899266435;
constexpr float kC3b = (float)2.890611442640554;
constexpr float kC3c = (float)-0.4570457994644658;
constexpr float kC3d = (float)0.3731763325901154;
constexpr float kC3e = (float)-0.4570457994644658;
constexpr float kC3f = (float)1.445305721320277;
constexpr float kC3g = (float)-0.5900435899266435;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(gmem)
               : "memory");
}

// Starts copying src[0, count) into dst[phase, phase + count), phase being
// src's float offset from a 16-byte boundary (0..3), and returns phase: the
// floats up to src's first boundary and past its last by plain loads, the
// 16-byte chunks between by cp.async (wait for them before reading). dst is
// 16-byte aligned and holds count + 4 floats.
__device__ __forceinline__ int stage(float* dst, const float* __restrict__ src,
                                     int count) {
  const int t = threadIdx.x;
  const int phase = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min((4 - phase) & 3, count);
  const int chunks = (count - head) >> 2;
  const int tail_at = head + 4 * chunks;
  if (t < head) dst[phase + t] = __ldg(src + t);
  for (int q = t; q < chunks; q += kSplats)
    cp_async16(dst + phase + head + 4 * q, src + head + 4 * q);
  if (t < count - tail_at) dst[phase + tail_at + t] = __ldg(src + tail_at + t);
  return phase;
}

__device__ __forceinline__ float clamp01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

template <int B>
__global__ void __launch_bounds__(kSplats)
sh_color_kernel(const float* __restrict__ means, const float* __restrict__ colors,
                const float* __restrict__ sh, const float* __restrict__ eye, int n,
                float* __restrict__ out) {
  __shared__ __align__(16) float s_sh[kSplats * 3 * B + 4];
  __shared__ __align__(16) float s_mean[kSplats * 3 + 4];
  __shared__ __align__(16) float s_col[kSplats * 3 + 4];
  const long long first = (long long)blockIdx.x * kSplats;
  const int run = (int)min((long long)kSplats, (long long)n - first);
  const int pm = stage(s_mean, means + first * 3, run * 3);
  const int pc = stage(s_col, colors + first * 3, run * 3);
  const int ps = stage(s_sh, sh + first * (3 * B), run * 3 * B);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const float ex = __ldg(eye), ey = __ldg(eye + 1), ez = __ldg(eye + 2);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int t = threadIdx.x;
  if (t < run) {
    const float* m = s_mean + pm + 3 * t;
    const float* c = s_col + pc + 3 * t;
    const float* k = s_sh + ps + 3 * B * t;  // coefficient j, channel ch: k[3j + ch]
    const float dx = m[0] - ex, dy = m[1] - ey, dz = m[2] - ez;
    float nrm = sqrtf((dx * dx + dy * dy) + dz * dz);
    nrm = nrm < 1e-12f ? 1e-12f : nrm;
    const float x = dx / nrm, y = dy / nrm, z = dz / nrm;
    float o[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      o[ch] = c[ch] - 0.5f;
      o[ch] = o[ch] + kC1 * ((-y * k[ch] + z * k[3 + ch]) - x * k[6 + ch]);
    }
    if (B >= 8) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      const float a0 = kC2a * xy, a1 = kC2b * yz;
      const float a2 = kC2c * ((2.0f * zz - xx) - yy);
      const float a3 = kC2d * xz, a4 = kC2e * (xx - yy);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float s = a0 * k[9 + ch] + a1 * k[12 + ch];
        s = s + a2 * k[15 + ch];
        s = s + a3 * k[18 + ch];
        s = s + a4 * k[21 + ch];
        o[ch] = o[ch] + s;
      }
      if (B >= 15) {
        const float b0 = (kC3a * y) * (3.0f * xx - yy);
        const float b1 = (kC3b * xy) * z;
        const float b2 = (kC3c * y) * ((4.0f * zz - xx) - yy);
        const float b3 = (kC3d * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
        const float b4 = (kC3e * x) * ((4.0f * zz - xx) - yy);
        const float b5 = (kC3f * z) * (xx - yy);
        const float b6 = (kC3g * x) * (xx - 3.0f * yy);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float s = b0 * k[24 + ch] + b1 * k[27 + ch];
          s = s + b2 * k[30 + ch];
          s = s + b3 * k[33 + ch];
          s = s + b4 * k[36 + ch];
          s = s + b5 * k[39 + ch];
          s = s + b6 * k[42 + ch];
          o[ch] = o[ch] + s;
        }
      }
    }
    // the colours overwrite this thread's own mean, read above
    float* w = s_mean + pm + 3 * t;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) w[ch] = clamp01(o[ch] + 0.5f);
  }
  __syncthreads();
  float* dst = out + first * 3;
  for (int i = t; i < 3 * run; i += kSplats) dst[i] = s_mean[pm + i];
}

template <int B>
int launch(const void* means, const void* colors, const void* sh, const void* eye,
           int n, void* out, cudaStream_t stream) {
  auto kern = sh_color_kernel<B>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + kSplats - 1) / kSplats;
  kern<<<grid, kSplats, 0, stream>>>((const float*)means, (const float*)colors,
                                     (const float*)sh, (const float*)eye, n, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// The (n, 3) colours of n splats with bands = 3, 8 or 15 higher-band
// coefficients a channel (degree 1, 2, 3): means, colors (n, 3), sh
// (n, bands, 3), eye (3,) and out (n, 3), all float32, contiguous, on the
// device, n > 0. One launch of ceil(n / 128) CTAs.
extern "C" int sh_colors(const void* means, const void* colors, const void* sh,
                         const void* eye, int n, int bands, void* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bands) {
    case 3: return launch<3>(means, colors, sh, eye, n, out, s);
    case 8: return launch<8>(means, colors, sh, eye, n, out, s);
    case 15: return launch<15>(means, colors, sh, eye, n, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
