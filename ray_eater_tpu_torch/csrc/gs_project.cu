// K1 — EWA splat projection, one thread per splat.
//
// Replaces the TPU kernel ray_eater_tpu/ops/gs.py _project_kernel (:370),
// launched by _project_fast (:377). It evaluates _cov3d_math then
// _project_math exactly: opacity-aware cutoff scut, ceil radii clamped to
// max_radius, per-axis rx/ry, the 1.3x frustum clamp and every `valid`
// condition. Operands and their order follow the plain PyTorch version
// (ray_eater_tpu_torch/ops/gs.py _project_math); the library is built with
// --fmad=false so each multiply and add rounds as it does there.
//
// Bound on an H100 SXM: memory. Per splat it reads 44 B (mean, scale, quat,
// opacity) and writes 36 B (nine f32 planes): 80 MB at 1M splats, about
// 24 us at 3.35 TB/s, against about 0.2 GFLOP (3 us at 67 TFLOP/s f32).
// Design: the TPU's stacked (10, rows, 128) planes and block rows were
// DMA-issue workarounds; here each thread reads its splat's columns
// straight from the cloud and writes nine coalesced output planes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kAlphaMin = (float)(1.0 / 255.0);

__global__ void __launch_bounds__(256)
project_kernel(const float* __restrict__ means, const float* __restrict__ scales,
               const float* __restrict__ quats, const float* __restrict__ opac,
               const float* __restrict__ scal, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v[20];
#pragma unroll
  for (int k = 0; k < 20; ++k) v[k] = __ldg(scal + k);
  const float r[3][3] = {{v[0], v[1], v[2]}, {v[3], v[4], v[5]}, {v[6], v[7], v[8]}};
  const float tv0 = v[9], tv1 = v[10], tv2 = v[11];
  const float fx = v[12], fy = v[13], p00 = v[14], p11 = v[15];
  const float width = v[16], height = v[17], near = v[18], max_radius = v[19];

  const float px = means[3 * i], py = means[3 * i + 1], pz = means[3 * i + 2];
  const float sx = scales[3 * i], sy = scales[3 * i + 1], sz = scales[3 * i + 2];
  const float qw = quats[4 * i], qx = quats[4 * i + 1], qy = quats[4 * i + 2],
              qz = quats[4 * i + 3];
  const float op = opac[i];

  // _cov3d_math: world covariance Sigma = (R S)(R S)^T
  const float inv_n =
      1.0f / sqrtf(fmaxf(qw * qw + qx * qx + qy * qy + qz * qz, 1e-24f));
  const float w = qw * inv_n, x = qx * inv_n, y = qy * inv_n, z = qz * inv_n;
  const float m[3][3] = {
      {(1.0f - 2.0f * (y * y + z * z)) * sx, 2.0f * (x * y - w * z) * sy,
       2.0f * (x * z + w * y) * sz},
      {2.0f * (x * y + w * z) * sx, (1.0f - 2.0f * (x * x + z * z)) * sy,
       2.0f * (y * z - w * x) * sz},
      {2.0f * (x * z - w * y) * sx, 2.0f * (y * z + w * x) * sy,
       (1.0f - 2.0f * (x * x + y * y)) * sz}};
  float sig[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      sig[a][b] = m[a][0] * m[b][0] + m[a][1] * m[b][1] + m[a][2] * m[b][2];
      sig[b][a] = sig[a][b];
    }

  // _project_math: view transform
  const float pvx = r[0][0] * px + r[0][1] * py + r[0][2] * pz + tv0;
  const float pvy = r[1][0] * px + r[1][1] * py + r[1][2] * pz + tv1;
  const float zv = r[2][0] * px + r[2][1] * py + r[2][2] * pz + tv2;
  float t[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      t[a][b] = r[a][0] * sig[0][b] + r[a][1] * sig[1][b] + r[a][2] * sig[2][b];

  const float z_safe = fmaxf(zv, near);
  const float inv_z = 1.0f / z_safe;
  const float lim_x = 1.3f * (width * 0.5f) / fabsf(fx);
  const float lim_y = 1.3f * (height * 0.5f) / fabsf(fy);
  const float txz = fminf(fmaxf(pvx * inv_z, -lim_x), lim_x);
  const float tyz = fminf(fmaxf(pvy * inv_z, -lim_y), lim_y);
  const float j00 = fx * inv_z;
  const float j02 = -fx * txz * inv_z;
  const float j11 = fy * inv_z;
  const float j12 = -fy * tyz * inv_z;
#define CV(a, b) (t[a][0] * r[b][0] + t[a][1] * r[b][1] + t[a][2] * r[b][2])
  const float c00 = CV(0, 0), c01 = CV(0, 1), c02 = CV(0, 2);
  const float c11 = CV(1, 1), c12 = CV(1, 2), c22 = CV(2, 2);
#undef CV
  const float a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + 0.3f;
  const float bb = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22);
  const float c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + 0.3f;

  const float det = a * c - bb * bb;
  const float mid = 0.5f * (a + c);
  const float lam_max = mid + sqrtf(fmaxf(mid * mid - det, 0.0f));
  const float scut = fminf(
      3.0f, sqrtf(fmaxf(2.0f * logf(fmaxf(op, kAlphaMin) * 255.0f), 1e-6f)));
  const float radius = fminf(ceilf(scut * sqrtf(fmaxf(lam_max, 0.0f))), max_radius);
  const float rx = fminf(ceilf(scut * sqrtf(fmaxf(a, 0.0f))), radius);
  const float ry = fminf(ceilf(scut * sqrtf(fmaxf(c, 0.0f))), radius);
  const float inv_det = 1.0f / (det > 1e-12f ? det : 1.0f);
  const float mx = (pvx * inv_z * p00 + 1.0f) * 0.5f * width;
  const float my = (pvy * inv_z * p11 + 1.0f) * 0.5f * height;
  const bool valid = (zv > near) && (det > 1e-12f) && (radius >= 1.0f) &&
                     (mx + rx > 0.0f) && (mx - rx < width) && (my + ry > 0.0f) &&
                     (my - ry < height) && (op > kAlphaMin);

  out[0 * (size_t)n + i] = mx;
  out[1 * (size_t)n + i] = my;
  out[2 * (size_t)n + i] = c * inv_det;
  out[3 * (size_t)n + i] = -bb * inv_det;
  out[4 * (size_t)n + i] = a * inv_det;
  out[5 * (size_t)n + i] = valid ? zv : INFINITY;
  out[6 * (size_t)n + i] = radius;
  out[7 * (size_t)n + i] = rx;
  out[8 * (size_t)n + i] = ry;
}

}  // namespace

// means (n,3), scales (n,3), quats (n,4), opac (n,), scal (24,) f32 on the
// device; out (9, n) f32. Returns cudaGetLastError() after the launch.
extern "C" int gs_project(const void* means, const void* scales, const void* quats,
                          const void* opac, const void* scal, void* out, int n,
                          void* stream) {
  if (n > 0) {
    project_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        (const float*)means, (const float*)scales, (const float*)quats,
        (const float*)opac, (const float*)scal, (float*)out, n);
  }
  return (int)cudaGetLastError();
}
