// Kernel K1: backward bilinear warp of the TV-L1 solver, fused with the
// per-warp epilogue.
//
// Replaces gaze_tpu/ops/pallas/warp.py:warp_fields (the Pallas TPU
// kernel called from gaze_tpu/ops/tvl1.py:_warp3). The TPU kernel avoids
// the TPU's slow gather with per-tile anchors, a residual clamp and a
// +-16 px displacement clamp. Hopper serves a gather through L1, so this
// kernel computes the exact function those approximate: the
// border-clamped 4-tap gather of gaze_tpu/ops/warp.py:bilinear_sample,
// for I1 and its two gradients with one set of weights, and then
//   grad  = i1wx^2 + i1wy^2
//   rho_c = i1w - i1wx*u1 - i1wy*u2 - i0            (ops/tvl1.py:111-113)
// so the warped I1 itself never leaves the registers.
//
// Bound on the H100: memory. Per call it reads u1, u2, i1, i1x, i1y, i0
// and writes i1wx, i1wy, grad, rho_c: 10 x 4 B x B*H*W bytes (16 MB for
// B=8 at 224^2, about 4.8 us at 3.35 TB/s). Design: one thread per output
// pixel, consecutive threads on consecutive pixels of a row so the flow
// reads and the output writes coalesce; the 12 taps of a pixel are
// neighbours of its own position plus a smooth displacement, so they hit
// lines the neighbouring threads also read (L1 / L2).
//
// Arithmetic follows the plain PyTorch version (gaze_tpu_torch/ops/warp.py:
// warp3_plain) operation by operation; built with -fmad=false the two agree
// to the bit.

#include <cuda_runtime.h>

namespace {

__global__ void warp3_kernel(const float* __restrict__ i1,
                             const float* __restrict__ i1x,
                             const float* __restrict__ i1y,
                             const float* __restrict__ u1,
                             const float* __restrict__ u2,
                             const float* __restrict__ i0,
                             float* __restrict__ o_i1wx,
                             float* __restrict__ o_i1wy,
                             float* __restrict__ o_grad,
                             float* __restrict__ o_rho_c,
                             int B, int H, int W) {
  const long long n = (long long)B * H * W;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % W);
  const long long row = idx / W;  // b*H + y
  const int y = (int)(row % H);
  const long long frame = (row - y) * W;  // offset of (b, 0, 0)

  const float du = u1[idx];
  const float dv = u2[idx];
  const float xs = fminf(fmaxf((float)x + du, 0.0f), (float)(W - 1));
  const float ys = fminf(fmaxf((float)y + dv, 0.0f), (float)(H - 1));
  // Clamp the integer corner so the +1 taps stay inside the frame.
  const int x0 = min(max((int)floorf(xs), 0), W - 2);
  const int y0 = min(max((int)floorf(ys), 0), H - 2);
  const float fx = xs - (float)x0;
  const float fy = ys - (float)y0;
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const long long t = frame + (long long)y0 * W + x0;

  const float i1w = i1[t] * w00 + i1[t + 1] * w01 + i1[t + W] * w10 +
                    i1[t + W + 1] * w11;
  const float wx = i1x[t] * w00 + i1x[t + 1] * w01 + i1x[t + W] * w10 +
                   i1x[t + W + 1] * w11;
  const float wy = i1y[t] * w00 + i1y[t + 1] * w01 + i1y[t + W] * w10 +
                   i1y[t + W + 1] * w11;

  o_i1wx[idx] = wx;
  o_i1wy[idx] = wy;
  o_grad[idx] = wx * wx + wy * wy;
  o_rho_c[idx] = i1w - wx * du - wy * dv - i0[idx];
}

}  // namespace

// All arrays (B, H, W) float32, contiguous, on `device`; H, W >= 2.
// Returns cudaGetLastError() after the launch.
extern "C" int warp3_launch(const float* i1, const float* i1x,
                            const float* i1y, const float* u1,
                            const float* u2, const float* i0, float* i1wx,
                            float* i1wy, float* grad, float* rho_c, int B,
                            int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H * W;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      i1, i1x, i1y, u1, u2, i0, i1wx, i1wy, grad, rho_c, B, H, W);
  return (int)cudaGetLastError();
}
