// Kernel K1: backward bilinear warp of the TV-L1 solver, which forms I1's
// gradients itself, fused with the per-warp epilogue.
//
// Replaces gaze_tpu/ops/pallas/warp.py:warp_fields (the Pallas TPU
// kernel called from gaze_tpu/ops/tvl1.py:_warp3). The TPU kernel avoids
// the TPU's slow gather with per-tile anchors, a residual clamp and a
// +-16 px displacement clamp. Hopper serves a gather through L1, so this
// kernel computes the exact function those approximate: the
// border-clamped 4-tap gather of gaze_tpu/ops/warp.py:bilinear_sample,
// for I1 and its two central-difference gradients (gaze_tpu/ops/tvl1.py:
// 100, central_gradient) with one set of weights, and then
//   grad  = i1wx^2 + i1wy^2
//   rho_c = i1w - i1wx*u1 - i1wy*u2 - i0            (ops/tvl1.py:111-113)
// so neither the gradient fields nor the warped I1 ever reach memory.
//
// The gradient at each of the four taps (y0..y0+1, x0..x0+1) is
// 0.5 * (I1[y, x+1] - I1[y, x-1]) along x, the one-sided difference on
// the first and last column, and the same along y: 12 loads from the 4x4
// neighbourhood of (y0, x0) without its corners, all from one array, the
// same float operations as gaze_tpu_torch/ops/image.py:central_gradient.
//
// Bound on the H100: memory. Per call it reads i1, u1, u2, i0 and writes
// i1wx, i1wy, grad, rho_c: 8 x 4 B x B*H*W bytes (12.8 MB for B=8 at
// 224^2, 3.83 us at 3.35 TB/s; the kernel that read precomputed
// gradients moved 10 fields, 4.79 us). Design: one thread per output
// pixel in 32 x 8 tiles of a frame, a warp on 32 consecutive pixels of a
// row so the flow reads and the output writes coalesce; the 12 taps of a
// pixel lie around its own position plus a smooth displacement, so a
// tile's taps share lines in L1 across 8 rows (a flat grid of 256 pixels
// spans one or two rows and shares fewer). The grid's own coordinates
// give x, y and the frame, so no thread divides. At most 32 registers,
// so 8 tiles fill an SM. The four outputs are the planes of one
// (4, B, H, W) buffer.
//
// The launch path is thin: the wrapper (ops/cuda/warp.py) passes five
// pointers, the shape, the device and the raw stream, and the device is
// set only when it is not already current.
//
// Arithmetic follows the plain PyTorch version (gaze_tpu_torch/ops/warp.py:
// warp3_plain) operation by operation; built with -fmad=false the two agree
// to the bit.

#include <cuda_runtime.h>

namespace {

// The difference of a pixel's right (or lower) neighbour vr and its left
// (or upper) neighbour vl, halved unless the pixel lies on the border,
// where the neighbour on the outside is the pixel itself (one-sided).
__device__ __forceinline__ float central(float vr, float vl, bool edge) {
  const float d = vr - vl;
  return edge ? d : 0.5f * d;
}

// One thread per output pixel, in tiles of TX x TY pixels of one frame; the
// z dimension of the grid walks the batch (stepping by gridDim.z, which
// is capped at 65535).
constexpr int TX = 32, TY = 8;

__global__ void __launch_bounds__(TX * TY, 8)
warp3_kernel(const float* __restrict__ i1, const float* __restrict__ u1,
             const float* __restrict__ u2, const float* __restrict__ i0,
             float* __restrict__ out, int B, int H, int W) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long n = (long long)B * H * W;
  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const long long frame = (long long)b * H * W;
    const long long idx = frame + (long long)y * W + x;
    const float* img = i1 + frame;

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

    // Neighbour columns of x0 and x0+1, neighbour rows of y0 and y0+1
    // (x0 <= W-2, so x0+1 is x0's right neighbour and x0 is x0+1's left).
    const bool xe0 = x0 == 0, xe1 = x0 + 1 == W - 1;
    const bool ye0 = y0 == 0, ye1 = y0 + 1 == H - 1;
    const int xl = xe0 ? x0 : x0 - 1;
    const int xr = xe1 ? x0 + 1 : x0 + 2;
    const float* r0 = img + y0 * W;
    const float* r1 = r0 + W;
    const float* ru = ye0 ? r0 : r0 - W;  // the row above y0
    const float* rd = ye1 ? r1 : r1 + W;  // the row below y0+1

    const float a00 = r0[x0], a01 = r0[x0 + 1], a10 = r1[x0], a11 = r1[x0 + 1];
    const float gx00 = central(a01, r0[xl], xe0);
    const float gx01 = central(r0[xr], a00, xe1);
    const float gx10 = central(a11, r1[xl], xe0);
    const float gx11 = central(r1[xr], a10, xe1);
    const float gy00 = central(a10, ru[x0], ye0);
    const float gy01 = central(a11, ru[x0 + 1], ye0);
    const float gy10 = central(rd[x0], a00, ye1);
    const float gy11 = central(rd[x0 + 1], a01, ye1);

    const float i1w = a00 * w00 + a01 * w01 + a10 * w10 + a11 * w11;
    const float wx = gx00 * w00 + gx01 * w01 + gx10 * w10 + gx11 * w11;
    const float wy = gy00 * w00 + gy01 * w01 + gy10 * w10 + gy11 * w11;

    out[idx] = wx;
    out[n + idx] = wy;
    out[2 * n + idx] = wx * wx + wy * wy;
    out[3 * n + idx] = i1w - wx * du - wy * dv - i0[idx];
  }
}

}  // namespace

// i1, u1, u2, i0: (B, H, W) float32, contiguous, on `device`; out: (4, B,
// H, W) float32 there, filled with (i1wx, i1wy, grad, rho_c); H, W >= 2.
// Returns a CUDA error code: cudaGetLastError() after the launch.
extern "C" int warp3_launch(const float* i1, const float* u1, const float* u2,
                            const float* i0, float* out, int B, int H, int W,
                            int device, void* stream) {
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B < 65535 ? B : 65535);
  warp3_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(i1, u1, u2, i0,
                                                                out, B, H, W);
  return (int)cudaGetLastError();
}
