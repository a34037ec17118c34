// Kernel K2: one TV-L1 primal-dual iteration of one (level, warp) step.
//
// Replaces gaze_tpu/ops/pallas/tvl1_pd.py:pd_iterations (the Pallas TPU
// kernel called from gaze_tpu/ops/tvl1.py:_solve_level). Its spec is the
// scan body gaze_tpu/ops/tvl1.py:131-159: thresholding of the linearized
// data term, the primal update u = v + theta*div(p), dual ascent with
// reprojection p <- (p + taut*grad(u)) / (1 + taut*|grad(u)|).
//
// Borders: the divergence takes p1[0] in column 0 and -p1[W-2] in the
// last column (the same for rows, gaze_tpu/ops/image.py:88-92); the
// forward gradient is zero in the last column and the last row, which
// keeps x-duals zero in the last column and y-duals zero in the last row.
//
// Bound on the H100: memory. One call of `iters` iterations must read the
// 10 input fields once and write the 6 carried ones once: 16 x 4 B x
// B*H*W bytes (25.7 MB for B=8 at 224^2, about 7.7 us at 3.35 TB/s); its
// arithmetic, about 54 float operations per pixel and iteration, is below
// that at the 67 TFLOP/s float32 rate. Design: one launch per iteration,
// ping-pong buffers held by the wrapper, one thread per pixel in 32x8
// tiles. The dual update at p needs the new u at p, p+x and p+y; the
// thread recomputes the primal update at those two neighbours from the
// old u and p, so one launch is one whole iteration with no grid-wide
// barrier. At B<=8 and 224^2 the 16 arrays (about 26 MB) stay in the 50 MB
// L2, so the iterations after the first read mostly from L2. Keeping the
// carry on chip across iterations (temporal tiling, clusters) is later
// work.
//
// Arithmetic follows the plain PyTorch version (gaze_tpu_torch/ops/cuda/
// tvl1_pd.py:pd_iterations_plain) operation by operation, with the same
// 1e-9 epsilon; built with -fmad=false the two agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr float kEpsGrad = 1e-9f;

struct Fields {
  const float* u1;
  const float* u2;
  const float* p11;
  const float* p12;
  const float* p21;
  const float* p22;
  const float* i1wx;
  const float* i1wy;
  const float* grad;
  const float* rho_c;
};

// Backward-difference divergence of (pa, pb) at pixel q = (x, y).
__device__ __forceinline__ float divergence(const float* __restrict__ pa,
                                            const float* __restrict__ pb,
                                            long long q, int x, int y, int H,
                                            int W) {
  const float d1 = (x == 0) ? pa[q]
                 : (x == W - 1) ? -pa[q - 1]
                 : pa[q] - pa[q - 1];
  const float d2 = (y == 0) ? pb[q]
                 : (y == H - 1) ? -pb[q - W]
                 : pb[q] - pb[q - W];
  return d1 + d2;
}

// Thresholding step and primal update at pixel q: the new (u1, u2).
__device__ __forceinline__ void primal(const Fields& f, long long q, int x,
                                       int y, int H, int W, float lt,
                                       float theta, float* n1, float* n2) {
  const float u1 = f.u1[q];
  const float u2 = f.u2[q];
  const float gx = f.i1wx[q];
  const float gy = f.i1wy[q];
  const float g = f.grad[q];
  const float rho = f.rho_c[q] + gx * u1 + gy * u2;
  const float nlt = -lt;
  float d1, d2;
  if (rho < nlt * g) {
    d1 = lt * gx;
    d2 = lt * gy;
  } else if (rho > lt * g) {
    d1 = nlt * gx;
    d2 = nlt * gy;
  } else {
    const float den = g + kEpsGrad;
    d1 = -rho * gx / den;
    d2 = -rho * gy / den;
  }
  *n1 = (u1 + d1) + theta * divergence(f.p11, f.p12, q, x, y, H, W);
  *n2 = (u2 + d2) + theta * divergence(f.p21, f.p22, q, x, y, H, W);
}

__global__ void pd_iteration_kernel(Fields f, float* __restrict__ o_u1,
                                    float* __restrict__ o_u2,
                                    float* __restrict__ o_p11,
                                    float* __restrict__ o_p12,
                                    float* __restrict__ o_p21,
                                    float* __restrict__ o_p22, int H, int W,
                                    float lt, float taut, float theta) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long q = ((long long)blockIdx.z * H + y) * W + x;

  float a1, a2;
  primal(f, q, x, y, H, W, lt, theta, &a1, &a2);
  // Forward gradient of the new u; zero in the last column / row.
  float g1x = 0.0f, g2x = 0.0f, g1y = 0.0f, g2y = 0.0f;
  if (x < W - 1) {
    float r1, r2;
    primal(f, q + 1, x + 1, y, H, W, lt, theta, &r1, &r2);
    g1x = r1 - a1;
    g2x = r2 - a2;
  }
  if (y < H - 1) {
    float b1, b2;
    primal(f, q + W, x, y + 1, H, W, lt, theta, &b1, &b2);
    g1y = b1 - a1;
    g2y = b2 - a2;
  }
  const float ng1 = 1.0f + taut * sqrtf(g1x * g1x + g1y * g1y);
  const float ng2 = 1.0f + taut * sqrtf(g2x * g2x + g2y * g2y);
  o_u1[q] = a1;
  o_u2[q] = a2;
  o_p11[q] = (f.p11[q] + taut * g1x) / ng1;
  o_p12[q] = (f.p12[q] + taut * g1y) / ng1;
  o_p21[q] = (f.p21[q] + taut * g2x) / ng2;
  o_p22[q] = (f.p22[q] + taut * g2y) / ng2;
}

}  // namespace

// One iteration: 10 input fields -> 6 output fields, all (B, H, W)
// float32, contiguous, on `device`, outputs distinct from inputs; H, W >= 2.
// lt = lambda*theta, taut = tau/theta. Returns cudaGetLastError().
extern "C" int tvl1_pd_launch(const float* u1, const float* u2,
                              const float* p11, const float* p12,
                              const float* p21, const float* p22,
                              const float* i1wx, const float* i1wy,
                              const float* grad, const float* rho_c,
                              float* o_u1, float* o_u2, float* o_p11,
                              float* o_p12, float* o_p21, float* o_p22, int B,
                              int H, int W, float lt, float taut, float theta,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Fields f{u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c};
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, B);
  pd_iteration_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      f, o_u1, o_u2, o_p11, o_p12, o_p21, o_p22, H, W, lt, taut, theta);
  return (int)cudaGetLastError();
}
