// Kernel K2: the `iters` TV-L1 primal-dual iterations of one (level, warp)
// step in one launch, and optionally the between-warp 3x3 median of the
// flow after them.
//
// Replaces gaze_tpu/ops/pallas/tvl1_pd.py:pd_iterations (the Pallas TPU
// kernel called from gaze_tpu/ops/tvl1.py:_solve_level), which also runs
// all iterations in one call with the carry on chip. Its spec is the scan
// body gaze_tpu/ops/tvl1.py:131-159: thresholding of the linearized data
// term, the primal update u = v + theta*div(p), dual ascent with
// reprojection p <- (p + taut*grad(u)) / (1 + taut*|grad(u)|). The median
// is gaze_tpu_torch/ops/image.py:median3x3 (edge-replicated, the
// 19-comparator network), applied `median_passes` times to u1 and u2.
//
// Borders: the divergence takes p1[0] in column 0 and -p1[W-2] in the
// last column (the same for rows, gaze_tpu/ops/image.py:88-92); the
// forward gradient is zero in the last column and the last row, which
// keeps x-duals zero in the last column and y-duals zero in the last row.
// These rules hold at the frame's edges only, never at a tile's.
//
// Bound on the H100: memory. One call must read the 10 input fields once
// and write the 6 carried ones once: 16 x 4 B x B*H*W bytes (25.7 MB for
// B=8 at 224^2, about 7.7 us at 3.35 TB/s). Its arithmetic, about 54
// float operations per pixel and iteration (8 of them IEEE divisions and
// square roots), is below that at the 67 TFLOP/s float32 rate.
//
// Design: halo'd temporal tiling. A block owns a T x T tile of one frame
// and loads the tile plus a halo of h = iters + median_passes pixels on
// every side: the carry (u1, u2, p11, p12, p21, p22) into shared memory;
// the four frozen fields (i1wx, i1wy, grad, rho_c) are read where they
// are, through L1 (the block's region of them is read again every
// iteration). Each iteration is a primal phase over the region, a
// barrier, a dual phase, a barrier; both update in place (the primal
// reads only its own u and the duals, the dual only its own p and the new
// u). A pixel's update needs the duals one pixel left and up (primal) and
// the new flow one pixel right and down (dual), so the exact part of the
// region shrinks by one pixel per side per iteration (and per median
// pass). Iteration k computes only that part, its threads enumerating
// just the pixels of it that lie in the frame (Span); after all of them
// the tile's interior is exact and is written once. No neighbour's update
// is recomputed. The host picks T (8 to 64) to fill the 132 SMs with the
// least region per block: 56 at 224^2 and B=8 (128 blocks, a 78^2 region
// for 10 iterations and one median pass).
//
// Arithmetic follows the plain PyTorch version (gaze_tpu_torch/ops/cuda/
// tvl1_pd.py:pd_iterations_plain) operation by operation, with the same
// 1e-9 epsilon; built with -fmad=false the two agree to the bit.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;              // threads per block: 32 warps hide latency
constexpr int MAX_SIDE = 90;          // region side: 6 x 4 B x 90^2 = 194 KB
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

struct Out {
  float* u1;
  float* u2;
  float* p11;
  float* p12;
  float* p21;
  float* p22;
};

// Backward-difference divergence of (pa, pb) at region index i, frame
// pixel (x, y); region rows are R apart.
__device__ __forceinline__ float divergence(const float* pa, const float* pb, int i, int R,
                                            int x, int y, int H, int W) {
  const float d1 = (x == 0) ? pa[i] : (x == W - 1) ? -pa[i - 1] : pa[i] - pa[i - 1];
  const float d2 = (y == 0) ? pb[i] : (y == H - 1) ? -pb[i - R] : pb[i] - pb[i - R];
  return d1 + d2;
}

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// Region index i -> (row, column) for i < R * R <= MAX_SIDE^2: the float
// quotient (i + 0.5) / R is within 1e-5 of the exact one, which lies at
// least 0.5 / R from an integer.
__device__ __forceinline__ void region_rc(int i, int R, float inv_r, int& ry, int& rx) {
  ry = (int)(((float)i + 0.5f) * inv_r);
  rx = i - ry * R;
}

// The pixels of region rows and columns lo .. hi that lie in the frame: a
// rectangle of nr x nc, enumerated by j = 0 .. nr * nc - 1, so that a
// phase spends no thread on a pixel it does not update.
struct Span {
  int r0, c0, nr, nc;
  float inv_nc;

  __device__ Span(int lo, int hi, int gx0, int gy0, int H, int W) {
    r0 = max(lo, -gy0);
    c0 = max(lo, -gx0);
    nr = max(min(hi, H - 1 - gy0) - r0 + 1, 0);
    nc = max(min(hi, W - 1 - gx0) - c0 + 1, 0);
    inv_nc = nc > 0 ? 1.0f / (float)nc : 0.0f;
  }

  __device__ int size() const { return nr * nc; }

  // j -> region row and column, as region_rc (nr, nc <= MAX_SIDE).
  __device__ void at(int j, int& ry, int& rx) const {
    const int r = (int)(((float)j + 0.5f) * inv_nc);
    ry = r0 + r;
    rx = c0 + j - r * nc;
  }
};

__global__ void __launch_bounds__(NT, 1)
pd_iterations_kernel(Fields f, Out o, int H, int W, int T, int iters, int median_passes,
                     float lt, float taut, float theta) {
  extern __shared__ float sm[];
  const int h = iters + median_passes;
  const int R = T + 2 * h;
  const int RR = R * R;
  const float inv_r = 1.0f / (float)R;
  float* const su1 = sm;
  float* const su2 = sm + RR;
  float* const sp11 = sm + 2 * RR;
  float* const sp12 = sm + 3 * RR;
  float* const sp21 = sm + 4 * RR;
  float* const sp22 = sm + 5 * RR;
  const int gx0 = blockIdx.x * T - h;  // frame coordinates of region (0, 0)
  const int gy0 = blockIdx.y * T - h;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const int tid = threadIdx.x;
  const float nlt = -lt;

  for (int i = tid; i < RR; i += NT) {
    int ry, rx;
    region_rc(i, R, inv_r, ry, rx);
    const int x = gx0 + rx;
    const int y = gy0 + ry;
    if (x >= 0 && x < W && y >= 0 && y < H) {
      const size_t q = frame + (size_t)y * W + x;
      su1[i] = f.u1[q];
      su2[i] = f.u2[q];
      sp11[i] = f.p11[q];
      sp12[i] = f.p12[q];
      sp21[i] = f.p21[q];
      sp22[i] = f.p22[q];
    } else {
      su1[i] = su2[i] = sp11[i] = sp12[i] = sp21[i] = sp22[i] = 0.0f;
    }
  }
  __syncthreads();

  for (int k = 1; k <= iters; ++k) {
    // Primal phase over region rows and columns k .. R - k.
    const Span primal(k, R - k, gx0, gy0, H, W);
    for (int j = tid; j < primal.size(); j += NT) {
      int ry, rx;
      primal.at(j, ry, rx);
      const int i = ry * R + rx;
      const int x = gx0 + rx;
      const int y = gy0 + ry;
      // the frozen fields stay in global memory, read through L1
      const size_t q = frame + (size_t)y * W + x;
      const float u1 = su1[i];
      const float u2 = su2[i];
      const float gx = __ldg(f.i1wx + q);
      const float gy = __ldg(f.i1wy + q);
      const float g = __ldg(f.grad + q);
      const float rho = __ldg(f.rho_c + q) + gx * u1 + gy * u2;
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
      su1[i] = (u1 + d1) + theta * divergence(sp11, sp12, i, R, x, y, H, W);
      su2[i] = (u2 + d2) + theta * divergence(sp21, sp22, i, R, x, y, H, W);
    }
    __syncthreads();
    // Dual phase over region rows and columns k .. R - 1 - k.
    const Span dual(k, R - 1 - k, gx0, gy0, H, W);
    for (int j = tid; j < dual.size(); j += NT) {
      int ry, rx;
      dual.at(j, ry, rx);
      const int i = ry * R + rx;
      const int x = gx0 + rx;
      const int y = gy0 + ry;
      const float a1 = su1[i];
      const float a2 = su2[i];
      // Forward gradient of the new u; zero in the last column / row.
      float g1x = 0.0f, g2x = 0.0f, g1y = 0.0f, g2y = 0.0f;
      if (x < W - 1) {
        g1x = su1[i + 1] - a1;
        g2x = su2[i + 1] - a2;
      }
      if (y < H - 1) {
        g1y = su1[i + R] - a1;
        g2y = su2[i + R] - a2;
      }
      const float ng1 = 1.0f + taut * sqrtf(g1x * g1x + g1y * g1y);
      const float ng2 = 1.0f + taut * sqrtf(g2x * g2x + g2y * g2y);
      sp11[i] = (sp11[i] + taut * g1x) / ng1;
      sp12[i] = (sp12[i] + taut * g1y) / ng1;
      sp21[i] = (sp21[i] + taut * g2x) / ng2;
      sp22[i] = (sp22[i] + taut * g2y) / ng2;
    }
    __syncthreads();
  }

  // The tile's interior, region rows and columns h .. h + T - 1, is
  // written once. Duals first: a median pass overwrites sp11 and sp12.
  const Span interior(h, h + T - 1, gx0, gy0, H, W);
  for (int j = tid; j < interior.size(); j += NT) {
    int ry, rx;
    interior.at(j, ry, rx);
    const int i = ry * R + rx;
    const size_t q = frame + (size_t)(gy0 + ry) * W + gx0 + rx;
    o.p11[q] = sp11[i];
    o.p12[q] = sp12[i];
    o.p21[q] = sp21[i];
    o.p22[q] = sp22[i];
  }
  if (median_passes > 0) __syncthreads();

  // Edge-replicated 3x3 medians of u1 and u2: u -> sp1x, then back.
  for (int m = 1; m <= median_passes; ++m) {
    const float* s1 = (m & 1) ? su1 : sp11;
    const float* s2 = (m & 1) ? su2 : sp12;
    float* d1 = (m & 1) ? sp11 : su1;
    float* d2 = (m & 1) ? sp12 : su2;
    const Span med(iters + m, R - 1 - iters - m, gx0, gy0, H, W);
    for (int j = tid; j < med.size(); j += NT) {
      int ry, rx;
      med.at(j, ry, rx);
      const int i = ry * R + rx;
      const int x = gx0 + rx;
      const int y = gy0 + ry;
      // neighbour offsets, replicating the frame's edge
      const int up = y > 0 ? -R : 0;
      const int dn = y < H - 1 ? R : 0;
      const int lf = x > 0 ? -1 : 0;
      const int rt = x < W - 1 ? 1 : 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* s = c ? s2 : s1;
        float v0 = s[i + up + lf], v1 = s[i + up], v2 = s[i + up + rt];
        float v3 = s[i + lf], v4 = s[i], v5 = s[i + rt];
        float v6 = s[i + dn + lf], v7 = s[i + dn], v8 = s[i + dn + rt];
        sort2(v1, v2); sort2(v4, v5); sort2(v7, v8); sort2(v0, v1);
        sort2(v3, v4); sort2(v6, v7); sort2(v1, v2); sort2(v4, v5);
        sort2(v7, v8); sort2(v0, v3); sort2(v5, v8); sort2(v4, v7);
        sort2(v3, v6); sort2(v1, v4); sort2(v2, v5); sort2(v4, v7);
        sort2(v4, v2); sort2(v6, v4); sort2(v4, v2);
        (c ? d2 : d1)[i] = v4;
      }
    }
    __syncthreads();
  }

  const float* fu1 = (median_passes & 1) ? sp11 : su1;
  const float* fu2 = (median_passes & 1) ? sp12 : su2;
  for (int j = tid; j < interior.size(); j += NT) {
    int ry, rx;
    interior.at(j, ry, rx);
    const int i = ry * R + rx;
    const size_t q = frame + (size_t)(gy0 + ry) * W + gx0 + rx;
    o.u1[q] = fu1[i];
    o.u2[q] = fu2[i];
  }
}

// The tile side for this shape: the least region per block times the
// waves of blocks on 132 SMs (one block per SM), larger tiles on a tie.
int pick_tile(int B, int H, int W, int halo) {
  const int sides[] = {64, 56, 48, 40, 32, 28, 24, 16, 8};
  int best = 0;
  long long best_cost = 0;
  for (int T : sides) {
    const int R = T + 2 * halo;
    if (R > MAX_SIDE) continue;
    const long long blocks = (long long)B * ((H + T - 1) / T) * ((W + T - 1) / T);
    const long long cost = (blocks + 131) / 132 * R * R;
    if (best == 0 || cost < best_cost) {
      best = T;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// `iters` iterations, then `median_passes` (0, 1 or 2) 3x3 medians of u1
// and u2: 10 input fields -> 6 output fields, all (B, H, W) float32,
// contiguous, on `device`, outputs distinct from inputs; H, W >= 2,
// iters + median_passes <= 41. lt = lambda*theta, taut = tau/theta.
// Returns cudaGetLastError() after the launch.
extern "C" int tvl1_pd_launch(const float* u1, const float* u2, const float* p11,
                              const float* p12, const float* p21, const float* p22,
                              const float* i1wx, const float* i1wy, const float* grad,
                              const float* rho_c, float* o_u1, float* o_u2, float* o_p11,
                              float* o_p12, float* o_p21, float* o_p22, int B, int H, int W,
                              int iters, int median_passes, float lt, float taut, float theta,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H < 2 || W < 2 || iters < 0 || median_passes < 0 || median_passes > 2)
    return (int)cudaErrorInvalidValue;
  const int halo = iters + median_passes;
  const int T = pick_tile(B, H, W, halo);
  if (T == 0) return (int)cudaErrorInvalidValue;
  const int R = T + 2 * halo;
  const int smem = 6 * R * R * (int)sizeof(float);
  err = cudaFuncSetAttribute(pd_iterations_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const Fields f{u1, u2, p11, p12, p21, p22, i1wx, i1wy, grad, rho_c};
  const Out o{o_u1, o_u2, o_p11, o_p12, o_p21, o_p22};
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, B);
  pd_iterations_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(f, o, H, W, T, iters,
                                                                 median_passes, lt, taut, theta);
  return (int)cudaGetLastError();
}
