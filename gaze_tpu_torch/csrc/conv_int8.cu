// Kernel K3: one int8 3x3 SAME convolution of the quantized VGG streams,
// s8 x s8 -> s32 on the tensor cores, with its epilogue fused.
//
// Replaces gaze_tpu/ops/pallas/conv_int8.py:conv3x3_int8_chain (body
// _chain_kernel) and, because PyTorch has no int8 convolution on CUDA,
// also the XLA int8 convolutions of gaze_tpu/models/quant.py:
// quant_vgg_forward: every int8 conv of both streams, conv1_2 through
// conv5_3 (and an int8 stem conv1_1 once the wrapper has zero-padded its
// Ci to 32). Per output pixel p and channel n:
//   acc = sum over 3x3 taps and Ci of x[p + tap] * w[n, tap]   (int32)
// where input positions outside the frame read `pad_code` (the stored
// real zero: -128 on the zero-point-128 grid, 0 on a signed grid); then
//   requant:  out = clip(rint(f32(acc) * a[n] + c[n]), -128, 127)  int8
//   dequant:  out = max((f32(acc) + c[n]) * a[n] + bias[n], 0)     float32
//
// Bound on the H100: operations. A layer is 2 * B*H*W * 9*Ci*Co int8
// operations against about B*H*W*(Ci + Co) bytes: conv1_2 at B=8, 224^2,
// 64->64 is 29.6 G operations (15 us at 1,979 TOPS dense int8) and moves
// 51 MB (15 us at 3.35 TB/s); every deeper layer has a larger ratio of
// operations to bytes. The turbo step's 24 layers are 488 G operations,
// about 0.25 ms.
//
// Design (a first, simple version): implicit GEMM with M = B*H*W output
// pixels, N = Co, K = 9*Ci taken tap by tap, 32 input channels per step.
// A block computes a 128-pixel x BN-channel tile (BN = 128 when Co is a
// multiple of 128, else 64) with 8 warps, each a 64x32 or 32x32 sub-tile of
// mma.sync.m16n8k32 s8 products into int32 registers. Each step loads the
// 128 pixels' 32 channels for one tap (16 bytes per thread, the pad code
// where the tap leaves the frame) and the BN x 32 weights from OHWI
// memory into shared memory; the next step's loads are in flight in
// registers while the tensor cores work on the current one (two shared
// buffers, one barrier per step). Shared rows are 48 bytes apart so the
// fragment loads hit 32 distinct banks. The epilogue runs in registers on
// the accumulator fragments and writes the output once. wgmma, TMA and a
// persistent schedule are later work.
//
// Arithmetic follows the plain PyTorch version (gaze_tpu_torch/ops/
// conv_int8.py:conv3x3_int8_plain): the integer sum is exact in any
// order, the accumulator is cast with __int2float_rn, each epilogue
// operation rounds on its own (built with -fmad=false) and rintf rounds
// half to even, so the two agree to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // output pixels per block
constexpr int BK = 32;       // input channels per step (one tap)
constexpr int ROW = 48;      // shared bytes per tile row: 32 data + 16 pad
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BN, bool DEQUANT>
__global__ void __launch_bounds__(THREADS)
conv3x3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ a, const float* __restrict__ c,
                    const float* __restrict__ bias, void* __restrict__ out,
                    int B, int H, int W, int Ci, int Co, int pad_code) {
  constexpr int WARPS_M = BN == 128 ? 2 : 4;
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int WM = BM / WARPS_M;  // 64 or 32 pixels per warp
  constexpr int WN = BN / WARPS_N;  // 32 channels per warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;

  __shared__ __align__(16) uint8_t As[2][BM * ROW];
  __shared__ __align__(16) uint8_t Bs[2][BN * ROW];

  const int M = B * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;

  // Loader roles: thread tid moves 16 bytes of tile row tid / 2.
  const int lr = tid >> 1;
  const int lh = (tid & 1) * 16;
  const int am = m0 + lr;
  const bool a_row = am < M;
  int ab = 0, aoh = 0, aow = 0;
  if (a_row) {
    aow = am % W;
    const int t = am / W;
    aoh = t % H;
    ab = t / H;
  }
  const bool b_load = lr < BN;
  const int bn = n0 + lr;
  const bool b_row = b_load && bn < Co;

  const int padw = (int)((uint32_t)(pad_code & 0xff) * 0x01010101u);
  const int csteps = Ci / BK;
  const int ksteps = 9 * csteps;

  int4 areg = make_int4(padw, padw, padw, padw);
  int4 breg = make_int4(0, 0, 0, 0);
  auto load = [&](int s) {
    const int tap = s / csteps;
    const int ci0 = (s - tap * csteps) * BK + lh;
    const int ih = aoh + tap / 3 - 1;
    const int iw = aow + tap % 3 - 1;
    if (a_row && ih >= 0 && ih < H && iw >= 0 && iw < W) {
      areg = *reinterpret_cast<const int4*>(
          x + ((size_t)(ab * H + ih) * W + iw) * Ci + ci0);
    } else {
      areg = make_int4(padw, padw, padw, padw);
    }
    if (b_row) {
      breg = *reinterpret_cast<const int4*>(w + ((size_t)bn * 9 + tap) * Ci + ci0);
    }
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&As[buf][lr * ROW + lh]) = areg;
    if (b_load) *reinterpret_cast<int4*>(&Bs[buf][lr * ROW + lh]) = breg;
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < ksteps; ++s) {
    const int buf = s & 1;
    if (s + 1 < ksteps) load(s + 1);
    uint32_t af[MT][4];
    uint32_t bf[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint8_t* p = &As[buf][(wm0 + i * 16 + g) * ROW + tig * 4];
      af[i][0] = *reinterpret_cast<const uint32_t*>(p);
      af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW);
      af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * ROW + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint8_t* q = &Bs[buf][(wn0 + j * 8 + g) * ROW + tig * 4];
      bf[j][0] = *reinterpret_cast<const uint32_t*>(q);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(q + 16);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    if (s + 1 < ksteps) store(buf ^ 1);
    __syncthreads();
  }

  // Accumulator fragment (i, j): element 2*half + e sits at pixel row
  // g + 8*half and channel 2*tig + e of the 16x8 tile.
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm0 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn0 + j * 8 + tig * 2 + e;
          if (n >= Co) continue;
          const float accf = __int2float_rn(acc[i][j][2 * half + e]);
          const size_t o = (size_t)m * Co + n;
          if (DEQUANT) {
            float y = accf + c[n];
            y = y * a[n];
            y = y + bias[n];
            static_cast<float*>(out)[o] = fmaxf(y, 0.0f);
          } else {
            float y = accf * a[n];
            y = y + c[n];
            y = fminf(fmaxf(rintf(y), -128.0f), 127.0f);
            static_cast<int8_t*>(out)[o] = (int8_t)(int)y;
          }
        }
      }
    }
  }
}

template <int BN, bool DEQUANT>
void launch(dim3 grid, cudaStream_t stream, const int8_t* x, const int8_t* w,
            const float* a, const float* c, const float* bias, void* out,
            int B, int H, int W, int Ci, int Co, int pad_code) {
  conv3x3_int8_kernel<BN, DEQUANT><<<grid, THREADS, 0, stream>>>(
      x, w, a, c, bias, out, B, H, W, Ci, Co, pad_code);
}

}  // namespace

// x: (B, H, W, Ci) int8 NHWC; w: (Co, 3, 3, Ci) int8 OHWI; a, c and (for
// dequant) bias: (Co,) float32; out: (B, H, W, Co) int8 (requant) or
// float32 (dequant). All contiguous on `device`, x and w 16-byte aligned,
// Ci a multiple of 32, B*H*W*max(Ci, Co) < 2^31. Returns
// cudaGetLastError() after the launch.
extern "C" int conv3x3_int8_launch(const void* x, const void* w,
                                   const void* a, const void* c,
                                   const void* bias, void* out, int B, int H,
                                   int W, int Ci, int Co, int pad_code,
                                   int dequant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Ci <= 0 || Ci % BK != 0 || Co <= 0 || B <= 0 || H <= 0 || W <= 0 ||
      (dequant && bias == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = B * H * W;
  const bool wide = Co % 128 == 0;
  const int BN = wide ? 128 : 64;
  const dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN);
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(bias);
  if (wide && dequant)
    launch<128, true>(grid, s, xi, wi, af, cf, bf, out, B, H, W, Ci, Co, pad_code);
  else if (wide)
    launch<128, false>(grid, s, xi, wi, af, cf, bf, out, B, H, W, Ci, Co, pad_code);
  else if (dequant)
    launch<64, true>(grid, s, xi, wi, af, cf, bf, out, B, H, W, Ci, Co, pad_code);
  else
    launch<64, false>(grid, s, xi, wi, af, cf, bf, out, B, H, W, Ci, Co, pad_code);
  return (int)cudaGetLastError();
}
