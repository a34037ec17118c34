// Kernel K3: one int8 3x3 SAME convolution of the quantized VGG streams,
// s8 x s8 -> s32 on Hopper's warpgroup tensor cores, epilogue fused.
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
// and, after the last conv of a VGG stage, optionally the 2x2 stride-2
// max-pool of the requantized codes (gaze_tpu_torch/ops/conv_int8.py:
// maxpool2x2_int8; odd edges dropped), which the layer then writes alone.
//
// Bound on the H100: operations. A layer is 2 * B*H*W * 9*Ci*Co int8
// operations against about B*H*W*(Ci + Co) bytes: conv1_2 at B=8, 224^2,
// 64->64 is 29.6 G operations (15 us at 1,979 TOPS dense int8) and moves
// 51 MB (15 us at 3.35 TB/s); every deeper layer has a larger ratio of
// operations to bytes. The turbo step's 24 layers are 488 G operations,
// about 0.25 ms.
//
// Design: implicit GEMM, M = output pixels, N = Co, K = 9 taps x Ci.
// - A block owns one 8x16-pixel spatial tile of one image (128 rows of M)
//   and BN = 64 or 128 output channels. Two consumer warpgroups each run
//   wgmma.mma_async m64nBNk32 s8 x s8 -> s32 on 64 of the rows, both
//   operands read from shared memory in the K-major swizzled layout.
// - A producer warp keeps two rings full with TMA, in the order the
//   consumers use them: per chunk of BK channels and column offset dx,
//   one 4-D box of the NHWC codes, BK channels x 16 x 10 pixels (the
//   tile's rows and the rows above and below it); then, per row offset
//   dy, one 2-D box (BK x BN) of the OHWI weights, whose rows are already
//   K-major. Tap (dy, dx) reads the box from row 16 * dy on, a whole
//   number of swizzle atoms, so one box serves three taps and the codes
//   cross from L2 3 times per chunk, not 9. Full/empty mbarriers hand
//   the stages over; the consumers keep one wgmma group in flight and free
//   a stage as soon as the last group that read it retires.
// - A K step (one tap, one chunk) is BK = 128 bytes (channels) when Ci is
//   a multiple of 128 (128-byte swizzle), else 64 (64-byte swizzle;
//   conv1_2, conv2_1) or 32 (32-byte swizzle; the padded int8 stem). A
//   512-channel layer takes 36 steps, not 144.
// - The pad code: TMA fills a box's out-of-frame elements with 0, not the
//   pad code. Since acc is an exact integer, the epilogue adds it back:
//     acc = acc_zero_fill + pad_code * sum over taps outside the frame
//           of colsum[tap, n],   colsum[tap, n] = sum_ci w[n, tap, ci].
//   Which taps leave the frame depends only on whether the pixel is on
//   the top, bottom, left or right edge: 16 border classes. The wrapper
//   folds the sums into a 16 x Co int32 table once per layer, so an edge
//   pixel adds one table entry per channel (ops/conv_int8.py:
//   border_table and pad_correction are the plain form).
// - The grid is persistent: as many blocks as fit at once (two per SM),
//   each walking over tiles; the producer's
//   ring runs on across tiles, so a tile's loads land while the previous
//   tile's epilogue runs. BN = 128 (twice the operations per byte loaded)
//   where that still gives every SM a tile, else 64: the 14^2 layers have
//   128 tiles, not the 52 blocks of a 128 x 128 tiling. Pixels of a tile
//   outside the frame (14 = 16 - 2, 28 = 2 x 16 - 4) compute and are not
//   stored.
// - The epilogue runs on the accumulator registers and writes the output
//   once; for int8 output the four lanes of a quad trade codes with
//   shuffles so that each stores 8 consecutive channels at once.
// - The fused max-pool: a warp holds one pixel row of the tile (tiles
//   start at even rows and columns), so a 2x2 window is two lanes of two
//   neighbouring warps. Lanes take the column pair's max with a shuffle,
//   odd warps hand theirs to the even ones through shared memory (8 KB
//   at BN = 128; a named barrier per warpgroup), and the even warps store
//   a quarter of the codes. The max of int8 codes is exact.
//
// Arithmetic follows the plain PyTorch version (gaze_tpu_torch/ops/
// conv_int8.py:conv3x3_int8_plain): the integer sum and the correction
// are exact in any order, the accumulator is cast with __int2float_rn,
// each epilogue operation rounds on its own (built with -fmad=false) and
// rintf rounds half to even, so the two agree to the bit (and the pooled
// layer with conv3x3_int8_plain followed by maxpool2x2_int8).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // output pixels per tile
constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int CONSUMERS = 256;          // two warpgroups of 64 rows each
constexpr int THREADS = CONSUMERS + 32; // and one producer warp

// Two blocks per SM, so that one's epilogue overlaps the other's loads and
// products; each gets the deepest rings that half the shared memory holds.
// An A stage is one input box of TILE_H + 2 rows, which serves the three
// taps of one column offset; a B stage is one tap's weights.
template <int BK, int BN>
struct Cfg {
  static constexpr int A_BYTES = (TILE_H + 2) * TILE_W * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int BUDGET = 100 * 1024;
  static constexpr int A_STAGES = 3 * A_BYTES <= BUDGET / 2 ? 3 : 2;
  static constexpr int B_FIT = (BUDGET - A_STAGES * A_BYTES) / B_BYTES;
  static constexpr int B_STAGES = B_FIT < 12 ? B_FIT : 12;
  // The fused 2x2 max-pool: per warpgroup, the odd rows' pair maxima
  // (2 odd warps x 2 halves x BN / 8 words x 16 lanes) for the even rows.
  static constexpr int POOL_BYTES = 2 * 2 * 2 * (BN / 8) * 16 * 4;
  // rings, their full and empty mbarriers, the pool exchange, and slack
  // to align the base to 1024 B
  static constexpr int SMEM = A_STAGES * A_BYTES + B_STAGES * B_BYTES +
                              16 * (A_STAGES + B_STAGES) + POOL_BYTES + 1024;
  static_assert(B_STAGES >= 2, "the B ring needs two stages");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are BK bytes,
// swizzled by TMA with the BK-byte pattern: 8-row atoms BK * 8 bytes apart.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = BK == 128 ? 1 : BK == 64 ? 2 : 3;  // SW128, SW64, SW32
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * BK / 16) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma instructions.
template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_m64n64k32(d, da, db);
  } else {
    wgmma_m64n128k32(d, da, db);
  }
}

// The four lanes of a quad trade requantized codes so that lane tig holds
// all 8 channels of chunk 4 jb + tig: pk[j] holds channels 8 j + 2 tig and
// + 1 in its low 16 bits; returns them as 8 bytes.
template <int BN>
__device__ __forceinline__ uint2 quad_gather(const uint32_t (&pk)[BN / 8], int jb, int lane) {
  const int tig = lane & 3;
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int rnd = 0; rnd < 4; ++rnd) {
    const int d = (tig - rnd) & 3;
    const uint32_t send = d == 0   ? pk[4 * jb]
                          : d == 1 ? pk[4 * jb + 1]
                          : d == 2 ? pk[4 * jb + 2]
                                   : pk[4 * jb + 3];
    const int src = (tig + rnd) & 3;
    const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | src);
    if (src < 2)
      lo |= got << (16 * src);
    else
      hi |= got << (16 * (src - 2));
  }
  return make_uint2(lo, hi);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int BK, int BN, bool DEQUANT, bool POOL>
__global__ void __launch_bounds__(THREADS, 2)
conv3x3_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a,
                    const float* __restrict__ c, const float* __restrict__ bias,
                    const int* __restrict__ border, void* __restrict__ out, int H, int W,
                    int Ci, int Co, int tiles_h, int tiles_w, int tiles) {
  static_assert(!(POOL && DEQUANT), "the max-pool follows a requantizing conv");
  using C = Cfg<BK, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t a_s = (raw + 1023) & ~1023u;           // swizzle atoms need 1024 B
  const uint32_t b_s = a_s + C::A_STAGES * C::A_BYTES;
  const uint32_t a_full = b_s + C::B_STAGES * C::B_BYTES;
  const uint32_t a_empty = a_full + 8 * C::A_STAGES;
  const uint32_t b_full = a_empty + 8 * C::A_STAGES;
  const uint32_t b_empty = b_full + 8 * C::B_STAGES;
  uint32_t* const pool_s =
      reinterpret_cast<uint32_t*>(smem_raw + (b_empty + 8 * C::B_STAGES - raw));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::A_STAGES; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < C::B_STAGES; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (Co + BN - 1) / BN;
  const int csteps = Ci / BK;
  // Tile t of this persistent block: output channels n-tile t % n_tiles of
  // the spatial tile t / n_tiles (8 x 16 pixels of one image).
  auto decode = [&](int t, int& b, int& oh0, int& ow0, int& n0) {
    n0 = (t % n_tiles) * BN;
    t /= n_tiles;
    ow0 = (t % tiles_w) * TILE_W;
    t /= tiles_w;
    oh0 = (t % tiles_h) * TILE_H;
    b = t / tiles_h;
  };

  if (tid >= CONSUMERS) {
    // Producer: one thread issues the TMA loads of every tile in the order
    // the consumers use them: per channel chunk and column offset dx, one
    // input box of TILE_H + 2 rows, then the weights of its three taps
    // (dy = 0, 1, 2). The rings run on across tiles, so the next tile's
    // loads land while the consumers run this one's epilogue.
    if (tid == CONSUMERS) {
      int ia = 0, ib = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int b, oh0, ow0, n0;
        decode(t, b, oh0, ow0, n0);
        for (int cs = 0; cs < csteps; ++cs) {
          for (int dx = 0; dx < 3; ++dx, ++ia) {
            const int sa = ia % C::A_STAGES;
            mbar_wait(a_empty + 8 * sa, ((ia / C::A_STAGES) & 1) ^ 1);
            mbar_expect_tx(a_full + 8 * sa, C::A_BYTES);
            tma_load_4d(a_s + sa * C::A_BYTES, &xmap, a_full + 8 * sa, cs * BK, ow0 + dx - 1,
                        oh0 - 1, b);
            for (int dy = 0; dy < 3; ++dy, ++ib) {
              const int sb = ib % C::B_STAGES;
              mbar_wait(b_empty + 8 * sb, ((ib / C::B_STAGES) & 1) ^ 1);
              mbar_expect_tx(b_full + 8 * sb, C::B_BYTES);
              tma_load_2d(b_s + sb * C::B_BYTES, &wmap, b_full + 8 * sb,
                          (dy * 3 + dx) * Ci + cs * BK, n0);
            }
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg multiplies rows 64 * wg .. 64 * wg + 63.
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int row0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;
  int ia = 0, ib = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int b, oh0, ow0, n0;
    decode(t, b, oh0, ow0, n0);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int cs = 0; cs < csteps; ++cs) {
      for (int dx = 0; dx < 3; ++dx, ++ia) {
        const int sa = ia % C::A_STAGES;
        mbar_wait(a_full + 8 * sa, (ia / C::A_STAGES) & 1);
        for (int dy = 0; dy < 3; ++dy, ++ib) {
          const int sb = ib % C::B_STAGES;
          mbar_wait(b_full + 8 * sb, (ib / C::B_STAGES) & 1);
          // tap (dy, dx): tile row r reads box row r + TILE_W * dy
          const uint32_t at = a_s + sa * C::A_BYTES + (wg * 64 + TILE_W * dy) * BK;
          const uint32_t bt = b_s + sb * C::B_BYTES;
          reg_fence(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            wgmma_tile<BN>(acc, smem_desc<BK>(at + 32 * kk), smem_desc<BK>(bt + 32 * kk));
          wgmma_commit();
          reg_fence(acc);
          if (cs + dx + dy > 0) {
            // the previous step's group has retired: free its B stage, and
            // its A stage when that step was the box's last tap
            wgmma_wait<1>();
            reg_fence(acc);
            mbar_arrive(b_empty + 8 * ((ib - 1) % C::B_STAGES));
            if (dy == 0) mbar_arrive(a_empty + 8 * ((ia - 1) % C::A_STAGES));
          }
        }
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(b_empty + 8 * ((ib - 1) % C::B_STAGES));
    mbar_arrive(a_empty + 8 * ((ia - 1) % C::A_STAGES));

    // Accumulator element 4 * j + 2 * half + e of thread (warp, g = lane /
    // 4, tig = lane % 4) sits at tile row 16 * warp + 8 * half + g of the
    // warpgroup's 64 and at channel 8 * j + 2 * tig + e of the tile's BN.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      const int oh = oh0 + r / TILE_W;
      const int ow = ow0 + r % TILE_W;
      const bool valid = oh < H && ow < W;
      // border class: which of the top, bottom, left and right taps leave
      // the frame; class 0 (inside) takes no correction
      const int cls = valid ? (oh == 0) | (oh == H - 1) << 1 | (ow == 0) << 2 | (ow == W - 1) << 3
                            : 0;
      const int* const brow = border + cls * Co;
      const size_t pix = ((size_t)b * H + (valid ? oh : 0)) * W + (valid ? ow : 0);
      // the exact accumulator of channel n, its border taps restored
      auto value = [&](int j, int e, int n) {
        int v = acc[4 * j + 2 * half + e];
        if (cls != 0) v += brow[n];
        return __int2float_rn(v);
      };
      if (DEQUANT) {
        if (!valid) continue;
        float* o = static_cast<float*>(out) + pix * Co;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * tig;
          float y[2] = {0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n + e >= Co) continue;
            float z = value(j, e, n + e) + c[n + e];
            z = z * a[n + e];
            z = z + bias[n + e];
            y[e] = fmaxf(z, 0.0f);
          }
          if (n + 1 < Co && Co % 2 == 0) {
            *reinterpret_cast<float2*>(o + n) = make_float2(y[0], y[1]);
          } else if (n < Co) {
            o[n] = y[0];
            if (n + 1 < Co) o[n + 1] = y[1];
          }
        }
      } else {
        // Requant, two codes per chunk of 8 channels: pk[j] holds channels
        // 8 j + 2 tig and + 1 in its low 16 bits.
        uint32_t pk[BN / 8];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          pk[j] = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * j + 2 * tig + e;
            if (n >= Co) continue;
            float z = value(j, e, n) * a[n];
            z = z + c[n];
            z = fminf(fmaxf(rintf(z), -128.0f), 127.0f);
            pk[j] |= ((uint32_t)(int)z & 0xffu) << (8 * e);
          }
        }
        if (POOL) {
          // 2x2 max-pool of the codes (exact). This warp holds one pixel
          // row of the tile, lane g its columns g and g + 8: the column
          // pair is lanes g and g ^ 1, the row pair warps w and w ^ 1.
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            pk[j] = __vmaxs4(pk[j], __shfl_xor_sync(0xffffffffu, pk[j], 4));
          const int wq = (tid >> 5) & 3;  // the warp's row in its warpgroup
          uint32_t* const ex = pool_s + (((wg * 2 + (wq >> 1)) * 2 + half) * (BN / 8)) * 16;
          const int slot = (g >> 1) * 4 + tig;
          if ((wq & 1) && !(g & 1)) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) ex[j * 16 + slot] = pk[j];
          }
          named_barrier(1 + wg, 128);
          if (!(wq & 1)) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) pk[j] = __vmaxs4(pk[j], ex[j * 16 + slot]);
          }
          named_barrier(1 + wg, 128);  // ex is free for the next tile
          const int Hp = H / 2, Wp = W / 2;
          const bool store = !(wq & 1) && !(g & 1) && oh / 2 < Hp && ow / 2 < Wp;
          int8_t* const o = static_cast<int8_t*>(out) +
                            (((size_t)b * Hp + (store ? oh / 2 : 0)) * Wp + (store ? ow / 2 : 0)) * Co;
          if (Co % 8 == 0) {
#pragma unroll
            for (int jb = 0; jb < BN / 32; ++jb) {
              const uint2 v = quad_gather<BN>(pk, jb, lane);
              const int n = n0 + 8 * (4 * jb + tig);
              if (store && n < Co) *reinterpret_cast<uint2*>(o + n) = v;
            }
          } else if (store) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = n0 + 8 * j + 2 * tig + e;
                if (n < Co) o[n] = (int8_t)((pk[j] >> (8 * e)) & 0xffu);
              }
            }
          }
          continue;
        }
        int8_t* o = static_cast<int8_t*>(out) + pix * Co;
        if (Co % 8 == 0) {
          // one 8-byte store of 8 consecutive channels a lane
#pragma unroll
          for (int jb = 0; jb < BN / 32; ++jb) {
            const uint2 v = quad_gather<BN>(pk, jb, lane);
            const int n = n0 + 8 * (4 * jb + tig);
            if (valid && n < Co) *reinterpret_cast<uint2*>(o + n) = v;
          }
        } else if (valid) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + 8 * j + 2 * tig + e;
              if (n < Co) o[n] = (int8_t)((pk[j] >> (8 * e)) & 0xffu);
            }
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

constexpr int kErrEncode = 10000;  // + the CUresult of a failed encode

template <int BK, int BN, bool DEQUANT, bool POOL>
int launch(const void* x, const void* w, const float* a, const float* c, const float* bias,
           const int* border, void* out, int B, int H, int W, int Ci, int Co,
           cudaStream_t stream) {
  using C = Cfg<BK, BN>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrEncode + 999;
  const CUtensorMapSwizzle swz = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : BK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)Ci, (cuuint64_t)W * Ci, (cuuint64_t)H * W * Ci};
  const cuuint32_t xbox[4] = {BK, TILE_W, TILE_H + 2, 1};
  CUresult r = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), xdim,
                      xstride, xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode + (int)r;
  const cuuint64_t wdim[2] = {(cuuint64_t)9 * Ci, (cuuint64_t)Co};
  const cuuint64_t wstride[1] = {(cuuint64_t)9 * Ci};
  const cuuint32_t wbox[2] = {BK, BN};
  r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdim, wstride, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kErrEncode + (int)r;

  auto kernel = conv3x3_int8_kernel<BK, BN, DEQUANT, POOL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (H + TILE_H - 1) / TILE_H;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const int tiles = B * tiles_h * tiles_w * ((Co + BN - 1) / BN);
  // Persistent: as many blocks as fit on the card at once, each walking
  // over tiles blockIdx.x, + gridDim.x, ...
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, C::SMEM)) !=
          cudaSuccess)
    return (int)err;
  const int grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(xmap, wmap, a, c, bias, border, out, H, W, Ci, Co,
                                             tiles_h, tiles_w, tiles);
  return (int)cudaGetLastError();
}

template <int BK>
int launch_bk(bool wide, int epilogue, const void* x, const void* w, const float* a,
              const float* c, const float* bias, const int* border, void* out, int B, int H,
              int W, int Ci, int Co, cudaStream_t s) {
  // epilogue: 0 requant, 1 dequant, 2 requant and 2x2 max-pool
  if (wide) {
    if (epilogue == 1)
      return launch<BK, 128, true, false>(x, w, a, c, bias, border, out, B, H, W, Ci, Co, s);
    if (epilogue == 2)
      return launch<BK, 128, false, true>(x, w, a, c, bias, border, out, B, H, W, Ci, Co, s);
    return launch<BK, 128, false, false>(x, w, a, c, bias, border, out, B, H, W, Ci, Co, s);
  }
  if (epilogue == 1)
    return launch<BK, 64, true, false>(x, w, a, c, bias, border, out, B, H, W, Ci, Co, s);
  if (epilogue == 2)
    return launch<BK, 64, false, true>(x, w, a, c, bias, border, out, B, H, W, Ci, Co, s);
  return launch<BK, 64, false, false>(x, w, a, c, bias, border, out, B, H, W, Ci, Co, s);
}

// The instantiation's (BK, BN) for a layer: BK the widest of 128, 64 and
// 32 input channels that divides Ci; BN = 128 (twice the operations per
// byte loaded) where that still gives every SM a tile, else 64.
void pick_block(int B, int H, int W, int Ci, int Co, int& bk, int& bn) {
  bk = Ci % 128 == 0 ? 128 : Ci % 64 == 0 ? 64 : 32;
  const long long tiles = (long long)B * ((H + TILE_H - 1) / TILE_H) * ((W + TILE_W - 1) / TILE_W);
  bn = Co % 128 == 0 && tiles * (Co / 128) >= 132 ? 128 : 64;
}

}  // namespace

// x: (B, H, W, Ci) int8 NHWC; w: (Co, 3, 3, Ci) int8 OHWI; a, c and (for
// dequant) bias: (Co,) float32; border: (16, Co) int32, the pad code's
// share of the accumulator per border class (ops/conv_int8.py:
// border_table); out: (B, H, W, Co) int8 (requant), float32 (dequant) or
// (B, H/2, W/2, Co) int8 (requant then 2x2 max-pool, odd edges dropped).
// All contiguous on `device`, x and w 16-byte aligned, Ci a multiple of
// 32, B*H*W*max(Ci, Co) < 2^31. Returns cudaGetLastError() after the
// launch, or 10000 + the CUresult of a failed tensor-map encode.
extern "C" int conv3x3_int8_launch(const void* x, const void* w, const void* a, const void* c,
                                   const void* bias, const void* border, void* out, int B,
                                   int H, int W, int Ci, int Co, int dequant, int pool,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Ci <= 0 || Ci % 32 != 0 || Co <= 0 || B <= 0 || H <= 0 || W <= 0 || border == nullptr ||
      (dequant && bias == nullptr) || (dequant && pool))
    return (int)cudaErrorInvalidValue;
  const int epilogue = dequant ? 1 : pool ? 2 : 0;
  int bk, bn;
  pick_block(B, H, W, Ci, Co, bk, bn);
  const bool wide = bn == 128;
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(bias);
  const int* bt = static_cast<const int*>(border);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bk == 128)
    return launch_bk<128>(wide, epilogue, x, w, af, cf, bf, bt, out, B, H, W, Ci, Co, s);
  if (bk == 64)
    return launch_bk<64>(wide, epilogue, x, w, af, cf, bf, bt, out, B, H, W, Ci, Co, s);
  return launch_bk<32>(wide, epilogue, x, w, af, cf, bf, bt, out, B, H, W, Ci, Co, s);
}

// The (BK, BN) that conv3x3_int8_launch takes for a layer of this shape,
// into bk and bn; launches nothing. Returns cudaErrorInvalidValue where
// the launcher would refuse the shape, else 0.
extern "C" int conv3x3_int8_block(int B, int H, int W, int Ci, int Co, int* bk, int* bn) {
  if (Ci <= 0 || Ci % 32 != 0 || Co <= 0 || B <= 0 || H <= 0 || W <= 0 || !bk || !bn)
    return (int)cudaErrorInvalidValue;
  pick_block(B, H, W, Ci, Co, *bk, *bn);
  return 0;
}
