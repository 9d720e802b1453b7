// Fused 3x3 SAME convolution over NHWC bf16 for Hopper (sm_90a).
//
// Replaces: kidney_diffusion_tpu/kernels/conv3x3.py::_pallas_conv3x3 (body
// `_kernel`, stats finisher at :475-481). Same function: y = conv3x3(pro(x))
// + bias with fp32 accumulation, where the optional prologue is
// silu(x * a + c) per (batch, input channel) and the conv's SAME zero padding
// is applied AFTER it; optional per-(batch, output channel) [sum z, sum z^2]
// of the pre-bias output z; with chunks > 0 the batch is a batch of row
// chunks and a chunk's halo rows come from its neighbour chunk of the same
// image (zeros only at the image's top and bottom).
//
// What bounds it on this card: each output element takes 2*9*Cin operations
// and each input element feeds 9*Cout of them, so at the U-Net's widths
// (128-1024 channels at 512² and below) the work is far above the ~295
// FLOP/byte where the H100's bf16 tensor cores, not HBM, become the limit:
// bound by operations. The narrow ends (Cin = 6 at the init conv, Cout = 3 at
// the final conv) and the small deep maps with large weights are bound by
// bytes.
//
// Design: an implicit GEMM over (pixels x Cout) with K = 9*Cin. A block owns
// a 64-pixel tile (1x64, 2x32 or 4x16 rows x columns) and 64 output
// channels. For every 16-channel slice of the input it stages the tile's
// (TH+2) x (TW+2) halo'd patch in shared memory — prologue applied there,
// border and chunk-edge zeros written after it — plus the 9 taps' (16 x 64)
// weight slices, then each of its 4 warps runs 9 x 4 bf16 WMMA products
// (16x16x16, fp32 accumulate) for its 16 pixels. The tap shifts are free:
// a tap's A operand is the same patch read at a (dy, dx) offset. Ragged Cin
// and Cout are zero-filled in shared memory and masked on store. The
// epilogue stages the fp32 tile in shared memory, writes each tile's
// per-channel [sum z, sum z^2] to its own slot of a scratch tensor (no
// atomics: blocks run in no fixed order, the wrapper sums the slots in a
// fixed order), adds the bias and stores bf16. Simple and right first;
// cp.async / TMA pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;       // output pixels per block
constexpr int TN = 64;       // output channels per block
constexpr int KC = 16;       // input channels per K step
constexpr int THREADS = 128; // 4 warps, 16 pixels each
constexpr int MAX_PATCH = 3 * 66;  // max (TH+2)*(TW+2) over the three tile shapes

__device__ __forceinline__ float silu(float f) { return f / (1.0f + expf(-f)); }

// Source pointer of image row `r`, column `c` for batch item `bi`, or null
// where the conv input is a padding zero. Rows outside [0, H) come from the
// neighbour chunk when the batch is row-chunked.
__device__ __forceinline__ const __nv_bfloat16* src_pixel(
    const __nv_bfloat16* x, int bi, int r, int c, int H, int W, int Cin, int chunks, int nb) {
  if (c < 0 || c >= W || r < -1 || r > H) return nullptr;
  int b = bi;
  if (r == -1) {
    if (chunks <= 0 || bi % chunks == 0) return nullptr;
    b = bi - 1;
    r = H - 1;
  } else if (r == H) {
    if (chunks <= 0 || bi % chunks == chunks - 1 || bi + 1 >= nb) return nullptr;
    b = bi + 1;
    r = 0;
  }
  return x + ((size_t)(b * H + r) * W + c) * Cin;
}

__global__ void __launch_bounds__(THREADS) conv3x3_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ pro,
    __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
    int H, int W, int Cin, int Cout, int chunks, int TH, int TW, int tiles_x, int n_tiles) {
  __shared__ __align__(128) __nv_bfloat16 patch[MAX_PATCH * KC];
  __shared__ __align__(128) __nv_bfloat16 wsm[9 * KC * TN];
  __shared__ __align__(128) float out[TM * TN];

  const int nb = gridDim.z;
  const int bi = blockIdx.z;
  const int co0 = blockIdx.y * TN;
  const int tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * TH;
  const int tx0 = (tile % tiles_x) * TW;
  const int PW = TW + 2;
  const int npatch = (TH + 2) * PW;
  const int warp = threadIdx.x / 32;
  const float* pa = pro ? pro + (size_t)bi * 2 * Cin : nullptr;  // [a; c] rows
  const bool vec_x = (Cin % 8) == 0;
  const bool vec_w = (Cout % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // this warp's 16 pixels: one run inside one tile row (TW is 16, 32 or 64)
  const int m0 = warp * 16;
  const int wy = m0 / TW, wx = m0 % TW;

  for (int ci0 = 0; ci0 < Cin; ci0 += KC) {
    // ---- stage the halo'd input patch (prologue, then padding zeros) ----
    if (vec_x) {
      for (int i = threadIdx.x; i < npatch * 2; i += THREADS) {
        const int p = i >> 1, half = i & 1;
        const int c = ci0 + half * 8;
        const __nv_bfloat16* src =
            src_pixel(x, bi, ty0 + p / PW - 1, tx0 + p % PW - 1, H, W, Cin, chunks, nb);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (src != nullptr && c < Cin) {
          val = *reinterpret_cast<const uint4*>(src + c);
          if (pa != nullptr) {
            __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float f = __bfloat162float(v[e]) * pa[c + e] + pa[Cin + c + e];
              v[e] = __float2bfloat16(silu(f));
            }
          }
        }
        *reinterpret_cast<uint4*>(&patch[p * KC + half * 8]) = val;
      }
    } else {
      for (int i = threadIdx.x; i < npatch * KC; i += THREADS) {
        const int p = i / KC, k = i % KC;
        const int c = ci0 + k;
        const __nv_bfloat16* src =
            src_pixel(x, bi, ty0 + p / PW - 1, tx0 + p % PW - 1, H, W, Cin, chunks, nb);
        __nv_bfloat16 v = __float2bfloat16(0.0f);
        if (src != nullptr && c < Cin) {
          v = src[c];
          if (pa != nullptr) v = __float2bfloat16(silu(__bfloat162float(v) * pa[c] + pa[Cin + c]));
        }
        patch[p * KC + k] = v;
      }
    }
    // ---- stage the 9 taps' (KC x TN) weight slices -----------------------
    if (vec_w) {
      for (int i = threadIdx.x; i < 9 * KC * (TN / 8); i += THREADS) {
        const int n8 = i % (TN / 8), k = (i / (TN / 8)) % KC, tap = i / (KC * (TN / 8));
        const int ci = ci0 + k, co = co0 + n8 * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (ci < Cin && co < Cout)
          val = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cin + ci) * Cout + co);
        *reinterpret_cast<uint4*>(&wsm[(tap * KC + k) * TN + n8 * 8]) = val;
      }
    } else {
      for (int i = threadIdx.x; i < 9 * KC * TN; i += THREADS) {
        const int n = i % TN, k = (i / TN) % KC, tap = i / (KC * TN);
        const int ci = ci0 + k, co = co0 + n;
        wsm[i] = (ci < Cin && co < Cout) ? w[((size_t)tap * Cin + ci) * Cout + co]
                                         : __float2bfloat16(0.0f);
      }
    }
    __syncthreads();

    // ---- 9 taps x 4 column fragments of tensor-core products -------------
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &patch[((wy + dy) * PW + wx + dx) * KC], KC);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &wsm[(dy * 3 + dx) * KC * TN + j * 16], TN);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: fp32 tile -> stats slots, bias, bf16 store --------------
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&out[m0 * TN + j * 16], acc[j], TN, wmma::mem_row_major);
  __syncthreads();

  if (partial != nullptr && threadIdx.x < TN) {
    const int n = threadIdx.x, co = co0 + n;
    if (co < Cout) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int m = 0; m < TM; ++m) {
        const int oy = ty0 + m / TW, ox = tx0 + m % TW;
        if (oy < H && ox < W) {
          const float z = out[m * TN + n];
          s1 += z;
          s2 += z * z;
        }
      }
      const size_t slot = ((size_t)bi * n_tiles + tile) * 2 * Cout + co;
      partial[slot] = s1;
      partial[slot + Cout] = s2;
    }
  }

  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int m = i / TN, n = i % TN;
    const int oy = ty0 + m / TW, ox = tx0 + m % TW, co = co0 + n;
    if (oy < H && ox < W && co < Cout) {
      const float b = bias != nullptr ? bias[co] : 0.0f;
      y[((size_t)(bi * H + oy) * W + ox) * Cout + co] = __float2bfloat16(out[i] + b);
    }
  }
}

}  // namespace

extern "C" {

// x (nb, H, W, Cin) bf16; w (3, 3, Cin, Cout) bf16; bias (Cout) fp32 or null;
// pro (nb, 2, Cin) fp32 or null; y (nb, H, W, Cout) bf16; partial
// (nb, n_tiles, 2, Cout) fp32 or null. tile_w is 16, 32 or 64 and
// tile_h = 64 / tile_w. Returns cudaGetLastError() after the launch.
int kdt_conv3x3(const void* x, const void* w, const void* bias, const void* pro, void* y,
                void* partial, int nb, int H, int W, int Cin, int Cout, int chunks,
                int tile_w, void* stream) {
  const int tile_h = TM / tile_w;
  const int tiles_x = (W + tile_w - 1) / tile_w;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  const dim3 grid(tiles_x * tiles_y, (Cout + TN - 1) / TN, nb);
  conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(pro),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), H, W, Cin, Cout, chunks,
      tile_h, tile_w, tiles_x, tiles_x * tiles_y);
  return static_cast<int>(cudaGetLastError());
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
