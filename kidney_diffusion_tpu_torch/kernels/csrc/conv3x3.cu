// Fused 3x3 SAME convolution over NHWC bf16 for Hopper (sm_90a), in two
// modes: bf16 operands, and w8a8 int8 operands.
//
// Replaces: kidney_diffusion_tpu/kernels/conv3x3.py::_pallas_conv3x3 (body
// `_kernel`, stats finisher at :475-481), and, in its int8 mode, the XLA
// path `_int8_conv` + `xla_conv3x3(quant=True)` (:243-351) that the JAX
// package runs for the w8a8 serving sites (PyTorch has no int8 convolution
// on CUDA). Same function: y = conv3x3(pro(x)) + bias with exact
// accumulation, where the optional prologue is silu(x * a + c) per (batch,
// input channel), rounded to bf16, and the conv's SAME zero padding is
// applied AFTER it; optional per-(batch, output channel) [sum z, sum z^2] of
// the pre-bias output z; optional per-channel [max, min] of the post-bias
// output (the range epilogue: from fp32 z + bias when stats are on, from the
// bf16 output otherwise); with chunks > 0 the batch is a batch of row chunks
// and a chunk's halo rows come from its neighbour chunk of the same image
// (zeros only at the image's top and bottom).
//
// int8 mode: the prologue'd bf16 value is quantized while the patch is
// staged, q = clip(rint(v / s_a), -127, 127) with the per-tensor scale s_a
// read from device memory (no host sync); the weights arrive quantized per
// output channel (int8, from the wrapper); products accumulate in int32,
// which is exact (9 * 2048 * 127^2 < 2^31); the epilogue dequantizes as
// float(acc) * (s_a * s_w[co]) and then adds the bias, each step rounded on
// its own (no fused multiply-add), so with the same scales the output is
// bit-equal to the plain version. Quantizing a halo row staged from the
// neighbour chunk gives the same int8 as quantizing first and exchanging
// halos after, because s_a is one scalar.
//
// bias_in_dtype: y = bf16(bf16(z) + bf16(bias)), the two roundings of
// `flax.linen.Conv(dtype=bf16)` (the unchunked init conv's call site).
//
// What bounds it on this card: each output element takes 2*9*Cin operations
// and each input element feeds 9*Cout of them, so at the U-Net's widths
// (128-1024 channels at 512² and below) the work is far above the ~295
// FLOP/byte where the H100's bf16 tensor cores, not HBM, become the limit
// (~590 for int8): bound by operations. The narrow ends (Cin = 6 at the
// init conv, Cout = 3 at the final conv) and the small deep maps with large
// weights are bound by bytes.
//
// Design: an implicit GEMM over (pixels x Cout) with K = 9*Cin. A block owns
// a 64-pixel tile (1x64, 2x32 or 4x16 rows x columns) and 64 output
// channels. For every 16-channel slice of the input it stages the tile's
// (TH+2) x (TW+2) halo'd patch in shared memory — prologue applied there,
// border and chunk-edge zeros written after it, int8 quantize last — plus
// the 9 taps' (16 x 64) weight slices, then each of its 4 warps runs 9 x 4
// WMMA products (16x16x16; bf16 -> fp32 or s8 -> s32) for its 16 pixels.
// The tap shifts are free: a tap's A operand is the same patch read at a
// (dy, dx) offset. WMMA wants 32-byte aligned tile pointers, so the int8
// patch keeps 32 bytes per pixel (16 used) and the int8 weights sit in
// 16 x 16 blocks. Ragged Cin and Cout are zero-filled in shared memory and
// masked on store. The epilogue stages the tile's accumulators in shared
// memory, writes each tile's per-channel stats and range to its own slot of
// a scratch tensor (no atomics: blocks run in no fixed order, the wrapper
// reduces the slots in a fixed order), adds the bias and stores bf16. It
// serves the calls `kernels/conv3x3.py::route` sends it: ragged widths that
// neither `conv3x3_sm90.cu` (bf16 and int8 calls with Cin and Cout
// multiples of 64, on `wgmma`) nor `conv3x3_narrow.cu` (the init and final
// convs) takes, in either mode, and the bf16-bias rounding at such widths.
// No call of the flagship cascade comes here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int TM = 64;       // output pixels per block
constexpr int TN = 64;       // output channels per block
constexpr int KC = 16;       // input channels per K step
constexpr int THREADS = 128; // 4 warps, 16 pixels each
constexpr int MAX_PATCH = 3 * 66;  // max (TH+2)*(TW+2) over the three tile shapes

struct Args {
  const __nv_bfloat16* x;  // (nb, H, W, Cin)
  const void* w;           // (3, 3, Cin, Cout) bf16, or int8 in int8 mode
  const float* bias;       // (Cout) or null
  const float* pro;        // (nb, 2, Cin) or null
  const float* s_a;        // int8 mode: the activation scale, one scalar
  const float* sasw;       // int8 mode: (Cout) s_a * s_w
  __nv_bfloat16* y;        // (nb, H, W, Cout)
  float* partial;          // (nb, n_tiles, 2, Cout) [sum z, sum z^2] or null
  float* prange;           // (nb, n_tiles, 2, Cout) [max, min] or null
  int H, W, Cin, Cout, chunks, TH, TW, tiles_x, n_tiles;
  int range_mode;          // 1: of fp32 z (bias added by the wrapper); 2: of the bf16 output
  int bias_in_dtype;
};

__device__ __forceinline__ float silu(float f) { return f / (1.0f + expf(-f)); }

__device__ __forceinline__ signed char quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

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

template <bool INT8>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(const Args a) {
  using AT = std::conditional_t<INT8, signed char, __nv_bfloat16>;  // operand type
  using CT = std::conditional_t<INT8, int, float>;                  // accumulator type
  constexpr int PS = INT8 ? 32 : KC;  // patch elements per pixel (32-byte rows for int8)
  __shared__ __align__(128) AT patch[MAX_PATCH * PS];
  __shared__ __align__(128) AT wsm[9 * KC * TN];
  __shared__ __align__(128) CT out[TM * TN];

  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout, TW = a.TW;
  const int nb = gridDim.z;
  const int bi = blockIdx.z;
  const int co0 = blockIdx.y * TN;
  const int tile = blockIdx.x;
  const int ty0 = (tile / a.tiles_x) * a.TH;
  const int tx0 = (tile % a.tiles_x) * TW;
  const int PW = TW + 2;
  const int npatch = (a.TH + 2) * PW;
  const int warp = threadIdx.x / 32;
  const float* pa = a.pro ? a.pro + (size_t)bi * 2 * Cin : nullptr;  // [a; c] rows
  const bool vec_x = (Cin % 8) == 0;
  const bool vec_w = (Cout % (INT8 ? 16 : 8)) == 0;
  const float s_a = INT8 ? *a.s_a : 1.0f;
  const AT* w = static_cast<const AT*>(a.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, CT> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], static_cast<CT>(0));

  // this warp's 16 pixels: one run inside one tile row (TW is 16, 32 or 64)
  const int m0 = warp * 16;
  const int wy = m0 / TW, wx = m0 % TW;

  for (int ci0 = 0; ci0 < Cin; ci0 += KC) {
    // ---- stage the halo'd input patch (prologue, padding zeros, quantize) ----
    if (vec_x) {
      for (int i = threadIdx.x; i < npatch * 2; i += THREADS) {
        const int p = i >> 1, half = i & 1;
        const int c = ci0 + half * 8;
        const __nv_bfloat16* src = src_pixel(a.x, bi, ty0 + p / PW - 1, tx0 + p % PW - 1, H,
                                             W, Cin, a.chunks, nb);
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
        if constexpr (INT8) {
          const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&val);
          uint2 q;
          signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
          for (int e = 0; e < 8; ++e) qb[e] = quantize(__bfloat162float(v[e]), s_a);
          *reinterpret_cast<uint2*>(&patch[p * PS + half * 8]) = q;
        } else {
          *reinterpret_cast<uint4*>(&patch[p * PS + half * 8]) = val;
        }
      }
    } else {
      for (int i = threadIdx.x; i < npatch * KC; i += THREADS) {
        const int p = i / KC, k = i % KC;
        const int c = ci0 + k;
        const __nv_bfloat16* src = src_pixel(a.x, bi, ty0 + p / PW - 1, tx0 + p % PW - 1, H,
                                             W, Cin, a.chunks, nb);
        __nv_bfloat16 v = __float2bfloat16(0.0f);
        if (src != nullptr && c < Cin) {
          v = src[c];
          if (pa != nullptr) v = __float2bfloat16(silu(__bfloat162float(v) * pa[c] + pa[Cin + c]));
        }
        if constexpr (INT8) {
          patch[p * PS + k] = quantize(__bfloat162float(v), s_a);
        } else {
          patch[p * PS + k] = v;
        }
      }
    }
    // ---- stage the 9 taps' (KC x TN) weight slices -----------------------
    // bf16: [tap][k][TN] row-major; int8: [tap][16-column block][k][16]
    if (vec_w) {
      constexpr int VEC = 16 / sizeof(AT);  // elements per 16-byte load
      for (int i = threadIdx.x; i < 9 * KC * (TN / VEC); i += THREADS) {
        const int nv = i % (TN / VEC), k = (i / (TN / VEC)) % KC, tap = i / (KC * (TN / VEC));
        const int ci = ci0 + k, co = co0 + nv * VEC;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (ci < Cin && co < Cout)
          val = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cin + ci) * Cout + co);
        const int dst = INT8 ? ((tap * 4 + nv) * KC + k) * 16 : (tap * KC + k) * TN + nv * VEC;
        *reinterpret_cast<uint4*>(&wsm[dst]) = val;
      }
    } else {
      for (int i = threadIdx.x; i < 9 * KC * TN; i += THREADS) {
        const int n = i % TN, k = (i / TN) % KC, tap = i / (KC * TN);
        const int ci = ci0 + k, co = co0 + n;
        const int dst = INT8 ? ((tap * 4 + n / 16) * KC + k) * 16 + n % 16 : i;
        wsm[dst] = (ci < Cin && co < Cout) ? w[((size_t)tap * Cin + ci) * Cout + co]
                                           : AT{};
      }
    }
    __syncthreads();

    // ---- 9 taps x 4 column fragments of tensor-core products -------------
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int tap = dy * 3 + dx;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, AT, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &patch[((wy + dy) * PW + wx + dx) * PS], PS);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, AT, wmma::row_major> fb;
          if constexpr (INT8) {
            wmma::load_matrix_sync(fb, &wsm[(tap * 4 + j) * KC * 16], 16);
          } else {
            wmma::load_matrix_sync(fb, &wsm[tap * KC * TN + j * 16], TN);
          }
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  // ---- epilogue: accumulators -> stats and range slots, bias, bf16 store --
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&out[m0 * TN + j * 16], acc[j], TN, wmma::mem_row_major);
  __syncthreads();

  // pre-bias fp32 output of tile element i (channel co)
  auto zval = [&](int i, int co) -> float {
    if constexpr (INT8) {
      return __fmul_rn(__int2float_rn(out[i]), a.sasw[co]);
    } else {
      return out[i];
    }
  };
  // the stored value: bf16 of z + bias, or of bf16(z) + bf16(bias)
  auto yval = [&](float z, float b) -> __nv_bfloat16 {
    if (a.bias_in_dtype)
      return __float2bfloat16(__bfloat162float(__float2bfloat16(z)) +
                              __bfloat162float(__float2bfloat16(b)));
    return __float2bfloat16(__fadd_rn(z, b));
  };

  if ((a.partial != nullptr || a.prange != nullptr) && threadIdx.x < TN) {
    const int n = threadIdx.x, co = co0 + n;
    if (co < Cout) {
      const float b = a.bias != nullptr ? a.bias[co] : 0.0f;
      float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
      for (int m = 0; m < TM; ++m) {
        const int oy = ty0 + m / TW, ox = tx0 + m % TW;
        if (oy < H && ox < W) {
          const float z = zval(m * TN + n, co);
          s1 += z;
          s2 += z * z;
          const float r = a.range_mode == 2 ? __bfloat162float(yval(z, b)) : z;
          hi = fmaxf(hi, r);
          lo = fminf(lo, r);
        }
      }
      const size_t slot = ((size_t)bi * a.n_tiles + tile) * 2 * Cout + co;
      if (a.partial != nullptr) {
        a.partial[slot] = s1;
        a.partial[slot + Cout] = s2;
      }
      if (a.prange != nullptr) {
        a.prange[slot] = hi;
        a.prange[slot + Cout] = lo;
      }
    }
  }

  for (int i = threadIdx.x; i < TM * TN; i += THREADS) {
    const int m = i / TN, n = i % TN;
    const int oy = ty0 + m / TW, ox = tx0 + m % TW, co = co0 + n;
    if (oy < H && ox < W && co < Cout) {
      const float b = a.bias != nullptr ? a.bias[co] : 0.0f;
      a.y[((size_t)(bi * H + oy) * W + ox) * Cout + co] = yval(zval(i, co), b);
    }
  }
}

template <bool INT8>
int launch(Args a, int nb, int tile_w, void* stream) {
  a.TW = tile_w;
  a.TH = TM / tile_w;
  a.tiles_x = (a.W + a.TW - 1) / a.TW;
  const int tiles_y = (a.H + a.TH - 1) / a.TH;
  a.n_tiles = a.tiles_x * tiles_y;
  const dim3 grid(a.n_tiles, (a.Cout + TN - 1) / TN, nb);
  conv3x3_kernel<INT8><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* x, const void* w, const void* bias, const void* pro, void* y,
               void* partial, void* prange, int H, int W, int Cin, int Cout, int chunks,
               int range_mode) {
  Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.bias = static_cast<const float*>(bias);
  a.pro = static_cast<const float*>(pro);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.prange = static_cast<float*>(prange);
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.chunks = chunks;
  a.range_mode = range_mode;
  return a;
}

}  // namespace

extern "C" {

// x (nb, H, W, Cin) bf16; w (3, 3, Cin, Cout) bf16; bias (Cout) fp32 or null;
// pro (nb, 2, Cin) fp32 or null; y (nb, H, W, Cout) bf16; partial and prange
// (nb, n_tiles, 2, Cout) fp32 or null. tile_w is 16, 32 or 64 and
// tile_h = 64 / tile_w. range_mode 1: [max, min] of the pre-bias fp32 z;
// 2: of the bf16 output. Returns cudaGetLastError() after the launch.
int kdt_conv3x3(const void* x, const void* w, const void* bias, const void* pro, void* y,
                void* partial, void* prange, int nb, int H, int W, int Cin, int Cout,
                int chunks, int tile_w, int range_mode, int bias_in_dtype, void* stream) {
  Args a = make_args(x, w, bias, pro, y, partial, prange, H, W, Cin, Cout, chunks, range_mode);
  a.bias_in_dtype = bias_in_dtype;
  return launch<false>(a, nb, tile_w, stream);
}

// The w8a8 mode: w (3, 3, Cin, Cout) int8 quantized per output channel;
// s_a one fp32 on the device; sasw (Cout) fp32 = s_a * s_w. Other arguments
// as kdt_conv3x3.
int kdt_conv3x3_int8(const void* x, const void* w, const void* s_a, const void* sasw,
                     const void* bias, const void* pro, void* y, void* partial, void* prange,
                     int nb, int H, int W, int Cin, int Cout, int chunks, int tile_w,
                     int range_mode, void* stream) {
  Args a = make_args(x, w, bias, pro, y, partial, prange, H, W, Cin, Cout, chunks, range_mode);
  a.s_a = static_cast<const float*>(s_a);
  a.sasw = static_cast<const float*>(sasw);
  return launch<true>(a, nb, tile_w, stream);
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
