// Tap-product probe for Hopper (sm_90a): does the int8 tensor-core path pay
// at the conv kernel's tile shape?
//
// Replaces: tools/probe_int8_pallas.py::run (the pallas_call at :76, bodies
// `kernel_bf16` :36, `kernel_int8` :47, `kernel_int8_quantize` :58). Same
// functions: nine accumulated (M x K) . (K x N) products of one x with the
// nine taps of w, output bf16, in three forms:
//   0 bf16:  bf16 operands, fp32 sum, o = bf16(acc);
//   1 int8:  int8 operands, int32 sum, o = bf16(float(acc) * 1e-4);
//   2 quant: bf16 x quantized in shared memory, q = clip(rint(x / s), -127,
//            127), then as 1 with o = bf16(float(acc) * (s * 1e-2)).
// int32 sums are exact and every fp32 step is rounded on its own (no fused
// multiply-add), so forms 1 and 2 are bit-equal to their plain versions.
//
// What bounds it on this card: 2*M*K*N*9 = 2.4 GOP on 2.3-4.5 MB of
// operands, about 500-1000 operations per byte: bound by operations
// (989 TFLOP/s bf16, 1979 TOP/s int8 dense).
//
// Design: one block per 64 x 64 output tile (4 warps, 16 rows each). The
// block stages its 64 x K rows of x once (quantizing them in form 2), then
// for each tap stages that tap's K x 64 slice of w and runs K/16 WMMA
// 16x16x16 steps per warp and column fragment (bf16 -> fp32 or s8 -> s32).
// WMMA wants 32-byte aligned tile pointers, so int8 tiles sit in 16-wide
// column blocks ([k block][row][16] for x, [n block][k][16] for w). The
// accumulators go through shared memory (reusing the w buffer) to the bf16
// store. A probe of the WMMA path the conv kernel uses, not a fast GEMM:
// wgmma with TMA is the later work it helps to choose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, THREADS = 128, KMAX = 128;

template <int FORM>
__global__ void __launch_bounds__(THREADS) probe_kernel(
    const void* __restrict__ xv, const void* __restrict__ wv, const float* __restrict__ s,
    __nv_bfloat16* __restrict__ o, int M, int K, int N, int taps) {
  constexpr bool INT8 = FORM != 0;
  using AT = std::conditional_t<INT8, signed char, __nv_bfloat16>;
  using CT = std::conditional_t<INT8, int, float>;
  // x tile, then the w tile, which the epilogue reuses for the accumulators
  constexpr int XBYTES = BM * KMAX * sizeof(AT);
  constexpr int WBYTES = KMAX * BN * sizeof(AT) > BM * BN * 4 ? KMAX * BN * sizeof(AT) : BM * BN * 4;
  __shared__ __align__(128) unsigned char smem[XBYTES + WBYTES];
  AT* xs = reinterpret_cast<AT*>(smem);
  AT* ws = reinterpret_cast<AT*>(smem + XBYTES);
  CT* out = reinterpret_cast<CT*>(smem + XBYTES);

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const float scale = FORM == 2 ? *s : 1.0f;

  // ---- x rows of this tile: bf16 [m][K]; int8 [k/16][m][16] ----
  for (int i = threadIdx.x; i < BM * K / 8; i += THREADS) {
    const int m = i / (K / 8), k = (i % (K / 8)) * 8;
    if constexpr (FORM == 0) {
      *reinterpret_cast<uint4*>(&xs[m * K + k]) =
          *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(xv) +
                                          (size_t)(m0 + m) * K + k);
    } else if constexpr (FORM == 1) {
      *reinterpret_cast<uint2*>(&xs[((k / 16) * BM + m) * 16 + k % 16]) =
          *reinterpret_cast<const uint2*>(static_cast<const signed char*>(xv) +
                                          (size_t)(m0 + m) * K + k);
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(xv) + (size_t)(m0 + m) * K + k);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint2 q;
      signed char* qb = reinterpret_cast<signed char*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = rintf(__fdiv_rn(__bfloat162float(v[e]), scale));
        qb[e] = static_cast<signed char>(static_cast<int>(fminf(fmaxf(f, -127.0f), 127.0f)));
      }
      *reinterpret_cast<uint2*>(&xs[((k / 16) * BM + m) * 16 + k % 16]) = q;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, CT> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], static_cast<CT>(0));

  for (int t = 0; t < taps; ++t) {
    // ---- this tap's K x 64 slice of w: bf16 [k][64]; int8 [n/16][k][16] ----
    const AT* wt = static_cast<const AT*>(wv) + (size_t)t * K * N;
    constexpr int VEC = 16 / sizeof(AT);
    for (int i = threadIdx.x; i < K * BN / VEC; i += THREADS) {
      const int k = i / (BN / VEC), n = (i % (BN / VEC)) * VEC;
      const uint4 val = *reinterpret_cast<const uint4*>(wt + (size_t)k * N + n0 + n);
      const int dst = INT8 ? ((n / 16) * K + k) * 16 : k * BN + n;
      *reinterpret_cast<uint4*>(&ws[dst]) = val;
    }
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, AT, wmma::row_major> fa;
      if constexpr (INT8) {
        wmma::load_matrix_sync(fa, &xs[((k0 / 16) * BM + warp * 16) * 16], 16);
      } else {
        wmma::load_matrix_sync(fa, &xs[warp * 16 * K + k0], K);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, AT, wmma::row_major> fb;
        if constexpr (INT8) {
          wmma::load_matrix_sync(fb, &ws[(j * K + k0) * 16], 16);
        } else {
          wmma::load_matrix_sync(fb, &ws[k0 * BN + j * 16], BN);
        }
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&out[warp * 16 * BN + j * 16], acc[j], BN, wmma::mem_row_major);
  __syncthreads();
  const float deq = FORM == 1 ? 1e-4f : __fmul_rn(scale, 1e-2f);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int m = i / BN, n = i % BN;
    float v;
    if constexpr (INT8) {
      v = __fmul_rn(__int2float_rn(out[i]), deq);
    } else {
      v = out[i];
    }
    o[(size_t)(m0 + m) * N + n0 + n] = __float2bfloat16(v);
  }
}

}  // namespace

extern "C" {

// form 0: x (M, K) bf16, w (taps, K, N) bf16; form 1: both int8; form 2: x
// bf16, w int8, s one fp32 on the device. o (M, N) bf16. M and N multiples
// of 64, K a multiple of 16 up to 128. Returns cudaGetLastError().
int kdt_probe_int8(int form, const void* x, const void* w, const void* s, void* o, int M,
                   int K, int N, int taps, void* stream) {
  if (M % BM || N % BN || K % 16 || K > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(M / BM, N / BN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
  if (form == 0) {
    probe_kernel<0><<<grid, THREADS, 0, st>>>(x, w, sf, ob, M, K, N, taps);
  } else if (form == 1) {
    probe_kernel<1><<<grid, THREADS, 0, st>>>(x, w, sf, ob, M, K, N, taps);
  } else {
    probe_kernel<2><<<grid, THREADS, 0, st>>>(x, w, sf, ob, M, K, N, taps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
