// The wide 3x3 SAME convolutions over NHWC for Hopper (sm_90a): an implicit
// GEMM on `wgmma`, with `cp.async` staging overlapped with the math, in two
// modes of one kernel template. bf16 (Q = false) serves every bf16 call
// with Cin % 64 == 0 and Cout % 64 == 0 and the conv's own bias rounding
// (every conv of the flagship U-Nets but the init and final convs, which
// `conv3x3_narrow.cu` serves); int8 (Q = true) serves every w8a8 int8 call
// with Cin % 64 == 0 and Cout % 64 == 0 (all 106 int8 sites of the flagship
// stage 3). `conv3x3.cu` keeps what neither takes (ragged widths of other
// configurations). The routing is a pure function of (Cin, Cout, quant,
// bias_in_dtype) in `kernels/conv3x3.py`.
//
// Replaces: kidney_diffusion_tpu/kernels/conv3x3.py::_pallas_conv3x3 (body
// `_kernel`, stats finisher at :475-481), for these calls. Same function as
// `conv3x3.cu`'s bf16 mode: y = conv3x3(pro(x)) + bias with fp32
// accumulation, where the optional prologue is silu(x * a + c) per (batch,
// input channel), rounded to bf16, and the SAME zero padding is applied
// AFTER it; optional per-tile [sum z, sum z^2] of the pre-bias output z and
// [max, min] slots (of fp32 z, or of the bf16 output); with chunks > 0 the
// batch is a batch of row chunks of one image each, and a chunk's halo rows
// come from its neighbour chunk of the same image (zeros at the image's top
// and bottom; with chunks == 0 every batch item's top and bottom).
//
// What bounds it on this card: 2*9*Cin operations per output element on
// (Cin + Cout) * 2 bytes per pixel; at 128-2048 channels that is far above
// the ~295 FLOP/byte where the bf16 tensor cores, not HBM, are the limit:
// bound by operations. Inside the kernel the limit is nearer: every block
// reads its weight slices from L2 again, 128 operations per weight byte
// with 128-pixel tiles, and each (slice, tap) step pays a barrier, its
// loads and its A fragments besides four or eight products. The small deep
// maps (4x4 to 16x16 at 768-2048 channels) are bound by their weight
// bytes, and their few output tiles leave SMs idle.
//
// Design. A block owns BM = 128 or 256 output pixels of one batch item (a
// TH x TW tile chosen by the wrapper to cover the map with the fewest
// tiles) and BN = 128 (or 64, for maps with few tiles, to double the
// blocks) output channels. Two consumer warpgroups each run BM/128
// `wgmma.m64nBNk16` products per k step (fp32 accumulators in registers).
// K = 9 * Cin walks 64-channel input slices, and within a slice the 9 taps:
// - A (pixels x channels) comes from registers: the tile's halo'd patch
//   (TH+2) x (TW+2) x 64 sits in shared memory, 128 bytes a pixel with its
//   16-byte chunks XOR-swizzled by the pixel index, and a tap's A fragment
//   is `ldmatrix` with per-lane row addresses shifted by (dy, dx) — the
//   9 taps are shifts of one patch, which `wgmma`'s shared-memory
//   descriptors cannot express.
// - B (channels x Cout) is the tap's (64 x BN) weight slice, Cout
//   contiguous as stored ("MN-major"), taken by `wgmma` with its transpose
//   bit from 128B-swizzled shared memory; no weight re-layout per call.
// - A ring of weight slices is filled by 16-byte `cp.async` from all
//   threads, STAGES-1 (slice, tap) steps ahead of the math: 4 slots where
//   two blocks fit on an SM (128-pixel 8x16 and 16x8 tiles; that build
//   keeps to 128 registers), so one block's pipeline fill, prologue and
//   epilogue overlap the other's products; 6 where one does. Where a
//   128-pixel tile's patch keeps blocks one to an SM (4x32, 2x64), the
//   wrapper takes 256-pixel tiles instead: a weight slice then feeds twice
//   the products. The next slice's patch is fetched at a slice's first tap
//   into the second patch buffer, and its prologue (silu(x*a + c) in fp32
//   by the fast exponential and reciprocal, rounded to bf16, padding
//   pixels left at zero) runs in parts while the last taps' `wgmma`s are
//   in flight. A step's `wgmma`s are one commit group, waited for before
//   the next step's barrier.
// - Small deep maps, whose output tiles fill under half the SMs, split K:
//   each block takes a run of input slices and writes fp32 partial sums;
//   `conv3x3_finish` adds them in a fixed order and runs the epilogue.
// - Epilogue: per-channel [sum z, sum z^2] and [max, min] of the tile's
//   valid pixels by warp shuffles and then shared memory across the eight
//   warps in a fixed order, into the tile's own slot (the wrapper reduces
//   the slots in a fixed order: no atomics); then bias, bf16, and 16-byte
//   stores through shared memory. A tile never spans two batch items.
//
// The int8 mode replaces, besides, the XLA path `_int8_conv` +
// `xla_conv3x3(quant=True)` (kidney_diffusion_tpu/kernels/conv3x3.py:243,
// :299-373) that the JAX package runs for its w8a8 serving sites (PyTorch
// has no int8 convolution on CUDA). The prologue'd input, rounded to bf16,
// is quantized per tensor, q = clip(rint(v / s_a), -127, 127) with s_a read
// from device memory (no host sync); the weights come quantized per output
// channel; products sum exactly in int32; the epilogue dequantizes as
// float(acc) * (s_a * s_w[co]) and then adds the bias, each step rounded on
// its own, so the output is bit-equal to the plain version. It is bound by
// operations as the bf16 mode is (the int8 tensor rate is twice bf16's).
// What differs from bf16:
// - A slice is 128 input channels: a patch pixel keeps its 128 bytes, and a
//   k32 s8 A fragment has the byte layout of a k16 bf16 one, so `ldmatrix`
//   reads the same addresses; half the (slice, tap) steps of bf16.
// - 8-bit `wgmma` takes B only K-major: the weight slice is BN rows of 128
//   bytes, one per output channel, from weights the wrapper lays out
//   (3, 3, Cout, Cin) once per weight tensor; the descriptor's 8-row groups
//   are 1024 bytes apart (SBO), and a k32 step moves its start 32 bytes.
// - The patch cannot arrive by `cp.async`: it is quantized while staged,
//   through registers. Slice 0's in the pipeline fill; slice s+1's in eight
//   parts while slice s's taps are in flight, each part's loads issued a
//   step ahead and its prologue coefficients read from shared memory. The
//   prologue and the quotient take the fast exponential, reciprocal and
//   product by 1 / s_a where those provably round to the same bf16 and
//   integer as the plain version's accurate exponential and true
//   divisions, and the accurate ones (out of line) where they might not,
//   all 8 elements of a chunk side by side first.
// - The split over K carries int32 partial sums; the finishing kernel adds
//   them (exactly, in any order) and dequantizes as the main epilogue does.
// What holds it back: the staging. Every block quantizes its own halo'd
// patch of every slice, so an input element is converted once per output
// block of 128 channels, times the halo (12 times at Cout 1024 on 4 x 64
// tiles); at the deep skip concats that conversion, not the products, sets
// the pace (PERF.md).
// Left for later: TMA for the weights with a producer warp and `mbarrier`s
// (and cluster multicast, so neighbouring blocks share one read of a
// weight slice), and a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// input channels per slice: 128-byte patch pixels and weight rows, 64 in
// bf16 (Q = false), 128 in int8 (Q = true)
__host__ __device__ constexpr int kc_of(bool q) { return q ? 128 : 64; }
constexpr int KC = 64;           // the bf16 slice
constexpr int THREADS = 256;     // two warpgroups
// weight slices in the ring: 4 where two blocks share an SM, else 6
__host__ __device__ constexpr int stages_for(int min_blocks) { return min_blocks == 2 ? 4 : 6; }
// (TH+2)*(TW+2) of the widest tile: 2 x 64 for 128 pixels, 4 x 64 for 256
__host__ __device__ constexpr int max_patch(int bm) { return bm == 256 ? 396 : 264; }

struct Args {
  const __nv_bfloat16* x;  // (nb, H, W, Cin)
  const void* w;           // bf16 (3, 3, Cin, Cout); int8: (3, 3, Cout, Cin), K-major
  const float* bias;       // (Cout) or null
  const float* pro;        // (nb, 2, Cin) or null
  const float* s_a;        // int8: the activation scale, one scalar on the device
  const float* sasw;       // int8: (Cout) s_a * s_w
  __nv_bfloat16* y;        // (nb, H, W, Cout)
  float* partial;          // (nb, n_tiles, 2, Cout) [sum z, sum z^2] or null
  float* prange;           // (nb, n_tiles, 2, Cout) [max, min] or null
  void* ws;                // split over K: (ksplit, nb, H, W, Cout) partial sums, fp32 or int32
  int nb, H, W, Cin, Cout, chunks, TH, TW, tiles_x, n_tiles;
  int range_mode;          // 1: of fp32 z (bias added by the wrapper); 2: of the bf16 output
  int ksplit, kps, nsl;    // splits of K, slices per split, slices of Cin
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's completed generic-proxy writes to shared memory
// (cp.async) visible to the async proxy that `wgmma` reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory descriptor of a (16 x BN) B slice: 128B swizzle, N-major;
// 64-column atoms 8192 bytes apart (LBO), 8-row groups 1024 bytes apart (SBO)
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((KC * 128) >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// shared-memory descriptor of a (BN x 32-byte) int8 B slice: 128B swizzle,
// K-major (each output channel a 128-byte row of K); 8-row groups 1024
// bytes apart (SBO); LBO unused, since a k32 step stays inside one row
__device__ __forceinline__ uint64_t desc_b_kmajor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, fp32) += a (64 x 16 bf16, registers) . b (16 x 128 bf16, shared
// memory, N-major: the transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += a (64 x 16 bf16, registers) . b (16 x 64 bf16, shared
// memory, N-major: the transpose bit set)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, int32) += a (64 x 32 s8, registers) . b (32 x 128 s8, shared
// memory, K-major: 8-bit operands take no transpose bit)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, int32) += a (64 x 32 s8, registers) . b (32 x 64 s8, shared
// memory, K-major: 8-bit operands take no transpose bit)
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// silu in fp32 by the fast exponential and reciprocal (ex2.approx,
// rcp.approx: a few fp32 ulps, far below the bf16 rounding that follows)
__device__ __forceinline__ float silu(float f) { return __fdividef(f, 1.0f + __expf(-f)); }

// The int8 mode's prologue, silu(x * a + c) rounded to bf16, as the plain
// version computes it: x * a + c with each step rounded (its two tensor
// ops), silu by the accurate exponential and a true division. In int8 a
// one-ulp bf16 difference near a quantization boundary is a whole step, so
// the result must be that bf16. The fast exponential and reciprocal give
// it where they provably round alike: for |f| < 16 their quotient is
// within 16 fp32 ulps of the accurate one, so unless its bits lie within
// 64 ulps of a bf16 rounding midpoint both round to the same bf16.
// `silu_fast` returns that bf16 (as fp32) and true, or f and false, when
// the accurate path must decide.
__device__ __forceinline__ bool silu_fast(float f, float& y) {
  const float fast = __fdividef(f, 1.0f + __expf(-f));
  const uint32_t low = __float_as_uint(fast) & 0xFFFFu;
  const bool ok = fabsf(f) < 16.0f && (low > 0x8000u + 64u || low < 0x8000u - 64u);
  y = ok ? __bfloat162float(__float2bfloat16(fast)) : f;
  return ok;
}

// the accurate path, out of line (rare)
__device__ __noinline__ float silu_accurate(float f) {
  return __bfloat162float(__float2bfloat16(f / (1.0f + expf(-f))));
}

__device__ __noinline__ float div_rn(float v, float s) { return __fdiv_rn(v, s); }

// The quotient v / s for q = clip(round_half_even(v / s), -127, 127), from
// r = 1 / s: v * r is within 2^-23 relative of v / s, so within 2^-15
// where the rounding matters (|v / s| < 256; beyond, both clip). Unless it
// lies within 2^-13 of a half-integer it rounds as the true quotient does
// (true); else (rare; and NaN) the true division must decide (false).
__device__ __forceinline__ bool quotient_fast(float v, float r, float& t) {
  t = v * r;
  return fabsf(t - floorf(t) - 0.5f) > 0x1p-13f;
}

__device__ __forceinline__ int clip_round(float t) {
  return static_cast<int>(fminf(fmaxf(rintf(t), -127.0f), 127.0f));
}

// Whether the conv reads image row `r` (-1 and H: the halo rows), column
// `c` of batch item `bi` from the input, not as a padding zero: rows -1
// and H exist only inside a row-chunked image, from the neighbour chunk.
__device__ __forceinline__ bool is_input(const Args& a, int bi, int r, int c) {
  if (c < 0 || c >= a.W || r < -1 || r > a.H) return false;
  if (r == -1) return a.chunks > 0 && bi % a.chunks != 0;
  if (r == a.H) return a.chunks > 0 && bi % a.chunks != a.chunks - 1 && bi + 1 < a.nb;
  return true;
}

// The input pixel the conv reads at row `r`, column `c` of item `bi` (see
// `is_input`; the halo rows resolve to the neighbour chunk's edge rows).
__device__ __forceinline__ const __nv_bfloat16* src_pixel(const Args& a, int bi, int r, int c) {
  const int b = r < 0 ? bi - 1 : (r == a.H ? bi + 1 : bi);
  r = r < 0 ? a.H - 1 : (r == a.H ? 0 : r);
  return a.x + ((size_t)(b * a.H + r) * a.W + c) * a.Cin;
}

// byte offset of 16-byte chunk `c` of patch pixel `p` (chunks XOR-swizzled
// by the pixel, so 8 consecutive pixels of an ldmatrix hit 8 bank groups)
__device__ __forceinline__ uint32_t patch_off(int p, int c) {
  return p * 128 + ((c ^ (p & 7)) << 4);
}

template <bool Q, int BM, int BN, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) conv3x3_wgmma(const Args a) {
  using Acc = std::conditional_t<Q, int, float>;  // int32 sums in int8, fp32 in bf16
  using Acc2 = std::conditional_t<Q, int2, float2>;
  constexpr int CH = kc_of(Q);         // input channels per slice
  constexpr int W_TILE = 128 * BN;     // bytes of one (CH x BN) weight slice
  constexpr int MT = BM / 128;         // 64-row products per warpgroup and k step
  constexpr int NACC = BN / 2;         // accumulators per thread and product
  constexpr int STAGES = stages_for(MINB);
  constexpr int AHEAD = STAGES - 1;    // steps a weight slice is fetched ahead
  constexpr int FIRST_T = AHEAD;       // first tap at which the next slice's patch is in
  constexpr int NPORT = 9 - FIRST_T;   // taps that share the next slice's prologue
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned: the 128B swizzle is a function of the address bits
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* patch_mem = smem + STAGES * W_TILE;
  const uint32_t ring = smem_u32(smem);
  const uint32_t patch0 = smem_u32(patch_mem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp within it
  const int bi = blockIdx.z / a.ksplit, split = blockIdx.z % a.ksplit;
  const int co0 = blockIdx.y * BN, tile = blockIdx.x;
  const int TH = a.TH, TW = a.TW, PW = TW + 2;
  const int npatch = (TH + 2) * PW;
  const int patch_bytes = npatch * 128;  // one of the two patch buffers
  const int ty0 = (tile / a.tiles_x) * TH, tx0 = (tile % a.tiles_x) * TW;
  // this block's input slices: s0 .. s0 + nslices - 1 (all, without a split)
  const int s0 = split * a.kps, nslices = min(a.kps, a.nsl - s0);
  const int n_iter = nslices * 9;
  const float* pa = a.pro ? a.pro + (size_t)bi * 2 * a.Cin : nullptr;  // [a; c] rows

  // the (CH x BN) weight slice of step `it` (slice it / 9, tap it % 9) into
  // its ring slot, 128B-swizzled.
  // bf16: 64-column atoms of 64 rows x 128 bytes (Cout contiguous, as
  // stored). A thread copies the same 16-byte column wc of weight rows wr,
  // wr + WRP, ...; WRP is a multiple of 8, so the swizzle of its rows is
  // that of wr.
  // int8: BN rows of 128 bytes, one per output channel (K-major, laid out
  // so by the wrapper once per weight tensor). A thread copies 16-byte
  // chunk wc of rows wr, wr + WRP, ...; chunks past Cin (a last half
  // slice) are zero-filled.
  constexpr int WCH = Q ? 8 : BN / 8, WRP = THREADS / WCH;
  constexpr int WROWS = Q ? BN : KC;  // rows of a weight slice
  const int wr = tid / WCH, wc = tid % WCH;
  const uint32_t w_dst = Q ? wr * 128 + ((wc ^ (wr & 7)) << 4)
                           : (wc >> 3) * (KC * 128) + wr * 128 + (((wc & 7) ^ (wr & 7)) << 4);
  auto load_w = [&](int it) {
    const int s = it / 9, tap = it - s * 9;
    const uint32_t dst = ring + (it % STAGES) * W_TILE + w_dst;
    if constexpr (Q) {
      const int8_t* w8 = static_cast<const int8_t*>(a.w);
      const int ci = (s0 + s) * CH + wc * 16;
      const bool in = ci < a.Cin;
      const int8_t* src = w8 + ((size_t)tap * a.Cout + co0 + wr) * a.Cin + (in ? ci : 0);
#pragma unroll
      for (int j = 0; j < WROWS / WRP; ++j)
        cp_async16(dst + j * WRP * 128, src + (size_t)j * WRP * a.Cin, in);
    } else {
      const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(a.w);
      const __nv_bfloat16* src =
          wb + ((size_t)tap * a.Cin + (s0 + s) * KC + wr) * a.Cout + co0 + wc * 8;
#pragma unroll
      for (int j = 0; j < WROWS / WRP; ++j)
        cp_async16(dst + j * WRP * 128, src + (size_t)j * WRP * a.Cout, true);
    }
  };
  // bf16: the raw halo'd patch of slice `s` into patch buffer s & 1; zeros
  // where the conv reads padding. A thread copies chunk position tid & 7
  // of pixels 32 apart, walking their patch row and column.
  auto load_patch = [&](int s) {
    const uint32_t dst = patch0 + (s & 1) * patch_bytes;
    const int c = tid & 7, coff = (s0 + s) * KC + c * 8;
    int p = tid >> 3, pr = p / PW, pc = p - pr * PW;
    for (; p < npatch; p += THREADS / 8) {
      const int r = ty0 + pr - 1, col = tx0 + pc - 1;
      const bool in = is_input(a, bi, r, col);
      cp_async16(dst + patch_off(p, c), in ? src_pixel(a, bi, r, col) + coff : a.x, in);
      pc += THREADS / 8;
      while (pc >= PW) pc -= PW, ++pr;
    }
  };
  // bf16: the prologue on chunks [lo, hi) of slice s's patch, in place;
  // padding pixels stay zero (SAME padding comes after the prologue). lo is
  // a multiple of 8 and THREADS of 8, so a thread keeps one 16-byte chunk
  // position c (8 channels) and its 16 coefficients, and walks pixels 32
  // apart.
  auto prologue = [&](int s, int lo, int hi) {
    uint8_t* buf = patch_mem + (s & 1) * patch_bytes;
    const int c = tid & 7, ch = (s0 + s) * KC + c * 8;
    float av[8], cv[8];
    *reinterpret_cast<float4*>(av) = __ldg(reinterpret_cast<const float4*>(pa + ch));
    *reinterpret_cast<float4*>(av + 4) = __ldg(reinterpret_cast<const float4*>(pa + ch + 4));
    *reinterpret_cast<float4*>(cv) = __ldg(reinterpret_cast<const float4*>(pa + a.Cin + ch));
    *reinterpret_cast<float4*>(cv + 4) =
        __ldg(reinterpret_cast<const float4*>(pa + a.Cin + ch + 4));
    int p = (lo + tid) >> 3;
    int pr = p / PW, pc = p - pr * PW;  // patch row and column of pixel p
    for (int i = lo + tid; i < hi; i += THREADS, p += THREADS / 8) {
      if (i != lo + tid) {
        pc += THREADS / 8;
        while (pc >= PW) pc -= PW, ++pr;
      }
      if (!is_input(a, bi, ty0 + pr - 1, tx0 + pc - 1)) continue;
      uint4* ptr = reinterpret_cast<uint4*>(buf + patch_off(p, c));
      uint4 val = *ptr;
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v[e]);
        v[e] = __floats2bfloat162_rn(silu(fmaf(f.x, av[2 * e], cv[2 * e])),
                                     silu(fmaf(f.y, av[2 * e + 1], cv[2 * e + 1])));
      }
      *ptr = val;
    }
  };
  // int8: the patch of slice s staged from the input into patch buffer
  // s & 1: prologue (exact), bf16, quantize; padding pixels and channels
  // past Cin are zeros. A thread keeps one 8-channel position c = tid & 15
  // (half a 16-byte patch chunk) and takes pixels 16 apart.
  const float s_a = Q ? __ldg(a.s_a) : 1.0f, r_a = 1.0f / s_a;
  // 8 bf16 input channels (raw) of patch pixel p -> 8 int8 in the patch,
  // with the prologue coefficients av[e], cv[e] (fetched by `coef`). The 8
  // elements go through the fast paths side by side, without a branch;
  // only the elements whose rounding the fast paths cannot vouch for go
  // through the accurate ones after.
  auto q_store = [&](int s, int p, bool in, const uint4& raw, auto coef) {
    uint2 q = make_uint2(0, 0);
    if (in) {
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
      float t[8];
      uint32_t slow = 0;
      if (pa != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float f = __fadd_rn(__fmul_rn(__bfloat162float(v[e]), coef(e, 0)), coef(e, 1));
          slow |= silu_fast(f, t[e]) ? 0u : 1u << e;
        }
        if (slow) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (slow & (1u << e)) t[e] = silu_accurate(t[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) t[e] = __bfloat162float(v[e]);
      }
      float u[8];
      slow = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) slow |= quotient_fast(t[e], r_a, u[e]) ? 0u : 1u << e;
      if (slow) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (slow & (1u << e)) u[e] = div_rn(t[e], s_a);
      }
      uint32_t* qw = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qw[e >> 2] |= (static_cast<uint32_t>(clip_round(u[e])) & 0xFFu) << (8 * (e & 3));
    }
    *reinterpret_cast<uint2*>(patch_mem + (s & 1) * patch_bytes + (tid & 1) * 8 +
                              patch_off(p, (tid & 15) >> 1)) = q;
  };
  // whether patch pixel p feeds slice s's 8-channel position of this
  // thread, and its raw input
  auto q_fetch = [&](int s, int p, int hi, bool& in, uint4& raw) {
    const int pr = p / PW, pc = p - pr * PW, r = ty0 + pr - 1, col = tx0 + pc - 1;
    const int ch = (s0 + s) * CH + (tid & 15) * 8;
    in = p < hi && ch < a.Cin && is_input(a, bi, r, col);
    raw = in ? __ldg(reinterpret_cast<const uint4*>(src_pixel(a, bi, r, col) + ch))
             : make_uint4(0, 0, 0, 0);
  };
  // The pipeline fill: all of slice 0's patch, FU pixels a thread in flight
  // at once, coefficients from device memory.
  auto stage_fill = [&]() {
    constexpr int FU = 6;
    const int ch = s0 * CH + (tid & 15) * 8;
    float av[8], cv[8];
    if (pa != nullptr && ch < a.Cin) {
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        *reinterpret_cast<float4*>(av + e) = __ldg(reinterpret_cast<const float4*>(pa + ch + e));
        *reinterpret_cast<float4*>(cv + e) =
            __ldg(reinterpret_cast<const float4*>(pa + a.Cin + ch + e));
      }
    }
    auto coef = [&](int e, int which) { return which ? cv[e] : av[e]; };
    for (int p0 = tid >> 4; p0 < npatch; p0 += FU * 16) {
      uint4 raw[FU];
      bool in[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) q_fetch(0, p0 + u * 16, npatch, in[u], raw[u]);
#pragma unroll
      for (int u = 0; u < FU; ++u)
        if (p0 + u * 16 < npatch) q_store(0, p0 + u * 16, in[u], raw[u], coef);
    }
  };
  // In the loop, slice s+1's patch is staged in 8 parts, part k (pixels
  // [part(k-1), part(k))) at tap k of slice s, while the tap's products
  // are in flight; its loads are issued at the end of the step before, so
  // they arrive over the barrier, and its coefficients come from shared
  // memory (`qcoef`, [slice parity][a; c][CH], filled at tap 0).
  constexpr int LU = BM == 256 ? 4 : 3;  // 16 LU >= the largest part
  auto part = [&](int k) { return k * npatch / 8; };
  float* qcoef = reinterpret_cast<float*>(patch_mem + 2 * patch_bytes);
  uint4 lraw[LU];
  bool lin[LU];
  auto part_fetch = [&](int s, int k) {
#pragma unroll
    for (int u = 0; u < LU; ++u)
      q_fetch(s, part(k - 1) + (tid >> 4) + u * 16, part(k), lin[u], lraw[u]);
  };
  auto part_store = [&](int s, int k) {
    const float* cf = qcoef + (s & 1) * 2 * CH + (tid & 15) * 8;
    auto coef = [&](int e, int which) { return cf[which * CH + e]; };
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int p = part(k - 1) + (tid >> 4) + u * 16;
      if (p < part(k)) q_store(s, p, lin[u], lraw[u], coef);
    }
  };

  // pipeline fill: patch 0 and the weight slices of steps 0 .. AHEAD-1
  if constexpr (!Q) load_patch(0);
  for (int j = 0; j < AHEAD; ++j) {
    if (j < n_iter) load_w(j);
    cp_async_commit();  // group j (in bf16, group 0 also holds patch 0)
  }
  if constexpr (Q) {
    stage_fill();  // visible after the first step's barrier
  } else if (pa != nullptr) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();
    prologue(0, 0, npatch * 8);
  }
  Acc acc[MT][NACC];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[i][j] = 0;

  // Warpgroup wg owns tile pixels [64 MT wg, 64 MT (wg + 1)), its product i
  // the 64 from 64 (MT wg + i). This lane's A row of product i's ldmatrix
  // (pixel m of the tile) sits at patch pixel p_a[i] at tap (0, 0).
  int p_a[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = (MT * wg + i) * 64 + wq * 16 + (lane & 15);
    p_a[i] = (m / TW) * PW + (m % TW);
  }
  const int khalf = lane >> 4;  // the column half it addresses

  for (int it = 0; it < n_iter; ++it) {  // step it: slice it / 9, tap it % 9
    const int s = it / 9, tap = it - s * 9;
    cp_async_wait<AHEAD - 1>();  // this thread's copies of step it are in
    fence_proxy_async();
    __syncthreads();  // everyone's are in; every warpgroup is done with step it-1
    if (it + AHEAD < n_iter) load_w(it + AHEAD);  // into step it-1's slot
    if constexpr (!Q) {
      if (tap == 0 && s + 1 < nslices) load_patch(s + 1);  // its buffer held slice s-1
    }
    cp_async_commit();

    // A fragments of the tap: the patch read at a (dy, dx) shift, all of
    // them in registers before the products start (so ptxas keeps the four
    // `wgmma`s of the step in one pipelined group). A k32 s8 fragment has
    // the byte layout of a k16 bf16 one, so both read the same addresses.
    const int shift = (tap / 3) * PW + (tap % 3);
    const uint32_t pbuf = patch0 + (s & 1) * patch_bytes;
    uint32_t af[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(af[i][kk], pbuf + patch_off(p_a[i] + shift, kk * 2 + khalf));
    const uint32_t wslot = ring + (it % STAGES) * W_TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // one B slice feeds the warpgroup's MT products
        if constexpr (Q && BN == 128) {
          wgmma_m64n128k32_s8(acc[i], af[i][kk], desc_b_kmajor(wslot + kk * 32));
        } else if constexpr (Q) {
          wgmma_m64n64k32_s8(acc[i], af[i][kk], desc_b_kmajor(wslot + kk * 32));
        } else if constexpr (BN == 128) {
          wgmma_m64n128k16(acc[i], af[i][kk], desc_b(wslot + kk * 2048));
        } else {
          wgmma_m64n64k16(acc[i], af[i][kk], desc_b(wslot + kk * 2048));
        }
      }
    }
    wgmma_commit();
    // while the tensor cores work: the next slice's patch (int8: staged in
    // eight parts, its coefficients at tap 0; bf16: its prologue in NPORT
    // parts)
    if constexpr (Q) {
      if (s + 1 < nslices) {
        if (tap == 0 && pa != nullptr) {
          const int ci = (s0 + s + 1) * CH + (tid % CH), which = tid / CH;
          qcoef[((s + 1) & 1) * 2 * CH + tid] = ci < a.Cin ? __ldg(pa + which * a.Cin + ci) : 0.0f;
        }
        if (tap > 0) part_store(s + 1, tap);
      }
    } else if (pa != nullptr && s + 1 < nslices && tap >= FIRST_T) {
      const int q = tap - FIRST_T;  // whole pixels per part
      prologue(s + 1, q * npatch / NPORT * 8, (q + 1) * npatch / NPORT * 8);
    }
    __syncwarp();
    wgmma_wait<0>();  // the step's products are done: its A registers and slot are free
    if constexpr (Q) {  // the loads of the next step's part
      const int sn = (it + 1) / 9, tn = it + 1 - sn * 9;
      if (tn > 0 && sn + 1 < nslices) part_fetch(sn + 1, tn);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
  cp_async_wait<0>();
  __syncthreads();  // the ring and the patch buffers are free

  // ---- epilogue. Accumulator 4j + 2h + c of product i: row m0[i] + 8h,
  // column 8j + 2*t4 + c
  const int t4 = lane & 3;
  auto valid = [&](int m) { return ty0 + m / TW < a.H && tx0 + m % TW < a.W; };
  int m0[MT];
  bool ok0[MT], ok1[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m0[i] = (MT * wg + i) * 64 + wq * 16 + (lane >> 2);
    ok0[i] = valid(m0[i]);
    ok1[i] = valid(m0[i] + 8);
  }
  if (a.ksplit > 1) {  // a partial product: conv3x3_finish sums the splits
    Acc* ws = static_cast<Acc*>(a.ws) + (size_t)split * a.nb * a.H * a.W * a.Cout + co0;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m1 = m0[i] + 8;
      const size_t px0 = (size_t)(bi * a.H + ty0 + m0[i] / TW) * a.W + tx0 + m0[i] % TW;
      const size_t px1 = (size_t)(bi * a.H + ty0 + m1 / TW) * a.W + tx0 + m1 % TW;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = j * 8 + 2 * t4;
        if (ok0[i])
          *reinterpret_cast<Acc2*>(ws + px0 * a.Cout + n) = Acc2{acc[i][4 * j], acc[i][4 * j + 1]};
        if (ok1[i])
          *reinterpret_cast<Acc2*>(ws + px1 * a.Cout + n) =
              Acc2{acc[i][4 * j + 2], acc[i][4 * j + 3]};
      }
    }
    return;
  }
  // the pre-bias fp32 output of accumulator k of product i (column n): the
  // fp32 sum, or the int32 sum dequantized, each step rounded on its own
  float zq[Q ? MT : 1][Q ? NACC : 1];
  if constexpr (Q) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float sc = __ldg(a.sasw + co0 + j * 8 + 2 * t4 + c);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            zq[i][4 * j + 2 * h + c] = __fmul_rn(__int2float_rn(acc[i][4 * j + 2 * h + c]), sc);
      }
  }
  auto zval = [&](int i, int k, int n) -> float {
    if constexpr (Q) {
      return zq[i][k];
    } else {
      return acc[i][k];
    }
  };
  if (a.partial != nullptr || a.prange != nullptr) {
    float4* red = reinterpret_cast<float4*>(patch_mem);  // [8 warps][BN] {s1, s2, max, min}
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = j * 8 + 2 * t4 + c;
        const float bb = a.bias != nullptr ? a.bias[co0 + n] : 0.0f;
        float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(h ? ok1[i] : ok0[i])) continue;
            const float z = zval(i, 4 * j + 2 * h + c, n);
            s1 += z;
            s2 += z * z;
            const float r = a.range_mode == 2
                                ? __bfloat162float(__float2bfloat16(__fadd_rn(z, bb)))
                                : z;
            hi = fmaxf(hi, r);
            lo = fminf(lo, r);
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
          lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        }
        if (lane < 4) red[warp * BN + n] = make_float4(s1, s2, hi, lo);
      }
    }
    __syncthreads();
    for (int n = tid; n < BN; n += THREADS) {
      float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) {  // a fixed order
        const float4 r = red[w * BN + n];
        s1 += r.x;
        s2 += r.y;
        hi = fmaxf(hi, r.z);
        lo = fminf(lo, r.w);
      }
      const size_t slot = ((size_t)bi * a.n_tiles + tile) * 2 * a.Cout + co0 + n;
      if (a.partial != nullptr) {
        a.partial[slot] = s1;
        a.partial[slot + a.Cout] = s2;
      }
      if (a.prange != nullptr) {
        a.prange[slot] = hi;
        a.prange[slot + a.Cout] = lo;
      }
    }
  }

  // bias, bf16, staged in shared memory (rows padded by 16 bytes) for
  // 16-byte stores of whole pixel rows
  constexpr int OLD = BN + 8;
  constexpr int OCH = BN / 8;  // 16-byte chunks of an output pixel row
  __nv_bfloat16* ost = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = j * 8 + 2 * t4;
    const float b0 = a.bias != nullptr ? a.bias[co0 + n] : 0.0f;
    const float b1 = a.bias != nullptr ? a.bias[co0 + n + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(&ost[m0[i] * OLD + n]) = __floats2bfloat162_rn(
          __fadd_rn(zval(i, 4 * j, n), b0), __fadd_rn(zval(i, 4 * j + 1, n + 1), b1));
      *reinterpret_cast<__nv_bfloat162*>(&ost[(m0[i] + 8) * OLD + n]) = __floats2bfloat162_rn(
          __fadd_rn(zval(i, 4 * j + 2, n), b0), __fadd_rn(zval(i, 4 * j + 3, n + 1), b1));
    }
  }
  __syncthreads();
  // a thread stores chunk oc of pixels m, m + MRP, ... (tile row my, column mx)
  constexpr int MRP = THREADS / OCH;
  const int oc = tid % OCH;
  int m = tid / OCH, my = m / TW, mx = m - my * TW;
  __nv_bfloat16* yc = a.y + co0 + oc * 8;
#pragma unroll
  for (int j = 0; j < BM / MRP; ++j, m += MRP) {
    const int oy = ty0 + my, ox = tx0 + mx;
    if (oy < a.H && ox < a.W)
      *reinterpret_cast<uint4*>(yc + ((size_t)(bi * a.H + oy) * a.W + ox) * a.Cout) =
          *reinterpret_cast<const uint4*>(&ost[m * OLD + oc * 8]);
    mx += MRP;
    while (mx >= TW) mx -= TW, ++my;
  }
}

// After a split over K: the sum of the splits' partial products in a fixed
// order (int32 sums in int8: exact, then dequantized as the main kernel
// does), then the main kernel's epilogue (per-tile stats and range slots
// over the same tiles, bias, bf16). A block: one tile's pixels x 64
// channels; a thread one channel and every FIN_GROUPS-th pixel, its loads
// of several pixels and splits in flight at once.
constexpr int FIN_GROUPS = 16;

template <bool Q>
__global__ void __launch_bounds__(64 * FIN_GROUPS) conv3x3_finish(const Args a) {
  using Acc = std::conditional_t<Q, int, float>;
  __shared__ float4 red[FIN_GROUPS][64];
  const int tid = threadIdx.x, c = tid & 63, g = tid >> 6;
  const int bi = blockIdx.z, co = blockIdx.y * 64 + c, tile = blockIdx.x;
  const int ty0 = (tile / a.tiles_x) * a.TH, tx0 = (tile % a.tiles_x) * a.TW;
  const size_t plane = (size_t)a.nb * a.H * a.W * a.Cout;  // one split's partials
  const Acc* __restrict__ ws = static_cast<const Acc*>(a.ws);
  __nv_bfloat16* __restrict__ y = a.y;
  const float b = a.bias != nullptr ? a.bias[co] : 0.0f;
  const float scale = Q ? a.sasw[co] : 1.0f;
  float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll 4
  for (int m = g; m < a.TH * a.TW; m += FIN_GROUPS) {
    const int oy = ty0 + m / a.TW, ox = tx0 + m % a.TW;
    if (oy >= a.H || ox >= a.W) continue;
    const size_t idx = ((size_t)(bi * a.H + oy) * a.W + ox) * a.Cout + co;
    Acc sum = 0;
#pragma unroll 4
    for (int k = 0; k < a.ksplit; ++k) sum += ws[k * plane + idx];
    float z;
    if constexpr (Q) {
      z = __fmul_rn(__int2float_rn(sum), scale);
    } else {
      z = sum;
    }
    const __nv_bfloat16 yv = __float2bfloat16(__fadd_rn(z, b));
    y[idx] = yv;
    s1 += z;
    s2 += z * z;
    const float r = a.range_mode == 2 ? __bfloat162float(yv) : z;
    hi = fmaxf(hi, r);
    lo = fminf(lo, r);
  }
  if (a.partial == nullptr && a.prange == nullptr) return;
  red[g][c] = make_float4(s1, s2, hi, lo);
  __syncthreads();
  if (g != 0) return;
  for (int k = 1; k < FIN_GROUPS; ++k) {  // a fixed order
    const float4 r = red[k][c];
    s1 += r.x;
    s2 += r.y;
    hi = fmaxf(hi, r.z);
    lo = fminf(lo, r.w);
  }
  const size_t slot = ((size_t)bi * a.n_tiles + tile) * 2 * a.Cout + co;
  if (a.partial != nullptr) {
    a.partial[slot] = s1;
    a.partial[slot + a.Cout] = s2;
  }
  if (a.prange != nullptr) {
    a.prange[slot] = hi;
    a.prange[slot + a.Cout] = lo;
  }
}

// dynamic shared memory: alignment slack, the weight ring, two patch
// buffers (the epilogue reuses both: the output tile fits the ring, the
// eight warps' [BN] stats the patch buffers); the same in bf16 and int8
template <int BN, int MINB>
int smem_bytes(int npatch, bool q) {
  return 1024 + stages_for(MINB) * 128 * BN + 2 * npatch * 128 + (q ? 2 * 2 * 128 * 4 : 0);
}

// Two blocks share an SM where their shared memory fits (228 KB an SM, 1 KB
// of it reserved per block), so one block's patch prologue, pipeline fill
// and epilogue overlap the other's products; that build keeps to 128
// registers a thread.
template <int BN>
bool two_per_sm(int npatch, bool q) {
  return 2 * (smem_bytes<BN, 2>(npatch, q) + 1024) <= 228 * 1024;
}

template <bool Q, int BM, int BN, int MINB>
int launch_with(const Args& a, void* stream) {
  static bool allowed = false;  // above 48 KB only once the kernel allows it
  if (!allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_wgmma<Q, BM, BN, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<BN, MINB>(max_patch(BM), Q));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = true;
  }
  const int smem = smem_bytes<BN, MINB>((a.TH + 2) * (a.TW + 2), Q);
  const dim3 grid(a.n_tiles, a.Cout / BN, a.nb * a.ksplit);
  conv3x3_wgmma<Q, BM, BN, MINB><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.ksplit == 1) return static_cast<int>(err);
  conv3x3_finish<Q><<<dim3(a.n_tiles, a.Cout / 64, a.nb), 64 * FIN_GROUPS, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 256-pixel tiles (each weight slice read from L2 feeds twice the
// products) with 128 channels, one block an SM; 128-pixel tiles with 128
// or 64 channels, two blocks an SM where they fit
template <bool Q>
int launch(const Args& a, int bn, void* stream) {
  if (a.TH * a.TW == 256) return launch_with<Q, 256, 128, 1>(a, stream);
  const int npatch = (a.TH + 2) * (a.TW + 2);
  if (bn == 128)
    return two_per_sm<128>(npatch, Q) ? launch_with<Q, 128, 128, 2>(a, stream)
                                      : launch_with<Q, 128, 128, 1>(a, stream);
  return two_per_sm<64>(npatch, Q) ? launch_with<Q, 128, 64, 2>(a, stream)
                                   : launch_with<Q, 128, 64, 1>(a, stream);
}

// The arguments both modes share, checked; false for what the kernels do
// not take. A slice is kc input channels (64 in bf16, 128 in int8; an int8
// Cin that is an odd multiple of 64 ends in a zero-filled half slice).
bool make_args(Args& a, int kc, const void* x, const void* w, const void* bias, const void* pro,
               void* y, void* partial, void* prange, void* ws, int nb, int H, int W, int Cin,
               int Cout, int chunks, int tile_h, int tile_w, int bn, int ksplit,
               int range_mode) {
  const int nsl = (Cin + kc - 1) / kc, kps = ksplit > 0 ? (nsl + ksplit - 1) / ksplit : 0;
  if (Cin % 64 != 0 || Cin <= 0 || (bn != 64 && bn != 128) || Cout % bn != 0 ||
      (tile_h * tile_w != 128 && tile_h * tile_w != 256) || tile_w % 8 != 0 ||
      (tile_h + 2) * (tile_w + 2) > max_patch(tile_h * tile_w) ||
      (tile_h * tile_w == 256 && (bn != 128 || ksplit != 1)) ||
      ksplit < 1 || (ksplit - 1) * kps >= nsl || (ksplit > 1 && ws == nullptr) ||
      (long long)nb * ksplit > 65535)
    return false;
  a = Args{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = w;
  a.bias = static_cast<const float*>(bias);
  a.pro = static_cast<const float*>(pro);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.prange = static_cast<float*>(prange);
  a.ws = ws;
  a.nb = nb;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Cout = Cout;
  a.chunks = chunks;
  a.TH = tile_h;
  a.TW = tile_w;
  a.tiles_x = (W + tile_w - 1) / tile_w;
  a.n_tiles = a.tiles_x * ((H + tile_h - 1) / tile_h);
  a.range_mode = range_mode;
  a.ksplit = ksplit;
  a.kps = kps;
  a.nsl = nsl;
  return true;
}

}  // namespace

extern "C" {

// x (nb, H, W, Cin) bf16; w (3, 3, Cin, Cout) bf16; bias (Cout) fp32 or null;
// pro (nb, 2, Cin) fp32 or null; y (nb, H, W, Cout) bf16; partial and prange
// (nb, n_tiles, 2, Cout) fp32 or null, n_tiles = ceil(H / tile_h) *
// ceil(W / tile_w). Cin % 64 == 0, Cout % bn == 0, bn 64 or 128, tile_h *
// tile_w == 128, or 256 with bn 128 and ksplit 1, tile_w a multiple of 8,
// (tile_h + 2) * (tile_w + 2) <= 264 (128) or 396 (256); all pointers
// 16-byte aligned.
// range_mode 1: [max, min] of the pre-bias fp32 z; 2: of the bf16 output.
// ksplit > 1 splits the Cin / 64 input slices into ksplit runs of
// ceil(Cin / 64 / ksplit), none empty, whose partial products go to ws
// (ksplit, nb, H, W, Cout) fp32 and are summed by a second kernel.
// Returns cudaGetLastError() after the last launch (cudaErrorInvalidValue
// for arguments the kernels do not take).
int kdt_conv3x3_wide(const void* x, const void* w, const void* bias, const void* pro, void* y,
                     void* partial, void* prange, void* ws, int nb, int H, int W, int Cin,
                     int Cout, int chunks, int tile_h, int tile_w, int bn, int ksplit,
                     int range_mode, void* stream) {
  Args a;
  if (!make_args(a, kc_of(false), x, w, bias, pro, y, partial, prange, ws, nb, H, W, Cin, Cout,
                 chunks, tile_h, tile_w, bn, ksplit, range_mode))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false>(a, bn, stream);
}

// The w8a8 int8 mode: w_k (3, 3, Cout, Cin) int8, the per-output-channel
// quantized weights laid out K-major (Cin contiguous); s_a one fp32 on the
// device; sasw (Cout) fp32 = s_a * s_w. Slices are 128 input channels
// (ceil(Cin / 128) of them, split as above); ws (ksplit, nb, H, W, Cout)
// int32. Other arguments as kdt_conv3x3_wide.
int kdt_conv3x3_wide_int8(const void* x, const void* w_k, const void* s_a, const void* sasw,
                          const void* bias, const void* pro, void* y, void* partial,
                          void* prange, void* ws, int nb, int H, int W, int Cin, int Cout,
                          int chunks, int tile_h, int tile_w, int bn, int ksplit,
                          int range_mode, void* stream) {
  Args a;
  if (s_a == nullptr || sasw == nullptr ||
      !make_args(a, kc_of(true), x, w_k, bias, pro, y, partial, prange, ws, nb, H, W, Cin, Cout,
                 chunks, tile_h, tile_w, bn, ksplit, range_mode))
    return static_cast<int>(cudaErrorInvalidValue);
  a.s_a = static_cast<const float*>(s_a);
  a.sasw = static_cast<const float*>(sasw);
  return launch<true>(a, bn, stream);
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
