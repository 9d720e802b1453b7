// The narrow ends of the U-Nets' 3x3 SAME convolutions over NHWC bf16 for
// Hopper (sm_90a): the init conv (Cin <= 16: 3 or 6 on the flagship, 9 at
// the conditioned stages of every ultra_res level above 0, 10 and 12 on
// patch_conditioned and v2) and the final conv (Cout <= 8: 3), each with
// its own kernel. `kernels/conv3x3.py` routes them here ("narrow"), by a
// pure function of (Cin, Cout, quant, bias_in_dtype).
//
// Replaces: kidney_diffusion_tpu/kernels/conv3x3.py::_pallas_conv3x3 (:394,
// body `_kernel`, stats finisher at :475-481), for these calls. Same
// function as `conv3x3_sm90.cu` and `conv3x3.cu` in bf16: y = conv3x3(pro(x))
// + bias with fp32 accumulation, the optional prologue silu(x * a + c) per
// (batch, input channel) rounded to bf16 with the SAME zero padding after
// it, per-tile [sum z, sum z^2] and [max, min] slots (range_mode 1: of fp32
// z; 2: of the bf16 output), row chunks whose halo rows come from the
// neighbour chunk, and `bias_in_dtype`: y = bf16(bf16(z) + bf16(bias)), the
// two roundings of `flax.linen.Conv(dtype=bf16)` at the unchunked init conv.
//
// What bounds them on this card: bytes. The final conv does 2*9*Cin*3
// operations per pixel on 2*Cin input bytes (27 per byte); the init conv
// 2*9*Cin*Cout on 2*Cout output bytes (81 at Cin 9). Both are far below
// the ~295 FLOP/byte where the bf16 tensor cores would be the limit: the
// final conv must read its input once, the init conv write its output once
// (at stage 3's Cin-9 call 268 MB out, 19 MB in). A general implicit GEMM
// wastes both: padded to 64 output channels the final conv computes 21x
// the products it needs and re-reads rows; padded to 16 input channels per
// tap the init conv does nine passes of K.
//
// Design.
// - Final conv (`narrow_out`, Cout <= 8, Cin % 64 == 0, Cin <= 256): a
//   persistent grid, one block an SM, walks (tile, 64-channel slice) jobs;
//   a tile is 4 x 64 pixels and all Cout channels (padded to 8, one n8 of
//   `mma.sync.m16n8k16`). The tile's halo'd patch (6 x 66 pixels x 128
//   bytes, 16-byte chunks XOR-swizzled) arrives by `cp.async` in a ring of
//   three buffers, two jobs ahead, so each input byte comes from HBM about
//   once (the halo rows mostly from L2) while the previous job computes.
//   The 9 taps' weights of every slice sit in shared memory in fragment
//   order (at most 36 KB), loaded once per block. Each warp owns a
//   16-column strip and half of a slice's K: it reads every patch row once
//   per (dx, k16) with `ldmatrix` and adds it into the accumulators of the
//   up to three output rows that row feeds (dy = 0, 1, 2), so the patch is
//   read 3 times, not 9. The two K halves meet in shared memory; the
//   epilogue stages the tile's outputs (6 bytes a pixel at Cout 3) and
//   stores whole pixel rows with 16-byte stores.
// - Init conv (`narrow_in<Cin>`, Cin <= 16, Cout % 64 == 0, Cout <= 512),
//   one instantiation per Cin, so the patch and offset arithmetic is by
//   constants. K is the 9 taps x Cin folded into one dimension (27-144
//   values, padded to KS = ceil(9 Cin / 16) k16 steps: 6 at Cin 9 and 10, 7
//   at 12, 9 at 16): one K pass, not nine padded taps. A persistent grid
//   walks tiles of 128 pixels (Cout <= 128), 64 (Cout <= 256) or 32 (more):
//   the warps split into pixel groups of 16 and, above Cout 128, channel
//   groups, so a tile's whole output (all Cout) is at most 32 KB.
//   - Input: the tile's halo'd patch, Cin channels a pixel (18-32 bytes, not
//     16-byte aligned), loaded element by element (2-byte loads) into
//     registers one tile ahead, then into shared memory with the prologue.
//     Each warp gathers its 16 pixels' A fragments from it once a tile
//     through a per-lane table of packed 16-bit byte offsets (one 32-bit
//     add gives two), held in shared memory so they cost no registers
//     (124 at Cin 9, 128 at 12, no spills).
//   - Weights: the folded B (K x Cout), zero past K, in shared memory in
//     `mma.sync` fragment order, two n8 blocks to a 16-byte load, loaded
//     once per block (24 KB at Cin 9 and Cout 128, 147 KB at Cin 16 and
//     Cout 512).
//   - Output, where the time goes: each 64-channel pass of a warp turns its
//     accumulators into bf16 pairs, and two 4 x 4 transposes within each
//     lane quad (odd pixels swapping halves first) turn them into 16-byte
//     rows written to the staged tile without bank conflicts. The staged
//     tile is NHWC exactly, so each tile row (TW pixels x Cout) is one
//     contiguous run, and one thread writes it with the asynchronous bulk
//     copy (`cp.async.bulk.global.shared::cta`, one bulk group a tile). Two
//     staging buffers let a tile's store drain while the next tile
//     computes; the bulk group is waited for (`.read`) only before its
//     buffer is written again. The range of the bf16 output (request C's
//     and the level's stage-3 call) is read off the staged tile before the
//     next one overwrites it.
//   - Occupancy: two blocks an SM (128 registers a thread) with two staging
//     buffers where the shared memory allows (every Cout <= 192, and every
//     served call but one); else two with one (Cin 8-14 at Cout 256: v2's
//     stage 1 at Cin 9), else one block with two (Cin 15-16 at Cout 256,
//     Cin >= 8 at Cout 512); `kdt_conv3x3_narrow_in_plan` reports it.
// Stats and range slots go to one slot per tile, reduced across warps in
// a fixed order (no atomics; the wrapper reduces the slots in a fixed
// order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int SMS = 132;      // streaming multiprocessors of an H100 SXM

struct Args {
  const __nv_bfloat16* x;  // (nb, H, W, Cin)
  const __nv_bfloat16* w;  // (3, 3, Cin, Cout)
  const float* bias;       // (Cout) or null
  const float* pro;        // (nb, 2, Cin) or null
  __nv_bfloat16* y;        // (nb, H, W, Cout)
  float* partial;          // (nb, n_tiles, 2, Cout) [sum z, sum z^2] or null
  float* prange;           // (nb, n_tiles, 2, Cout) [max, min] or null
  int nb, H, W, Cin, Cout, chunks, TH, TW, tiles_x, n_tiles;
  int range_mode;          // 1: of fp32 z (bias added by the wrapper); 2: of the bf16 output
  int bias_in_dtype;
  int nbuf;                // the init conv's staging buffers (set at its launch)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 as one 32-bit fragment register: lo in the low half
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The prologue as the plain version computes it: x * a + c with each step
// rounded, silu by the accurate exponential and a true division, bf16.
__device__ __forceinline__ __nv_bfloat16 prologue(float x, float a, float c) {
  const float f = __fadd_rn(__fmul_rn(x, a), c);
  return __float2bfloat16(f / (1.0f + expf(-f)));
}

// the stored value: bf16 of z + bias, or of bf16(z) + bf16(bias)
__device__ __forceinline__ __nv_bfloat16 yval(const Args& a, float z, float b) {
  if (a.bias_in_dtype)
    return __float2bfloat16(__bfloat162float(__float2bfloat16(z)) +
                            __bfloat162float(__float2bfloat16(b)));
  return __float2bfloat16(__fadd_rn(z, b));
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
__device__ __forceinline__ const __nv_bfloat16* src_pixel(const Args& a, int bi, int r, int c,
                                                          int cin) {
  const int b = r < 0 ? bi - 1 : (r == a.H ? bi + 1 : bi);
  r = r < 0 ? a.H - 1 : (r == a.H ? 0 : r);
  return a.x + ((size_t)(b * a.H + r) * a.W + c) * cin;
}

// byte offset of 16-byte chunk `c` of patch pixel `p` (chunks XOR-swizzled
// by the pixel, so 8 consecutive pixels of an ldmatrix hit 8 bank groups)
__device__ __forceinline__ uint32_t patch_off(int p, int c) {
  return p * 128 + ((c ^ (p & 7)) << 4);
}

// ---------------------------------------------------------------------------
// final conv: Cout <= 8
constexpr int OUT_TH = 4, OUT_TW = 64;       // the tile: 4 rows x 64 columns
constexpr int OUT_PW = OUT_TW + 2;           // patch columns
constexpr int OUT_NPATCH = (OUT_TH + 2) * OUT_PW;
constexpr int OUT_PBYTES = OUT_NPATCH * 128;  // one 64-channel patch buffer
constexpr int OUT_NBUF = 3;                   // patch ring: two jobs in flight
constexpr int OUT_MAX_CIN = 256;

// shared memory: the patch ring, the weights in fragment order, the K
// halves' exchange, the stats exchange and the output tile
__host__ __device__ constexpr int out_smem_bytes(int cin) {
  return OUT_NBUF * OUT_PBYTES + 9 * cin * 16 + 4 * OUT_TH * 32 * 16 + 4 * 8 * 16 +
         OUT_TH * OUT_TW * 8 * 2;
}

__global__ void __launch_bounds__(THREADS, 1) conv3x3_narrow_out(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* patches = smem;
  uint2* bfrag = reinterpret_cast<uint2*>(smem + OUT_NBUF * OUT_PBYTES);  // [tap][k16][lane]
  float4* kred = reinterpret_cast<float4*>(smem + OUT_NBUF * OUT_PBYTES + 9 * a.Cin * 16);
  float4* sred = kred + 4 * OUT_TH * 32;                                  // [strip][n]
  __nv_bfloat16* ost = reinterpret_cast<__nv_bfloat16*>(sred + 4 * 8);   // [row][col][Cout]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = warp & 3, kh = warp >> 2;  // 16-column strip, half of a slice's K
  const int g = lane >> 2, t4 = lane & 3;
  const int nsl = a.Cin / 64, nk16 = a.Cin / 16;
  const int total = a.nb * a.n_tiles;
  const int my_tiles = blockIdx.x < total ? (total - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int n_jobs = my_tiles * nsl;

  // the weights of every (tap, k16) as this lane's B fragment: k rows 2t,
  // 2t+1 (b0) and 2t+8, 2t+9 (b1) of input channel block k16, column g
  for (int i = tid; i < 9 * nk16 * 32; i += THREADS) {
    const int l = i & 31, tk = i >> 5, tap = tk / nk16, k16 = tk - tap * nk16;
    const int n = l >> 2, k0 = k16 * 16 + 2 * (l & 3);
    __nv_bfloat16 v[4] = {};
    if (n < a.Cout) {
      const __nv_bfloat16* wp = a.w + ((size_t)tap * a.Cin + k0) * a.Cout + n;
      v[0] = wp[0];
      v[1] = wp[a.Cout];
      v[2] = wp[8 * a.Cout];
      v[3] = wp[9 * a.Cout];
    }
    bfrag[i] = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }

  auto tile_of = [&](int j) { return blockIdx.x + (j / nsl) * gridDim.x; };
  // job j (tile, slice j % nsl): its raw halo'd patch into buffer j % 3;
  // zeros where the conv reads padding
  auto load = [&](int j) {
    const int tg = tile_of(j), s = j % nsl;
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * OUT_TH, tx0 = (tt % a.tiles_x) * OUT_TW;
    const uint32_t dst = smem_u32(patches + (j % OUT_NBUF) * OUT_PBYTES);
    const int c = tid & 7, coff = s * 64 + c * 8;
    int p = tid >> 3, pr = p / OUT_PW, pc = p - pr * OUT_PW;
    for (; p < OUT_NPATCH; p += THREADS / 8) {
      const int r = ty0 + pr - 1, col = tx0 + pc - 1;
      const bool in = is_input(a, bi, r, col);
      cp_async16(dst + patch_off(p, c), in ? src_pixel(a, bi, r, col, a.Cin) + coff : a.x, in);
      pc += THREADS / 8;
      while (pc >= OUT_PW) pc -= OUT_PW, ++pr;
    }
  };

  if (n_jobs > 0) load(0);
  cp_async_commit();
  if (n_jobs > 1) load(1);
  cp_async_commit();

  float acc[OUT_TH][4];
#pragma unroll
  for (int r = 0; r < OUT_TH; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;

  for (int j = 0; j < n_jobs; ++j) {
    const int tg = tile_of(j), s = j % nsl;
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * OUT_TH, tx0 = (tt % a.tiles_x) * OUT_TW;
    uint8_t* buf = patches + (j % OUT_NBUF) * OUT_PBYTES;
    cp_async_wait<1>();  // this thread's copies of job j are in
    __syncthreads();     // everyone's; every warp is done with job j - 1
    if (a.pro != nullptr) {  // in place, all threads; padding pixels stay zero
      const float* pa = a.pro + (size_t)bi * 2 * a.Cin + s * 64;
      for (int i = tid; i < OUT_NPATCH * 8; i += THREADS) {
        const int p = i >> 3, c = i & 7, pr = p / OUT_PW, pc = p - pr * OUT_PW;
        if (!is_input(a, bi, ty0 + pr - 1, tx0 + pc - 1)) continue;
        uint4* ptr = reinterpret_cast<uint4*>(buf + patch_off(p, c));
        uint4 val = *ptr;
        __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = prologue(__bfloat162float(v[e]), pa[c * 8 + e], pa[a.Cin + c * 8 + e]);
        *ptr = val;
      }
      __syncthreads();
    }
    if (j + 2 < n_jobs) load(j + 2);  // into job j - 1's buffer
    cp_async_commit();

    // this warp's B fragments of the slice: 9 taps x its two k16 steps
    uint32_t bw[9][2][2];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint2 v = bfrag[(tap * nk16 + s * 4 + kh * 2 + kk) * 32 + lane];
        bw[tap][kk][0] = v.x;
        bw[tap][kk][1] = v.y;
      }
    // patch row pr feeds output rows pr - dy, dy = 0, 1, 2
    const uint32_t pbase = smem_u32(buf);
    const int col = strip * 16 + (lane & 15), khalf = lane >> 4;
#pragma unroll
    for (int pr = 0; pr < OUT_TH + 2; ++pr) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t af[4];
          ldmatrix_x4(af, pbase + patch_off(pr * OUT_PW + col + dx, (kh * 2 + kk) * 2 + khalf));
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int orow = pr - dy;
            if (orow < 0 || orow >= OUT_TH) continue;
            mma_bf16(acc[orow], af, bw[dy * 3 + dx][kk][0], bw[dy * 3 + dx][kk][1]);
          }
        }
      }
    }
    if (s != nsl - 1) continue;

    // ---- the tile is done: the two K halves meet, then the epilogue ----
    if (kh == 1) {
#pragma unroll
      for (int r = 0; r < OUT_TH; ++r)
        kred[(strip * OUT_TH + r) * 32 + lane] = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                                             acc[r][3]);
    }
    __syncthreads();
    const bool stats = a.partial != nullptr || a.prange != nullptr;
    if (kh == 0) {
#pragma unroll
      for (int r = 0; r < OUT_TH; ++r) {
        const float4 o = kred[(strip * OUT_TH + r) * 32 + lane];
        acc[r][0] += o.x;
        acc[r][1] += o.y;
        acc[r][2] += o.z;
        acc[r][3] += o.w;
      }
      // accumulator 2h + c of row r: pixel (r, strip * 16 + g + 8h), channel 2 t4 + c
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * t4 + c;
        const bool n_ok = n < a.Cout;
        const float b = (n_ok && a.bias != nullptr) ? a.bias[n] : 0.0f;
        float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
        for (int r = 0; r < OUT_TH; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cx = strip * 16 + g + 8 * h;
            const float z = acc[r][2 * h + c];
            const __nv_bfloat16 yv = yval(a, z, b);
            if (n_ok) ost[(r * OUT_TW + cx) * a.Cout + n] = yv;
            if (!stats || ty0 + r >= a.H || tx0 + cx >= a.W) continue;
            s1 += z;
            s2 += z * z;
            const float rv = a.range_mode == 2 ? __bfloat162float(yv) : z;
            hi = fmaxf(hi, rv);
            lo = fminf(lo, rv);
          }
        }
        if (stats) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
            hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
            lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
          }
          if (lane < 4) sred[strip * 8 + n] = make_float4(s1, s2, hi, lo);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < OUT_TH; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.0f;
    __syncthreads();
    if (stats && tid < a.Cout) {
      float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
      for (int w = 0; w < 4; ++w) {  // a fixed order
        const float4 r = sred[w * 8 + tid];
        s1 += r.x;
        s2 += r.y;
        hi = fmaxf(hi, r.z);
        lo = fminf(lo, r.w);
      }
      const size_t slot = ((size_t)bi * a.n_tiles + tt) * 2 * a.Cout + tid;
      if (a.partial != nullptr) {
        a.partial[slot] = s1;
        a.partial[slot + a.Cout] = s2;
      }
      if (a.prange != nullptr) {
        a.prange[slot] = hi;
        a.prange[slot + a.Cout] = lo;
      }
    }
    // whole pixel rows of the tile: 16-byte stores where the row is aligned
    const int ncols = min(OUT_TW, a.W - tx0), row_elems = ncols * a.Cout;
    for (int r = 0; r < OUT_TH && ty0 + r < a.H; ++r) {
      __nv_bfloat16* dst = a.y + ((size_t)(bi * a.H + ty0 + r) * a.W + tx0) * a.Cout;
      const __nv_bfloat16* src = ost + r * OUT_TW * a.Cout;
      if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (row_elems & 7) == 0) {
        for (int i = tid; i < row_elems / 8; i += THREADS)
          reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
      } else {
        for (int i = tid; i < row_elems; i += THREADS) dst[i] = src[i];
      }
    }
    // ost, kred and sred are next written after the next job's barrier
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// init conv: Cin <= 16, K = 9 * Cin folded into KS k16 steps
constexpr int IN_MAX_CIN = 16;
constexpr int IN_MAX_COUT = 512;
constexpr int IN_MAX_PATCH = 264;  // (TH+2)*(TW+2) of the widest tile, 2 x 64
// the patch (Cin channels a pixel), then, once its A fragments are in
// registers, the epilogue's exchange: 8 warps x 64 channels of float4
// (stats), or [slot][Cout] bf16 [max] and [min] (the output's range)
constexpr int IN_SCRATCH = IN_MAX_PATCH * IN_MAX_CIN * 2;
constexpr int SM_SMEM = 233472;     // shared memory of an SM (228 KB)
constexpr int BLOCK_RESERVED = 1024;  // the part of it the system keeps a block

__host__ __device__ constexpr int in_ks(int cin) { return (9 * cin + 15) / 16; }
// channel groups a tile's Cout is split into across warps: a tile holds
// 128 / cg pixels, so its staged output is at most 32 KB
__host__ __device__ constexpr int in_cg(int cout) { return cout <= 128 ? 1 : (cout <= 256 ? 2 : 4); }
__host__ __device__ constexpr int in_stage_bytes(int cout) { return 128 / in_cg(cout) * cout * 2; }

// shared memory: the staged output tiles (nbuf of them), the folded weights
// in fragment order, the scratch, the bias and the A offsets per lane
__host__ __device__ constexpr int in_smem_bytes(int ks, int cout, int nbuf) {
  return nbuf * in_stage_bytes(cout) + ks * cout * 32 + IN_SCRATCH + cout * 4 + 4 * ks * 8;
}

// (staging buffers, blocks an SM) of an init-conv launch: two blocks an SM
// with two staging buffers where they fit, else two with one, else one
// block with two
__host__ __device__ constexpr int in_nbuf(int ks, int cout) {
  return 2 * (in_smem_bytes(ks, cout, 2) + BLOCK_RESERVED) <= SM_SMEM   ? 2
         : 2 * (in_smem_bytes(ks, cout, 1) + BLOCK_RESERVED) <= SM_SMEM ? 1
                                                                         : 2;
}
__host__ __device__ constexpr int in_blocks_per_sm(int ks, int cout) {
  return 2 * (in_smem_bytes(ks, cout, in_nbuf(ks, cout)) + BLOCK_RESERVED) <= SM_SMEM ? 2 : 1;
}

__device__ __forceinline__ void bulk_store(void* gdst, uint32_t ssrc, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(gdst), "r"(ssrc), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N bulk groups of this thread still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's generic-proxy writes to shared memory, ordered before the
// async proxy's (bulk copy) reads of it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The four lanes of a quad hold words w0..w3 each; afterwards lane t4 holds
// word t4 of lanes 0, 1, 2, 3 (a 4 x 4 transpose by two exchanges)
__device__ __forceinline__ void quad_transpose(uint32_t& w0, uint32_t& w1, uint32_t& w2,
                                               uint32_t& w3, int t4) {
  const bool o1 = t4 & 1, o2 = t4 & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, o1 ? w0 : w1, 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, o1 ? w2 : w3, 1);
  if (o1) {
    w0 = r0;
    w2 = r1;
  } else {
    w1 = r0;
    w3 = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, o2 ? w0 : w2, 2);
  r1 = __shfl_xor_sync(0xffffffffu, o2 ? w1 : w3, 2);
  if (o2) {
    w0 = r0;
    w1 = r1;
  } else {
    w2 = r0;
    w3 = r1;
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

template <int CIN>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_narrow_in(const Args a) {
  constexpr int KS = in_ks(CIN), K = 9 * CIN;
  // patch elements a thread loads for the next tile (two to a register)
  constexpr int NEL = (IN_MAX_PATCH * CIN + THREADS - 1) / THREADS;
  extern __shared__ __align__(128) uint8_t smem[];
  const int Cout = a.Cout, CG = in_cg(Cout), PG = 8 / CG, BM = 16 * PG;
  const int npass = Cout / 64, npw = (npass + CG - 1) / CG, n16 = Cout / 16;
  const int stage_bytes = BM * Cout * 2;
  uint8_t* stg = smem;  // [buffer][pixel][Cout] bf16, the tile's rows as NHWC lays them out
  const uint4* bfrag = reinterpret_cast<const uint4*>(smem + a.nbuf * stage_bytes);
  uint8_t* scratch = smem + a.nbuf * stage_bytes + KS * Cout * 32;
  __nv_bfloat16* patch = reinterpret_cast<__nv_bfloat16*>(scratch);
  float4* sred = reinterpret_cast<float4*>(scratch);  // [warp][64]
  float* bias_s = reinterpret_cast<float*>(scratch + IN_SCRATCH);
  uint2* koff_s = reinterpret_cast<uint2*>(bias_s + Cout);  // [t4][ks]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int pg = warp / CG, cg = warp - pg * CG;  // this warp's 16 pixels, its channel group
  const int TH = a.TH, TW = a.TW, PW = TW + 2, RUN = PW * CIN;
  const int n_el = (TH + 2) * RUN, total = a.nb * a.n_tiles;
  const uint32_t pw_magic = 0xffffffffu / PW + 1;  // p / PW == umulhi(p, pw_magic) here
  const int tws = __ffs(TW) - 1;                     // TW is a power of two

  // the folded weights B (K x Cout) = w reshaped, k = tap * Cin + ci, as
  // this lane's B fragments of (k16, n8 blocks 2q and 2q+1): rows 2t, 2t+1
  // and 2t+8, 2t+9, column g; zeros past K
  {
    uint4* bf = reinterpret_cast<uint4*>(smem + a.nbuf * stage_bytes);
    for (int i = tid; i < KS * n16 * 32; i += THREADS) {
      const int l = i & 31, kq = i >> 5, ks = kq / n16, q = kq - ks * n16;
      const int k0 = ks * 16 + 2 * (l & 3);
      uint32_t u[4];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int n = (2 * q + hb) * 8 + (l >> 2);
        __nv_bfloat16 v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + (e & 1) + (e >> 1) * 8;
          v[e] = k < K ? a.w[(size_t)k * Cout + n] : __float2bfloat16(0.0f);
        }
        u[2 * hb] = pack2(v[0], v[1]);
        u[2 * hb + 1] = pack2(v[2], v[3]);
      }
      bf[i] = make_uint4(u[0], u[1], u[2], u[3]);
    }
  }
  for (int i = tid; i < Cout; i += THREADS) bias_s[i] = a.bias != nullptr ? a.bias[i] : 0.0f;
  // where lane t4's A fragment elements sit in the patch, in bytes from its
  // pixel: k = ks * 16 + 2 t4 + {0, 1} (x) and + {8, 9} (y), two 16-bit
  // offsets a word; past K, offset 0 (a real element, times a zero weight)
  for (int i = tid; i < 4 * KS; i += THREADS) {
    const int t = i / KS, ks = i - t * KS;
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = ks * 16 + 2 * t + (e & 1) + (e >> 1) * 8;
      const int tap = k / CIN, ci = k - tap * CIN;
      o[e] = k < K ? 2 * ((tap / 3) * RUN + (tap % 3) * CIN + ci) : 0;
    }
    koff_s[i] = make_uint2(o[0] | (o[1] << 16), o[2] | (o[3] << 16));
  }

  // this warp's pixels m = 16 pg + g (+ 8); their byte offsets in the patch, twice
  const int m_lo = pg * 16 + g, m_hi = m_lo + 8;
  const uint32_t pb_lo = 0x10001u * (2 * CIN * ((m_lo / TW) * PW + m_lo % TW));
  const uint32_t pb_hi = 0x10001u * (2 * CIN * ((m_hi / TW) * PW + m_hi % TW));
  // range mode 2 without stats reads [max, min] off the staged bf16 output;
  // stats (and range mode 1) come from the fp32 accumulators
  const bool stats = a.partial != nullptr || (a.prange != nullptr && a.range_mode != 2);
  const bool out_range = a.partial == nullptr && a.prange != nullptr && a.range_mode == 2;

  // the next tile's patch elements, loaded into registers while this tile
  // computes: a thread holds elements tid, tid + THREADS, ... (raw bf16)
  uint32_t nxt[(NEL + 1) / 2];
  auto fetch = [&](int tg) {
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * TH, tx0 = (tt % a.tiles_x) * TW;
#pragma unroll
    for (int e = 0; e < NEL; ++e) {
      const int i = tid + e * THREADS, p = i / CIN, ci = i - p * CIN;
      const int pr = __umulhi(p, pw_magic), r = ty0 + pr - 1, col = tx0 + p - pr * PW - 1;
      uint32_t v = 0;
      if (i < n_el && is_input(a, bi, r, col))
        v = __ldg(reinterpret_cast<const unsigned short*>(src_pixel(a, bi, r, col, CIN) + ci));
      if (e & 1)
        nxt[e >> 1] |= v << 16;
      else
        nxt[e >> 1] = v;
    }
  };
  if (blockIdx.x < total) fetch(blockIdx.x);

  int it = 0;
  for (int tg = blockIdx.x; tg < total; tg += gridDim.x, ++it) {
    const int bi = tg / a.n_tiles, tt = tg - bi * a.n_tiles;
    const int ty0 = (tt / a.tiles_x) * TH, tx0 = (tt % a.tiles_x) * TW;
    uint8_t* sbuf = stg + (a.nbuf == 2 ? (it & 1) : 0) * stage_bytes;
    if (tid == 0) {  // the staging buffer's last bulk store has read it
      if (a.nbuf == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    __syncthreads();  // also: the previous tile's fragments and exchange are read
    // the halo'd patch, Cin channels a pixel: prologue, padding zeros after it
    const float* pa = a.pro ? a.pro + (size_t)bi * 2 * CIN : nullptr;
#pragma unroll
    for (int e = 0; e < NEL; ++e) {
      const int i = tid + e * THREADS;
      if (i >= n_el) break;
      __nv_bfloat16 v = __ushort_as_bfloat16(static_cast<unsigned short>(nxt[e >> 1] >> (16 * (e & 1))));
      if (pa != nullptr) {
        const int p = i / CIN, ci = i - p * CIN;
        const int pr = __umulhi(p, pw_magic);
        if (is_input(a, bi, ty0 + pr - 1, tx0 + p - pr * PW - 1))
          v = prologue(__bfloat162float(v), pa[ci], pa[CIN + ci]);
      }
      patch[i] = v;
    }
    __syncthreads();
    if (tg + gridDim.x < total) fetch(tg + gridDim.x);

    // the A fragments of this warp's 16 pixels, all KS k16 steps
    uint32_t af[KS][4];
    {
      const uint8_t* pbytes = scratch;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint2 ko = koff_s[t4 * KS + ks];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {  // a0: row g, k 2t; a1: row g+8; a2, a3: k + 8
          const uint32_t o = ((rr & 1) ? pb_hi : pb_lo) + ((rr >> 1) ? ko.y : ko.x);
          const uint32_t lo = *reinterpret_cast<const unsigned short*>(pbytes + (o & 0xffffu));
          const uint32_t hi = *reinterpret_cast<const unsigned short*>(pbytes + (o >> 16));
          af[ks][rr] = lo | (hi << 16);
        }
      }
    }
    if (stats) __syncthreads();  // the exchange overwrites the patch
    const bool ok_lo = ty0 + m_lo / TW < a.H && tx0 + m_lo % TW < a.W;
    const bool ok_hi = ty0 + m_hi / TW < a.H && tx0 + m_hi % TW < a.W;

    // passes of 64 output channels: warp (pg, cg) takes passes cg, cg + CG, ...
    for (int pi = 0; pi < npw; ++pi) {
      const int pass = pi * CG + cg, cb = pass * 64;
      if (pass < npass) {  // warp-uniform
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint4 b = bfrag[(ks * n16 + cb / 16 + q) * 32 + lane];
            mma_bf16(acc[2 * q], af[ks], b.x, b.y);
            mma_bf16(acc[2 * q + 1], af[ks], b.z, b.w);
          }
        // accumulator 2h + c of n8 block nt: pixel m_lo (h 0) or m_hi,
        // column cb + nt * 8 + 2 t4 + c; bf16 pairs of columns
        uint32_t P[2][8];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int nl = nt * 8 + 2 * t4;
          const float2 bb = *reinterpret_cast<const float2*>(&bias_s[cb + nl]);
          const __nv_bfloat16 y00 = yval(a, acc[nt][0], bb.x), y01 = yval(a, acc[nt][1], bb.y);
          const __nv_bfloat16 y10 = yval(a, acc[nt][2], bb.x), y11 = yval(a, acc[nt][3], bb.y);
          P[0][nt] = pack2(y00, y01);
          P[1][nt] = pack2(y10, y11);
          if (!stats) continue;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!(h ? ok_hi : ok_lo)) continue;
              const float z = acc[nt][2 * h + c];
              s1 += z;
              s2 += z * z;
              const __nv_bfloat16 yv = h ? (c ? y11 : y10) : (c ? y01 : y00);
              const float rv = a.range_mode == 2 ? __bfloat162float(yv) : z;
              hi = fmaxf(hi, rv);
              lo = fminf(lo, rv);
            }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              s1 += __shfl_xor_sync(0xffffffffu, s1, off);
              s2 += __shfl_xor_sync(0xffffffffu, s2, off);
              hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
              lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            }
            if (lane < 4) sred[warp * 64 + nl + c] = make_float4(s1, s2, hi, lo);
          }
        }
        // into the staged tile as 16-byte rows of 8 channels: odd g swaps
        // its two halves of 32 channels, then a transpose in each quad
        // gives lane t4 block t4 of a half, so the 8 lanes of a quarter
        // warp (g, g + 1) write one pixel's first 64 bytes and the next
        // one's last 64: all 32 banks, no conflict
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) w[j] = (g & 1) ? P[h][j ^ 4] : P[h][j];
          quad_transpose(w[0], w[1], w[2], w[3], t4);
          quad_transpose(w[4], w[5], w[6], w[7], t4);
          uint8_t* row = sbuf + ((h ? m_hi : m_lo) * Cout + cb) * 2;
          const int b0 = ((g & 1) ? 4 : 0) + t4;
          *reinterpret_cast<uint4*>(row + b0 * 16) = make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(row + (b0 ^ 4) * 16) = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      if (stats) {
        __syncthreads();
        if (tid < 64 * CG) {
          const int gc = tid >> 6, ch = tid & 63, p = pi * CG + gc;
          if (p < npass) {
            float s1 = 0.0f, s2 = 0.0f, hi = -INFINITY, lo = INFINITY;
            for (int w = 0; w < PG; ++w) {  // a fixed order
              const float4 r = sred[(w * CG + gc) * 64 + ch];
              s1 += r.x;
              s2 += r.y;
              hi = fmaxf(hi, r.z);
              lo = fminf(lo, r.w);
            }
            const size_t slot = ((size_t)bi * a.n_tiles + tt) * 2 * Cout + p * 64 + ch;
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
        __syncthreads();  // sred is free for the next pass
      }
    }
    fence_proxy_async();
    __syncthreads();  // the tile is staged
    if (tid == 0) {  // each valid row of the tile: one contiguous run in NHWC
      const int ncols = min(TW, a.W - tx0);
      for (int r = 0; r < TH && ty0 + r < a.H; ++r)
        bulk_store(a.y + ((size_t)(bi * a.H + ty0 + r) * a.W + tx0) * Cout,
                   smem_u32(sbuf + r * TW * Cout * 2), ncols * Cout * 2);
      bulk_commit();
    }
    if (out_range) {
      // [max, min] of the staged bf16 output over the tile's valid pixels:
      // a thread takes 8 channels (chunk c) of pixels s, s + slots, ...;
      // the slots meet in the scratch ([slot][Cout] bf16, max then min),
      // reduced over slots in a fixed order
      const int nc = Cout / 8, slots = THREADS / nc, c = tid % nc, s = tid / nc;
      __nv_bfloat162 hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = __floats2bfloat162_rn(-INFINITY, -INFINITY);
        lo[e] = __floats2bfloat162_rn(INFINITY, INFINITY);
      }
      if (s < slots) {
        for (int m = s; m < BM; m += slots) {
          if (ty0 + (m >> tws) >= a.H || tx0 + (m & (TW - 1)) >= a.W) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(sbuf + (m * Cout + c * 8) * 2);
          const uint32_t vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = __hmax2(hi[e], as_bf2(vv[e]));
            lo[e] = __hmin2(lo[e], as_bf2(vv[e]));
          }
        }
        uint4* xh = reinterpret_cast<uint4*>(scratch + (s * Cout + c * 8) * 2);
        uint4* xl = reinterpret_cast<uint4*>(scratch + ((slots + s) * Cout + c * 8) * 2);
        *xh = make_uint4(as_u32(hi[0]), as_u32(hi[1]), as_u32(hi[2]), as_u32(hi[3]));
        *xl = make_uint4(as_u32(lo[0]), as_u32(lo[1]), as_u32(lo[2]), as_u32(lo[3]));
      }
      __syncthreads();
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(scratch);
      for (int ch = tid; ch < Cout; ch += THREADS) {
        float h = -INFINITY, l = INFINITY;
        for (int q = 0; q < slots; ++q) {  // a fixed order
          h = fmaxf(h, __bfloat162float(xb[q * Cout + ch]));
          l = fminf(l, __bfloat162float(xb[(slots + q) * Cout + ch]));
        }
        const size_t slot = ((size_t)bi * a.n_tiles + tt) * 2 * Cout + ch;
        a.prange[slot] = h;
        a.prange[slot + Cout] = l;
      }
      // the scratch is next written after the next tile's first barrier
    }
  }
  if (tid == 0) bulk_wait_all();  // shared memory stays until the stores have read it
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes, int& allowed) {
  if (allowed >= bytes) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return static_cast<int>(err);
}

template <int CIN>
int launch_in(Args a, cudaStream_t stream) {
  static int allowed = 0;  // above 48 KB only once the kernel allows it
  constexpr int ks = in_ks(CIN);
  if (allowed == 0) {  // all of the SM's unified memory as shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        conv3x3_narrow_in<CIN>, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.nbuf = in_nbuf(ks, a.Cout);
  const int bytes = in_smem_bytes(ks, a.Cout, a.nbuf);
  const int err = set_smem(conv3x3_narrow_in<CIN>, bytes, allowed);
  if (err != 0) return err;
  const int blocks = min(a.nb * a.n_tiles, in_blocks_per_sm(ks, a.Cout) * SMS);
  conv3x3_narrow_in<CIN><<<blocks, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (nb, H, W, Cin) bf16; w (3, 3, Cin, Cout) bf16; bias (Cout) fp32 or null;
// pro (nb, 2, Cin) fp32 or null; y (nb, H, W, Cout) bf16; partial and prange
// (nb, n_tiles, 2, Cout) fp32 or null; all pointers 16-byte aligned.
// Either Cout <= 8 with Cin % 64 == 0 and Cin <= 256 (the final conv: tiles
// of 4 x 64 pixels, tile_h and tile_w must say so), or Cin <= 8 with
// Cout % 64 == 0 and Cout <= 512 (the init conv: tiles of tile_h x tile_w
// == 128 pixels, (tile_h + 2) * (tile_w + 2) <= 264). n_tiles =
// ceil(H / tile_h) * ceil(W / tile_w). range_mode 1: [max, min] of the
// pre-bias fp32 z; 2: of the bf16 output. bias_in_dtype: y = bf16(bf16(z)
// + bf16(bias)). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments the kernels do not take).
int kdt_conv3x3_narrow(const void* x, const void* w, const void* bias, const void* pro, void* y,
                       void* partial, void* prange, int nb, int H, int W, int Cin, int Cout,
                       int chunks, int tile_h, int tile_w, int range_mode, int bias_in_dtype,
                       void* stream) {
  const bool out = Cout >= 1 && Cout <= 8 && Cin % 64 == 0 && Cin >= 64 && Cin <= OUT_MAX_CIN &&
                   tile_h == OUT_TH && tile_w == OUT_TW;
  const bool in = Cin >= 1 && Cin <= IN_MAX_CIN && Cout % 64 == 0 && Cout >= 64 &&
                  Cout <= IN_MAX_COUT && tile_h >= 1 && tile_w >= 1 &&
                  tile_h * tile_w == 128 / in_cg(Cout) && (tile_w & (tile_w - 1)) == 0 &&
                  (tile_h + 2) * (tile_w + 2) <= IN_MAX_PATCH;
  if (!(out || in) || nb < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.pro = static_cast<const float*>(pro);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.partial = static_cast<float*>(partial);
  a.prange = static_cast<float*>(prange);
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
  a.bias_in_dtype = bias_in_dtype;
  const int total = nb * a.n_tiles;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out) {
    static int allowed = 0;
    const int bytes = out_smem_bytes(Cin);
    const int err = set_smem(conv3x3_narrow_out, bytes, allowed);
    if (err != 0) return err;
    conv3x3_narrow_out<<<min(total, SMS), THREADS, bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  switch (Cin) {  // Cin a compile-time constant: the patch and offset arithmetic folds
    case 1: return launch_in<1>(a, st);
    case 2: return launch_in<2>(a, st);
    case 3: return launch_in<3>(a, st);
    case 4: return launch_in<4>(a, st);
    case 5: return launch_in<5>(a, st);
    case 6: return launch_in<6>(a, st);
    case 7: return launch_in<7>(a, st);
    case 8: return launch_in<8>(a, st);
    case 9: return launch_in<9>(a, st);
    case 10: return launch_in<10>(a, st);
    case 11: return launch_in<11>(a, st);
    case 12: return launch_in<12>(a, st);
    case 13: return launch_in<13>(a, st);
    case 14: return launch_in<14>(a, st);
    case 15: return launch_in<15>(a, st);
    default: return launch_in<16>(a, st);
  }
}

// The init conv's launch at (Cin, Cout): plan[0] = dynamic shared memory
// bytes, plan[1] = staging buffers, plan[2] = blocks an SM, plan[3] =
// pixels a tile. Returns cudaErrorInvalidValue for widths it does not take.
int kdt_conv3x3_narrow_in_plan(int Cin, int Cout, int* plan) {
  if (Cin < 1 || Cin > IN_MAX_CIN || Cout % 64 != 0 || Cout < 64 || Cout > IN_MAX_COUT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ks = in_ks(Cin), nbuf = in_nbuf(ks, Cout);
  plan[0] = in_smem_bytes(ks, Cout, nbuf);
  plan[1] = nbuf;
  plan[2] = in_blocks_per_sm(ks, Cout);
  plan[3] = 128 / in_cg(Cout);
  return 0;
}

const char* kdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
