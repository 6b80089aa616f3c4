// The int8 grouped expert FFN for Hopper (sm_90a): the port of the XLA
// _expert_ffn_blocked of deepsearch_tts_tpu/ops/moe.py:56 (no Pallas kernel
// there: lax.ragged_dot has no int8 path, so JAX scatters the expert-sorted
// rows into [n_exp, cap] blocks and runs batched int8 dot_generals).
// Over expert-sorted rows (rows offsets[e] .. offsets[e+1]-1 of X belong to
// expert e), with int8 weights and one float32 scale a weight column:
//   SWIGLU = true   h = bf16(silu(g) * u), g = (X @ Wg[e]) * sg[e],
//                   u = (X @ Wu[e]) * su[e]   (g and u stay float32)
//   SWIGLU = false  y = bf16((X @ W[e]) * s[e])
// JAX's capacity rule: row r of expert e is computed only while
// r - offsets[e] < cap; the rows past it are written as 0 (JAX drops them:
// their output is 0). cap is the caller's, from static sizes. The products
// multiply bf16 activations by the int8 weights widened to bf16 (exact:
// |q| <= 127) with float32 sums, as JAX does; the activations are never
// quantized (that would change the numbers).
//
// Two forms, which the wrappers (ops/moe.py) choose from static sizes alone
// (grouped_prefill: 16 rows an expert on average or more takes the second):
//
// grouped_expert_i8, decode. What bounds it: the touched experts' int8
// weights (qwen3-30b-a3b, 16 tokens x top-8: ~74 experts, 233 MB for
// gate|up and 116 MB for down a layer against one or two rows an expert, B
// FLOP a weight byte), so the goal is streaming each touched expert's
// weights once at HBM rate. The design: the decode grouped expert kernel's
// shape (fused_layer.cu grouped_expert) over int8 tiles. One block of 4
// warps per (row split, column tile, expert): the row split varies
// fastest, so the blocks that share an expert's weight tile run together
// and read it from L2 after the first. A 4-stage cp.async ring brings
// 64-row x 128-byte weight tiles (8 KB, rows padded to 144 bytes so
// ldmatrix is free of bank conflicts) and the matching 64-row bf16
// activation tiles. ldmatrix.trans reads the int8 tile as 16-bit pairs and
// widen4 turns each register into two bf16 B fragments, exactly (as
// i8_stream does: n8 block 2G + e of a warp holds its columns 16G + 2i + e);
// mma.sync m16n8k16 bf16 -> float32; the column scale multiplies the float32
// sum in the epilogue. A block walks its expert's 64-row tiles
// (gridDim.x of them at once); m-tiles past the computed rows are neither
// loaded nor multiplied; a block whose expert has no rows returns at once,
// so the group offsets stay on the device. SWIGLU blocks hold 64 gate and
// the same 64 up columns (warps 0-1 gate, 2-3 up) and meet in shared memory.
// At prefill sizes it would walk an expert's ~190 rows one 64-row tile at
// a time, every weight tile through the ring once per row tile, on
// mma.sync at 17 % of the bf16 tensor peak (0.92 / 0.43 ms at 3072 tokens,
// PERF.md): so the wrappers take the prefill form there.
//
// grouped_expert_i8_tc, prefill (3072 tokens x top-8: ~190 rows an expert,
// cap 384). What bounds it: the bytes (0.40 GB of int8 weights of every
// touched expert and 0.14 GB of rows a gate|up call: 0.16 ms at 3.35 TB/s)
// and the tensor operations (155 GFLOP: 0.16 ms at 989 TFLOP/s) are even,
// so each weight tile must be read once for all of an expert's rows while
// the tensor cores keep up. The design is the bf16 prefill kernel's
// (fused_layer.cu grouped_expert_tc): a persistent grid (one block an SM)
// over a work list of (expert, n-tile, m-tile) items built on the device
// from `offsets` and cap (ceil(min(rows_e, cap) / 256) m-tiles an expert,
// no host sync), 256-row x 128-column tiles (an expert of up to 256 rows
// reads each weight tile once), a TMA producer and two consumer warpgroups
// on wgmma m64n128k16 over a 4-stage mbarrier ring, the epilogue staged
// through shared memory and stored as whole 16-byte rows. What is new is
// the widening. The int8 weight boxes land unswizzled (64 k rows x 64
// bytes, two a stage: half a bf16 stage's bytes); three warps of the
// producer warpgroup widen each landed stage into a bf16 MN-major tile in
// the 128-byte-swizzle layout TMA would have written (byte permutes into
// the low mantissa of 2^23 and one float subtract a value: exact, no
// conversion unit), fence it for the async proxy and signal a second ring
// of two tiles; the consumers keep wgmma_ss_n128_tb as the bf16 kernel
// runs it. Why this route: the bf16 kernel is this kernel without the
// widening, and on the same routing it took 0.3670 / 0.2055 ms against
// this kernel's 0.4014 / 0.2241 (3072 tokens, H100 at 700 W, PERF.md), so
// the widening costs ~9 % and no other route can gain more than that. The
// other route, the product swapped so that the widened weight is wgmma's
// register A operand (ldmatrix.trans + widen4 give its fragment), makes
// the token rows wgmma's N: N is then fixed at compile time whatever an
// expert's row count, the SwiGLU pair lands in rows of different threads
// and the epilogue must transpose. The column scale multiplies the
// float32 sums in the epilogue; g and u stay float32. Capacity: the items
// cover each expert's first cap rows only; the epilogue stores no row at
// or past min(offsets[e+1], offsets[e] + cap); the item of an expert's
// last m-tile writes the rows from offsets[e] + cap to offsets[e+1] of its
// columns as zeros. A box that
// reads past an expert's computed rows reads its dropped rows or the next
// expert's (or zeros past S): harmless only because those rows are never
// stored.
//
// Interface: plain C, raw pointers, launched on the caller's stream; no
// allocation; each entry returns the cudaGetLastError() code of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma (the prefill form)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 128;                 // weight columns a block: 4 warps x 32
constexpr int GT = 128;                   // threads a block
constexpr int KT = 64;                    // k rows a stage (8 KB of int8 weights)
constexpr int STAGES = 4;                 // cp.async ring depth
constexpr int MAX_ROWS = 64;              // expert-sorted rows a row tile
constexpr int MT = MAX_ROWS / 16;         // m-tiles a row tile
constexpr int WROW = TILE + 16;           // bytes of a padded int8 weight row
constexpr int AROW = KT + 8;              // bf16 of a padded activation row
constexpr int W_STAGE = KT * WROW;        // bytes
constexpr int A_STAGE = MAX_ROWS * AROW * 2;
constexpr int SMEM = STAGES * (W_STAGE + A_STAGE);
constexpr int HALF = TILE / 2;
constexpr int BROW = TILE + 4;            // float row of the SwiGLU epilogue buffer
static_assert(MAX_ROWS * BROW * 4 <= SMEM, "the SwiGLU buffer must fit in the ring");

// 16-byte global -> shared copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, col-major), float32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four int8 weights (a 32-bit word) -> the bf16 pairs (bytes 0, 2) and
// (bytes 1, 3), exact: the sign-flipped byte goes into the low mantissa of
// 2^23, one subtract of 2^23 + 128 leaves the value, whose upper 16 bits
// are its bf16 (fused_layer.cu widen4)
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& even, uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(f[i]) : "r"(u), "r"(0x4B000000u), "r"(0x7440 | i));
    f[i] = __float_as_uint(__uint_as_float(f[i]) - 8388736.f);
  }
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(even) : "r"(f[0]), "r"(f[2]));
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(odd) : "r"(f[1]), "r"(f[3]));
}

__device__ __forceinline__ void store_bf16x4(bf16* dst, const float* o) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]), hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = v;
}

// grid: (row splits, column tiles, NE); block: GT threads. W0 / W1: the
// block's two 64-column weight halves (SWIGLU: gate and up; else one
// 128-column tile, W1 unused), expert e's [K, ldw] int8 matrix at
// W + e * K * ldw; S0 / S1 their column scales, expert e's at S + e * ldw.
template <bool SWIGLU>
__global__ void __launch_bounds__(GT)
grouped_expert_i8(const bf16* __restrict__ X, const int* __restrict__ offsets, int cap,
                  const int8_t* __restrict__ W0, const int8_t* __restrict__ W1,
                  const float* __restrict__ S0, const float* __restrict__ S1, int ldw,
                  int K, bf16* __restrict__ out, int ldo) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;                                        // [STAGES][KT][WROW]
  bf16* as = reinterpret_cast<bf16*>(smem + STAGES * W_STAGE);     // [STAGES][MAX_ROWS][AROW]
  const int e = blockIdx.z;
  const int first = offsets[e], end = offsets[e + 1];
  if (first == end) return;
  const int cend = min(end, first + cap);   // rows past it are dropped
  const int n0 = blockIdx.y * (SWIGLU ? HALF : TILE);
  const long long es = (long long)K * ldw;
  const int8_t* seg0 = W0 + e * es + n0;
  const int8_t* seg1 = SWIGLU ? W1 + e * es + n0 : seg0 + HALF;
  const float* sc0 = S0 + (long long)e * ldw + n0;
  const float* sc1 = SWIGLU ? S1 + (long long)e * ldw + n0 : sc0 + HALF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = K / KT;
  const int mi = lane >> 3, rr = lane & 7;       // ldmatrix lane roles
  const int g = lane >> 2, t4 = lane & 3;        // accumulator lane roles
  const int ncols = SWIGLU ? HALF : TILE;        // output columns of the block

  for (int rb = first + blockIdx.x * MAX_ROWS; rb < end; rb += gridDim.x * MAX_ROWS) {
    const int rows = min(MAX_ROWS, end - rb);
    const int nc = max(0, min(rows, cend - rb));   // rows of the tile within capacity
    if (nc > 0) {
      const int mt_used = (nc + 15) / 16;

      auto load_stage = [&](int stage, int kt) {
        const int k0 = kt * KT;
        unsigned char* wdst = ws + stage * W_STAGE;
        for (int i = threadIdx.x; i < KT * (TILE / 16); i += GT) {
          const int r = i / (TILE / 16), c = (i % (TILE / 16)) * 16;
          const int8_t* src = (c < HALF ? seg0 + c : seg1 + (c - HALF)) + (long long)(k0 + r) * ldw;
          cp_async16(wdst + r * WROW + c, src, 16);
        }
        bf16* adst = as + stage * MAX_ROWS * AROW;
        for (int i = threadIdx.x; i < mt_used * 16 * (KT / 8); i += GT) {
          const int r = i / (KT / 8), c = (i % (KT / 8)) * 8;
          const bool ok = r < nc;
          cp_async16(adst + r * AROW + c, X + (long long)(rb + (ok ? r : 0)) * K + k0 + c,
                     ok ? 16 : 0);
        }
      };

      float acc[MT][4][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][nb][i] = 0.f;

#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_stage(s, s);
        cp_async_commit();
      }
      for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage kt landed for every thread; stage kt-1 is consumed
        {
          const int nt = kt + STAGES - 1;
          if (nt < nk) load_stage(nt % STAGES, nt);
          cp_async_commit();
        }
        const unsigned char* wst = ws + (kt % STAGES) * W_STAGE;
        const bf16* ast = as + (kt % STAGES) * MAX_ROWS * AROW;
#pragma unroll
        for (int kk = 0; kk < KT; kk += 16) {
          // B fragments: matrix mi = (k half mi & 1, 16-byte chunk mi >> 1)
          // of the warp's 32 columns; n8 block 2G + e holds columns 16G + 2i + e
          uint32_t r[4], b[4][2];
          ldmatrix_x4_trans(r, wst + (kk + 8 * (mi & 1) + rr) * WROW + (2 * warp + (mi >> 1)) * 16);
          widen4(r[0], b[0][0], b[1][0]);
          widen4(r[1], b[0][1], b[1][1]);
          widen4(r[2], b[2][0], b[3][0]);
          widen4(r[3], b[2][1], b[3][1]);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m < mt_used) {
              uint32_t a[4];
              ldmatrix_x4(a, ast + (m * 16 + rr + 8 * (mi & 1)) * AROW + kk + 8 * (mi >> 1));
#pragma unroll
              for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[m][nb], a, b[nb]);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every warp is done with the ring

      // acc[m][nb][i]: row m*16 + g + 8*(i >> 1), warp column
      // 16*(nb >> 1) + 4*t4 + 2*(i & 1) + (nb & 1): four neighbouring columns
      // 16G + 4*t4 .. + 3 of a row come from (nb, i) = (2G, 2h), (2G+1, 2h),
      // (2G, 2h+1), (2G+1, 2h+1)
      if constexpr (SWIGLU) {
        float* buf = reinterpret_cast<float*>(smem);   // [MAX_ROWS][BROW]
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt_used) {
#pragma unroll
            for (int nb = 0; nb < 4; ++nb)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = warp * 32 + 16 * (nb >> 1) + 4 * t4 + 2 * (i & 1) + (nb & 1);
                const float s = c < HALF ? sc0[c] : sc1[c - HALF];
                buf[(m * 16 + g + 8 * (i >> 1)) * BROW + c] = acc[m][nb][i] * s;
              }
          }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < nc * HALF; i += GT) {
          const int r = i / HALF, c = i % HALF;
          const float gt = buf[r * BROW + c], u = buf[r * BROW + HALF + c];
          out[(long long)(rb + r) * ldo + n0 + c] = __float2bfloat16(gt / (1.f + __expf(-gt)) * u);
        }
        __syncthreads();  // the buffer is the next row tile's ring
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt_used) {
#pragma unroll
            for (int G = 0; G < 2; ++G) {
              const int c = warp * 32 + 16 * G + 4 * t4;
              const float4 s = *reinterpret_cast<const float4*>(c < HALF ? sc0 + c : sc1 + (c - HALF));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = m * 16 + g + 8 * h;
                if (r < nc) {
                  const float o[4] = {acc[m][2 * G][2 * h] * s.x, acc[m][2 * G + 1][2 * h] * s.y,
                                      acc[m][2 * G][2 * h + 1] * s.z,
                                      acc[m][2 * G + 1][2 * h + 1] * s.w};
                  store_bf16x4(out + (long long)(rb + r) * ldo + n0 + c, o);
                }
              }
            }
          }
        }
      }
    }
    // rows past the capacity: 0, 8 columns a store
    for (int i = threadIdx.x; i < (rows - nc) * (ncols / 8); i += GT) {
      const int r = nc + i / (ncols / 8), c = (i % (ncols / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (long long)(rb + r) * ldo + n0 + c) = make_uint4(0, 0, 0, 0);
    }
  }
}

template <bool SWIGLU>
int launch(const void* x, const void* offsets, int cap, const void* w0, const void* w1,
           const void* s0, const void* s1, int ldw, int K, int col_tiles, int NE, int zsplit,
           void* out, int ldo, cudaStream_t st) {
  if (K % KT || ldw % 16) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(grouped_expert_i8<SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    attr_set = true;
  }
  grouped_expert_i8<SWIGLU><<<dim3(zsplit, col_tiles, NE), GT, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(offsets), cap,
      static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s0), static_cast<const float*>(s1), ldw, K,
      static_cast<bf16*>(out), ldo);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ prefill form
//
// grouped_expert_i8_tc (notes at the head of the file)
constexpr int PBM = 256;              // expert-sorted rows a tile
constexpr int PBN = 128;              // weight columns a tile
constexpr int PBK = 64;               // k a stage: one 128-byte swizzle atom of bf16
constexpr int PTH = 384;              // two consumer warpgroups + the producer warpgroup
constexpr int PSTAGES = 4;            // TMA ring depth
constexpr int PWIDE = 2;              // widened bf16 weight tiles
constexpr int PWIDEN = 96;            // threads that widen (producer warps 1-3)
constexpr int PBOX = 64 * 128;        // bytes of a 64 x 64 bf16 box (a row box, a widened half)
constexpr int PA = 4 * PBOX;          // a row stage: four 64-row boxes
constexpr int PQ = 2 * 64 * 64;       // an int8 weight stage: two [64 k][64 B] boxes
constexpr int PW = 2 * PBOX;          // a widened weight tile: two 64-column bf16 boxes
constexpr int PMAX_NE = 1024;         // experts the tile table holds
constexpr int PTAB = PMAX_NE + 4;     // ints of one table (16-byte multiple)

// a tile's output columns (h: 64, y: 128) and the padded bf16 row of the
// epilogue's staging rows
template <bool SWIGLU>
struct PTile {
  static constexpr int cols = SWIGLU ? PBN / 2 : PBN;
  static constexpr int erow = cols + 8;
};

template <bool SWIGLU>
constexpr int ptc_smem_bytes() {
  return 1024                                       // slack: the tiles start 1024-byte aligned
         + PSTAGES * (PA + PQ) + PWIDE * PW         // the rings
         + 8 * 2 * (PSTAGES + PWIDE)                // mbarriers
         + (2 * PTAB + 16) * 4                      // row offsets, m-tile cumsum, scan scratch
         + 8 * 8 * PTile<SWIGLU>::erow * 2;         // 8 staging rows for each consumer warp
}
static_assert(ptc_smem_bytes<true>() <= 232448 && ptc_smem_bytes<false>() <= 232448,
              "the int8 prefill kernel's shared memory exceeds a block's");

// sixteen int8 weights -> sixteen bf16 in order (lo: bytes 0-7, hi: 8-15),
// exact, as widen4 but pairing neighbouring bytes
__device__ __forceinline__ uint32_t widen_pair(uint32_t u, int i) {
  uint32_t a, b;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(a) : "r"(u), "r"(0x4B000000u), "r"(0x7440 | i));
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(b) : "r"(u), "r"(0x4B000000u), "r"(0x7440 | (i + 1)));
  a = __float_as_uint(__uint_as_float(a) - 8388736.f);
  b = __float_as_uint(__uint_as_float(b) - 8388736.f);
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ void widen16(const uint4& v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  lo = make_uint4(widen_pair(w[0], 0), widen_pair(w[0], 2), widen_pair(w[1], 0),
                  widen_pair(w[1], 2));
  hi = make_uint4(widen_pair(w[2], 0), widen_pair(w[2], 2), widen_pair(w[3], 0),
                  widen_pair(w[3], 2));
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return __fdividef(g, 1.f + __expf(-g)) * u;
}

// grid: the card's SMs; PTH threads. SWIGLU: tw0 / tw1 are the gate / up
// int8 maps, sc0 / sc1 their scales, and n-tile t covers h columns t*64 ..
// t*64 + 63; else tw0 is W, sc0 its scales, and n-tile t covers y columns
// t*128 .. t*128 + 127. Expert e's scales start at sc + e * lds.
template <bool SWIGLU>
__global__ void __launch_bounds__(PTH, 1)
grouped_expert_i8_tc(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw0,
                     const __grid_constant__ CUtensorMap tw1, const int* __restrict__ offsets,
                     int cap, const float* __restrict__ sc0, const float* __restrict__ sc1,
                     int lds, int NE, int K, int n_tiles, bf16* __restrict__ out, int ldo) {
  constexpr int NCOL = PTile<SWIGLU>::cols, EROW = PTile<SWIGLU>::erow;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;                                  // [PSTAGES] row stages
  unsigned char* ws = as + PSTAGES * PA;                     // [PWIDE] widened weight tiles
  unsigned char* qs = ws + PWIDE * PW;                       // [PSTAGES] int8 weight stages
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + PSTAGES * PQ);
  uint64_t* empty = full + PSTAGES;
  uint64_t* wide = empty + PSTAGES;                          // a widened tile is ready
  uint64_t* wfree = wide + PWIDE;                            // a widened tile is read
  int* off = reinterpret_cast<int*>(wfree + PWIDE);         // [NE + 1] row offsets
  int* cum = off + PTAB;                                     // [NE + 1] m-tiles before e
  int* wtot = cum + PTAB;                                    // [12] scan scratch
  bf16* epi = reinterpret_cast<bf16*>(wtot + 16);           // [8 warps][8][EROW] staging
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e <= NE; e += PTH) off[e] = offsets[e];
  if (tid == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // every consumer warp releases the stage
    }
    for (int j = 0; j < PWIDE; ++j) {
      mbar_init(&wide[j], PWIDEN);    // every widening thread
      mbar_init(&wfree[j], 8);        // every consumer warp
    }
    mbar_init_fence();
    cum[0] = 0;
  }
  __syncthreads();
  // cum[e + 1] = m-tiles of experts 0..e over their first cap rows: a
  // block-wide scan, PTH experts a pass
  int carry = 0;
  for (int base = 0; base < NE; base += PTH) {
    const int e = base + tid;
    int v = e < NE ? (min(off[e + 1] - off[e], cap) + PBM - 1) / PBM : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < PTH / 32; ++w) {
      before += w < warp ? wtot[w] : 0;
      total += wtot[w];
    }
    if (e < NE) cum[e + 1] = carry + before + v;
    carry += total;
    __syncthreads();   // wtot is rewritten by the next pass
  }
  const int items = cum[NE] * n_tiles;
  const int nk = K / PBK;
  // work item w -> its expert e (the last with cum[e] * n_tiles <= w: an
  // expert with no rows owns no item), n-tile, m-tile, first row and the
  // rows of the tile within the capacity
  auto item = [&](int w, int& e, int& nt, int& mt, int& row0, int& rows) {
    int lo = 0, hi = NE - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cum[mid] * n_tiles <= w) lo = mid;
      else hi = mid - 1;
    }
    e = lo;
    const int mt_e = cum[e + 1] - cum[e], local = w - cum[e] * n_tiles;
    nt = local / mt_e;
    mt = local % mt_e;
    row0 = off[e] + mt * PBM;
    rows = min(PBM, min(off[e + 1], off[e] + cap) - row0);
  };
  const int wg = tid / 128;

  if (wg == 2) {
    // ---- producer: registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid == 256) {
      // one thread issues every TMA load
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        int e, nt, mt, row0, rows;
        item(w, e, nt, mt, row0, rows);
        const int nbox = (rows + 63) / 64;   // 64-row boxes with a computed row
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % PSTAGES;
          if (it >= PSTAGES) mbar_wait(&empty[s], (it / PSTAGES - 1) & 1);
          unsigned char* a = as + s * PA;
          unsigned char* q = qs + s * PQ;
          mbar_expect_tx(&full[s], nbox * PBOX + PQ);
          for (int i = 0; i < nbox; ++i)
            tma_load_2d(a + i * PBOX, &tx, &full[s], kt * PBK, row0 + 64 * i);
          if (SWIGLU) {
            tma_load_3d(q, &tw0, &full[s], nt * 64, kt * PBK, e);
            tma_load_3d(q + PQ / 2, &tw1, &full[s], nt * 64, kt * PBK, e);
          } else {
            for (int c = 0; c < 2; ++c)
              tma_load_3d(q + c * (PQ / 2), &tw0, &full[s], nt * PBN + c * 64, kt * PBK, e);
          }
        }
      }
    } else if (tid >= 288) {
      // warps 9-11 widen each landed int8 stage into the bf16 tile the
      // consumers read: chunk c (16 bytes) of the stage is half h, k row r,
      // columns 16 * c16 .. + 15, which go to 16-byte chunks 2 * c16 and
      // 2 * c16 + 1 of row r of widened box h, swizzled as TMA's 128-byte
      // swizzle places them (chunk j of row r at j ^ (r & 7))
      const int wt = tid - 288;
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % PSTAGES, j = it % PWIDE;
          mbar_wait(&full[s], (it / PSTAGES) & 1);
          if (it >= PWIDE) mbar_wait(&wfree[j], (it / PWIDE - 1) & 1);
          const unsigned char* q = qs + s * PQ;
          unsigned char* wd = ws + j * PW;
          for (int c = wt; c < PQ / 16; c += PWIDEN) {
            const int h = c >> 8, r = (c >> 2) & 63, c16 = c & 3, sw = r & 7;
            uint4 lo, hi;
            widen16(*reinterpret_cast<const uint4*>(q + c * 16), lo, hi);
            unsigned char* row = wd + h * PBOX + r * 128;
            *reinterpret_cast<uint4*>(row + (((2 * c16) ^ sw) << 4)) = lo;
            *reinterpret_cast<uint4*>(row + (((2 * c16 + 1) ^ sw) << 4)) = hi;
          }
          fence_proxy_async();   // the tile is read by wgmma (the async proxy)
          mbar_arrive(&wide[j]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 128*wg .. 128*wg + 127 of a
    // tile, as m64 sub-tiles j = 0, 1 (rows 128*wg + 64*j + ...)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int wq = (tid >> 5) & 3, c2 = (lane & 3) * 2;
    float acc[2][64];
    int it = 0;
    // a consumer warp's release of ring stage s and widened tile j
    auto release = [&](int s, int j) {
      if (lane == 0) {
        mbar_arrive(&wfree[j]);
        mbar_arrive(&empty[s]);
      }
    };
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      int e, nt, mt, row0, rows;
      item(w, e, nt, mt, row0, rows);
      const int subs = min(2, max(0, (rows - 128 * wg + 63) / 64));   // sub-tiles with rows
      if (subs == 0) {   // no row of this warpgroup: release each stage once widened
        for (int kt = 0; kt < nk; ++kt, ++it) {
          mbar_wait(&wide[it % PWIDE], (it / PWIDE) & 1);
          release(it % PSTAGES, it % PWIDE);
        }
      } else {
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % PSTAGES, j = it % PWIDE;
          mbar_wait(&full[s], (it / PSTAGES) & 1);   // the row boxes
          mbar_wait(&wide[j], (it / PWIDE) & 1);     // the widened weights
          const unsigned char* a = as + s * PA + 2 * wg * PBOX;
          const unsigned char* b = ws + j * PW;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < PBK / 16; ++kk) {
            const uint64_t db = sw128_desc(b + kk * 16 * 128, PBOX, 1024);
            wgmma_ss_n128_tb(acc[0], sw128_desc(a + kk * 32, 16, 1024), db, kt > 0 || kk > 0);
            if (subs == 2)
              wgmma_ss_n128_tb(acc[1], sw128_desc(a + PBOX + kk * 32, 16, 1024), db,
                               kt > 0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();   // this stage is read: release it at once
          release(s, j);
        }
        fence_regs(acc[0]);
        fence_regs(acc[1]);

        // the epilogue, 8 rows at a time through this warp's staging rows:
        // the accumulators (row 16*wq + lane/4 (+8) of sub-tile j, columns
        // 8i + c2) times the column scales go in, whole rows come out in
        // 16-byte pieces
        const float* s0 = sc0 + (long long)e * lds + nt * NCOL + c2;
        const float* s1 = SWIGLU ? sc1 + (long long)e * lds + nt * NCOL + c2 : s0;
        bf16* stage = epi + (wg * 4 + wq) * 8 * EROW;
        bf16* srow = stage + (lane >> 2) * EROW + c2;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j >= subs) break;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (SWIGLU) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {   // gate column c at acc[j][4i..], up at acc[j][32 + 4i..]
                const float* a = &acc[j][4 * i + 2 * half];
                const float2 sg = __ldg(reinterpret_cast<const float2*>(s0 + 8 * i));
                const float2 su = __ldg(reinterpret_cast<const float2*>(s1 + 8 * i));
                *reinterpret_cast<__nv_bfloat162*>(srow + 8 * i) = __floats2bfloat162_rn(
                    silu_mul(a[0] * sg.x, a[32] * su.x), silu_mul(a[1] * sg.y, a[33] * su.y));
              }
            } else {
#pragma unroll
              for (int i = 0; i < 16; ++i) {
                const float2 sc = __ldg(reinterpret_cast<const float2*>(s0 + 8 * i));
                *reinterpret_cast<__nv_bfloat162*>(srow + 8 * i) = __floats2bfloat162_rn(
                    acc[j][4 * i + 2 * half] * sc.x, acc[j][4 * i + 2 * half + 1] * sc.y);
              }
            }
            __syncwarp();
            const int rbase = 128 * wg + 64 * j + 16 * wq + 8 * half;   // the tile rows staged
#pragma unroll
            for (int q = lane; q < NCOL; q += 32) {   // 8 rows x NCOL / 8 pieces
              const int rr = q / (NCOL / 8), cc = (q % (NCOL / 8)) * 8;
              // rows at or past the expert's computed end (its dropped
              // rows, the next expert's, or past S) are never stored
              if (rbase + rr < rows)
                *reinterpret_cast<uint4*>(out + (long long)(row0 + rbase + rr) * ldo +
                                          nt * NCOL + cc) =
                    *reinterpret_cast<const uint4*>(stage + rr * EROW + cc);
            }
            __syncwarp();   // the staging rows are rewritten next
          }
        }
      }
      // the expert's last m-tile: its rows past the capacity are 0 in this
      // item's columns, 8 columns a store
      if (mt == cum[e + 1] - cum[e] - 1) {
        const int d0 = off[e] + cap, nd = off[e + 1] - d0;
        for (int q = tid; q < nd * (NCOL / 8); q += 256) {
          const int r = q / (NCOL / 8), c = (q % (NCOL / 8)) * 8;
          *reinterpret_cast<uint4*>(out + (long long)(d0 + r) * ldo + nt * NCOL + c) =
              make_uint4(0, 0, 0, 0);
        }
      }
    }
  }
}

// an int8 tensor map over the [NE, K, ldw] stack at w, its first ncols
// columns: 64-byte x 64-row boxes, unswizzled (the widening reads it in order)
bool i8_map(CUtensorMap* map, const void* w, int ncols, int K, int NE, int ldw) {
  const EncodeTiled enc = encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)ncols, (cuuint64_t)K, (cuuint64_t)NE};
  const cuuint64_t strides[2] = {(cuuint64_t)ldw, (cuuint64_t)K * ldw};
  const cuuint32_t box[3] = {64, PBK, 1}, ones[3] = {1, 1, 1};
  return enc && enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w), dims, strides,
                    box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tx over x [S, K]; tw0 (tw1) over the [NE, K, ldw] int8 stack at w0 (w1),
// its first ncols columns; s0 (s1) their scales, expert e's at s + e * ldw
template <bool SWIGLU>
int launch_tc(const void* x, const void* offsets, int cap, const void* w0, const void* w1,
              const void* s0, const void* s1, int ldw, int ncols, int NE, int K, int S,
              int grid, void* out, int ldo, cudaStream_t st) {
  if (NE > PMAX_NE || K % PBK || ldw % 16 || ncols % PTile<SWIGLU>::cols || S < 1 || cap < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw0, tw1;
  const cuuint64_t xdim[2] = {(cuuint64_t)K, (cuuint64_t)S}, xstride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {PBK, 64};
  if (!bf16_map(&tx, x, 2, xdim, xstride, xbox) || !i8_map(&tw0, w0, ncols, K, NE, ldw) ||
      !i8_map(&tw1, w1, ncols, K, NE, ldw))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = ptc_smem_bytes<SWIGLU>();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(grouped_expert_i8_tc<SWIGLU>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attr_set = true;
  }
  grouped_expert_i8_tc<SWIGLU><<<grid, PTH, bytes, st>>>(
      tx, tw0, tw1, static_cast<const int*>(offsets), cap, static_cast<const float*>(s0),
      static_cast<const float*>(s1), ldw, NE, K, ncols / PTile<SWIGLU>::cols,
      static_cast<bf16*>(out), ldo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Entry 1: h [S,F] for expert-sorted bf16 rows x [S,E]; offsets [NE+1]
// int32 on the device; w_gate / w_up: expert e's [E,F] int8 matrices at
// w + e*E*ldw with row stride ldw, s_gate / s_up their float32 column
// scales at s + e*ldw (packed [NE,E,2F] gate|up: ldw = 2F, w_up = w_gate +
// F, s_up = s_gate + F). E % 64 == 0, F % 64 == 0.
int dstts_grouped_gateup_i8(const void* x, const void* offsets, int cap, const void* w_gate,
                            const void* w_up, const void* s_gate, const void* s_up, int ldw,
                            int NE, int E, int F, int zsplit, void* h, void* stream) {
  if (F % HALF) return (int)cudaErrorInvalidValue;
  return launch<true>(x, offsets, cap, w_gate, w_up, s_gate, s_up, ldw, E, F / HALF, NE,
                      zsplit, h, F, static_cast<cudaStream_t>(stream));
}

// Entry 2: y [S,E] = (h [S,F] @ Wd[e]) * sd[e] over w_down [NE,F,E] int8
// and s_down [NE,1,E] float32. F % 64 == 0, E % 128 == 0.
int dstts_grouped_down_i8(const void* h, const void* offsets, int cap, const void* w_down,
                          const void* s_down, int NE, int F, int E, int zsplit, void* y,
                          void* stream) {
  if (E % TILE) return (int)cudaErrorInvalidValue;
  return launch<false>(h, offsets, cap, w_down, w_down, s_down, s_down, E, F, E / TILE, NE,
                       zsplit, y, E, static_cast<cudaStream_t>(stream));
}

// The prefill form (grouped_expert_i8_tc), entry 1: h [S,F] as
// dstts_grouped_gateup_i8; w_gate / w_up 16-byte aligned with ldw % 16 == 0;
// E % 64 == 0, F % 64 == 0, NE <= 1024; grid: the card's SMs.
int dstts_grouped_gateup_i8_tc(const void* x, const void* offsets, int cap, const void* w_gate,
                               const void* w_up, const void* s_gate, const void* s_up, int ldw,
                               int NE, int E, int F, int S, int grid, void* h, void* stream) {
  return launch_tc<true>(x, offsets, cap, w_gate, w_up, s_gate, s_up, ldw, F, NE, E, S, grid, h,
                         F, static_cast<cudaStream_t>(stream));
}

// Entry 2: y [S,E] as dstts_grouped_down_i8. F % 64 == 0, E % 128 == 0.
int dstts_grouped_down_i8_tc(const void* h, const void* offsets, int cap, const void* w_down,
                             const void* s_down, int NE, int F, int E, int S, int grid, void* y,
                             void* stream) {
  return launch_tc<false>(h, offsets, cap, w_down, w_down, s_down, s_down, E, E, NE, F, S, grid,
                          y, E, static_cast<cudaStream_t>(stream));
}

// Blocks an SM can hold of each entry's kernel, as the runtime computes
// them from registers, threads and shared memory: out[0] gate|up, out[1]
// down (the decode form), out[2], out[3] the same of the prefill form.
int dstts_grouped_i8_occupancy(int* out) {
  constexpr int pgu = ptc_smem_bytes<true>(), pdn = ptc_smem_bytes<false>();
  cudaFuncSetAttribute(grouped_expert_i8<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(grouped_expert_i8<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(grouped_expert_i8_tc<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pgu);
  cudaFuncSetAttribute(grouped_expert_i8_tc<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pdn);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], grouped_expert_i8<true>, GT, SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], grouped_expert_i8<false>, GT, SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], grouped_expert_i8_tc<true>, PTH, pgu);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], grouped_expert_i8_tc<false>, PTH, pdn);
  return (int)cudaGetLastError();
}

}  // extern "C"
