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
// their output is 0). cap is the caller's, from static sizes.
//
// What bounds it: at a decode step the touched experts' int8 weights
// (qwen3-30b-a3b, 16 tokens x top-8: ~74 experts, 233 MB for gate|up and
// 116 MB for down a layer against one or two rows an expert, B FLOP a weight
// byte), so the goal is streaming each touched expert's weights once at
// HBM rate. At prefill (~190 rows an expert at 3072 tokens) the tensor
// operations catch up with the bytes (155 GFLOP for gate|up).
//
// Design (simple first; a wgmma prefill form is later work): the decode
// grouped expert kernel's shape (fused_layer.cu grouped_expert) over int8
// tiles. One block of 4 warps per (row split, column tile, expert): the
// row split varies fastest, so the blocks that share an expert's weight
// tile run together and read it from L2 after the first. A 4-stage cp.async
// ring brings 64-row x 128-byte weight tiles (8 KB, rows padded to 144
// bytes so ldmatrix is free of bank conflicts) and the matching 64-row bf16
// activation tiles. ldmatrix.trans reads the int8 tile as 16-bit pairs and
// widen4 turns each register into two bf16 B fragments, exactly (as
// i8_stream does: n8 block 2G + e of a warp holds its columns 16G + 2i + e);
// mma.sync m16n8k16 bf16 -> float32; the column scale multiplies the float32
// sum in the epilogue. A block walks its expert's 64-row tiles
// (gridDim.x of them at once); m-tiles past the computed rows are neither
// loaded nor multiplied; a block whose expert has no rows returns at once,
// so the group offsets stay on the device. SWIGLU blocks hold 64 gate and
// the same 64 up columns (warps 0-1 gate, 2-3 up) and meet in shared memory.
//
// Interface: plain C, raw pointers, launched on the caller's stream; no
// allocation; each entry returns the cudaGetLastError() code of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Blocks an SM can hold of each entry's kernel, as the runtime computes
// them from registers, threads and shared memory: out[0] gate|up, out[1] down.
int dstts_grouped_i8_occupancy(int* out) {
  cudaFuncSetAttribute(grouped_expert_i8<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(grouped_expert_i8<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], grouped_expert_i8<true>, GT, SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], grouped_expert_i8<false>, GT, SMEM);
  return (int)cudaGetLastError();
}

}  // extern "C"
