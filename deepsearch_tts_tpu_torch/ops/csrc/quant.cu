// B12, per-output-channel int8 quantization for Hopper (sm_90a): the port
// of deepsearch_tts_tpu/ops/quant.py quantize_int8 (_quant_kernel,
// quant.py:24-38):
//   s [N] = max(amax_k |w[k, n]| / 127, 1e-8)           (IEEE division)
//   q [K, N] int8 = clip(round_half_even(w / s), -127, 127)
// or, stochastic, clip(floor(w / s + u), -127, 127) with u = 24 random bits
// * 2^-24 from Philox4x32-10 keyed by the seed, counter = the element's flat
// index k * N + n (word 0; ops/quant.philox4x32_10 is the same generator in
// plain torch).
//
// What bounds it: bytes. Each weight must be read once (2 B of bf16) and
// its int8 written once (1 B): [5120, 51200] moves 786 MB, 0.235 ms at
// 3.35 TB/s. The TPU kernel holds the whole [K, block] in VMEM and reads it
// once; the Triton kernel this replaces walked K twice a 64-column program
// (the amax, then the scale and the store) and moved 1.31 GB.
//
// Design: one read. A column strip [K, BN] (rows of 64 bytes: 32 bf16 or
// fp16 columns, 16 float32) is held on chip across a thread-block cluster
// of CS blocks that split K:
// block r of the cluster loads rows [r * RB, (r + 1) * RB) of the strip by
// TMA, all of them at its start, in boxes of BH rows with one mbarrier each,
// and takes the column amax of its rows box by box as they land (each
// thread 16-byte chunks of one column group, then a warp butterfly and the
// warps through shared memory; max is exact, so no order matters). The
// block's amax goes to its shared memory; a cluster barrier; every block
// reads the CS partial amaxes through distributed shared memory
// (mapa + ld.shared::cluster), forms the scales, arrives at a second
// cluster barrier (no block may leave while another still reads it, so the
// wait is at the end), quantizes its rows from shared memory and stores
// them, 8 or 4 bytes a thread where q is 8-byte aligned, else byte by byte.
// Block 0 of the cluster writes the scales.
// The host picks (CS, RB, BH) per shape (ops/quant.quant_plan) so that
// RB rows fit a block's share of shared memory at three blocks an SM
// (fewer where a strip needs it: one block's loads overlap the others'
// quantizing and stores), clusters of up to 16 blocks, RB is a whole
// number of 128-byte-aligned boxes, and no box reaches into the next
// block's rows;
// boxes past K read zeros (TMA's bounds), which add nothing to an amax, and
// rows past K are not stored. A row stride that is not a multiple of 16
// bytes, or a w that is not 16-byte aligned, cannot be a TMA tensor map;
// such matrices (widths no served model has) are loaded by the threads,
// element by element, into the same layout.
//
// Interface: plain C, raw pointers, launched on the caller's stream with
// cudaLaunchKernelEx and the cluster attribute; returns the launch's
// cudaError (a refused cluster launch is an error, never skipped).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, the tensor map encoder

namespace {

typedef __nv_bfloat16 bf16;

constexpr int QT = 256;        // threads a block
constexpr int QMAXBOX = 16;    // TMA boxes a block (one mbarrier each)
constexpr int QMAXBOXROWS = 256;   // rows a box (TMA's limit a dimension)

struct QArgs {
  const void* w;   // [K, N] row-major
  int8_t* q;       // [K, N]
  float* s;        // [N]
  int K, N;
  int rows, bh;    // rows a block (a whole number of boxes), rows a box
  int tma;         // 1: TMA boxes; 0: the threads' own element loads
  int vec;         // 1: q's rows take 8- / 4-byte stores (TMA-able N, q 8-byte aligned)
  int stochastic;
  unsigned long long seed;
};

// 16 bytes of T -> floats
__device__ __forceinline__ void to_float(const uint4& u, bf16*, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void to_float(const uint4& u, __half*, float* f) {
  const __half2* p = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void to_float(const uint4& u, float*, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// ------------------------------------------------------------- clusters

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// every thread of every block of the cluster arrives / waits
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float at p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, int rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// Philox4x32-10 (Salmon et al., SC 2011), word 0 of the block at counter
// (idx lo, idx hi, 0, 0) under key (seed lo, seed hi)
__device__ __forceinline__ uint32_t philox_word0(unsigned long long idx,
                                                 unsigned long long seed) {
  uint32_t c0 = (uint32_t)idx, c1 = (uint32_t)(idx >> 32), c2 = 0, c3 = 0;
  uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// rint(x / s) (half to even) of the IEEE quotient, from the product with
// r = RN(1 / s): x * r is within 2^-23 |x / s| + half an ulp of x / s, under
// 2^-16 where |x / s| <= 128 (the scale makes |x| / s <= 127); its rint is
// the quotient's unless x * r lies within 2^-15 of a half-integer (a tie
// of x / s among them), and there the exact quotient decides (~6e-5 of
// the values). No division a value otherwise.
__device__ __forceinline__ float round_quotient(float x, float s, float r) {
  const float y = x * r, n = rintf(y);
  if (fabsf(y - n) < 0.5f - 0x1p-15f) return n;
  return rintf(__fdiv_rn(x, s));
}

// grid: CS blocks a strip of BN columns (64 bytes), clusters of CS; QT threads
template <typename T>
__global__ void __launch_bounds__(QT)
quant_strip(const __grid_constant__ CUtensorMap tw, const __grid_constant__ QArgs p) {
  constexpr int BN = 64 / (int)sizeof(T);  // columns a strip
  constexpr int V = 16 / (int)sizeof(T);   // values a 16-byte chunk
  constexpr int CPR = BN / V;              // chunks a row
  constexpr int RSTEP = QT / CPR;          // rows a pass of the block
  static_assert(CPR >= 1 && CPR <= 32 && QT % CPR == 0, "strip width");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[QMAXBOX];
  __shared__ float red[QT / 32][BN];
  __shared__ float amax_s[BN];   // this block's column amax, read by the cluster
  __shared__ float scale_s[BN];
  T* tile = reinterpret_cast<T*>(smem);   // [nbox * bh][BN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cs = cluster_size(), rank = cluster_rank();
  const int col0 = blockIdx.x / cs * BN;
  const int r0 = rank * p.rows;
  const int live = r0 < p.K ? (p.K - r0 < p.rows ? p.K - r0 : p.rows) : 0;
  const int nbox = (live + p.bh - 1) / p.bh;
  const int nrows = nbox * p.bh;   // rows in shared memory (past K: zeros)

  if (p.tma) {
    if (tid == 0) {
      for (int b = 0; b < nbox; ++b) mbar_init(&bar[b], 1);
      mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0)
      for (int b = 0; b < nbox; ++b) {
        mbar_expect_tx(&bar[b], (uint32_t)(p.bh * BN * sizeof(T)));
        tma_load_2d(tile + (long long)b * p.bh * BN, &tw, &bar[b], col0, r0 + b * p.bh);
      }
  } else {
    const T* w = static_cast<const T*>(p.w);
    for (int i = tid; i < nrows * BN; i += QT) {
      const int r = i / BN, c = i % BN, gr = r0 + r, gc = col0 + c;
      tile[i] = gr < p.K && gc < p.N ? w[(long long)gr * p.N + gc] : T(0.f);
    }
    __syncthreads();
  }

  // ---- the column amax of this block's rows, box by box as they land
  const int c = tid % CPR, rr = tid / CPR;
  float m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = 0.f;
  for (int b = 0; b < nbox; ++b) {
    if (p.tma) mbar_wait(&bar[b], 0);
    for (int r = b * p.bh + rr; r < (b + 1) * p.bh; r += RSTEP) {
      float f[V];
      to_float(*reinterpret_cast<const uint4*>(tile + (long long)r * BN + c * V), (T*)nullptr, f);
#pragma unroll
      for (int i = 0; i < V; ++i) m[i] = fmaxf(m[i], fabsf(f[i]));
    }
  }
  // the lanes of one column group: lane = c (mod CPR)
#pragma unroll
  for (int o = 16; o >= CPR; o >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
  if (lane < CPR)
#pragma unroll
    for (int i = 0; i < V; ++i) red[warp][c * V + i] = m[i];
  __syncthreads();
  if (tid < BN) {
    float a = red[0][tid];
#pragma unroll
    for (int w = 1; w < QT / 32; ++w) a = fmaxf(a, red[w][tid]);
    amax_s[tid] = a;
  }
  // ---- the cluster's amax: every block's, through distributed shared memory
  cluster_arrive();
  cluster_wait();
  if (tid < BN) {
    float a = 0.f;
    for (int k = 0; k < cs; ++k) a = fmaxf(a, ld_cluster(&amax_s[tid], k));
    const float sc = fmaxf(__fdiv_rn(a, 127.f), 1e-8f);
    scale_s[tid] = sc;
    if (rank == 0 && col0 + tid < p.N) p.s[col0 + tid] = sc;
  }
  cluster_arrive();   // this block's reads of the others' amax are done
  __syncthreads();

  // ---- quantize the rows from shared memory
  float sc[V], rc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sc[i] = scale_s[c * V + i];
    rc[i] = __frcp_rn(sc[i]);
  }
  const int gc = col0 + c * V;
  const bool whole = p.vec && gc + V <= p.N;
  for (int r = rr; r < live; r += RSTEP) {
    const long long gr = r0 + r;
    float f[V];
    to_float(*reinterpret_cast<const uint4*>(tile + (long long)r * BN + c * V), (T*)nullptr, f);
    __align__(8) int8_t o[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float v;
      if (p.stochastic) {
        const uint32_t bits = philox_word0((unsigned long long)(gr * p.N + gc + i), p.seed);
        v = floorf(__fdiv_rn(f[i], sc[i]) + (float)(bits >> 8) * (1.f / 16777216.f));
      } else {
        v = round_quotient(f[i], sc[i], rc[i]);
      }
      o[i] = (int8_t)(int)fminf(fmaxf(v, -127.f), 127.f);
    }
    int8_t* dst = p.q + gr * p.N + gc;
    if (whole) {
      if (V == 8)
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      else
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(o);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (gc + i < p.N) dst[i] = o[i];
    }
  }
  cluster_wait();   // no block leaves while another may still read its amax
}

// a 2-D tensor map of a [rows, cols] matrix, boxes of box_cols x box_rows,
// no swizzle, zeros past the matrix; a box row is promoted to 128 bytes in
// L2 (a 64-byte row brings the next strip's bytes, for the cluster beside
// it; none or 256 bytes measured no faster: PERF.md, PR 11)
bool map_2d(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr, int rows, int cols,
            long long ld, int box_cols, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, ones[2] = {1, 1};
  return enc && enc(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, ones,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                    CUDA_SUCCESS;
}

template <typename T>
int launch_quant(CUtensorMapDataType dt, const QArgs& a, int cs, int smem, cudaStream_t st) {
  constexpr int BN = 64 / (int)sizeof(T);   // 64-byte rows
  CUtensorMap tw = {};
  if (a.tma && !map_2d(&tw, dt, a.w, a.K, a.N, (long long)a.N * sizeof(T), BN, a.bh))
    return (int)cudaErrorInvalidValue;
  static int attr = 0;   // the opt-in above 48 KB, raised as needed
  static bool wide = false;   // clusters of 16 blocks: beyond the portable 8
  if (cs > 8 && !wide) {
    const cudaError_t e =
        cudaFuncSetAttribute(quant_strip<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    wide = true;
  }
  if (smem > attr) {
    const cudaError_t e =
        cudaFuncSetAttribute(quant_strip<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.N + BN - 1) / BN * cs));
  cfg.blockDim = dim3(QT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, quant_strip<T>, tw, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dtype 0 bf16, 1 fp16, 2 float32
int dispatch(int dtype, const QArgs& a, int cs, int smem, cudaStream_t st) {
  if (dtype == 0) return launch_quant<bf16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, cs, smem, st);
  if (dtype == 1) return launch_quant<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, a, cs, smem, st);
  if (dtype == 2) return launch_quant<float>(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a, cs, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// B12. w [K,N] (dtype: 0 bf16, 1 fp16, 2 float32), row-major; q [K,N] int8
// and s [N] float32 out. The plan (ops/quant.quant_plan): strips of 64-byte
// rows, clusters of cs blocks of `rows` rows (boxes of bh rows), smem
// dynamic shared bytes a block.
int dstts_quantize_int8(const void* w, void* q, void* s, int K, int N, int dtype, int cs,
                        int rows, int bh, int smem, int stochastic, unsigned long long seed,
                        void* stream) {
  if (K < 1 || N < 1 || dtype < 0 || dtype > 2 || cs < 1 || cs > 16 || bh < 1 ||
      bh > QMAXBOXROWS || rows % bh || rows / bh > QMAXBOX || (long long)cs * rows < K ||
      bh * 64 % 128 || smem < rows * 64)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 2 ? 4 : 2;
  QArgs a = {};
  a.w = w;
  a.q = static_cast<int8_t*>(q);
  a.s = static_cast<float*>(s);
  a.K = K;
  a.N = N;
  a.rows = rows;
  a.bh = bh;
  a.tma = (long long)N * esize % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.vec = (long long)N * esize % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0;
  a.stochastic = stochastic;
  a.seed = seed;
  return dispatch(dtype, a, cs, smem, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
