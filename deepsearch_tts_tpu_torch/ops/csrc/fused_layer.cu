// Fused decode-layer kernels for Hopper (sm_90a): the port of
// deepsearch_tts_tpu/ops/fused_layer.py
//   B3  fused_qkv_stacked         (_qkv_stacked_kernel,        fused_layer.py:244)
//   B4  fused_out_mlp_stacked     (_out_mlp_stacked_kernel,    fused_layer.py:356)
//   B7  fused_out_router_stacked  (_out_router_stacked_kernel, fused_layer.py:818)
//   B8  fused_mlp_stacked         (_mlp_stacked_kernel,        fused_layer.py:468)
//   B11 fused_mlp / fused_qkv / fused_out_mlp, the one-layer forms
//       (fused_layer.py:112, :150, :975): B8 / B3 / B4 at L = 1, and for
//       fused_out_mlp with unpacked gate and up, dstts_fused_out_mlp_split
//   B10 fused_qkv_stacked_i8      (_qkv_stacked_kernel_i8,     fused_layer.py:568)
//       fused_out_mlp_stacked_i8  (_out_mlp_stacked_kernel_i8, fused_layer.py:669)
//       and the bare int8 product of ops/quant.int8_matmul (quant.py:68)
// and the grouped expert FFN of the MoE layers, which the JAX package leaves
// to lax.ragged_dot (ops/moe.py:81 _expert_ffn_ragged): grouped_expert
// (decode) and grouped_expert_tc (prefill), after the epilogue kernels.
//
// What bounds them on this card: at the rows of a decode, lane or verify
// step (B <= 256) every product here is a thin matrix product whose
// weights dominate the bytes:
// (H+2K)*D*E*2 B for B3 (50 MB per layer at qwen3-8b) and
// (H*D*E + 3*E*F)*2 B for B4 (336 MB). At B rows the work is B FLOP per
// weight byte, far below the ~295 FLOP/byte ridge, so the goal is streaming
// the weights at HBM rate. A first version that multiplied on the CUDA cores
// (float32 FMA) was FMA-bound from B=16 on (B4 at B=16 moved 336 MB in
// 0.33 ms); the products now run on the tensor cores.
//
// Design:
// * Two split-K product kernels compute P[z, r, n] = sum_{k in slice z}
//   X[r, k] * W[k, n] for the rows of a call; the wrapper (ops/fused_layer.py
//   product_plan) takes one from the row count alone:
//   - gemm_partial<MT> (the first design, kept where it measured faster:
//     up to 16 rows): MT m-tiles of 16 rows (at most 64) and a 128-column
//     tile a block, 4 warps each owning 32 columns; a 4-stage cp.async ring
//     brings 32-row weight tiles (and the matching activation tiles) into
//     padded shared memory, ldmatrix (.trans for the row-major weights)
//     feeds mma.sync.m16n8k16 bf16 -> float32. Its grid has a row-group
//     dimension: past 64 rows each 64-row group streams every weight byte
//     again from HBM (B4 at 80 rows: 0.2639 ms, slower than its plain
//     version), which is why gemm_tc takes over past 16 rows.
//   - gemm_tc<MB> (past 16 rows; below "gemm_tc"): every row of a call up
//     to 256 (a lane step's 80, a verify step's 64 (K + 1)) in one weight
//     pass: a persistent grid over (128-column tile, k-slice) items with
//     no row-group dimension, TMA loads of 64-row boxes of X and 64 x 128
//     weight tiles into a 192 KB mbarrier ring, wgmma m64n128k16 with X as
//     the K-major A operand and the weight tile as the MN-major B; the
//     row boxes are the rows of the call rounded up to 64 (the tensor work
//     of a box past the rows is skipped, and at these row counts the
//     tensor cores have slack: a stage's products take well under its HBM
//     time). The k slices are counted per weight tile (tc_splits).
// * Few column tiles would leave most of the 132 SMs idle, so the wrapper
//   splits K over blockIdx.y (gemm_partial: until the grid has >= 2 blocks
//   per SM, capped so the float32 partial sums stay well below the weight
//   bytes; gemm_tc: over the items, whichever count fills the persistent
//   blocks' rounds best for the partials' bytes); an epilogue kernel
//   reduces the partial sums.
// * The TPU kernels keep RMSNorm, per-head q/k norm, RoPE, residuals and
//   SwiGLU inside VMEM-resident grid steps. Here a row kernel writes the
//   normalised bf16 rows, and small epilogue kernels finish each product:
//     B3: rms_norm_rows(x, ln1) -> gemm(wqkv) -> qkv_epilogue (q/k norm, rope)
//     B4: gemm(a, wo) -> residual (x2 = x + a@wo)
//         rms_norm_rows(x2, ln2) -> gemm(gate|up) -> swiglu (h = silu(g)*u)
//         gemm(h, wd) -> residual (out = x2 + h@wd)
//     B7: one launch of i8_stream<I8_ROUTER> (below; see "B7")
//     B8: [rms_norm_rows(x, ln)] -> gemm(wg), gemm(wu) -> swiglu -> gemm(wd)
//         -> residual (out = [x +] h@wd); gate and up are two stacks read
//         through two pointers, their partial sums side by side. MLA's
//         dense-layer MLPs (E = 7168, F = 18432: 793 MB of weights a call)
//         and shared experts (F = 2048: 88 MB), each weight byte read once.
//   B4's sequential grid on the TPU carried x2 through VMEM; Hopper blocks
//   cannot, so x2, xn and h ([B,E], [B,E], [B,F] bf16, under 8 MB at B=256)
//   go through device memory and stay in L2.
// * bf16 round points match the TPU kernels: xn, x2, h and the outputs are
//   rounded to bf16; every accumulator and the norm/rope math are float32.
// * B10 (int8 weights, one float32 scale per output column) has its own
//   product, i8_stream (below the grouped expert kernels). It multiplies
//   bf16 activations by the int8 weights widened to bf16 (exact: |q| <=
//   127), as JAX multiplies bf16 x bf16(int8) (fused_layer.py:583,
//   699-704), sums in float32 and applies the column scale to the sum. What
//   bounds it: the int8 weight bytes (one byte a weight; B FLOP a byte).
//   What held the first port back (scripts/trace_int8_product.py, PERF.md):
//   widening each 4 KB stage into a bf16 tile took ~70 % of a stage, since
//   each byte went through I2F and a float->bf16 conversion, with two
//   barriers a stage; and a chain of seven launches, 2.4 waves of uneven
//   depth and float32 partials through memory. The design:
//   - widening in registers at full rate: ldmatrix.trans reads the int8
//     tile as 16-bit pairs, so a 32-bit register holds two k-rows of two
//     neighbouring columns; widen4 splits it with byte permutes into the
//     low mantissa of 2^23, one float subtract leaves each exact value,
//     whose upper half is its bf16 (~3 integer / float ops a byte, no
//     conversion unit, no bf16 tile, no second barrier). The two columns
//     of a register feed two n8 blocks, so a warp's n8 block 2G + e holds
//     columns 16G + 2i + e; the epilogue maps them back.
//   - a persistent grid (the SM count, one block each) over a stream-K
//     split of the (column tile, 8 KB k-stage) sequence: block b owns
//     stages [b*total/G, (b+1)*total/G) in tile-major order, so the blocks'
//     shares differ by at most one stage and no wave has a tail;
//   - one producer warp issues TMA loads of 128-byte-wide weight boxes
//     (128-byte swizzle, 128-byte L2 promotion: 256 fetched the next
//     tile's bytes too) and of the activation stage into an mbarrier ring;
//     one consumer warp per 32 columns widens and multiplies in registers;
//   - tiles of 128 columns, and of 256 (256-byte runs of each weight row)
//     for the lm_head and for SwiGLU's gate and up halves;
//   - a tile split over blocks is finished inside the kernel: the other
//     blocks leave their sums in a partial slot and count themselves on
//     the tile's ticket (release); the block holding the tile's first
//     stages (its share's last segment) waits for the count (acquire), adds
//     the slots in block order and runs the tile's epilogue: the column
//     scale, then the residual (wo, wd), SwiGLU over matching gate and up
//     columns (the tile holds both), qkv's per-head RMSNorm and rope, or
//     the plain product. The launch is cooperative, so all of a grid's
//     blocks are resident at once and the wait always ends. The tickets are
//     one buffer a device: the device's int8 products run on one stream.
//   B10-out is four launches (wo, the norm of x2, gate|up, wd), B10-qkv two
//   (the norm, the product) and the bare product one.
// * B7 runs on the same kernel: i8_stream takes its weight type from its
//   epilogue, and I8_ROUTER streams bf16 (64 columns a 128-byte box row, no
//   widening, the same 8 KB ring stages). What bounds B7: the weight bytes
//   (16.8 MB of wo and 0.5 MB of router at qwen3-30b-a3b, B FLOP a byte).
//   What held its first port back was not the product but a chain of five
//   launches passing float32 partial sums through memory (each launch of
//   such a chain waits ~1.5 us for its first stage and ends 3-5 us after its
//   last; PERF.md). The design is one cooperative launch, one block an SM
//   (scripts/trace_b7.py times each step of it):
//   - phase 1, wo: B10's stream-K walk (TMA ring), but every block leaves
//     each of its segments' sums (two at most at these widths) in a slot
//     of its own: a tile spans ~8 blocks at these widths, and a block that
//     finished a tile in B10's way summed ~8 slots alone, latency bound
//     (5 us at B = 16, 13 us at B = 64);
//   - the router is prefetched: each block of phase 2 loads its 8 expert
//     columns of it (E rows of 16 bytes) by TMA into its own shared memory
//     once its wo loads are issued (issued first, they held the first wo
//     stages back ~2 us), so they land during the stream's tail;
//   - a grid-wide barrier (one 64-bit arrival count that only grows, read
//     at the launch's start for its base; sound since a cooperative grid is
//     all resident; one release fence a block, not one a thread; arrival
//     and wait apart, so that the index work of what follows needs no wait),
//     then every warp of the grid finishes (row, tile) units: x2
//     = bf16(x + the tile's slots in block order) and the sum of squares of
//     the rounded x2 over the tile's 128 columns into the unit's own slot
//     (b7_x2), and a second barrier;
//   - phase 2: the block of (8 expert columns, B * bands / grid rows, at
//     most 16) forms each row's 1/rms from the unit slots in tile order,
//     normalises its x2 rows into an hn tile in shared memory (writing its
//     band's share of the columns out: each hn element once) and
//     multiplies them by its router columns over the whole K on mma.sync:
//     each logit is summed by one block in one fixed order, with no float
//     atomics, so the engine's top-k sees the same logits for the same
//     inputs. Its loops divide no index: at 4 warps a block, runtime
//     divisions cost ~1 us a step. (Splitting K over 8 slices a band and
//     letting the last slice to arrive add the 8 partials cost ~2.5 us
//     more; running the two phases as two launches was slower at B = 1,
//     16 and 64: PERF.md.)
//   It takes every width the other kernels take (E % 128, any NE % 8, any
//   SM count): the grid is always the card's SMs, a block whose share is
//   empty (wo smaller than the grid) leaves a zero slot, the slots a tile
//   spans are added in batches, phase 2's (band, row group) items beyond
//   the grid are walked by the blocks in turn and K in chunks of B7_KC
//   rows, each (item, chunk) after a block's first loading its router
//   columns itself. At qwen3-30b-a3b and qwen3-235b-a22b widths every
//   block has one item and one chunk, all prefetched, and that phase 2 is
//   compiled as a kernel of its own (I8_ROUTER; the general one is
//   I8_ROUTER_ANY): with both in one kernel, B = 64 took 4-12 % longer.
//   Above 64 rows the wrapper runs groups of 64.
//
// * B3 (and B11's fused_qkv) stays the three launches above; its epilogue
//   reads cos / sin as float32 or bf16 (widening is exact), so B11's bf16
//   tables need no cast launches. Three one- and two-launch designs were
//   built and measured slower than the chain at B = 16 and 64 (PERF.md, PR
//   11): one launch of i8_stream over bf16 weights (the input norm split
//   over the grid behind a grid barrier, the A fragments normalised in
//   registers; its stream alone, with the norm, the conversion and the
//   epilogue left out, only matched the chain), the same ring loaded by
//   the consumers with cp.async, and gemm_partial whose last block of
//   each tile ran the epilogue.
//
// Interface: plain C, raw pointers, launched on the caller's stream; no
// allocation (the wrapper passes outputs and scratch); each entry returns the
// cudaGetLastError() code of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma (the grouped expert prefill kernel)

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 128;    // output columns per block: 4 warps x 32
constexpr int GT = 128;      // threads per product block
constexpr int KT = 32;       // k rows per pipeline stage
constexpr int STAGES = 4;    // cp.async ring depth
constexpr int WROW = TILE + 8;  // padded weight-tile row (272 B: ldmatrix without bank conflicts)
constexpr int AROW = KT + 8;    // padded activation-tile row (80 B)
constexpr int MAX_ROWS = 64;    // rows one block covers (MT = 4 m-tiles)
constexpr int HEAD = 128;    // head_dim the q/k epilogue is written for
constexpr int NT = 256;      // threads of the row kernels

inline unsigned cdiv(long long a, long long b) { return (unsigned)((a + b - 1) / b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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

// xn[r, :] = bf16(X[r, :] * rsqrt(mean(X[r, :]^2) + eps) * ln), one block a
// row of norm_rows' threads (K % 8 == 0). A thread loads its first 8-value
// chunk of X and of ln before the block's sum and keeps both in registers,
// so up to K = 8192 (every model width) X is read once and the row's
// latency is one load, one block sum and one store: at decode batch that
// latency is the kernel's time. Wider rows read the rest of X twice.
__device__ __forceinline__ void norm_put(bf16* out, int c, const uint4& x, const uint4& w,
                                         float inv) {
  float f[8], g[8];
  bf16x8_to_float(x, f);
  bf16x8_to_float(w, g);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __float2bfloat16((f[i] * inv) * g[i]);
  *reinterpret_cast<uint4*>(out + 8 * c) = *reinterpret_cast<const uint4*>(o);
}

__device__ __forceinline__ float sum_sq8(const uint4& x) {
  float f[8], ss = 0.f;
  bf16x8_to_float(x, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
  return ss;
}

__global__ void __launch_bounds__(1024)
rms_norm_rows(const bf16* __restrict__ X, const bf16* __restrict__ ln, int K,
              float eps, bf16* __restrict__ XN) {
  __shared__ float part[32];
  const bf16* xr = X + (long long)blockIdx.x * K;
  bf16* out = XN + (long long)blockIdx.x * K;
  const int n8 = K / 8, nt = blockDim.x, c0 = threadIdx.x;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const uint4 xv = c0 < n8 ? *reinterpret_cast<const uint4*>(xr + 8 * c0) : zero;
  const uint4 wv = c0 < n8 ? *reinterpret_cast<const uint4*>(ln + 8 * c0) : zero;
  float ss = sum_sq8(xv);
  for (int c = c0 + nt; c < n8; c += nt) ss += sum_sq8(*reinterpret_cast<const uint4*>(xr + 8 * c));
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nt / 32; ++w) t += part[w];
  const float inv = rsqrtf(t / (float)K + eps);
  if (c0 < n8) norm_put(out, c0, xv, wv, inv);
  for (int c = c0 + nt; c < n8; c += nt)
    norm_put(out, c, *reinterpret_cast<const uint4*>(xr + 8 * c),
             *reinterpret_cast<const uint4*>(ln + 8 * c), inv);
}

// rms_norm_rows over B rows of K: one thread an 8-value chunk, at most 1024
void norm_rows(const bf16* X, const bf16* ln, int B, int K, float eps, bf16* XN,
               cudaStream_t st) {
  int nt = (K / 8 + 31) / 32 * 32;
  nt = nt < 32 ? 32 : nt > 1024 ? 1024 : nt;
  rms_norm_rows<<<B, nt, 0, st>>>(X, ln, K, eps, XN);
}

template <int MT>
constexpr int gemm_smem_bytes() {
  return (STAGES * KT * WROW + STAGES * MT * 16 * AROW) * (int)sizeof(bf16);
}

// P[z, r, n] = sum_{k in [z*kps, (z+1)*kps)} X[r, k] * W[k, n] for the rows
// r0 = blockIdx.z * MAX_ROWS ... (MT*16 of them, rows >= B read as zeros);
// W is bf16.
// grid: (N/TILE, splits, ceil(B/MAX_ROWS)); block: GT threads.
template <int MT>
__global__ void __launch_bounds__(GT)
gemm_partial(const bf16* __restrict__ X, const bf16* __restrict__ W,
             float* __restrict__ P, int B, int K, int N, int kps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);               // [STAGES or 1][KT][WROW]
  bf16* as = ws + STAGES * KT * WROW;                     // [STAGES][MT*16][AROW]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * TILE;
  const int kb = blockIdx.y * kps;
  const int rb = blockIdx.z * MAX_ROWS;
  const int nk = kps / KT;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kb + kt * KT;
    bf16* wdst = ws + stage * KT * WROW;
    for (int i = threadIdx.x; i < KT * (TILE / 8); i += GT) {
      const int r = i / (TILE / 8), c = (i % (TILE / 8)) * 8;
      cp_async16(wdst + r * WROW + c, W + (long long)(k0 + r) * N + col0 + c, 16);
    }
    bf16* adst = as + stage * MT * 16 * AROW;
    for (int i = threadIdx.x; i < MT * 16 * (KT / 8); i += GT) {
      const int r = i / (KT / 8), c = (i % (KT / 8)) * 8;
      const int gr = rb + r;
      const bool ok = gr < B;
      cp_async16(adst + r * AROW + c, X + (long long)(ok ? gr : 0) * K + k0 + c,
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

  // ldmatrix lane roles: lane supplies row (lane % 8) of 8x8 matrix (lane / 8)
  const int mi = lane >> 3, rr = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt-1 is consumed
    {
      const int nt = kt + STAGES - 1;
      if (nt < nk) load_stage(nt % STAGES, nt);
      cp_async_commit();
    }
    const bf16* wst = ws + (kt % STAGES) * KT * WROW;
    const bf16* ast = as + (kt % STAGES) * MT * 16 * AROW;
#pragma unroll
    for (int kk = 0; kk < KT; kk += 16) {
      // B fragments of this warp's 4 n-blocks: matrices (k lo, nb), (k hi, nb),
      // (k lo, nb+1), (k hi, nb+1) per ldmatrix.x4.trans
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int krow = kk + rr + 8 * (mi & 1);
        const int ncol = warp * 32 + (2 * h + (mi >> 1)) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, wst + krow * WROW + ncol);
        b[2 * h][0] = r[0];
        b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2];
        b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, ast + (m * 16 + rr + 8 * (mi & 1)) * AROW + kk + 8 * (mi >> 1));
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[m][nb], a, b[nb]);
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int col = col0 + warp * 32 + nb * 8 + c2;
      const int r0 = rb + m * 16 + g, r1 = r0 + 8;
      if (r0 < B)
        *reinterpret_cast<float2*>(P + ((long long)blockIdx.y * B + r0) * N + col) =
            make_float2(acc[m][nb][0], acc[m][nb][1]);
      if (r1 < B)
        *reinterpret_cast<float2*>(P + ((long long)blockIdx.y * B + r1) * N + col) =
            make_float2(acc[m][nb][2], acc[m][nb][3]);
    }
  }
}

template <int MT>
void launch_gemm_mt(const bf16* X, const bf16* W, float* P, int B, int K, int N,
                    int splits, cudaStream_t st) {
  constexpr int bytes = gemm_smem_bytes<MT>();
  if (bytes > 48 * 1024) {
    static bool attr_set = false;  // the opt-in above 48 KB, once per process
    if (!attr_set) {
      cudaFuncSetAttribute(gemm_partial<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
      attr_set = true;
    }
  }
  gemm_partial<MT><<<dim3(N / TILE, splits, cdiv(B, MAX_ROWS)), GT, bytes, st>>>(
      X, W, P, B, K, N, K / splits);
}

// ---------------------------------------------- gemm_tc: the wgmma form
//
// P[z, r, n] = sum over k-slice z of X[r, k] * W[k, n] for all rows r < B
// in one pass over the weights (up to GMAX_ROWS rows a launch; notes at
// the head of the file). A persistent grid (at most one block an SM) over
// the items (128-column weight tile t, k-slice z), item w = z * tiles + t,
// block b taking items b, b + grid, ...; slice z covers the 64-row k stages
// [z * nk / splits, (z + 1) * nk / splits). One producer thread issues TMA
// loads of each stage (the row boxes of X [B, K] and a 64 x 128 weight
// tile, 128-byte swizzle) into an mbarrier ring and runs ahead into its
// next item; the consumer warpgroups multiply on wgmma m64n128k16 (X
// K-major as A, the weight tile MN-major as B) and write their float32
// sums to P straight from the accumulators. MB 64-row boxes a stage (1, 2
// or 4: the rows of the call rounded up to 64); box i belongs to consumer
// warpgroup i % cw, so both take rows from 65 rows on; a box with no row
// of the call is neither loaded nor multiplied. The ring is 192 KB
// whatever MB is: 8, 6 or 4 stages.
constexpr int GBK = 64;                  // k a stage: one 128-byte swizzle atom of bf16
constexpr int GBN = 128;                 // weight columns a tile
constexpr int GBOX = 64 * 128;           // bytes of a 64 x 64 bf16 box
constexpr int GRING = 196608;            // bytes of the ring
constexpr int GMAX_ROWS = 256;           // rows a launch holds
template <int MB>
struct GemmTc {
  static constexpr int cw = MB < 2 ? 1 : 2;           // consumer warpgroups
  static constexpr int subs = MB / cw;                 // 64-row boxes a consumer warpgroup
  static constexpr int threads = (cw + 1) * 128;       // + the producer warpgroup
  static constexpr int stage = MB * GBOX + 2 * GBOX;   // row boxes + a weight tile
  static constexpr int stages = GRING / stage;
  static constexpr int smem = 1024 + stages * stage + 16 * stages;
};
static_assert(GemmTc<4>::smem <= 232448 && GemmTc<1>::smem <= 232448,
              "gemm_tc's shared memory exceeds a block's");

// tx over X [B, K], tw over W [K, N] (bf16, 128-byte swizzle); this launch
// takes rows row0 .. row0 + rows - 1 (rows <= 64 * MB) into P [splits, B, N]
template <int MB>
__global__ void __launch_bounds__(GemmTc<MB>::threads, 1)
gemm_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
        float* __restrict__ P, int B, int row0, int rows, int N, int nk, int splits) {
  using G = GemmTc<MB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::stages * G::stage);
  uint64_t* empty = full + G::stages;
  const int tid = threadIdx.x, lane = tid & 31, wg = tid / 128;
  const int tiles = N / GBN, items = tiles * splits;
  const int nbox = (rows + 63) / 64;
  if (tid == 0) {
    for (int s = 0; s < G::stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * G::cw);   // every consumer warp releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == G::cw) {
    // ---- producer: one thread issues every TMA load
    if constexpr (G::cw == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 128 * G::cw) {
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int t = w % tiles, z = w / tiles;
        const int k1 = (z + 1) * nk / splits;
        for (int kt = z * nk / splits; kt < k1; ++kt, ++it) {
          const int s = it % G::stages;
          if (it >= G::stages) mbar_wait(&empty[s], (it / G::stages - 1) & 1);
          unsigned char* a = smem + s * G::stage;
          mbar_expect_tx(&full[s], (nbox + 2) * GBOX);
          for (int i = 0; i < nbox; ++i)
            tma_load_2d(a + i * GBOX, &tx, &full[s], kt * GBK, row0 + 64 * i);
          for (int c = 0; c < 2; ++c)
            tma_load_2d(a + (MB + c) * GBOX, &tw, &full[s], t * GBN + c * 64, kt * GBK);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg multiplies boxes wg, wg + cw, ...
    if constexpr (G::cw == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wq = (tid >> 5) & 3, c2 = (lane & 3) * 2;
    const int mine = nbox > wg ? (nbox - wg + G::cw - 1) / G::cw : 0;   // boxes with rows
    float acc[G::subs][64];
    int it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int t = w % tiles, z = w / tiles;
      const int k0 = z * nk / splits, k1 = (z + 1) * nk / splits;
      for (int kt = k0; kt < k1; ++kt, ++it) {
        const int s = it % G::stages;
        mbar_wait(&full[s], (it / G::stages) & 1);
        if (mine > 0) {
          const unsigned char* a = smem + s * G::stage;
          const unsigned char* b = a + MB * GBOX;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < GBK / 16; ++kk) {
            const uint64_t db = sw128_desc(b + kk * 16 * 128, GBOX, 1024);
#pragma unroll
            for (int j = 0; j < G::subs; ++j)
              if (j < mine)
                wgmma_ss_n128_tb(acc[j],
                                 sw128_desc(a + (j * G::cw + wg) * GBOX + kk * 32, 16, 1024),
                                 db, kt > k0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();   // this stage is read: release it at once
        }
        if (lane == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int j = 0; j < G::subs; ++j) fence_regs(acc[j]);
      // the sums: row 16*wq + lane/4 (+8) of box j*cw + wg, columns 8i + c2
#pragma unroll
      for (int j = 0; j < G::subs; ++j) {
        if (j >= mine) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = (j * G::cw + wg) * 64 + 16 * wq + (lane >> 2) + 8 * half;
          if (r < rows) {
            float* dst = P + ((long long)z * B + row0 + r) * N + t * GBN + c2;
#pragma unroll
            for (int i = 0; i < 16; ++i)
              *reinterpret_cast<float2*>(dst + 8 * i) =
                  make_float2(acc[j][4 * i + 2 * half], acc[j][4 * i + 2 * half + 1]);
          }
        }
      }
    }
  }
}

template <int MB>
void launch_gemm_tc_mb(const CUtensorMap& tx, const CUtensorMap& tw, float* P, int B, int row0,
                       int rows, int N, int nk, int splits, int grid, cudaStream_t st) {
  using G = GemmTc<MB>;
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(gemm_tc<MB>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem);
    attr_set = true;
  }
  gemm_tc<MB><<<grid, G::threads, G::smem, st>>>(tx, tw, P, B, row0, rows, N, nk, splits);
}

// the wgmma form over `grid` persistent blocks (fewer where the items are
// fewer), a launch a GMAX_ROWS rows; K % 64 == 0, N % 128 == 0, whole
// k-slices of at least one stage
int launch_gemm_tc(const bf16* X, const bf16* W, float* P, int B, int K, int N, int splits,
                   int grid, cudaStream_t st) {
  const int nk = K / GBK;
  if (K % GBK || N % GBN || splits < 1 || splits > nk || B < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const cuuint64_t xdim[2] = {(cuuint64_t)K, (cuuint64_t)B}, xstride[1] = {(cuuint64_t)K * 2};
  const cuuint64_t wdim[2] = {(cuuint64_t)N, (cuuint64_t)K}, wstride[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {64, 64};
  if (!bf16_map(&tx, X, 2, xdim, xstride, box) || !bf16_map(&tw, W, 2, wdim, wstride, box))
    return (int)cudaErrorInvalidValue;
  const int g = grid < (N / GBN) * splits ? grid : (N / GBN) * splits;
  for (int r0 = 0; r0 < B; r0 += GMAX_ROWS) {
    const int rows = B - r0 < GMAX_ROWS ? B - r0 : GMAX_ROWS;
    if (rows <= 64) launch_gemm_tc_mb<1>(tx, tw, P, B, r0, rows, N, nk, splits, g, st);
    else if (rows <= 128) launch_gemm_tc_mb<2>(tx, tw, P, B, r0, rows, N, nk, splits, g, st);
    else launch_gemm_tc_mb<4>(tx, tw, P, B, r0, rows, N, nk, splits, g, st);
  }
  return 0;
}

// one bf16 product into float32 partial sums P [splits, B, N]: the wgmma
// form over `grid` blocks (grid > 0), else gemm_partial, the fewest 16-row
// m-tiles that cover B (up to 4) and a block a 64-row group
int launch_gemm(const bf16* X, const bf16* W, float* P, int B, int K, int N, int splits,
                int grid, cudaStream_t st) {
  if (grid > 0) return launch_gemm_tc(X, W, P, B, K, N, splits, grid, st);
  if (B <= 16) launch_gemm_mt<1>(X, W, P, B, K, N, splits, st);
  else if (B <= 32) launch_gemm_mt<2>(X, W, P, B, K, N, splits, st);
  else launch_gemm_mt<4>(X, W, P, B, K, N, splits, st);
  return 0;
}

// a cos / sin value: element i of a float32 or (is_bf16) bf16 table
__device__ __forceinline__ float ld_cs(const void* t, int i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(t)[i])
                 : static_cast<const float*>(t)[i];
}

// B3 epilogue: one block per (row, head) of HEAD threads. q heads (< H) and
// k heads (< H+KV) get RMSNorm with q_norm / k_norm then rotate-half RoPE;
// v heads pass through. Sections are told apart by head index, as the TPU
// kernel does by column (fused_layer.py:265-279). cos / sin [B, 64] are
// float32, or bf16 where cs_bf16.
__global__ void __launch_bounds__(HEAD)
qkv_epilogue(const float* __restrict__ P, int S, int B, int C,
             const bf16* __restrict__ qn, const bf16* __restrict__ kn,
             const void* __restrict__ cosv, const void* __restrict__ sinv, int cs_bf16,
             bf16* __restrict__ out, int H, int KV, float eps) {
  __shared__ float part[HEAD / 32];
  __shared__ float nrm[HEAD];
  const int b = blockIdx.x, head = blockIdx.y, j = threadIdx.x;
  const int col = head * HEAD + j;
  float y = 0.f;
  for (int s = 0; s < S; ++s) y += P[((long long)s * B + b) * C + col];
  if (head >= H + KV) {  // v: uniform across the block, so no barrier is skipped
    out[(long long)b * C + col] = __float2bfloat16(y);
    return;
  }
  const float ss = warp_sum(y * y);
  if ((j & 31) == 0) part[j >> 5] = ss;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < HEAD / 32; ++w) t += part[w];
  const bf16* wn = head < H ? qn : kn;
  const float n = (y * rsqrtf(t / (float)HEAD + eps)) * __bfloat162float(wn[j]);
  nrm[j] = n;
  __syncthreads();
  constexpr int HALF = HEAD / 2;
  float o;
  const int jc = b * HALF + (j < HALF ? j : j - HALF);
  const float c = ld_cs(cosv, jc, cs_bf16), sn = ld_cs(sinv, jc, cs_bf16);
  if (j < HALF) {
    o = n * c - nrm[j + HALF] * sn;
  } else {
    o = n * c + nrm[j - HALF] * sn;
  }
  out[(long long)b * C + col] = __float2bfloat16(o);
}

// out[b, n] = bf16(res[b, n] + sum_s P[s, b, n]); res null: no residual
__global__ void __launch_bounds__(256)
residual_epilogue(const float* __restrict__ P, int S, int B, int N,
                  const bf16* __restrict__ res, bf16* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long total = (long long)B * N;
  if (i >= total) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += P[(long long)s * total + i];
  out[i] = __float2bfloat16(res ? __bfloat162float(res[i]) + acc : acc);
}

// h[b, f] = bf16(silu(g) * u) with g = sum_s Pg[s*sstride + b*ld + f] and u
// the same over Pu (B4: Pu = Pg + F in 2F-wide rows; B8: two [S,B,F]
// blocks)
__global__ void __launch_bounds__(256)
swiglu_epilogue(const float* __restrict__ Pg, const float* __restrict__ Pu,
                long long sstride, int ld, int S, int B, int F, bf16* __restrict__ h) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)B * F) return;
  const long long b = i / F, f = i % F;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long off = s * sstride + b * ld + f;
    g += Pg[off];
    u += Pu[off];
  }
  const float silu = g / (1.f + __expf(-g));
  h[i] = __float2bfloat16(silu * u);
}

// ------------------------------------------------------- grouped expert FFN
//
// The GPU counterpart of the three lax.ragged_dot calls of
// _expert_ffn_ragged (deepsearch_tts_tpu/ops/moe.py:81) over expert-sorted
// rows: rows offsets[e] .. offsets[e+1]-1 of X belong to expert e.
//   SWIGLU = true   h = bf16(silu(bf16(X @ Wg[e])) * bf16(X @ Wu[e]))
//   SWIGLU = false  y = bf16(X @ W[e])
// (the bf16 roundings of g and u are ragged_dot's bf16 results).
//
// What bounds it: the expert weights. At a 16-row decode step a layer of
// qwen3-30b-a3b touches ~81 of its 128 experts, 9.4 MB each (0.76 GB a
// layer, 37 GB a step), against 1-2 rows per touched expert: B FLOP per
// weight byte, far below the ridge, so the goal is streaming each touched
// expert's weights once at HBM rate. At prefill (~190 rows an expert at 3000
// tokens) the same launch loops over 64-row tiles and reads each weight tile
// once per row tile, mostly from L2.
//
// Design: the gemm_partial pieces above (4-stage cp.async ring of 32-row
// weight tiles, ldmatrix, mma.sync m16n8k16 bf16 -> float32), one block per
// (column tile, expert, row split). The group offsets stay on the device: a
// block reads its expert's two offsets and returns at once when the expert
// has no rows, so no host ever learns the group sizes. The weight pointer is
// offset by the expert; m-tiles past the tile's rows are neither loaded nor
// multiplied. SWIGLU blocks hold 64 gate columns and the same 64 up columns
// (warps 0-1 gate, 2-3 up) and meet in shared memory for the epilogue.
// grid: (column tiles, NE, row splits); block: GT threads.
constexpr int GROUP_MT = MAX_ROWS / 16;
constexpr int BROW = TILE + 4;   // float row of the SwiGLU epilogue buffer

template <bool SWIGLU>
__global__ void __launch_bounds__(GT)
grouped_expert(const bf16* __restrict__ X, const int* __restrict__ offsets,
               const bf16* __restrict__ W0, const bf16* __restrict__ W1,
               long long es, int ldw, int K, bf16* __restrict__ out, int ldo) {
  constexpr int MT = GROUP_MT;
  constexpr int HALF = TILE / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);               // [STAGES][KT][WROW]
  bf16* as = ws + STAGES * KT * WROW;                     // [STAGES][MAX_ROWS][AROW]
  const int e = blockIdx.y;
  const int first = offsets[e], end = offsets[e + 1];
  const int n0 = blockIdx.x * (SWIGLU ? HALF : TILE);
  // columns [0, 64) of the block's weight tile come from seg0, [64, 128) from seg1
  const bf16* seg0 = W0 + (long long)e * es + n0;
  const bf16* seg1 = SWIGLU ? W1 + (long long)e * es + n0 : seg0 + HALF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = K / KT;
  const int mi = lane >> 3, rr = lane & 7;      // ldmatrix lane roles
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // accumulator lane roles

  for (int rb = first + blockIdx.z * MAX_ROWS; rb < end; rb += gridDim.z * MAX_ROWS) {
    const int rows = min(MAX_ROWS, end - rb);
    const int mt_used = (rows + 15) / 16;

    auto load_stage = [&](int stage, int kt) {
      const int k0 = kt * KT;
      bf16* wdst = ws + stage * KT * WROW;
      for (int i = threadIdx.x; i < KT * (TILE / 8); i += GT) {
        const int r = i / (TILE / 8), c = (i % (TILE / 8)) * 8;
        const bf16* src = (c < HALF ? seg0 + c : seg1 + (c - HALF)) + (long long)(k0 + r) * ldw;
        cp_async16(wdst + r * WROW + c, src, 16);
      }
      bf16* adst = as + stage * MAX_ROWS * AROW;
      for (int i = threadIdx.x; i < mt_used * 16 * (KT / 8); i += GT) {
        const int r = i / (KT / 8), c = (i % (KT / 8)) * 8;
        const bool ok = r < rows;
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
      const bf16* wst = ws + (kt % STAGES) * KT * WROW;
      const bf16* ast = as + (kt % STAGES) * MAX_ROWS * AROW;
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        uint32_t b[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int krow = kk + rr + 8 * (mi & 1);
          const int ncol = warp * 32 + (2 * h + (mi >> 1)) * 8;
          uint32_t r[4];
          ldmatrix_x4_trans(r, wst + krow * WROW + ncol);
          b[2 * h][0] = r[0];
          b[2 * h][1] = r[1];
          b[2 * h + 1][0] = r[2];
          b[2 * h + 1][1] = r[3];
        }
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

    if (SWIGLU) {
      float* buf = reinterpret_cast<float*>(smem);        // [MAX_ROWS][BROW]
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mt_used) {
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int c = warp * 32 + nb * 8 + c2, r0 = m * 16 + g;
            buf[r0 * BROW + c] = acc[m][nb][0];
            buf[r0 * BROW + c + 1] = acc[m][nb][1];
            buf[(r0 + 8) * BROW + c] = acc[m][nb][2];
            buf[(r0 + 8) * BROW + c + 1] = acc[m][nb][3];
          }
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < rows * HALF; i += GT) {
        const int r = i / HALF, c = i % HALF;
        const float gt = __bfloat162float(__float2bfloat16(buf[r * BROW + c]));
        const float u = __bfloat162float(__float2bfloat16(buf[r * BROW + HALF + c]));
        out[(long long)(rb + r) * ldo + n0 + c] = __float2bfloat16(gt / (1.f + __expf(-gt)) * u);
      }
      __syncthreads();  // the buffer is the next row tile's ring
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < mt_used) {
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            const int col = n0 + warp * 32 + nb * 8 + c2;
            const int r0 = m * 16 + g, r1 = r0 + 8;
            if (r0 < rows)
              *reinterpret_cast<__nv_bfloat162*>(out + (long long)(rb + r0) * ldo + col) =
                  __floats2bfloat162_rn(acc[m][nb][0], acc[m][nb][1]);
            if (r1 < rows)
              *reinterpret_cast<__nv_bfloat162*>(out + (long long)(rb + r1) * ldo + col) =
                  __floats2bfloat162_rn(acc[m][nb][2], acc[m][nb][3]);
          }
        }
      }
    }
  }
}

template <bool SWIGLU>
int launch_grouped(const void* x, const void* offsets, const bf16* w0, const bf16* w1,
                   long long es, int ldw, int K, int col_tiles, int NE, int zsplit,
                   void* out, int ldo, cudaStream_t st) {
  constexpr int bytes = gemm_smem_bytes<GROUP_MT>();
  static_assert(MAX_ROWS * BROW * (int)sizeof(float) <= bytes,
                "the SwiGLU epilogue buffer must fit in the ring");
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(grouped_expert<SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  grouped_expert<SWIGLU><<<dim3(col_tiles, NE, zsplit), GT, bytes, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(offsets), w0, w1, es, ldw, K,
      static_cast<bf16*>(out), ldo);
  return (int)cudaGetLastError();
}

// ------------------------------------------- grouped expert FFN, prefill
//
// The same two functions at prefill, where an expert gets ~190 rows (3072
// tokens x top-8 over 128 experts) and the products are no longer thin: the
// decode kernel above re-reads each weight tile once per 64-row tile, on
// mma.sync, at 14 % of the bf16 tensor peak. What bounds the prefill: the
// bytes of every touched expert's weights (0.8 GB a gate|up call at
// qwen3-30b-a3b: 0.24 ms at 3.35 TB/s) and the tensor operations (155
// GFLOP: 0.16 ms at 989 TFLOP/s) are within 2x of each other, so the
// weights must stream from HBM once while the tensor cores keep up. The
// design, as K2's (attention.cu):
// * a tile is up to 256 expert-sorted rows by 128 weight columns, so an
//   expert of up to 256 rows reads each weight tile once, in one block:
//   each weight stage feeds every row of the expert from shared memory.
//   (128-row tiles read each weight tile in two blocks and count on L2 for
//   the second read; a block whose tile holds 64 rows runs ahead of its
//   twin, the two fall out of step and both read HBM.)
//   SWIGLU holds 64 gate columns and the same 64 up columns, so the SwiGLU
//   epilogue stays in registers (gate column c at acc[j][i], up column c at
//   acc[j][32 + i]);
// * two consumer warpgroups of 128 rows each, two wgmma m64n128k16
//   accumulators a warpgroup (128 float32 registers a thread); an m64
//   sub-tile with no row of the expert is neither loaded nor multiplied;
// * a persistent grid (one block an SM) over a flat list of work items
//   (expert, n-tile, m-tile), built by every block on the device from
//   `offsets` (no host sync, CUDA-graph safe): expert e owns ceil(rows_e /
//   256) m-tiles; its n-tiles run on neighbouring blocks at once, so its
//   rows are read from HBM once and from L2 after;
// * a producer warpgroup (setmaxnreg 40; the consumers 232, from ptxas'
//   168 at entry): one thread issues every TMA load into a 4-stage
//   full / empty mbarrier ring (128-byte swizzle) and runs ahead into the
//   next item while the consumers finish one; x_sorted comes in as a 2-D map
//   [S, K] in 64-row boxes, the weights as 3-D maps over [NE, K, N] (N
//   contiguous: the MN-major B operand, as K2's V), the packed [NE, E, 2F]
//   gate|up layout through two maps at base offsets 0 and F, the unpacked
//   pair through two maps;
// * a box that runs past an expert's last row reads the next expert's rows
//   (or zeros past S). That is harmless only because the epilogue stores no
//   row at or past offsets[e+1]: a row's products never mix with another's.
//   The epilogue goes through shared memory, 8 rows a warp at a time, and
//   leaves as whole rows in 16-byte stores (4-byte stores straight from the
//   accumulators left y's writes the largest cost of the down entry).
// What bounds it now (scripts/trace_grouped_prefill.py, PERF.md): a ring
// stage's time is mostly the tensor cores running its wgmma products, at
// about half their peak, while the producer waits for free stages; the
// consumers rarely wait for data.
// The wrapper (ops/moe.py grouped_prefill) takes this kernel or the decode
// one from static sizes only (S = T*top_k, NE).
constexpr int XBM = 256;              // expert-sorted rows a tile
constexpr int XBN = 128;              // weight columns a tile
constexpr int XBK = 64;               // k a stage: one 128-byte swizzle atom of bf16
constexpr int XTH = 384;              // two consumer warpgroups + the producer warpgroup
constexpr int XSTAGES = 4;            // ring depth
constexpr int XBOX = 64 * 128;        // bytes of one 64 x 64 box
constexpr int XA = 4 * XBOX;          // a row stage: four 64-row boxes
constexpr int XB = 2 * XBOX;          // a weight stage: two 64-column boxes
constexpr int XMAX_NE = 1024;         // experts the tile table holds
constexpr int XTAB = XMAX_NE + 4;     // ints of one table (16-byte multiple)

// a tile's output columns (h: 64, y: 128) and the padded bf16 row of the
// epilogue's staging rows (16 bytes of padding: the accumulator writes are
// free of bank conflicts)
template <bool SWIGLU>
struct XTile {
  static constexpr int cols = SWIGLU ? XBN / 2 : XBN;
  static constexpr int erow = cols + 8;
};

template <bool SWIGLU>
constexpr int xpre_smem_bytes() {
  return 1024                                       // slack: the tiles start 1024-byte aligned
         + XSTAGES * (XA + XB)                      // the ring
         + 8 * 2 * XSTAGES                          // mbarriers
         + (2 * XTAB + 16) * 4                      // row offsets, m-tile cumsum, scan scratch
         + 8 * 8 * XTile<SWIGLU>::erow * 2;         // 8 staging rows for each consumer warp
}
static_assert(xpre_smem_bytes<true>() <= 232448 && xpre_smem_bytes<false>() <= 232448,
              "the grouped expert prefill kernel's shared memory exceeds a block's");

// silu(g) * u with the fast division: the whole tile's SwiGLU runs between
// two items with the tensor cores idle, and IEEE division made it a large
// share of an item (bf16 output: the division's 2 ulp do not show)
__device__ __forceinline__ float swiglu_fast(float g, float u) {
  return __fdividef(g, 1.f + __expf(-g)) * u;
}

// grid: the card's SMs; XTH threads. SWIGLU: tw0 / tw1 are the gate / up
// maps and n-tile t covers h columns t*64 .. t*64 + 63; else tw0 is W and
// n-tile t covers y columns t*128 .. t*128 + 127.
template <bool SWIGLU>
__global__ void __launch_bounds__(XTH, 1)
grouped_expert_tc(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw0,
                  const __grid_constant__ CUtensorMap tw1, const int* __restrict__ offsets,
                  int NE, int K, int n_tiles, bf16* __restrict__ out, int ldo) {
  constexpr int NCOL = XTile<SWIGLU>::cols, EROW = XTile<SWIGLU>::erow;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* as = smem;                                  // [XSTAGES] row stages
  unsigned char* bs = as + XSTAGES * XA;                     // [XSTAGES] weight stages
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + XSTAGES * XB);
  uint64_t* empty = full + XSTAGES;
  int* off = reinterpret_cast<int*>(empty + XSTAGES);       // [NE + 1] row offsets
  int* cum = off + XTAB;                                     // [NE + 1] m-tiles before e
  int* wtot = cum + XTAB;                                    // [12] scan scratch
  bf16* epi = reinterpret_cast<bf16*>(wtot + 16);           // [8 warps][8][EROW] staging
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e <= NE; e += XTH) off[e] = offsets[e];
  if (tid == 0) {
    for (int s = 0; s < XSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // every consumer warp releases the stage
    }
    mbar_init_fence();
    cum[0] = 0;
  }
  __syncthreads();
  // cum[e + 1] = m-tiles of experts 0..e: a block-wide scan, XTH experts a pass
  int carry = 0;
  for (int base = 0; base < NE; base += XTH) {
    const int e = base + tid;
    int v = e < NE ? (off[e + 1] - off[e] + XBM - 1) / XBM : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < XTH / 32; ++w) {
      before += w < warp ? wtot[w] : 0;
      total += wtot[w];
    }
    if (e < NE) cum[e + 1] = carry + before + v;
    carry += total;
    __syncthreads();   // wtot is rewritten by the next pass
  }
  const int items = cum[NE] * n_tiles;
  const int nk = K / XBK;
  // work item w -> its expert e (the last with cum[e] * n_tiles <= w: an
  // expert with no rows owns no item), n-tile, first row and row count
  auto item = [&](int w, int& e, int& nt, int& row0, int& rows) {
    int lo = 0, hi = NE - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cum[mid] * n_tiles <= w) lo = mid;
      else hi = mid - 1;
    }
    e = lo;
    const int mt_e = cum[e + 1] - cum[e], local = w - cum[e] * n_tiles;
    nt = local / mt_e;
    row0 = off[e] + (local % mt_e) * XBM;
    rows = min(XBM, off[e + 1] - row0);
  };
  // a consumer warp's release of stage s
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  const int wg = tid / 128;

  if (wg == 2) {
    // ---- producer: registers go to the consumers; one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int it = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        int e, nt, row0, rows;
        item(w, e, nt, row0, rows);
        const int nbox = (rows + 63) / 64;   // 64-row boxes with a row of the expert
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % XSTAGES;
          if (it >= XSTAGES) mbar_wait(&empty[s], (it / XSTAGES - 1) & 1);
          unsigned char* a = as + s * XA;
          unsigned char* b = bs + s * XB;
          mbar_expect_tx(&full[s], nbox * XBOX + XB);
          for (int i = 0; i < nbox; ++i)
            tma_load_2d(a + i * XBOX, &tx, &full[s], kt * XBK, row0 + 64 * i);
          if (SWIGLU) {
            tma_load_3d(b, &tw0, &full[s], nt * 64, kt * XBK, e);
            tma_load_3d(b + XBOX, &tw1, &full[s], nt * 64, kt * XBK, e);
          } else {
            for (int c = 0; c < 2; ++c)
              tma_load_3d(b + c * XBOX, &tw0, &full[s], nt * XBN + c * 64, kt * XBK, e);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 128*wg .. 128*wg + 127 of a
    // tile, as m64 sub-tiles j = 0, 1 (rows 128*wg + 64*j + ...)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wq = (tid >> 5) & 3, c2 = (lane & 3) * 2;
    float acc[2][64];
    int it = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      int e, nt, row0, rows;
      item(w, e, nt, row0, rows);
      const int subs = min(2, max(0, (rows - 128 * wg + 63) / 64));   // sub-tiles with rows
      if (subs == 0) {   // no row of this warpgroup: release each stage as it lands
        for (int kt = 0; kt < nk; ++kt, ++it) {
          mbar_wait(&full[it % XSTAGES], (it / XSTAGES) & 1);
          release(it % XSTAGES);
        }
        continue;
      }
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % XSTAGES;
        mbar_wait(&full[s], (it / XSTAGES) & 1);
        const unsigned char* a = as + s * XA + 2 * wg * XBOX;
        const unsigned char* b = bs + s * XB;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < XBK / 16; ++kk) {
          const uint64_t db = sw128_desc(b + kk * 16 * 128, XBOX, 1024);
          wgmma_ss_n128_tb(acc[0], sw128_desc(a + kk * 32, 16, 1024), db, kt > 0 || kk > 0);
          if (subs == 2)
            wgmma_ss_n128_tb(acc[1], sw128_desc(a + XBOX + kk * 32, 16, 1024), db,
                             kt > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();   // this stage is read: release it at once (the other
        release(s);        // warpgroup's products keep the tensor cores busy)
      }
      fence_regs(acc[0]);
      fence_regs(acc[1]);

      // the epilogue, 8 rows at a time through this warp's staging rows: the
      // accumulators (row 16*wq + lane/4 (+8) of sub-tile j, columns 8i +
      // c2) go in, whole rows come out in 16-byte pieces
      bf16* stage = epi + (wg * 4 + wq) * 8 * EROW;
      bf16* srow = stage + (lane >> 2) * EROW + c2;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= subs) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (SWIGLU) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {   // g and u rounded to bf16 in pairs
              const float* a = &acc[j][4 * i + 2 * half];
              const float2 g = __bfloat1622float2(__floats2bfloat162_rn(a[0], a[1]));
              const float2 u = __bfloat1622float2(__floats2bfloat162_rn(a[32], a[33]));
              *reinterpret_cast<__nv_bfloat162*>(srow + 8 * i) =
                  __floats2bfloat162_rn(swiglu_fast(g.x, u.x), swiglu_fast(g.y, u.y));
            }
          } else {
#pragma unroll
            for (int i = 0; i < 16; ++i)
              *reinterpret_cast<__nv_bfloat162*>(srow + 8 * i) = __floats2bfloat162_rn(
                  acc[j][4 * i + 2 * half], acc[j][4 * i + 2 * half + 1]);
          }
          __syncwarp();
          const int rbase = 128 * wg + 64 * j + 16 * wq + 8 * half;   // the tile rows staged
#pragma unroll
          for (int q = lane; q < NCOL; q += 32) {   // 8 rows x NCOL / 8 pieces
            const int rr = q / (NCOL / 8), cc = (q % (NCOL / 8)) * 8;
            // rows at or past the expert's end (the next expert's, or past
            // S) are never stored
            if (rbase + rr < rows)
              *reinterpret_cast<uint4*>(out + (long long)(row0 + rbase + rr) * ldo +
                                        nt * NCOL + cc) =
                  *reinterpret_cast<const uint4*>(stage + rr * EROW + cc);
          }
          __syncwarp();   // the staging rows are rewritten next
        }
      }
    }
  }
}

// tx over x [S, K]; tw0 (tw1) over the [NE, K, ldw] stack at w0 (w1), its
// first ncols columns
template <bool SWIGLU>
int launch_grouped_tc(const void* x, const void* offsets, const void* w0, const void* w1,
                      int ldw, int ncols, int NE, int K, int S, int grid, void* out, int ldo,
                      cudaStream_t st) {
  if (NE > XMAX_NE || K % XBK || S < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw0, tw1;
  const cuuint64_t xdim[2] = {(cuuint64_t)K, (cuuint64_t)S}, xstride[1] = {(cuuint64_t)K * 2};
  const cuuint64_t wdim[3] = {(cuuint64_t)ncols, (cuuint64_t)K, (cuuint64_t)NE};
  const cuuint64_t wstride[2] = {(cuuint64_t)ldw * 2, (cuuint64_t)K * ldw * 2};
  const cuuint32_t xbox[2] = {XBK, 64}, wbox[3] = {64, XBK, 1};
  if (!bf16_map(&tx, x, 2, xdim, xstride, xbox) || !bf16_map(&tw0, w0, 3, wdim, wstride, wbox) ||
      !bf16_map(&tw1, w1, 3, wdim, wstride, wbox))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = xpre_smem_bytes<SWIGLU>();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(grouped_expert_tc<SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  grouped_expert_tc<SWIGLU><<<grid, XTH, bytes, st>>>(tx, tw0, tw1,
                                                      static_cast<const int*>(offsets), NE, K,
                                                      ncols / XTile<SWIGLU>::cols,
                                                      static_cast<bf16*>(out), ldo);
  return (int)cudaGetLastError();
}

// ------------------------------------- B10: the int8 product (and B7)
//
// i8_stream<TW, MT, EPI>: y = (bf16 X [B, K] @ widened int8 W [K, N]) *
// scales (B7: bf16 W, no scales), float32 sums, then one of five epilogues
// over a tile (EPI):
//   I8_SCALE   out = bf16(y)                          (int8_product)
//   I8_RESID   out = bf16(res + y)                    (wo, wd of B10-out)
//   I8_SWIGLU  h = bf16(silu(y_g) * y_u): the tile holds gate columns
//              128t .. 128t + 127 and the matching up columns F + 128t ..
//   I8_QKV     one head a 128 columns: per-head RMSNorm and rope for q / k
//              heads, v as it is (B10-qkv)
//   I8_ROUTER  B7 over bf16 weights, no scales: each segment's sums into a
//              slot of the block's, then across the grid x2 = bf16(res + y)
//              and its sums of squares (b7_x2), hn and the router logits
//              (router_phase)
// Design notes at the head of the file ("B10", "B7").
// A tile is TW = 128 or 256 columns of WB-byte weights (TW * WB-byte runs
// of each weight row); the host picks TW from the sizes (launch_i8). Per
// TW and WB:
#define I8_TILE_CONSTANTS(TW, WB)                                              \
  constexpr int QTW = TW;               /* columns a tile */                   \
  constexpr int QKT = 8192 / (QTW * WB); /* k rows a stage: 8 KB a stage */    \
  constexpr int QBOX = QTW * WB / QBW;  /* weight boxes a stage */             \
  constexpr int QAB = QKT * 2;          /* bytes an activation row of a stage */ \
  constexpr int QCW = QTW / 32;         /* consumer warps, 32 columns each */  \
  constexpr int QW_STAGE = QKT * QTW * WB; /* bytes of a weight stage */       \
  constexpr int QEROW = QTW + 4;        /* float row of the epilogue tile */   \
  (void)QBOX; (void)QAB; (void)QCW; (void)QW_STAGE; (void)QEROW;
constexpr int QBW = 128;                // bytes a TMA weight box row (its swizzle span)
constexpr int I8_MAX_TILES = 4096;      // tickets a call may use

constexpr int i8_threads(int TW) { return (TW / 32 + 1) * 32; }   // consumers + the producer
enum { I8_SCALE = 0, I8_RESID = 1, I8_SWIGLU = 2, I8_QKV = 3, I8_ROUTER = 4, I8_ROUTER_ANY = 5 };
// B7: I8_ROUTER at the served widths (router_phase<false>), I8_ROUTER_ANY
// at any other (router_phase<true>)
__host__ __device__ constexpr bool i8_b7(int EPI) { return EPI >= I8_ROUTER; }
// bytes a weight: int8, but B7's bf16
__host__ __device__ constexpr int i8_wbytes(int EPI) { return i8_b7(EPI) ? 2 : 1; }
constexpr int RBW = 8;                  // B7: router columns a phase-2 block (one mma n8 block)
constexpr int RROWS = 16;               // B7: most rows a phase-2 item (one mma m-tile)
constexpr int RBOX = 256;               // B7: router rows a TMA box
constexpr int B7_KC = 4096;             // B7: k rows (hn columns) a phase-2 chunk
constexpr int B7_SQT = 32;              // B7: tiles' sums of squares staged at once
// B7: floats of phase 2's scratch (ys): 1/rms, the warps' logits, the sums
// of squares; whole 128 bytes, as the router columns after it are a TMA
// destination
constexpr int B7_SCRATCH = (RROWS + 8 * RROWS * RBW + B7_SQT * RROWS + 31) / 32 * 32;

struct I8Args {
  const float* scales;   // [N] column scales
  const bf16* res;       // I8_RESID: [B, ldo]
  bf16* out;             // [B, ldo]
  const bf16* qn;        // I8_QKV: [128] q / k norm weights, cos / sin [B, 64]
  const bf16* kn;
  const float* cosv;
  const float* sinv;
  float* part;           // [grid][B][QTW] split-K partial sums
  int* tickets;          // [tiles], zero between calls
  long long total;       // tiles * nk stages, split evenly over the grid
  int B, N, nk, ldo, half_n, H, KV, stages;
  float eps;
  // I8_ROUTER (B7): part [grid][segs][B][QTW] the blocks' segment sums;
  // ln2 [N]; hn [B, ldo] out; sq [tiles][B] the (row, tile) sums of
  // squares; logits [B, NE] out; count: the grid barriers' (only grows)
  const bf16* ln;
  bf16* hn;
  float* sq;
  float* logits;
  unsigned long long* count;
  int NE, rpb, segs;   // rpb: rows a phase-2 item (<= RROWS); segs: slots a block
};

// the byte offset of 16-byte chunk c of row r in a tile of rb-byte rows
// that TMA wrote with an rb-byte swizzle (rb = 32, 64 or 128: the chunk
// index XOR address bits 7.. above it)
__device__ __forceinline__ int swz(int r, int c, int rb) {
  return r * rb + ((c ^ (((r * rb) >> 7) & (rb / 16 - 1))) << 4);
}

// shared memory of i8_stream: the ring, the epilogue tile, the ring's
// barriers; B7 (K = the wo rows, E = its columns) instead of the epilogue
// tile a small scratch, and a chunk of its router columns and its hn tile
// of RROWS rows (which reuses the ring: phase 2 no longer needs it), both
// B7_KC rows (columns) at most
__host__ __device__ constexpr int b7_kc(int E) { return E < B7_KC ? E : B7_KC; }
// (hn tile rows of whole 1024 columns, the threads' 8-column chunks of a
// round, + 8: a ragged round's chunks past the K chunk land in the padding)
__host__ __device__ constexpr int b7_hrow(int E) { return (b7_kc(E) + 1023) / 1024 * 1024 + 8; }
__host__ __device__ constexpr int b7_hn_bytes(int E) {
  return (RROWS * b7_hrow(E) * 2 + 127) / 128 * 128;
}
__host__ __device__ constexpr int b7_rs_bytes(int E) {
  return (b7_kc(E) + RBOX - 1) / RBOX * RBOX * RBW * 2;   // whole boxes: TMA fills past E
}

template <int TW, int MT, int EPI>
constexpr int i8_smem_bytes(int stages, int E) {
  I8_TILE_CONSTANTS(TW, i8_wbytes(EPI))
  const int ring = stages * (QW_STAGE + MT * 16 * QAB);
  if (i8_b7(EPI))
    return 1024 + (ring > b7_hn_bytes(E) ? ring : b7_hn_bytes(E)) + B7_SCRATCH * 4 +
           b7_rs_bytes(E) + 16 * stages + 16;
  return 1024 + ring + MT * 16 * QEROW * 4 + 16 * stages;
}

// the block whose share of the (tile, stage) sequence holds stage i: block
// b owns [floor(b * total / G), floor((b + 1) * total / G))
__device__ __forceinline__ int i8_block_of(long long i, long long total, int G) {
  return (int)(((i + 1) * G - 1) / total);
}
__device__ __forceinline__ long long i8_start(int b, long long total, int G) {
  return (long long)b * total / G;
}

// four int8 weights (a 32-bit word) -> the bf16 pairs (bytes 0, 2) and
// (bytes 1, 3), exact: the sign-flipped byte goes into the low mantissa of
// 2^23, one subtract of 2^23 + 128 leaves the value, whose upper 16 bits
// are its bf16 (|q| <= 128 needs 8 significant bits)
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

// A grid-wide barrier in two halves, so that a block can do work that
// needs nothing from the grid between its arrival and its wait, and a
// block that needs nothing after it can arrive and leave. *count only
// grows, by G at each barrier; a launch reads its base at its start
// (b7_base: no block can pass the launch's first barrier before every
// block has started), and its barrier j ends at base + (j + 1) * G. Only a
// cooperative launch may use it (every block resident at once), every
// launch on the count must have the same G, and a block must wait at each
// barrier before it arrives at the next (an early arrival would count
// towards the barrier before). The `n` threads of named barrier 1 take
// part; thread 0 arrives and waits for the block.
__device__ __forceinline__ unsigned long long b7_base(const unsigned long long* count, int G) {
  unsigned long long c;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(c) : "l"(count) : "memory");
  // c - c % G without a 64-bit division (slow on one thread): a double
  // quotient, corrected by one either way
  unsigned long long q = (unsigned long long)((double)c / G);
  if (q * G > c) --q;
  if ((q + 1) * G <= c) ++q;
  return q * G;
}
__device__ __forceinline__ void grid_arrive(unsigned long long* count, int n) {
  bar_sync(1, n);
  // the block's writes (ordered before thread 0's by the block barrier)
  // before its arrival: a release fence is cumulative
  if (threadIdx.x == 0)
    asm volatile("fence.acq_rel.gpu;\n"
                 "red.relaxed.gpu.global.add.u64 [%0], 1;\n" :: "l"(count) : "memory");
}
__device__ __forceinline__ void grid_wait(const unsigned long long* count, unsigned long long end,
                                          int n) {
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    unsigned long long now;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(now) : "l"(count) : "memory");
      if (now >= end) break;
      if (clock64() - t0 > 20000000000LL) __trap();   // a lost block: fail, not hang
    }
  }
  bar_sync(1, n);
}

// B7 between the wo stream and the norm, on every block of the grid: x2 =
// bf16(x + sum) and the sum of squares of the rounded x2 of each (row,
// tile) unit, one unit a warp (lane l: columns 4l .. 4l + 3 of the tile),
// once the grid barrier the block has arrived at has ended. The sum adds
// the tile's segment sums in block order: slot (b, j) holds block b's
// segment of the j-th tile its share meets, so the tile's first block b_lo
// gives slot (b_lo, t - its first tile) and every later block b_hi .. of
// the tile, whose share starts in it, slot (b, 0) (a block with an empty
// share left zeros there). The slots are read B7_PART_BATCH at a time.
constexpr int B7_PART_BATCH = 16;

__device__ void b7_x2(const I8Args& p, int G, int blk, unsigned long long end) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = p.N / 128 * p.B, nk = p.nk, total = (int)p.total;
  grid_wait(p.count, end, 128);
  for (int u = blk * 4 + warp; u < units; u += G * 4) {
    const int t = u / p.B, r = u - t * p.B, col = t * 128 + 4 * lane;
    // the tile's blocks b_lo .. b_hi (i8_block_of of its first and last
    // stage; total * G < 2^31, the host checks)
    const int b_lo = ((t * nk + 1) * G - 1) / total, b_hi = ((t + 1) * nk * G - 1) / total;
    // b_lo's slot: the tiles its share (from stage s0) meets before t
    const int s0 = b_lo * total / G;
    int seg_lo = 0;
    for (int k = t * nk; k > s0; k -= nk) ++seg_lo;
    const float* base = p.part + (long long)r * 128 + 4 * lane;
    const long long slot = (long long)p.B * 128;   // floats a slot
    float4 v[B7_PART_BATCH];
#pragma unroll
    for (int i = 0; i < B7_PART_BATCH; ++i)
      if (b_lo + i <= b_hi)
        v[i] = __ldcg(reinterpret_cast<const float4*>(
            base + ((long long)(b_lo + i) * p.segs + (i == 0 ? seg_lo : 0)) * slot));
    const uint2 xv = *reinterpret_cast<const uint2*>(p.res + (long long)r * p.ldo + col);
    float4 y = v[0];
#pragma unroll
    for (int i = 1; i < B7_PART_BATCH; ++i)
      if (b_lo + i <= b_hi) {
        y.x += v[i].x;
        y.y += v[i].y;
        y.z += v[i].z;
        y.w += v[i].w;
      }
    // a tile over more blocks than one batch (wo of fewer stages than the grid)
    for (int b0 = b_lo + B7_PART_BATCH; b0 <= b_hi; b0 += B7_PART_BATCH) {
#pragma unroll
      for (int i = 0; i < B7_PART_BATCH; ++i)
        if (b0 + i <= b_hi)
          v[i] = __ldcg(reinterpret_cast<const float4*>(base + (long long)(b0 + i) * p.segs * slot));
#pragma unroll
      for (int i = 0; i < B7_PART_BATCH; ++i)
        if (b0 + i <= b_hi) {
          y.x += v[i].x;
          y.y += v[i].y;
          y.z += v[i].z;
          y.w += v[i].w;
        }
    }
    const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(&xv);
    const float2 x01 = __bfloat1622float2(xr[0]), x23 = __bfloat1622float2(xr[1]);
    const float o[4] = {x01.x + y.x, x01.y + y.y, x23.x + y.z, x23.y + y.w};
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(o[0], o[1]));
    const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(o[2], o[3]));
    const float ss = warp_sum(lo.x * lo.x + lo.y * lo.y + hi.x * hi.x + hi.y * hi.y);
    store_bf16x4(p.out + (long long)r * p.ldo + col, o);
    if (lane == 0) p.sq[t * p.B + r] = ss;
  }
}

// B7's phase 2 in block blk of i8_stream<128, MT, I8_ROUTER[_ANY]> (its 4
// consumer warps), after x2 and the (row, tile) sums of squares of every
// block: the block arrives at the grid barrier that orders them first, and
// leaves if it has no phase-2 work, or does the work that needs nothing
// from the grid before it waits for the barrier's end. Item w = (c, g) =
// (w % bands, w / bands) takes router columns RBW * c .. + RBW and rows rpb
// * g .. + rpb (the host picks rpb so that the items fill the grid, and
// block blk takes items blk, blk + G, ...). For each item: its rows' 1/rms
// from their tiles' sums of squares in tile order; then for each chunk of
// K (B7_KC rows; one chunk where E <= B7_KC), the router columns of the
// chunk in rs (the block's first item's first chunk prefetched by TMA onto
// rbar during phase 1, the others loaded here); thread t owns the 8-value
// column chunks t, t + 128, ... of the chunk, so its ln2 stays in
// registers and no index is divided: it loads its chunks of the x2 rows
// four rows at a time, writes hn = bf16((x2 * 1/rms) * ln2) into the hn
// tile hs (and its band's share of the columns out: each hn element once);
// then the logits hn @ router columns on mma.sync (warp w: k-step pairs w,
// w + 4, ... of the chunk, a sum for each k-step of a pair, carried over
// the chunks; rows of the m-tile past the item's are not read out) go
// straight out, the sums added in one fixed order: one block holds each
// logit. GEN = false (I8_ROUTER: every block has at most one item, K is
// one chunk and E % 1024 == 0, as at every served width): the item and
// chunk loops and the ragged round fold away at compile time.
template <bool GEN>
__device__ void router_phase(const I8Args& p, bf16* hs, float* ys, unsigned char* rs,
                             uint64_t* rbar, const CUtensorMap* tr, int G, int blk,
                             unsigned long long end) {
  constexpr int NTH = 128, RB = 4, MAXCH = B7_KC / (8 * NTH);   // MAXCH: chunks a thread
  grid_arrive(p.count, NTH);
  const int bands = p.NE / RBW, items = bands * ((p.B + p.rpb - 1) / p.rpb);
  if (blk >= items) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int E = p.N, KC = GEN ? b7_kc(E) : E, HROW = b7_hrow(E);
  const int nkc = GEN ? (E + KC - 1) / KC : 1, tiles = E / 128, wend = GEN ? items : blk + 1;
  // whether thread tid loads chunk q of round q of a klen-wide K chunk
  auto has = [&](int q, int klen) {
    return GEN ? 8 * (tid + q * NTH) < klen : q * 8 * NTH < klen;
  };
  float* inv = ys;                         // [RROWS]
  float* red = ys + RROWS;                 // [4 warps][2][RROWS][RBW]
  float* sqs = red + 8 * RROWS * RBW;      // [B7_SQT][RROWS]
  const int mi = lane >> 3, rr = lane & 7, gq = lane >> 2, t4 = lane & 3;
  uint4 xv[RB][MAXCH], lv[MAXCH];
  // (a K chunk of klen columns is ceil(klen / 1024) rounds q of 128
  // threads' 8-column chunks, the last ragged where klen % 1024 != 0: the
  // loads of its chunks past klen are left out, and what they give lands
  // in the hn tile's padding and is never read)
  // the x2 rows rb .. rb + RB - 1 (of nr) of the K chunk from k0
  auto load_rows = [&](const bf16* x2, int rb, int nr, int k0, int klen) {
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int q = 0; q < MAXCH; ++q)
        if (rb + i < nr && has(q, klen))
          xv[i][q] = __ldcg(reinterpret_cast<const uint4*>(x2 + (long long)(rb + i) * p.ldo +
                                                           k0 + 8 * (tid + q * NTH)));
  };
  auto load_ln = [&](int k0, int klen) {
#pragma unroll
    for (int q = 0; q < MAXCH; ++q)
      if (has(q, klen))
        lv[q] = *reinterpret_cast<const uint4*>(p.ln + k0 + 8 * (tid + q * NTH));
  };
  // the chunk of router columns c from k row k0 (klen rows) into rs, once
  // every warp is past its reads of rs
  auto load_router = [&](int c, int k0, int klen) {
    if (tid == 0) {
      fence_proxy_async();
      const int boxes = (klen + RBOX - 1) / RBOX;
      mbar_expect_tx(rbar, boxes * RBOX * RBW * 2);
      for (int r = 0; r < boxes; ++r)
        tma_load_2d(rs + r * RBOX * RBW * 2, tr, rbar, c * RBW, k0 + r * RBOX);
    }
  };
  load_ln(0, KC);
  grid_wait(p.count, end, NTH);
  int ph = 0;   // rbar's phase
  for (int w = blk; w < wend; w += G) {
    const int g = w / bands, c = w - g * bands, r0 = g * p.rpb;
    const int nr = p.B - r0 < p.rpb ? p.B - r0 : p.rpb;
    // the hn columns this item writes: 8-column pieces j0 .. j1 of E / 8
    const int h0 = 8 * (E / 8 * c / bands), h1 = 8 * (E / 8 * (c + 1) / bands);
    const bf16* x2 = p.out + (long long)r0 * p.ldo;
    if (w != blk) {   // not the prefetched item
      load_router(c, 0, KC);
      if (nkc > 1) load_ln(0, KC);
    }
    load_rows(x2, 0, nr, 0, KC);   // the first four rows of x2 in flight
    // each row's sums of squares in tile order, B7_SQT tiles at a time
    float tsum = 0.f;
    for (int i0 = 0; i0 < tiles * RROWS; i0 += B7_SQT * RROWS) {
      float sv[B7_SQT * RROWS / NTH];
#pragma unroll
      for (int j = 0; j < B7_SQT * RROWS / NTH; ++j) {   // (tile i >> 4, row i & 15)
        const int i = i0 + tid + j * NTH;
        if (i < tiles * RROWS && (i & 15) < nr) sv[j] = __ldcg(p.sq + (i >> 4) * p.B + r0 + (i & 15));
      }
#pragma unroll
      for (int j = 0; j < B7_SQT * RROWS / NTH; ++j) {
        const int i = i0 + tid + j * NTH;
        if (i < tiles * RROWS && (i & 15) < nr) sqs[i - i0] = sv[j];
      }
      bar_sync(1, NTH);
      if (tid < nr) {
        const int n = tiles - i0 / RROWS < B7_SQT ? tiles - i0 / RROWS : B7_SQT;
        for (int i = 0; i < n; ++i) tsum += sqs[i * RROWS + tid];
      }
      if (i0 + B7_SQT * RROWS < tiles * RROWS) bar_sync(1, NTH);   // sqs again
    }
    if (tid < nr) inv[tid] = rsqrtf(tsum / (float)E + p.eps);
    bar_sync(1, NTH);
    float acc[2][4] = {};
    for (int kc = 0; kc < nkc; ++kc) {
      const int k0 = kc * KC, klen = E - k0 < KC ? E - k0 : KC, nq = (klen + 8 * NTH - 1) / (8 * NTH);
      if (kc > 0) {
        load_router(c, k0, klen);
        load_ln(k0, klen);
        load_rows(x2, 0, nr, k0, klen);
      }
      for (int rb = 0; rb < nr; rb += RB) {
        if (rb > 0) load_rows(x2, rb, nr, k0, klen);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (rb + i >= nr) break;
          const float s = inv[rb + i];
#pragma unroll
          for (int q = 0; q < MAXCH; ++q) {
            if (q >= nq) break;
            const int c8 = 8 * (tid + q * NTH);
            float f[8], wv[8];
            bf16x8_to_float(xv[i][q], f);
            bf16x8_to_float(lv[q], wv);
            __align__(16) bf16 o[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16((f[e] * s) * wv[e]);
            const uint4 v = *reinterpret_cast<const uint4*>(o);
            *reinterpret_cast<uint4*>(hs + (rb + i) * HROW + c8) = v;
            if (k0 + c8 >= h0 && k0 + c8 < h1)
              *reinterpret_cast<uint4*>(p.hn + (long long)(r0 + rb + i) * p.ldo + k0 + c8) = v;
          }
        }
      }
      mbar_wait(rbar, ph);   // the router columns
      ph ^= 1;
      bar_sync(1, NTH);
      for (int kp = warp; kp < klen / 32; kp += 4) {
        // B of two k-steps: the router's 16-byte rows kp * 32 + lane
        uint32_t b[4];
        ldmatrix_x4_trans(b, rs + (kp * 32 + lane) * RBW * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[4];
          ldmatrix_x4(a, hs + (rr + 8 * (mi & 1)) * HROW + kp * 32 + 16 * h + 8 * (mi >> 1));
          mma_bf16(acc[h], a, b + 2 * h);
        }
      }
      if (kc + 1 < nkc) bar_sync(1, NTH);   // rs and hs free for the next chunk
    }
    // (the next item reuses rs and hs after the barrier below)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(red + ((warp * 2 + h) * RROWS + gq + 8 * e) * RBW + 2 * t4) =
            make_float2(acc[h][2 * e], acc[h][2 * e + 1]);
    bar_sync(1, NTH);
    if (tid < nr * RBW) {
      const int r = tid / RBW, j = tid % RBW;
      float s = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < 8; ++w2) s += red[(w2 * RROWS + r) * RBW + j];
      p.logits[(long long)(r0 + r) * p.NE + c * RBW + j] = s;
    }
    // the next item's first writes to red come after its bar_syncs
  }
}

// grid: G persistent blocks, one an SM (the host picks G from the SM
// count), launched cooperatively; i8_threads(TW) threads
template <int TW, int MT, int EPI>
__global__ void __launch_bounds__(i8_threads(TW), 1)
i8_stream(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap tr, const __grid_constant__ I8Args p) {
  constexpr int WB = i8_wbytes(EPI);
  I8_TILE_CONSTANTS(TW, WB)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ST = p.stages;
  constexpr int ABYTES = MT * 16 * QAB;   // an activation stage: MT*16 rows x QKT bf16
  unsigned char* wring = smem;                            // [ST][QBOX][QKT][QBW] weights
  unsigned char* aring = wring + ST * QW_STAGE;           // [ST][MT*16][QKT] bf16
  int body = ST * (QW_STAGE + ABYTES);
  if (i8_b7(EPI) && b7_hn_bytes(p.N) > body) body = b7_hn_bytes(p.N);   // B7's hn tile
  float* ys = reinterpret_cast<float*>(smem + body);      // [MT*16][QEROW]; B7: [B7_SCRATCH]
  unsigned char* rs =                                     // B7: [<= B7_KC][RBW] bf16 router columns
      reinterpret_cast<unsigned char*>(ys + (i8_b7(EPI) ? B7_SCRATCH : MT * 16 * QEROW));
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + (i8_b7(EPI) ? b7_rs_bytes(p.N) : 0));
  uint64_t* empty = full + ST;
  uint64_t* rbar = empty + ST;                            // B7: the router columns
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, blk = blockIdx.x;
  const long long it0 = i8_start(blk, p.total, G), it1 = i8_start(blk + 1, p.total, G);
  // the first column of box i of tile t
  auto box_col = [&](int t, int i) {
    constexpr int HB = QBOX > 1 ? QBOX / 2 : 1;   // boxes of gate (of up) columns
    if (EPI == I8_SWIGLU) return (i < HB ? 0 : p.half_n) + t * (QTW / 2) + QBW * (i % HB);
    return t * QTW + QBW / WB * i;
  };
  // B7: whether this block has a phase-2 item (router_phase)
  const bool router = i8_b7(EPI) && blk < p.NE / RBW * ((p.B + p.rpb - 1) / p.rpb);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], QCW);
    }
    if (i8_b7(EPI)) mbar_init(rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == QCW) {
    // ---- producer: one thread issues every TMA load. Boxes past N (a
    // ragged last tile) and rows past B read zeros and count their bytes.
    if (lane == 0) {
      const int n = (int)(it1 - it0), pre = n < ST ? n : ST;
      const int kt_first = (int)(it0 % p.nk);
      int t = (int)(it0 / p.nk), kt = kt_first;   // (tile, stage) of load j
      for (int j = 0; j < pre; ++j) {
        mbar_expect_tx(&full[j], QW_STAGE + ABYTES);
#pragma unroll
        for (int i = 0; i < QBOX; ++i)
          tma_load_2d(wring + j * QW_STAGE + i * (QW_STAGE / QBOX), &tw, &full[j],
                      box_col(t, i), kt * QKT);
        tma_load_2d(aring + j * ABYTES, &tx, &full[j], kt * QKT, 0);
        if (++kt == p.nk) kt = 0, ++t;
      }
      // from here on j >= ST: stage j reuses slot s once its consumers are done
      for (int j = pre, s = 0, phase = 0; j < n; ++j) {
        mbar_wait(&empty[s], phase);
        mbar_expect_tx(&full[s], QW_STAGE + ABYTES);
#pragma unroll
        for (int i = 0; i < QBOX; ++i)
          tma_load_2d(wring + s * QW_STAGE + i * (QW_STAGE / QBOX), &tw, &full[s],
                      box_col(t, i), kt * QKT);
        tma_load_2d(aring + s * ABYTES, &tx, &full[s], kt * QKT, 0);
        if (++kt == p.nk) kt = 0, ++t;
        if (++s == ST) s = 0, phase ^= 1;
      }
      if (router) {
        // B7: the router columns of the block's first item and chunk, after
        // the wo loads (16 bytes a row: issued first, they held the first
        // wo stages back ~2 us), to land during the stream's tail and the
        // barriers
        const int bc = blk % (p.NE / RBW) * RBW, boxes = (b7_kc(p.N) + RBOX - 1) / RBOX;
        mbar_expect_tx(rbar, boxes * RBOX * RBW * 2);
        for (int r = 0; r < boxes; ++r)
          tma_load_2d(rs + r * RBOX * RBW * 2, &tr, rbar, bc, r * RBOX);
      }
    }
    return;
  }

  // ---- consumers: warp w multiplies tile columns 32w .. 32w + 31 (the
  // 32 * WB bytes of its rows from byte 32 * WB * w of the tile) over the stage
  const int mi = lane >> 3, rr = lane & 7;        // ldmatrix lane roles
  const int g = lane >> 2, t4 = lane & 3;         // accumulator lane roles
  const int box = warp * 32 * WB / QBW, chunk0 = warp * 32 * WB % QBW / 16;
  int s = 0, phase = 0;   // ring slot and phase of the next stage
  int left = (int)(it1 - it0), t = (int)(it0 / p.nk), kt0 = (int)(it0 % p.nk);
  [[maybe_unused]] const int t_first = t;   // B7's slots
  // B7: the grid barrier count's base for this launch (thread 0's)
  [[maybe_unused]] unsigned long long base = 0;
  if constexpr (i8_b7(EPI))
    if (tid == 0) base = b7_base(p.count, G);
  while (left > 0) {
    // a segment: stages kt0 .. kt0 + len - 1 of tile t
    const int len = left < p.nk - kt0 ? left : p.nk - kt0;
    float acc[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][nb][i] = 0.f;

    for (int q2 = 0; q2 < len; ++q2) {
      mbar_wait(&full[s], phase);
      const unsigned char* wst = wring + s * QW_STAGE + box * (QW_STAGE / QBOX);
      const unsigned char* ast = aring + s * ABYTES;
#pragma unroll
      for (int kk = 0; kk < QKT; kk += 16) {
        uint32_t b[4][2];
        if constexpr (WB == 1) {
          // B fragments: ldmatrix.trans of the int8 box read as 16-bit
          // pairs; matrix mi = (k half mi & 1, 16-byte chunk mi >> 1)
          uint32_t r[4];
          ldmatrix_x4_trans(r, wst + swz(kk + 8 * (mi & 1) + rr, chunk0 + (mi >> 1), QBW));
          // n8 block 2G + e holds columns 16G + 2i + e of this warp's 32
          widen4(r[0], b[0][0], b[1][0]);
          widen4(r[1], b[0][1], b[1][1]);
          widen4(r[2], b[2][0], b[3][0]);
          widen4(r[3], b[2][1], b[3][1]);
        } else {
          // bf16: n8 block nb holds columns 8nb .. 8nb + 7 (chunk nb);
          // matrix mi = (k half mi & 1, n8 block 2h + (mi >> 1))
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, wst + swz(kk + 8 * (mi & 1) + rr, chunk0 + 2 * h + (mi >> 1), QBW));
            b[2 * h][0] = r[0];
            b[2 * h][1] = r[1];
            b[2 * h + 1][0] = r[2];
            b[2 * h + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          // A: rows m*16 .. of the activation stage
          uint32_t a[4];
          ldmatrix_x4(a, ast + swz(m * 16 + rr + 8 * (mi & 1), (kk >> 3) + (mi >> 1), QAB));
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) mma_bf16(acc[m][nb], a, b[nb]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == ST) s = 0, phase ^= 1;
    }

    if constexpr (i8_b7(EPI)) {
      // B7: the segment's sums into the block's slot for it (b7_x2 adds
      // them up); thread (g, t4) holds columns 32w + 8nb + 2*t4, +1 of n8
      // block nb, rows g and g + 8 of each m-tile
      float* slot = p.part + (long long)(blk * p.segs + t - t_first) * p.B * QTW;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m * 16 + g + 8 * h, col = warp * 32 + nb * 8 + 2 * t4;
            if (row < p.B)
              *reinterpret_cast<float2*>(slot + row * QTW + col) =
                  make_float2(acc[m][nb][2 * h], acc[m][nb][2 * h + 1]);
          }
      left -= len;
      kt0 = 0;
      ++t;
      continue;
    }

    // ---- the segment's sums (thread (g, t4) holds columns 32w + 16G +
    // 4*t4 .. +3, rows g and g + 8 of each m-tile). A tile split over
    // blocks b_lo .. b_hi is finished by b_lo, whose segment of it comes
    // last in its share (the tile's first stages): the others' segments are
    // the first of their shares and done early; each leaves its sums in its
    // partial slot and counts itself in the tile's ticket; b_lo keeps its
    // own sums, waits for the count, adds theirs in block order and runs the
    // epilogue. The pull saves b_lo, on the kernel's critical path, a
    // partial slot's round trip and the ticket's.
    const int b_lo = i8_block_of((long long)t * p.nk, p.total, G);
    const int b_hi = i8_block_of((long long)t * p.nk + p.nk - 1, p.total, G);
    const bool split = b_hi > b_lo, last = !split || blk == b_lo;
    // the epilogue's row-invariant loads, issued before the fix-up so that
    // its wait hides them: scales (and q / k norm weights) of this lane's
    // columns (4l .. 4l + 3 of each 128-column chunk of the tile)
    constexpr int NCH = QTW / 128, NG = QTW / 256 > 0 ? QTW / 256 : 1;
    float4 sc[NCH], su[NG];
    float wn[NCH][4];
    if (last) {
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int col = t * QTW + ch * 128 + 4 * lane;
        const bool in = EPI == I8_SWIGLU ? ch < NG && t * (QTW / 2) + ch * 128 < p.half_n
                                         : t * QTW + ch * 128 < p.N;
        const int head = col / HEAD;
        if (EPI == I8_SWIGLU) {
          if (in) {
            const int f = t * (QTW / 2) + ch * 128 + 4 * lane;
            sc[ch] = *reinterpret_cast<const float4*>(p.scales + f);
            su[ch < NG ? ch : 0] = *reinterpret_cast<const float4*>(p.scales + p.half_n + f);
          }
        } else if (in) {
          sc[ch] = *reinterpret_cast<const float4*>(p.scales + col);
          if (EPI == I8_QKV && head < p.H + p.KV) {
            const bf16* w = (head < p.H ? p.qn : p.kn) + 4 * lane;
#pragma unroll
            for (int i = 0; i < 4; ++i) wn[ch][i] = __bfloat162float(w[i]);
          }
        }
      }
    }
    float* slot = p.part + (long long)blk * p.B * QTW;
    bar_sync(1, QCW * 32);   // the tile is free (the previous epilogue is done)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int G2 = 0; G2 < 2; ++G2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m * 16 + g + 8 * h, col = warp * 32 + G2 * 16 + 4 * t4;
          const float4 v = make_float4(acc[m][2 * G2][2 * h], acc[m][2 * G2 + 1][2 * h],
                                       acc[m][2 * G2][2 * h + 1], acc[m][2 * G2 + 1][2 * h + 1]);
          if (last)
            *reinterpret_cast<float4*>(ys + row * QEROW + col) = v;
          else if (row < p.B)
            *reinterpret_cast<float4*>(slot + row * QTW + col) = v;
        }
    if (!last) {
      // release: every thread's partial stores, then the ticket
      __threadfence();
      bar_sync(1, QCW * 32);
      if (tid == 0) {
        __threadfence();
        asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" :: "l"(p.tickets + t) : "memory");
      }
    } else if (split) {
      // acquire: the count of the other segments, then their slots (slot
      // bb holds block bb's first segment, which is its segment of t)
      if (tid == 0) {
        const long long t0 = clock64();
        int done = 0;
        while (true) {
          asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(done) : "l"(p.tickets + t)
                       : "memory");
          if (done == b_hi - b_lo) break;
          if (clock64() - t0 > 20000000000LL) __trap();   // a lost segment: fail, not hang
          __nanosleep(64);
        }
        p.tickets[t] = 0;   // ready for the next call
        __threadfence();
      }
      bar_sync(1, QCW * 32);
      __threadfence();
      for (int i = tid; i < p.B * (QTW / 4); i += QCW * 32) {
        const int row = i / (QTW / 4), c = (i % (QTW / 4)) * 4;
        float4* y = reinterpret_cast<float4*>(ys + row * QEROW + c);
        float4 v = *y;
#pragma unroll 4
        for (int bb = b_lo + 1; bb <= b_hi; ++bb) {
          const float4 u = __ldcg(reinterpret_cast<const float4*>(
              p.part + ((long long)bb * p.B + row) * QTW + c));
          v.x += u.x;
          v.y += u.y;
          v.z += u.z;
          v.w += u.w;
        }
        *y = v;
      }
    }
    if (last) {
      bar_sync(1, QCW * 32);   // the tile's sums are in ys
      // ---- the epilogue: warp w takes rows w, w + QCW, ..., RB rows at a
      // time, whose cos / sin (q / k heads) or residual it loads before it
      // stores any of them
      constexpr int RB = 4;
      for (int r0 = warp; r0 < p.B; r0 += RB * QCW) {
        float4 cs[RB], sn[RB];
        uint2 rv[RB][NCH];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int row = r0 + i * QCW;
          if (row >= p.B) break;
          if (EPI == I8_QKV) {
            const int j0 = (4 * lane) & 63;
            cs[i] = *reinterpret_cast<const float4*>(p.cosv + row * 64 + j0);
            sn[i] = *reinterpret_cast<const float4*>(p.sinv + row * 64 + j0);
          }
          if (EPI == I8_RESID) {
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch)
              if (t * QTW + ch * 128 < p.N)
                rv[i][ch] = *reinterpret_cast<const uint2*>(
                    p.res + (long long)row * p.ldo + t * QTW + ch * 128 + 4 * lane);
          }
        }
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int row = r0 + i * QCW;
          if (row >= p.B) break;
          const float* yr = ys + row * QEROW;
          bf16* dst = p.out + (long long)row * p.ldo;
          if (EPI == I8_SWIGLU) {
            // gate chunk c pairs with up chunk c + QTW / 2
#pragma unroll
            for (int ch = 0; ch < NG; ++ch) {
              const int c = ch * 128 + 4 * lane, f = t * (QTW / 2) + c;
              if (t * (QTW / 2) + ch * 128 >= p.half_n) break;
              const float gs[4] = {sc[ch].x, sc[ch].y, sc[ch].z, sc[ch].w};
              const float us[4] = {su[ch].x, su[ch].y, su[ch].z, su[ch].w};
              float o[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float gv = yr[c + q] * gs[q], uv = yr[QTW / 2 + c + q] * us[q];
                o[q] = gv / (1.f + __expf(-gv)) * uv;
              }
              store_bf16x4(dst + f, o);
            }
          } else {
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) {
              const int c = ch * 128 + 4 * lane, col = t * QTW + c;
              if (t * QTW + ch * 128 >= p.N) break;   // a ragged last tile (uniform per warp)
              float o[4] = {yr[c] * sc[ch].x, yr[c + 1] * sc[ch].y, yr[c + 2] * sc[ch].z,
                            yr[c + 3] * sc[ch].w};
              if (EPI == I8_RESID) {
                const __nv_bfloat162* r = reinterpret_cast<const __nv_bfloat162*>(&rv[i][ch]);
                const float2 r01 = __bfloat1622float2(r[0]), r23 = __bfloat1622float2(r[1]);
                o[0] = r01.x + o[0];
                o[1] = r01.y + o[1];
                o[2] = r23.x + o[2];
                o[3] = r23.y + o[3];
              }
              const int head = col / HEAD;
              if (EPI == I8_QKV && head < p.H + p.KV) {
                // q / k head: RMSNorm over its 128 columns, then rotate-half
                // rope (column j pairs with j +- 64, held by lane l ^ 16)
                const int j = 4 * lane;
                const float c4[4] = {cs[i].x, cs[i].y, cs[i].z, cs[i].w};
                const float s4[4] = {sn[i].x, sn[i].y, sn[i].z, sn[i].w};
                float ss = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3];
                ss = warp_sum(ss);
                const float hinv = rsqrtf(ss / (float)HEAD + p.eps);
                float n[4], pr[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) n[q] = (o[q] * hinv) * wn[ch][q];
#pragma unroll
                for (int q = 0; q < 4; ++q) pr[q] = __shfl_xor_sync(0xffffffffu, n[q], 16);
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  o[q] = j < 64 ? n[q] * c4[q] - pr[q] * s4[q] : n[q] * c4[q] + pr[q] * s4[q];
              }
              store_bf16x4(dst + col, o);
            }
          }
        }
      }
    }
    left -= len;
    kt0 = 0;
    ++t;
  }
  if constexpr (i8_b7(EPI)) {
    // B7: every block's segment sums, then x2 and the sums of squares of
    // every (row, tile), then the norm and the router
    // (a block with no stages leaves zeros in its first slot, which the
    // tile it lies inside adds)
    if (it0 == it1)
      for (int i = tid; i < p.B * QTW / 4; i += QCW * 32)
        reinterpret_cast<float4*>(p.part + (long long)blk * p.segs * p.B * QTW)[i] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    grid_arrive(p.count, QCW * 32);
    b7_x2(p, G, blk, base + G);
    router_phase<EPI == I8_ROUTER_ANY>(p, reinterpret_cast<bf16*>(smem), ys, rs, rbar, &tr, G,
                                       blk, base + 2 * G);
  }
}

// a 2-D tensor map of a [rows, cols] matrix of `dtype` (row stride ld
// bytes), boxes of box_cols x box_rows whose rows (box_bytes = 32, 64 or
// 128) are also the swizzle span (16: no swizzle); zeros past the matrix's
// end
bool map_sw(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr, int rows, int cols,
            long long ld, int box_cols, int box_rows, int box_bytes) {
  const EncodeTiled enc = encode_tiled();
  const CUtensorMapSwizzle sw = box_bytes == 16   ? CU_TENSOR_MAP_SWIZZLE_NONE
                                : box_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows}, strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, ones[2] = {1, 1};
  return enc && enc(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, ones,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                    CUDA_SUCCESS;
}

// the product of x [B, K] and w [K, N] (int8, or B7's bf16; row stride N)
// over `grid` persistent blocks with `stages` ring stages; a.out .. as
// I8Args; B7 also its router [N, a.NE] (bf16)
template <int TW, int MT, int EPI>
int launch_i8_mt(const bf16* x, const void* w, int K, int N, int grid,
                 I8Args a, cudaStream_t st, const bf16* router = nullptr) {
  constexpr int WB = i8_wbytes(EPI);
  I8_TILE_CONSTANTS(TW, WB)
  CUtensorMap tx, tw, tr = {};
  if (!map_sw(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, a.B, K, (long long)K * 2, QKT, MT * 16,
              QAB) ||
      !map_sw(&tw, WB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w,
              K, N, (long long)N * WB, QBW / WB, QKT, QBW))
    return (int)cudaErrorInvalidValue;
  if (i8_b7(EPI) && !map_sw(&tr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, router, N, a.NE,
                                  (long long)a.NE * 2, RBW, RBOX, RBW * 2))
    return (int)cudaErrorInvalidValue;
  const int bytes = i8_smem_bytes<TW, MT, EPI>(a.stages, N);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;
  static int attr_bytes = 0;   // the opt-in above 48 KB, raised as needed
  if (bytes > attr_bytes) {
    cudaFuncSetAttribute(i8_stream<TW, MT, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_bytes = bytes;
  }
  a.nk = K / QKT;
  a.total = (long long)((EPI == I8_SWIGLU ? N / 2 + QTW / 2 - 1 : N + QTW - 1) /
                        (EPI == I8_SWIGLU ? QTW / 2 : QTW)) * a.nk;
  // (B7 keeps the whole grid, whose size its barrier count needs)
  if (!i8_b7(EPI) && grid > a.total) grid = (int)a.total;
  // a tile's finishing block waits for the other blocks' segments, so every
  // block must be resident at once: a cooperative launch, which the runtime
  // refuses for a grid the card cannot hold at once
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(i8_threads(TW));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, i8_stream<TW, MT, EPI>, tx, tw, tr, a);
  return (int)cudaGetLastError();
}

// the tile width: 256 columns for SwiGLU (a gate box and an up box) and
// for the widest products (N > 51200: the lm_head), else 128, which gives
// the split more tiles to balance (scripts/sweep_hopper_kernels.py times
// both widths); the m-tiles per block: the fewest 16-row tiles that cover B
// (up to 4); a ragged last tile where N % TW != 0
int i8_tile_cols(int N, bool swiglu) { return !swiglu && N <= 51200 ? 128 : 256; }

template <int TW, int EPI>
int launch_i8_tw(const bf16* x, const void* w, int K, int N, int grid, I8Args a,
                 cudaStream_t st, const bf16* router = nullptr) {
  if (K % (8192 / (TW * i8_wbytes(EPI)))) return (int)cudaErrorInvalidValue;
  if (a.B <= 16) return launch_i8_mt<TW, 1, EPI>(x, w, K, N, grid, a, st, router);
  if (a.B <= 32) return launch_i8_mt<TW, 2, EPI>(x, w, K, N, grid, a, st, router);
  return launch_i8_mt<TW, 4, EPI>(x, w, K, N, grid, a, st, router);
}

template <int EPI>
int launch_i8(const bf16* x, const int8_t* w, int K, int N, int grid, I8Args a,
              cudaStream_t st) {
  if (N % 128 || N / 128 > I8_MAX_TILES || a.B < 1 || a.B > MAX_ROWS || grid < 1)
    return (int)cudaErrorInvalidValue;
  a.N = N;
  if constexpr (EPI != I8_SWIGLU) {
    if (i8_tile_cols(N, false) == 128)
      return launch_i8_tw<128, EPI>(x, w, K, N, grid, a, st);
  }
  return launch_i8_tw<256, EPI>(x, w, K, N, grid, a, st);
}

// B3: xn = rmsnorm(x)·ln -> xn @ W -> qkv_epilogue
int run_qkv(const bf16* X, const bf16* ln, const bf16* W, const bf16* qn, const bf16* kn,
            const void* cosv, const void* sinv, int cs_bf16, float* P, bf16* XN, bf16* out,
            int B, int E, int H, int KV, int splits, int grid, float eps, cudaStream_t st) {
  const int C = (H + 2 * KV) * HEAD;
  norm_rows(X, ln, B, E, eps, XN, st);
  if (int err = launch_gemm(XN, W, P, B, E, C, splits, grid, st)) return err;
  qkv_epilogue<<<dim3(B, H + 2 * KV), HEAD, 0, st>>>(P, splits, B, C, qn, kn, cosv, sinv,
                                                     cs_bf16, out, H, KV, eps);
  return (int)cudaGetLastError();
}

// B4 over one layer's weights; grid > 0: the products on gemm_tc
int run_out_mlp(const bf16* A, const bf16* X, const bf16* Wo, const bf16* ln, const bf16* Wgu,
                const bf16* Wd, float* P, bf16* X2, bf16* XN, bf16* Hh, bf16* O, int B, int HD,
                int E, int F, int s_o, int s_gu, int s_d, int grid, float eps,
                cudaStream_t st) {
  // (1) x2 = x + a @ wo
  if (int err = launch_gemm(A, Wo, P, B, HD, E, s_o, grid, st)) return err;
  residual_epilogue<<<cdiv((long long)B * E, 256), 256, 0, st>>>(P, s_o, B, E, X, X2);
  // (2) h = silu(xn @ Wg) * (xn @ Wu), xn = rmsnorm(x2) * ln2
  norm_rows(X2, ln, B, E, eps, XN, st);
  if (int err = launch_gemm(XN, Wgu, P, B, E, 2 * F, s_gu, grid, st)) return err;
  swiglu_epilogue<<<cdiv((long long)B * F, 256), 256, 0, st>>>(
      P, P + F, (long long)B * 2 * F, 2 * F, s_gu, B, F, Hh);
  // (3) out = x2 + h @ wd
  if (int err = launch_gemm(Hh, Wd, P, B, F, E, s_d, grid, st)) return err;
  residual_epilogue<<<cdiv((long long)B * E, 256), 256, 0, st>>>(P, s_d, B, E, X2, O);
  return (int)cudaGetLastError();
}

// B8 (and B11's unpacked out-MLP) over one layer's weights: out = [x +]
// (silu(xn @ Wg) * (xn @ Wu)) @ Wd, xn = rmsnorm(x) * ln (norm) or x
int run_mlp(const bf16* X, const bf16* ln, const bf16* Wg, const bf16* Wu, const bf16* Wd,
            float* P, bf16* xn, bf16* Hh, bf16* out, int B, int E, int F, int s_gu,
            int s_d, int grid, int norm, int residual, float eps, cudaStream_t st) {
  const bf16* XN = X;
  if (norm) {
    norm_rows(X, ln, B, E, eps, xn, st);
    XN = xn;
  }
  // gate and up partials side by side: [s_gu, B, F] each
  const long long gsz = (long long)s_gu * B * F;
  if (int err = launch_gemm(XN, Wg, P, B, E, F, s_gu, grid, st)) return err;
  if (int err = launch_gemm(XN, Wu, P + gsz, B, E, F, s_gu, grid, st)) return err;
  swiglu_epilogue<<<cdiv((long long)B * F, 256), 256, 0, st>>>(
      P, P + gsz, (long long)B * F, F, s_gu, B, F, Hh);
  if (int err = launch_gemm(Hh, Wd, P, B, F, E, s_d, grid, st)) return err;
  residual_epilogue<<<cdiv((long long)B * E, 256), 256, 0, st>>>(
      P, s_d, B, E, residual ? X : nullptr, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B3. x [B,E]; ln_all [L,E]; wqkv_all [L,E,C]; qn_all/kn_all [L,128];
// cos/sin [B,64] f32, or bf16 where cs_bf16; partial [splits,B,C] f32; xn
// [B,E] bf16 scratch; out [B,C]. grid > 0: the product on gemm_tc over
// `grid` blocks, else on gemm_partial (as every entry of this kind).
int dstts_fused_qkv(const void* x, const void* ln_all, const void* wqkv_all,
                    const void* qn_all, const void* kn_all, const void* cosv,
                    const void* sinv, void* partial, void* xn, void* out,
                    int layer, int B, int E, int H, int KV, int splits, int grid, int cs_bf16,
                    float eps, void* stream) {
  const long long C = (H + 2 * KV) * HEAD;
  return run_qkv(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_all) + (long long)layer * E,
      static_cast<const bf16*>(wqkv_all) + layer * E * C,
      static_cast<const bf16*>(qn_all) + (long long)layer * HEAD,
      static_cast<const bf16*>(kn_all) + (long long)layer * HEAD,
      cosv, sinv, cs_bf16, static_cast<float*>(partial), static_cast<bf16*>(xn),
      static_cast<bf16*>(out), B, E, H, KV, splits, grid, eps,
      static_cast<cudaStream_t>(stream));
}

// B10-qkv: B3 over int8 wq_all [L,E,C] with ws_all [L,1,C] f32 column
// scales in two launches: rms_norm_rows (xn [B,E] bf16 scratch), then
// i8_stream<I8_QKV> over `grid` blocks and `stages` ring stages. partial
// f32 [grid, B, 256]; tickets int32 [I8_MAX_TILES], zero (and left zero).
int dstts_fused_qkv_i8(const void* x, const void* ln_all, const void* wq_all,
                       const void* ws_all, const void* qn_all, const void* kn_all,
                       const void* cosv, const void* sinv, void* partial, void* tickets,
                       void* xn, void* out, int layer, int B, int E, int H, int KV, int grid,
                       int stages, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long C = (H + 2 * KV) * HEAD;
  bf16* XN = static_cast<bf16*>(xn);
  norm_rows(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_all) + (long long)layer * E,
            B, E, eps, XN, st);
  I8Args a = {};
  a.scales = static_cast<const float*>(ws_all) + layer * C;
  a.out = static_cast<bf16*>(out);
  a.qn = static_cast<const bf16*>(qn_all) + (long long)layer * HEAD;
  a.kn = static_cast<const bf16*>(kn_all) + (long long)layer * HEAD;
  a.cosv = static_cast<const float*>(cosv);
  a.sinv = static_cast<const float*>(sinv);
  a.part = static_cast<float*>(partial);
  a.tickets = static_cast<int*>(tickets);
  a.B = B;
  a.ldo = (int)C;
  a.H = H;
  a.KV = KV;
  a.stages = stages;
  a.eps = eps;
  return launch_i8<I8_QKV>(XN, static_cast<const int8_t*>(wq_all) + layer * E * C, E, (int)C,
                           grid, a, st);
}

// B4. a [B,HD]; x [B,E]; wo_all [L,HD,E]; ln_all [L,E]; gateup_all [L,E,2F];
// wd_all [L,F,E]; partial f32 (>= max(s*B*N) over the three products);
// x2, xn [B,E] and h [B,F] bf16 scratch; out [B,E].
int dstts_fused_out_mlp(const void* a, const void* x, const void* wo_all,
                        const void* ln_all, const void* gateup_all,
                        const void* wd_all, void* partial, void* x2, void* xn,
                        void* h, void* out, int layer, int B, int HD, int E,
                        int F, int s_o, int s_gu, int s_d, int grid, float eps,
                        void* stream) {
  const long long l = layer;
  return run_out_mlp(
      static_cast<const bf16*>(a), static_cast<const bf16*>(x),
      static_cast<const bf16*>(wo_all) + l * HD * E, static_cast<const bf16*>(ln_all) + l * E,
      static_cast<const bf16*>(gateup_all) + l * E * 2 * F,
      static_cast<const bf16*>(wd_all) + l * F * E, static_cast<float*>(partial),
      static_cast<bf16*>(x2), static_cast<bf16*>(xn), static_cast<bf16*>(h),
      static_cast<bf16*>(out), B, HD, E, F, s_o, s_gu, s_d, grid, eps,
      static_cast<cudaStream_t>(stream));
}

// B10-out: B4 over int8 wo_q [L,HD,E], gateup_q [L,E,2F], wd_q [L,F,E] and
// f32 column scales wo_s [L,1,E], gateup_s [L,1,2F], wd_s [L,1,E], in four
// launches: i8_stream<I8_RESID> (x2 = x + a @ wo), rms_norm_rows (xn),
// i8_stream<I8_SWIGLU> (h), i8_stream<I8_RESID> (out = x2 + h @ wd).
// partial f32 [grid, B, 256]; tickets int32 [I8_MAX_TILES] zero; x2, xn
// [B,E] and h [B,F] bf16 scratch.
int dstts_fused_out_mlp_i8(const void* a, const void* x, const void* wo_q, const void* wo_s,
                           const void* ln_all, const void* gateup_q, const void* gateup_s,
                           const void* wd_q, const void* wd_s, void* partial, void* tickets,
                           void* x2, void* xn, void* h, void* out, int layer, int B, int HD,
                           int E, int F, int grid, int stages, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long l = layer;
  bf16* X2 = static_cast<bf16*>(x2);
  bf16* XN = static_cast<bf16*>(xn);
  bf16* Hh = static_cast<bf16*>(h);
  I8Args p = {};
  p.part = static_cast<float*>(partial);
  p.tickets = static_cast<int*>(tickets);
  p.B = B;
  p.stages = stages;
  p.eps = eps;
  // (1) x2 = x + a @ wo
  I8Args o = p;
  o.scales = static_cast<const float*>(wo_s) + l * E;
  o.res = static_cast<const bf16*>(x);
  o.out = X2;
  o.ldo = E;
  int err = launch_i8<I8_RESID>(static_cast<const bf16*>(a),
                                static_cast<const int8_t*>(wo_q) + l * HD * E, HD, E, grid, o, st);
  if (err) return err;
  // (2) xn = rmsnorm(x2) * ln2; h = silu(xn @ Wg) * (xn @ Wu)
  norm_rows(X2, static_cast<const bf16*>(ln_all) + l * E, B, E, eps, XN, st);
  I8Args g = p;
  g.scales = static_cast<const float*>(gateup_s) + l * 2 * F;
  g.out = Hh;
  g.ldo = F;
  g.half_n = F;
  err = launch_i8<I8_SWIGLU>(XN, static_cast<const int8_t*>(gateup_q) + l * E * 2 * F, E, 2 * F,
                             grid, g, st);
  if (err) return err;
  // (3) out = x2 + h @ wd
  I8Args d = p;
  d.scales = static_cast<const float*>(wd_s) + l * E;
  d.res = X2;
  d.out = static_cast<bf16*>(out);
  d.ldo = E;
  return launch_i8<I8_RESID>(Hh, static_cast<const int8_t*>(wd_q) + l * F * E, F, E, grid, d, st);
}

// The bare int8 product of B10 (ops/quant.int8_matmul at <= 64 rows):
// out [B,N] bf16 = bf16((x [B,K] bf16 @ w_q [K,N] int8) * scales [1,N] f32),
// one launch of i8_stream<I8_SCALE>; partial f32 [grid, B, 256]; tickets
// int32 [I8_MAX_TILES] zero.
int dstts_int8_matmul(const void* x, const void* w_q, const void* scales, void* partial,
                      void* tickets, void* out, int B, int K, int N, int grid, int stages,
                      void* stream) {
  I8Args a = {};
  a.scales = static_cast<const float*>(scales);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(partial);
  a.tickets = static_cast<int*>(tickets);
  a.B = B;
  a.ldo = N;
  a.stages = stages;
  return launch_i8<I8_SCALE>(static_cast<const bf16*>(x), static_cast<const int8_t*>(w_q), K, N,
                             grid, a, static_cast<cudaStream_t>(stream));
}

// B8. out [B,E] = [x +] (silu(xn @ Wg) * (xn @ Wu)) @ Wd over layer `layer`
// of wg_all, wu_all [L,E,F] and wd_all [L,F,E], xn = rmsnorm(x) * ln_all[l]
// (norm) or x itself; residual adds x. partial f32 (>= max(2*s_gu*F,
// s_d*E)*B); xn [B,E] (read only with norm) and h [B,F] bf16 scratch.
int dstts_fused_mlp(const void* x, const void* ln_all, const void* wg_all,
                    const void* wu_all, const void* wd_all, void* partial, void* xn,
                    void* h, void* out, int layer, int B, int E, int F, int s_gu,
                    int s_d, int grid, int norm, int residual, float eps, void* stream) {
  const long long l = layer;
  return run_mlp(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_all) + l * E,
                 static_cast<const bf16*>(wg_all) + l * E * F,
                 static_cast<const bf16*>(wu_all) + l * E * F,
                 static_cast<const bf16*>(wd_all) + l * F * E, static_cast<float*>(partial),
                 static_cast<bf16*>(xn), static_cast<bf16*>(h), static_cast<bf16*>(out), B,
                 E, F, s_gu, s_d, grid, norm, residual, eps,
                 static_cast<cudaStream_t>(stream));
}

// B11 fused_out_mlp with unpacked gate and up (fused_layer.py:975): B4's
// x2 = x + a @ wo, then B8's two-pointer path on x2 with norm and residual.
// a [B,HD]; x [B,E]; wo [HD,E]; ln [E]; wg, wu [E,F]; wd [F,E]; partial f32
// (>= max(s_o*E, 2*s_gu*F, s_d*E)*B); x2, xn [B,E] and h [B,F] bf16 scratch.
int dstts_fused_out_mlp_split(const void* a, const void* x, const void* wo, const void* ln,
                              const void* wg, const void* wu, const void* wd, void* partial,
                              void* x2, void* xn, void* h, void* out, int B, int HD, int E,
                              int F, int s_o, int s_gu, int s_d, int grid, float eps,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* P = static_cast<float*>(partial);
  bf16* X2 = static_cast<bf16*>(x2);
  if (int err = launch_gemm(static_cast<const bf16*>(a), static_cast<const bf16*>(wo), P, B, HD,
                            E, s_o, grid, st))
    return err;
  residual_epilogue<<<cdiv((long long)B * E, 256), 256, 0, st>>>(
      P, s_o, B, E, static_cast<const bf16*>(x), X2);
  return run_mlp(X2, static_cast<const bf16*>(ln), static_cast<const bf16*>(wg),
                 static_cast<const bf16*>(wu), static_cast<const bf16*>(wd), P,
                 static_cast<bf16*>(xn), static_cast<bf16*>(h), static_cast<bf16*>(out), B,
                 E, F, s_gu, s_d, grid, 1, 1, eps, st);
}

// B7 over up to 64 rows. a [B,HD]; x [B,E]; wo_all [L,HD,E]; ln_all [L,E];
// router_all [L,E,NE] (bf16); x2, hn [B,E] bf16 and logits [B,NE] f32 out.
// Scratch: partial f32 [grid, segs, B, 128] (each block's segment sums;
// segs >= the most tiles a block's share meets), sq f32 [E / 128, B];
// count: the grid barrier's u64 (it only grows). grid: the card's SMs (the
// same on every call: the count's base needs it); `stages` ring stages;
// phase 2's items of rpb <= RROWS rows. One cooperative launch of
// i8_stream<128, MT, I8_ROUTER> (I8_ROUTER_ANY at widths beyond the served ones).
int dstts_fused_out_router(const void* a, const void* x, const void* wo_all, const void* ln_all,
                           const void* router_all, void* partial, void* sq, void* count,
                           void* x2, void* hn, void* logits, int layer, int B, int HD, int E,
                           int NE, int grid, int stages, int rpb, int segs, float eps,
                           void* stream) {
  const long long nk = HD / 32, total = (long long)E / 128 * nk;
  if (B < 1 || B > MAX_ROWS || E < 128 || E % 128 || HD < 32 || HD % 32 || NE < RBW ||
      NE % RBW || rpb < 1 || rpb > RROWS || grid < 1 || total * grid >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  // the most tiles a share of s = ceil(total / grid) stages meets
  const long long s = (total + grid - 1) / grid;
  if (segs < (s + 2 * nk - 2) / nk) return (int)cudaErrorInvalidValue;
  const long long l = layer;
  I8Args p = {};
  p.res = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(x2);
  p.part = static_cast<float*>(partial);
  p.B = B;
  p.N = E;
  p.ldo = E;
  p.stages = stages;
  p.eps = eps;
  p.ln = static_cast<const bf16*>(ln_all) + l * E;
  p.hn = static_cast<bf16*>(hn);
  p.sq = static_cast<float*>(sq);
  p.logits = static_cast<float*>(logits);
  p.count = static_cast<unsigned long long*>(count);
  p.NE = NE;
  p.rpb = rpb;
  p.segs = segs;
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* Wo = static_cast<const bf16*>(wo_all) + l * HD * E;
  const bf16* Wr = static_cast<const bf16*>(router_all) + l * E * NE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the served widths' phase 2 (one item a block, one K chunk, whole
  // rounds) is compiled apart: in one kernel with the general one, B = 64
  // took 4-12 % longer (PERF.md)
  if (E % 1024 == 0 && E <= B7_KC && NE / RBW * ((B + rpb - 1) / rpb) <= grid)
    return launch_i8_tw<128, I8_ROUTER>(A, Wo, HD, E, grid, p, st, Wr);
  return launch_i8_tw<128, I8_ROUTER_ANY>(A, Wo, HD, E, grid, p, st, Wr);
}

// The bf16 product of B3 / B4 / B8 alone: partial f32 [splits, B, N] =
// x [B, K] @ w [K, N] over k-slices, on gemm_tc over `grid` blocks (grid >
// 0) or on gemm_partial (the comparison of the two forms).
int dstts_gemm_partial(const void* x, const void* w, void* partial, int B, int K, int N,
                       int splits, int grid, void* stream) {
  if (int err = launch_gemm(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                            static_cast<float*>(partial), B, K, N, splits, grid,
                            static_cast<cudaStream_t>(stream)))
    return err;
  return (int)cudaGetLastError();
}

// Grouped expert FFN, entry 1: h [S,F] = silu(x @ Wg[e]) * (x @ Wu[e]) over
// expert-sorted rows x [S,E]; offsets [NE+1] int32 (exclusive cumsum of the
// group sizes, on the device); w_gate / w_up: expert e's [E,F] gate / up
// matrices at w + e*expert_stride with row stride ldw (packed gate|up: ldw =
// 2F and w_up = w_gate + F).
int dstts_grouped_gateup(const void* x, const void* offsets, const void* w_gate,
                         const void* w_up, long long expert_stride, int ldw, int NE,
                         int E, int F, int zsplit, void* h, void* stream) {
  return launch_grouped<true>(x, offsets, static_cast<const bf16*>(w_gate),
                              static_cast<const bf16*>(w_up), expert_stride, ldw, E,
                              F / (TILE / 2), NE, zsplit, h, F,
                              static_cast<cudaStream_t>(stream));
}

// Grouped expert FFN, entry 2: y [S,E] = h @ Wd[e]; w_down [NE,F,E].
int dstts_grouped_down(const void* h, const void* offsets, const void* w_down, int NE,
                       int F, int E, int zsplit, void* y, void* stream) {
  const bf16* W = static_cast<const bf16*>(w_down);
  return launch_grouped<false>(h, offsets, W, W, (long long)F * E, E, F, E / TILE, NE,
                               zsplit, y, E, static_cast<cudaStream_t>(stream));
}

// The prefill kernel of the grouped expert FFN (grouped_expert_tc), entry 1:
// h [S,F] as dstts_grouped_gateup over x [S,E]; w_gate / w_up: expert e's
// [E,F] matrices at w + e*E*ldw with row stride ldw (packed: ldw = 2F and
// w_up = w_gate + F; both 16-byte aligned). E % 64 == 0, F % 64 == 0,
// NE <= 1024; grid: the card's SMs.
int dstts_grouped_gateup_tc(const void* x, const void* offsets, const void* w_gate,
                            const void* w_up, int ldw, int NE, int E, int F, int S, int grid,
                            void* h, void* stream) {
  if (F % 64) return (int)cudaErrorInvalidValue;
  return launch_grouped_tc<true>(x, offsets, w_gate, w_up, ldw, F, NE, E, S, grid, h, F,
                                 static_cast<cudaStream_t>(stream));
}

// Entry 2: y [S,E] = h [S,F] @ Wd[e] over w_down [NE,F,E]. F % 64 == 0,
// E % 128 == 0.
int dstts_grouped_down_tc(const void* h, const void* offsets, const void* w_down, int NE,
                          int F, int E, int S, int grid, void* y, void* stream) {
  if (E % XBN) return (int)cudaErrorInvalidValue;
  return launch_grouped_tc<false>(h, offsets, w_down, w_down, E, E, NE, F, S, grid, y, E,
                                  static_cast<cudaStream_t>(stream));
}

// Blocks an SM can hold of the grouped expert kernels, as the runtime
// computes them from registers, threads and shared memory: out[0..3] = the
// decode kernel (gate|up, down), the prefill kernel (gate|up, down).
int dstts_grouped_occupancy(int* out) {
  constexpr int dec = gemm_smem_bytes<GROUP_MT>();
  constexpr int pre_gu = xpre_smem_bytes<true>(), pre_dn = xpre_smem_bytes<false>();
  cudaFuncSetAttribute(grouped_expert<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, dec);
  cudaFuncSetAttribute(grouped_expert<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, dec);
  cudaFuncSetAttribute(grouped_expert_tc<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pre_gu);
  cudaFuncSetAttribute(grouped_expert_tc<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       pre_dn);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], grouped_expert<true>, GT, dec);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], grouped_expert<false>, GT, dec);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], grouped_expert_tc<true>, XTH, pre_gu);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], grouped_expert_tc<false>, XTH, pre_dn);
  return (int)cudaGetLastError();
}

}  // extern "C"
