// Attention kernels for Hopper (sm_90a): the port of the JAX package's
// Pallas attention kernels.
//
// K1  decode_attention: T query tokens per row over a page table. It stands
//     for six TPU entry points:
//       B1 slot_attention             (ops/slot_attention.py:301, body :55)
//       B9 slot_window_attention      (ops/slot_attention.py:203, body :123),
//          the speculative verify window: T = W, one context read per window
//       B6 pallas_paged_attention     (ops/paged_attention.py:343, :49)
//       B6 pallas_paged_decode        (ops/paged_attention.py:191, :117)
//       B6 pallas_paged_decode_clamp  (ops/paged_attention.py:290, :239)
//     A contiguous slot row is one page of max_seq_len tokens (identity
//     table, table == nullptr: page = row_offset + b), so one kernel serves
//     the slot cache and the paged cache.
// K2  flash_attention: causal GQA prefill
//       B2 flash_attention            (ops/flash_attention.py:73, :27)
// K3  latent_attention: T=1 MQA decode over MLA's latent rows (v is k), at
//     the DeepSeek-V3 / Kimi-K2 width D = 576 (kv_lora_rank 512 + rope 64):
//       B1 slot_attention, v_pool=None (_slot_attn_kernel_shared, :116)
//       B6's three entries above when the pool is both k and v
//     (models/deepseek_v3.py:381-389, :409-413). Only the first 512 columns
//     of the value product are computed: MLA keeps [..., :kv_lora_rank].
//
// What bounds them on this card, and what the design does about it:
//
// * K1 is bound by bytes: every key and value of a row's context is read
//   once a layer (2*ctx*K*D*2 B: 8.4 MB a row at ctx 2048 and qwen3-8b, 134
//   MB a layer at B=16), against ~4 FLOP a byte at one query row a head
//   (B9's windows: up to 64). Serving gives it small batches and ragged
//   rows: one block per (row, kv head) would leave 8 blocks at B=1, and the
//   longest row alone would set the time at B=16. So the context is split
//   across blocks: grid (B, KV, splits), split z walking keys [z*chunk,
//   (z+1)*chunk) of its row up to the row's own limit (a block never reads
//   past it: the TPU kernels' per-row clamp and the clamp kernel's elided
//   reads come free). The wrapper picks splits from static sizes only
//   (ops/paged_attention.py decode_splits): none where B*K blocks already
//   fill the card, else up to ~4 blocks an SM with chunks of >= 256 keys;
//   seq_lens stay on the card (no host sync, CUDA-graph safe). A split past
//   its row's limit writes an empty partial (m = -inf, l = 0) and exits;
//   decode_merge combines the splits' (m, l, O) and never reads an empty
//   one's O. 64-key stages of K and V come in by a 3-stage cp.async ring
//   (a page-table tile is no TMA box). Both products run on the tensor
//   cores, mma.sync m16n8k16 bf16 -> float32: the R = T*G <= 64 folded query
//   rows are padded to 16-row m-tiles (wgmma needs 64 rows; most calls have
//   4 or 8), K arrives by ldmatrix, V by ldmatrix.trans, and scores, p and
//   the softmax stay in registers. Warp w holds m-tile w % MT and a quarter
//   (MT = 1), half (MT = 2) or all (MT = 4) of each stage's keys; the
//   warps' partials meet once, in shared memory, at the end. The ring is
//   104.4 KB (q is staged in it first, the merge buffers reuse it): 2
//   blocks an SM, as the runtime's occupancy query reports; ptxas gives
//   164 / 168 / 238 registers at MT = 1 / 2 / 4 (NVIDIA H100 80GB HBM3,
//   700.00 W, CUDA 12.8).
// * K2 is bound by tensor-core operations: ~2*T^2*H*D for causal attention
//   (77 GFLOP a layer at T=3072, qwen3-8b). Hopper reaches its full rate
//   only through wgmma, fed from shared memory by TMA:
//   - a block holds 128 folded query rows (row = t*G + g: the G query heads
//     of one kv head, so each K / V tile is read once per group) on two
//     consumer warpgroups of 64 rows, one wgmma m64 tile each, plus a
//     producer warpgroup whose one thread issues every TMA load and gives
//     its registers to the consumers (setmaxnreg 24 / 240);
//   - the Q tile is two TMA boxes of a 4-D map over q as (D, H, T, B), box
//     (64, G, 128/G, 1), hence 128 % G == 0; K and V tiles (128 keys x 128
//     columns, two 64-column boxes each under 128-byte swizzle, of 3-D maps
//     over k and v as (KV*D, S, B), so past S each batch row reads zeros,
//     never the next row's keys) come through
//     a 3-stage ring with full barriers for K and V and an empty barrier a
//     stage, so loads run ahead of the math without a block-wide barrier;
//   - S = Q K^T takes both operands from shared memory (K-major, 128-byte
//     swizzle descriptors); O += P V takes P from registers as bf16 and V
//     from shared memory transposed by its descriptor (MN-major); S and O
//     are float32 registers (64 + 64 a thread);
//   - the online softmax runs in registers with exp2 (ex2.approx), log2(e)
//     folded into the scale; only diagonal and ragged tiles are masked, and
//     tiles above the diagonal are never loaded; the longest query tiles
//     start first;
//   - each warpgroup issues tile kt+1's QK before tile kt's PV and runs the
//     softmax of kt+1 while PV kt is on the tensor cores; the two consumer
//     warpgroups take turns issuing products (named barriers 1 and 2), so
//     one's softmax runs under the other's products;
//   - shared memory: Q 32 KB + 3 stages of K and V (192 KB) = 224 KB, one
//     block an SM (12 warps), as the runtime's occupancy query reports;
//     ptxas gives 168 registers a thread at entry, moved by setmaxnreg to
//     24 (producer) and 240 (consumers) (NVIDIA H100 80GB HBM3, 700.00 W,
//     CUDA 12.8).
// * K3 sits near the card's ridge: per key it reads 1152 B once and does
//   2*H*(576 + 512) FLOP (H = 128: 242 FLOP a byte). One block per (row,
//   16 query heads): a 64-row stage of the row's context (72 KB,
//   double-buffered with cp.async) feeds both contractions, QK over 576
//   columns and PV over 512, on mma.sync m16n8k16 bf16 -> float32 (an f32
//   accumulator of 128 heads x 512 columns would be 256 KB, past a
//   register file). Warp w holds the 16 heads' scores of keys 16w..16w+15
//   and their PV accumulator of value columns 128w..128w+127; scores and p
//   meet in shared memory for the online softmax. The H/16 head tiles of a
//   row re-read its context, mostly from L2 (8x at H = 128, 4x at H = 64).
//
// Numerics of K3: float32 scores scaled after the product, float32 softmax
// sum. With p_bf16 (B1) PV takes p rounded to bf16; without it (B6, float32
// p) PV runs twice, on bf16(p) and on the bf16 remainder p - bf16(p), which
// carries p to ~16 significant bits in the float32 accumulator.
//
// Numerics. Scores are float32 and the scale D^-1/2 (times log2 e) is
// applied to them: the TPU kernels scale q in float32 first, which agrees
// within bf16 tolerance. p is rounded to bf16 before PV in K2 (wgmma
// operand) and, when p_bf16 is set, in K1 — the B1 round point
// (slot_attention.py:98); B9 rounds p like B1 (slot_attention.py:178). The
// B6 kernels keep p in float32 (paged_attention.py:106): K1 with p_bf16 = 0
// runs PV on bf16(p) and on its bf16 remainder, as K3 does. K1 rounds p
// relative to the running maximum of its own split and warp, not of the
// whole row: a rounding of another p, within the attention tolerance. The
// softmax sum always uses the unrounded p. Masked keys get p = 0 exactly;
// keys past the sequence or the split are masked (K1 loads them as zeros,
// K2's TMA as zeros past S in each batch row: flash_attention.py:58-61
// zeroes such v rows).
//
// Interface: plain C, raw pointers, launched on the caller's stream; no
// allocation; each entry returns the cudaGetLastError() code.

#include <cuda.h>   // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;        // head_dim both kernels are written for
constexpr int ROW = HD + 8;    // padded shared-memory row (272 B: conflict-free)
constexpr int NTH = 128;       // threads per block (4 warps)

constexpr float LOG2E = 1.4426950408889634f;

// K1
constexpr int DBK = 64;        // keys per stage
constexpr int DSTAGES = 3;     // cp.async ring depth
constexpr int DROWS = 64;      // query rows a block holds at most: 4 m-tiles of 16

// K3
constexpr int LDK = 576;       // latent row: kv_lora_rank 512 + rope 64
constexpr int LDV = 512;       // value columns (the latent part of the row)
constexpr int LROW = LDK + 8;  // padded shared-memory row (1168 B: conflict-free)
constexpr int LBH = 16;        // query heads per block: one m16 tile
constexpr int LBK = 64;        // keys per tile: 4 warps x 16
constexpr int PROW = LBK + 8;  // padded p row (144 B)

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------------------- K1

constexpr int decode_smem_bytes() {
  return DSTAGES * 2 * DBK * ROW * (int)sizeof(bf16);   // K/V ring (q staged in it first)
}
constexpr int OROW = HD + 4;   // merge buffer row (floats)
static_assert(DROWS * OROW * 4 + 2 * DROWS * 4 <= decode_smem_bytes(),
              "the merge buffers must fit in the ring");
static_assert(DROWS <= DBK, "the q tile is staged in one K buffer of the ring");

// grid (B, KV, splits), NTH threads. Query rows of the block: r = t*G + g for
// the T tokens and the G = H/KV query heads of kv head blockIdx.y; R = T*G
// <= 64 of them, padded to MT m-tiles of 16. Query t of row b sees keys
//   j < limit(t) = min(seq_len[b] (>= 1 if min_one), qpos[b*qpos_stride] + t + 1,
//                      max_keys)
// (qpos == nullptr: j < min(seq_len, max_keys) for every t). Key j of row b
// lies at page table[b*P + j/ps] (table == nullptr: row_offset + b), slot
// j % ps of the [R, ps, KV, HD] pools. Split z covers keys [z*chunk,
// (z+1)*chunk) (chunk a multiple of DBK). Warp w holds m-tile w % MT and
// keys [(w / MT) * KW, ...) of every stage (KP = 4/MT warps share an
// m-tile); their (m, l, O) meet in shared memory at the end. With one split
// the block writes out; with more it writes its unnormalised O and (m, l)
// (m in log2 units) to o_part / ml_part, and decode_merge finishes.
template <int MT>
__global__ void __launch_bounds__(NTH)
decode_attention(const bf16* __restrict__ q, long long q_bstride,
                 const bf16* __restrict__ kp, const bf16* __restrict__ vp,
                 const long long* __restrict__ table, int P, long long row_offset,
                 const long long* __restrict__ seq_len, const long long* __restrict__ qpos,
                 int qpos_stride, int min_one, int max_keys, bf16* __restrict__ out, int T,
                 int H, int KV, int ps, float scale_log2, int p_bf16, int chunk,
                 float* __restrict__ o_part, float* __restrict__ ml_part) {
  constexpr int KP = 4 / MT;      // warps that share an m-tile, each a part of the keys
  constexpr int KW = DBK / KP;    // keys of a stage per warp
  constexpr int NB = KW / 8;      // its n-blocks of 8 keys
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kvs = reinterpret_cast<bf16*>(smem);   // [DSTAGES][2][DBK][ROW]

  const int b = blockIdx.x, kh = blockIdx.y, z = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV, R = T * G;
  long long sl = seq_len[b];
  if (min_one) sl = sl > 1 ? sl : 1;
  const long long q0 = qpos ? qpos[(long long)b * qpos_stride] : sl - 1;
  auto limit = [&](int t) -> int {
    long long v = q0 + t + 1;
    v = v < sl ? v : sl;
    v = v < max_keys ? v : max_keys;
    return v > 0 ? (int)v : 0;
  };
  const int k0 = z * chunk;
  const int k1 = min(k0 + chunk, limit(T - 1));   // the widest row's limit
  const int ntiles = k1 > k0 ? (k1 - k0 + DBK - 1) / DBK : 0;
  const long long prow = ((long long)(b * KV + kh) * splits + z) * R;   // partial rows
  if (splits > 1 && ntiles == 0) {   // an empty split: the merge skips it
    for (int r = tid; r < R; r += NTH) {
      ml_part[2 * (prow + r)] = -INFINITY;
      ml_part[2 * (prow + r) + 1] = 0.f;
    }
    return;
  }

  // q tile, zero-padded to MT*16 rows, staged in the last stage's K buffer
  bf16* qs = kvs + (DSTAGES - 1) * 2 * DBK * ROW;
  for (int i = tid; i < MT * 16 * (HD / 8); i += NTH) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const bool ok = r < R;
    const int t = ok ? r / G : 0, g = ok ? r % G : 0;
    cp_async16(qs + r * ROW + c, q + b * q_bstride + ((long long)t * H + kh * G + g) * HD + c,
               ok ? 16 : 0);
  }
  cp_async_commit();

  const long long kv_row = (long long)KV * HD;   // elements between slots
  auto load_tile = [&](int stage, int kt) {
    bf16* kd = kvs + stage * 2 * DBK * ROW;
    bf16* vd = kd + DBK * ROW;
    for (int i = tid; i < DBK * (HD / 8); i += NTH) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int j = k0 + kt * DBK + r;
      const bool ok = j < k1;                   // keys past the split load as zeros
      long long off = 0;
      if (ok) {
        const long long page = table ? table[(long long)b * P + j / ps] : row_offset + b;
        off = (page * ps + j % ps) * kv_row + (long long)kh * HD + c;
      }
      cp_async16(kd + r * ROW + c, kp + off, ok ? 16 : 0);
      cp_async16(vd + r * ROW + c, vp + off, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  const int mt = warp % MT, kpart = warp / MT;
  const int mi = lane >> 3, rr = lane & 7, c2 = (lane & 3) * 2;
  cp_async_wait<DSTAGES - 1>();   // the q group
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (mt * 16 + rr + 8 * (mi & 1)) * ROW + kk * 16 + 8 * (mi >> 1));
  __syncthreads();   // the q buffer is the ring's last stage from here on

  // this thread's two rows of the m-tile (padding rows take the last row's limit)
  const int r0 = mt * 16 + (lane >> 2), r1 = r0 + 8;
  const int lim0 = limit(min(r0, R - 1) / G), lim1 = limit(min(r1, R - 1) / G);
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();   // tile kt landed for every thread; tile kt-1's stage is free
    {
      const int nt = kt + DSTAGES - 1;
      if (nt < ntiles) load_tile(nt % DSTAGES, nt);
      cp_async_commit();
    }
    const bf16* kst = kvs + (kt % DSTAGES) * 2 * DBK * ROW + kpart * KW * ROW;
    const bf16* vst = kst + DBK * ROW;

    // S = Q K^T over this warp's KW keys
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < NB / 2; ++h) {
        uint32_t r4[4];
        ldmatrix_x4(r4, kst + (h * 16 + 8 * (mi >> 1) + rr) * ROW + kk * 16 + 8 * (mi & 1));
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        mma_bf16(s[2 * h], qf[kk], b0);
        mma_bf16(s[2 * h + 1], qf[kk], b1);
      }
    }

    // mask, online softmax in registers (log2 units; rows r0: s[.][0..1], r1: s[.][2..3])
    const int kb = k0 + kt * DBK + kpart * KW;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kb + n * 8 + c2 + (i & 1);
        const float val = key < (i < 2 ? lim0 : lim1) ? s[n][i] * scale_log2 : -INFINITY;
        s[n][i] = val;
        if (i < 2) mx0 = fmaxf(mx0, val);
        else mx1 = fmaxf(mx1, val);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no key yet keeps m = -inf; exp2(-inf - 0) = 0 leaves it empty
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0, ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - ms0), al1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[n][i] - (i < 2 ? ms0 : ms1));
        s[n][i] = p;
        if (i < 2) ps0 += p;
        else ps1 += p;
      }
    }
    l0 = l0 * al0 + ps0;   // per-thread partial sums; reduced over the quad at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V: P from the score registers as bf16 (and, for float32 p, its
    // bf16 remainder through the same V fragments), V by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < KW / 16; ++j) {
      const float* p0 = s[2 * j];
      const float* p1 = s[2 * j + 1];
      const uint32_t a[4] = {pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
                             pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
      uint32_t lo[4] = {0u, 0u, 0u, 0u};
      if (!p_bf16) {
        lo[0] = pack_bf16(p0[0] - bf16_round(p0[0]), p0[1] - bf16_round(p0[1]));
        lo[1] = pack_bf16(p0[2] - bf16_round(p0[2]), p0[3] - bf16_round(p0[3]));
        lo[2] = pack_bf16(p1[0] - bf16_round(p1[0]), p1[1] - bf16_round(p1[1]));
        lo[3] = pack_bf16(p1[2] - bf16_round(p1[2]), p1[3] - bf16_round(p1[3]));
      }
#pragma unroll
      for (int h = 0; h < HD / 16; ++h) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, vst + (j * 16 + 8 * (mi & 1) + rr) * ROW + (2 * h + (mi >> 1)) * 8);
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        mma_bf16(o[2 * h], a, b0);
        mma_bf16(o[2 * h + 1], a, b1);
        if (!p_bf16) {
          mma_bf16(o[2 * h], lo, b0);
          mma_bf16(o[2 * h + 1], lo, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: it holds the merge buffers now

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* ob = reinterpret_cast<float*>(smem);   // [KP][MT*16][OROW]
  float* mb = ob + DROWS * OROW;                // [KP][MT*16]
  float* lb = mb + DROWS;
  const int wrow = (kpart * MT + mt) * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(ob + wrow * OROW + n * 8 + c2) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(ob + (wrow + 8) * OROW + n * 8 + c2) =
        make_float2(o[n][2], o[n][3]);
  }
  if ((lane & 3) == 0) {
    mb[wrow] = m0;
    lb[wrow] = l0;
    mb[wrow + 8] = m1;
    lb[wrow + 8] = l1;
  }
  __syncthreads();

  // thread tid owns output column tid of every row: merge the KP key parts
  for (int r = 0; r < R; ++r) {
    float M = -INFINITY;
#pragma unroll
    for (int k = 0; k < KP; ++k) M = fmaxf(M, mb[k * MT * 16 + r]);
    float L = 0.f, acc = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int wr = k * MT * 16 + r;
        const float w = exp2f(mb[wr] - M);   // 0 for a part with no key
        L += lb[wr] * w;
        acc += ob[wr * OROW + tid] * w;
      }
    }
    if (splits == 1) {
      const int t = r / G, g = r % G;
      out[(((long long)b * T + t) * H + kh * G + g) * HD + tid] =
          __float2bfloat16(acc / fmaxf(L, 1e-30f));
    } else {
      o_part[(prow + r) * HD + tid] = acc;
      if (tid == 0) {
        ml_part[2 * (prow + r)] = M;
        ml_part[2 * (prow + r) + 1] = L;
      }
    }
  }
}

// grid (R, KV, B), HD threads: out row r of (b, kv head) from the splits'
// partials; splits with no key (m = -inf) are skipped, never read
__global__ void __launch_bounds__(HD)
decode_merge(const float* __restrict__ o_part, const float* __restrict__ ml_part,
             bf16* __restrict__ out, int T, int H, int KV, int splits) {
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int G = H / KV, R = T * G;
  const long long base = (long long)(b * KV + kh) * splits;
  float M = -INFINITY;
  for (int z = 0; z < splits; ++z) M = fmaxf(M, ml_part[2 * ((base + z) * R + r)]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {
    for (int z = 0; z < splits; ++z) {
      const long long pr = (base + z) * R + r;
      const float m = ml_part[2 * pr];
      if (m == -INFINITY) continue;
      const float w = exp2f(m - M);
      L += ml_part[2 * pr + 1] * w;
      acc += o_part[pr * HD + d] * w;
    }
  }
  const int t = r / G, g = r % G;
  out[(((long long)b * T + t) * H + kh * G + g) * HD + d] =
      __float2bfloat16(acc / fmaxf(L, 1e-30f));
}

template <int MT>
int launch_decode(const void* q, long long q_bstride, const void* k, const void* v,
                  const void* table, int P, long long row_offset, const void* seq_len,
                  const void* qpos, int qpos_stride, int min_one, int max_keys, void* out,
                  int B, int T, int H, int KV, int ps, float scale, int p_bf16, int splits,
                  int chunk, void* o_part, void* ml_part, cudaStream_t st) {
  constexpr int bytes = decode_smem_bytes();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(decode_attention<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  decode_attention<MT><<<dim3(B, KV, splits), NTH, bytes, st>>>(
      static_cast<const bf16*>(q), q_bstride, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const long long*>(table), P, row_offset,
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos),
      qpos_stride, min_one, max_keys, static_cast<bf16*>(out), T, H, KV, ps,
      scale * LOG2E, p_bf16, chunk, static_cast<float*>(o_part),
      static_cast<float*>(ml_part));
  if (splits > 1) {
    decode_merge<<<dim3(T * (H / KV), KV, B), HD, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<bf16*>(out), T, H, KV, splits);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K2

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}
// one arrival that also expects `bytes` from the TMA loads of this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// wait for the completion of the phase of parity `parity`; a wait that lasts
// ~10 s (a lost arrival) traps, so a fault fails the launch instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > 20000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor of a tile stored in 128-byte swizzle atoms
// (8 rows of 128 B, as TMA's CU_TENSOR_MAP_SWIZZLE_128B writes them): start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// named barriers 1 and 2 order the two consumer warpgroups' products
// (0 is __syncthreads'): 256 threads, one warpgroup syncing, the other
// arriving
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

template <int N>   // at most N committed groups still running
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// pins the accumulators in place around the asynchronous products: no read
// or write of them moves across this point
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A B for a 64x128 tile of the warpgroup, K = 16: A and B from shared
// memory by descriptor, both K-major (scale_d = 0: d = A B)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B with A (16 bf16 a thread, the m16n8k16 A fragment of its warp's
// 16 rows) from registers and B from shared memory, transposed (MN-major)
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

constexpr int FBM = 128;       // folded query rows a block: two consumer warpgroups x 64
constexpr int FBN = 128;       // keys a K / V tile
constexpr int FSTAGES = 3;     // K / V ring depth
constexpr int FTH = 384;       // two consumer warpgroups + the producer warpgroup
constexpr int SWZ = 64;        // bf16 columns of one 128-byte swizzle atom: a TMA box's width
constexpr int FTILE = FBN * HD * 2;   // bytes of one K or V tile (and of the Q tile)
constexpr int FHALF = FTILE / 2;      // one 64-column half of a tile
static_assert(FBM == FBN, "the Q tile and a K / V tile share one size");

// what the softmax of one score tile needs of its rows: their positions
// (rows r0 and r0 + 8 of the thread), where masking starts, S, the column
// pair of the thread and the scale in log2 units
struct SoftmaxRows {
  int t0, t1, t_first, S, c2;
  float scale_log2;
};

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// scale, mask (only a tile that reaches past the first row's position or
// past S) and online softmax of the 64 x 128 score tile of keys kbase ..
// kbase + 127 in registers (row r0: sc[4i], sc[4i+1]; row r0 + 8: sc[4i+2],
// sc[4i+3]; key kbase + 8i + c2 (+1)); p leaves as bf16 pairs, pk[i] =
// (p[2i], p[2i+1]): the wgmma A fragments of the value product; m, l are
// updated and al0 / al1 are the factors of the old sums
__device__ __forceinline__ void softmax_tile(float (&sc)[64], uint32_t (&pk)[32], float& m0,
                                             float& m1, float& l0, float& l1, float& al0,
                                             float& al1, int kbase, const SoftmaxRows& r) {
  const bool masked = kbase + FBN - 1 > r.t_first || kbase + FBN > r.S;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * i + e] * r.scale_log2;
      if (masked) {
        const int key = kbase + 8 * i + r.c2 + (e & 1);
        if (key > (e < 2 ? r.t0 : r.t1) || key >= r.S) v = -INFINITY;
      }
      sc[4 * i + e] = v;
      if (e < 2) mx0 = fmaxf(mx0, v);
      else mx1 = fmaxf(mx1, v);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // a row with no key yet keeps m = -inf; 2^(-inf - 0) = 0 leaves it empty
  const float ms0 = mn0 == -INFINITY ? 0.f : mn0, ms1 = mn1 == -INFINITY ? 0.f : mn1;
  al0 = fast_exp2(m0 - ms0);
  al1 = fast_exp2(m1 - ms1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float ms = (i & 1) ? ms1 : ms0;
    const float p0 = fast_exp2(sc[2 * i] - ms), p1 = fast_exp2(sc[2 * i + 1] - ms);
    if (i & 1) ps1 += p0 + p1;
    else ps0 += p0 + p1;
    pk[i] = pack_bf16(p0, p1);
  }
  l0 = l0 * al0 + ps0;   // per-thread partial sums; reduced over the quad at the end
  l1 = l1 * al1 + ps1;
}

constexpr int flash_smem_bytes() {
  return 1024                                  // slack: the tiles start 1024-byte aligned
         + FTILE * (1 + 2 * FSTAGES)           // Q, then FSTAGES K and V tiles
         + 8 * (1 + 3 * FSTAGES);              // mbarriers
}

// grid (KV, B, ceil(T*G / FBM)), FTH threads, one block an SM. Block
// (kh, b, m) holds folded rows rho = m*FBM .. +FBM-1 of kv head kh, row rho =
// t*G + g being query head kh*G + g at position t = rho / G (the TMA box
// (64, G, FBM/G, 1) over q as (D, H, T, B) writes them in this order). Row rho
// sees keys j <= t, j < S (the TPU kernel's top-left mask,
// flash_attention.py:49). Tiles are 128 rows of 256 B in two 64-column
// halves of 128-byte swizzle atoms, as TMA writes them and wgmma reads them.
// Warpgroup 2 is the producer: one thread issues every TMA load. Warpgroups
// 0 and 1 each own 64 rows: S = Q K^T (both from shared memory), the online
// softmax in registers (log2 units), O += P V (P from registers, V from
// shared memory, transposed by its descriptor).
__global__ void __launch_bounds__(FTH, 1)
flash_attention(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int T, int S,
                int H, int KV, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ks = qs + FTILE;                  // [FSTAGES] K tiles
  unsigned char* vs = ks + FSTAGES * FTILE;        // [FSTAGES] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + FSTAGES * FTILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + FSTAGES;
  uint64_t* empty = v_full + FSTAGES;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int m = gridDim.z - 1 - blockIdx.z;        // the longest query tiles start first
  const int G = H / KV, TQ = FBM / G, R = T * G;
  const int t_first = m * TQ;
  const int t_last = min(t_first + TQ, T) - 1;
  const int ntiles = (min(S, t_last + 1) + FBN - 1) / FBN;   // no tile above the diagonal
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);   // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: registers go to the consumers; one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, FTILE);
      for (int h = 0; h < 2; ++h)
        tma_load_4d(qs + h * FHALF, &tq, q_full, h * SWZ, kh * G, t_first, b);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % FSTAGES;
        if (kt >= FSTAGES) mbar_wait(&empty[s], (kt / FSTAGES - 1) & 1);
        mbar_expect_tx(&k_full[s], FTILE);
        for (int h = 0; h < 2; ++h)
          tma_load_3d(ks + s * FTILE + h * FHALF, &tk, &k_full[s], kh * HD + h * SWZ,
                      kt * FBN, b);
        mbar_expect_tx(&v_full[s], FTILE);
        for (int h = 0; h < 2; ++h)
          tma_load_3d(vs + s * FTILE + h * FHALF, &tv, &v_full[s], kh * HD + h * SWZ,
                      kt * FBN, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64*wg .. 64*wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int c2 = (lane & 3) * 2;
    const int r0 = wg * 64 + wq * 16 + (lane >> 2);   // this thread's rows r0, r0 + 8
    const int t0 = (m * FBM + r0) / G, t1 = (m * FBM + r0 + 8) / G;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float sc[64];
    uint32_t pk[32], pn[32];   // p of the tile in the value product, and of the next
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;
    const SoftmaxRows rows{t0, t1, t_first, S, c2, scale_log2};

    // S = Q K^T of tile kt into sc (asynchronous: committed, not waited)
    auto issue_qk = [&](int kt) {
      const unsigned char* kst = ks + (kt % FSTAGES) * FTILE;
      mbar_wait(&k_full[kt % FSTAGES], (kt / FSTAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // steps 4..7 in the second 64-column half
        const int off = (kk / 4) * FHALF + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(qs + off + wg * 64 * 128, 16, 1024),
                 sw128_desc(kst + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    // O += P V of tile kt (asynchronous): V is [keys][columns] in shared
    // memory (MN-major): its two 64-column halves lie 16 KB apart (LBO),
    // 8-key groups 1 KB apart (SBO)
    auto issue_pv = [&](int kt) {
      mbar_wait(&v_full[kt % FSTAGES], (kt / FSTAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < FBN / 16; ++j)
        wgmma_rs_tb(o, pk[4 * j], pk[4 * j + 1], pk[4 * j + 2], pk[4 * j + 3],
                    sw128_desc(vs + (kt % FSTAGES) * FTILE + j * 16 * 128, FHALF, 1024));
      wgmma_commit();
    };

    // ping-pong: warpgroup wg issues its products between bar_sync(1 + wg)
    // and bar_arrive(2 - wg), so the two take turns on the tensor cores and
    // one's softmax runs under the other's products; warpgroup 1 lets
    // warpgroup 0 go first. Both run the same tiles, so turns pair up.
    if (wg == 1) bar_arrive(1);
    mbar_wait(q_full, 0);
    bar_sync(1 + wg);
    issue_qk(0);
    bar_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, pk, m0, m1, l0, l1, al0, al1, 0, rows);
    // every tile but the last: the QK of tile kt+1 is issued before the PV
    // of tile kt, and the softmax of kt+1 runs while PV kt is on the tensor
    // cores (no branch inside, so ptxas sees which group each wait retires)
    for (int kt = 0; kt + 1 < ntiles; ++kt) {
      bar_sync(1 + wg);
      issue_qk(kt + 1);
      issue_pv(kt);
      bar_arrive(2 - wg);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile(sc, pn, m0, m1, l0, l1, al0, al1, (kt + 1) * FBN, rows);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pk);   // pk stays untouched until the product that reads it is done
      mbar_arrive(&empty[kt % FSTAGES]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) pk[i] = pn[i];
    }
    bar_sync(1 + wg);
    issue_pv(ntiles - 1);
    bar_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[(ntiles - 1) % FSTAGES]);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rho = m * FBM + r0 + 8 * half;
      if (rho >= R) continue;
      const int t = rho / G, g = rho % G;
      bf16* orow = out + (((long long)b * T + t) * H + kh * G + g) * HD;
      const float inv = half ? inv1 : inv0;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + c2) = __floats2bfloat162_rn(
            o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled, fetched from the driver at run time (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor map with 128-byte swizzle (zeros past the tensor's end)
bool bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc && enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                    strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------------- K3

constexpr int latent_smem_bytes() {
  return (LBH + 2 * LBK) * LROW * (int)sizeof(bf16)    // q tile + 2 stages of rows
         + 2 * LBH * PROW * (int)sizeof(bf16)           // p (hi, lo)
         + LBH * LBK * (int)sizeof(float)               // scores
         + 3 * LBH * (int)sizeof(float);                // m, l, alpha
}

// grid (B, H / LBH), NTH threads (4 warps). Block (b, hb) holds query heads
// hb*16 .. hb*16 + 15 of row b (one m16 tile), which all see keys j < limit:
//   limit = min(seq_len[b] (>= 1 if min_one), qpos[b*qpos_stride] + 1 (qpos
//           not null), max_keys).
// Key j lies at slot j % ps of page table[b*P + j/ps] (table == nullptr:
// row_offset + b) of the [R, ps, 1, LDK] pool; its first LDV columns are its
// value. One stage of LBK rows in shared memory feeds both products: QK over
// all LDK columns (warp w: keys 16w .. 16w + 15), PV over the first LDV
// (warp w: value columns 128w .. 128w + 127).
__global__ void __launch_bounds__(NTH)
latent_attention(const bf16* __restrict__ q, const bf16* __restrict__ pool,
                 const long long* __restrict__ table, int P, long long row_offset,
                 const long long* __restrict__ seq_len, const long long* __restrict__ qpos,
                 int qpos_stride, int min_one, int max_keys, bf16* __restrict__ out, int H,
                 int ps, float scale, int p_bf16) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);                 // [LBH][LROW]
  bf16* ks = qs + LBH * LROW;                               // [2][LBK][LROW]
  bf16* pt = ks + 2 * LBK * LROW;                           // [2][LBH][PROW]: p hi, lo
  float* ss = reinterpret_cast<float*>(pt + 2 * LBH * PROW);  // [LBH][LBK]
  float* ms = ss + LBH * LBK;
  float* ls = ms + LBH;
  float* as = ls + LBH;

  const int b = blockIdx.x, h0 = blockIdx.y * LBH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  long long lim = seq_len[b];
  if (min_one) lim = lim > 1 ? lim : 1;
  if (qpos) {
    const long long v = qpos[(long long)b * qpos_stride] + 1;
    lim = lim < v ? lim : v;
  }
  lim = lim < max_keys ? lim : max_keys;
  const int nkeys = lim > 0 ? (int)lim : 0;
  const int ntiles = (nkeys + LBK - 1) / LBK;

  for (int i = tid; i < LBH * (LDK / 8); i += NTH) {
    const int r = i / (LDK / 8), c = (i % (LDK / 8)) * 8;
    cp_async16(qs + r * LROW + c, q + ((long long)b * H + h0 + r) * LDK + c, 16);
  }
  // warp w copies rows w, w + 4, ...: one page lookup a row, 16 bytes a lane
  auto load_tile = [&](int stage, int kt) {
    bf16* dst = ks + stage * LBK * LROW;
    for (int r = warp; r < LBK; r += NTH / 32) {
      const int j = kt * LBK + r;
      const bool ok = j < nkeys;                 // rows past the limit load as zeros
      const bf16* src = pool;
      if (ok) {
        const long long page = table ? table[(long long)b * P + j / ps] : row_offset + b;
        src = pool + (page * ps + j % ps) * LDK;
      }
      for (int c = lane * 8; c < LDK; c += 32 * 8)
        cp_async16(dst + r * LROW + c, ok ? src + c : src, ok ? 16 : 0);
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();   // the q tile and tile 0
  if (tid < LBH) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
    as[tid] = 1.f;
  }

  constexpr int NB = LDV / 4 / 8;   // this warp's n-blocks of 8 value columns
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  const int mi = lane >> 3, rr = lane & 7;       // ldmatrix lane roles
  const int g = lane >> 2, c2 = (lane & 3) * 2;  // accumulator lane roles

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) load_tile((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and q) landed; tile kt-1's stage is refilled only now
    const bf16* kst = ks + (kt & 1) * LBK * LROW;

    // (1) scores of the 16 heads against this warp's 16 keys, 36 k-steps;
    // even and odd k-steps accumulate apart (four independent mma chains)
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < LDK / 16; ++kk) {
      uint32_t a[4], r4[4];
      ldmatrix_x4(a, qs + (rr + 8 * (mi & 1)) * LROW + kk * 16 + 8 * (mi >> 1));
      ldmatrix_x4(r4, kst + (warp * 16 + 8 * (mi >> 1) + rr) * LROW + kk * 16 + 8 * (mi & 1));
      const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
      mma_bf16(s[2 * (kk & 1)], a, b0);
      mma_bf16(s[2 * (kk & 1) + 1], a, b1);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = warp * 16 + n * 8 + c2 + (i & 1);
        ss[(g + 8 * (i >> 1)) * LBK + kl] =
            kt * LBK + kl < nkeys ? (s[n][i] + s[2 + n][i]) * scale : -INFINITY;
      }
    }
    __syncthreads();

    // (2) online softmax, one warp per row, two keys a lane; p is stored as
    // bf16 (hi) and, for float32 p, its bf16 remainder (lo)
    for (int r = warp; r < LBH; r += NTH / 32) {
      const float s0 = ss[r * LBK + lane], s1 = ss[r * LBK + lane + 32];
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
        p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
        alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      }
      const float psum = warp_sum(p0 + p1);
      const bf16 hi0 = __float2bfloat16(p0), hi1 = __float2bfloat16(p1);
      pt[r * PROW + lane] = hi0;
      pt[r * PROW + lane + 32] = hi1;
      if (!p_bf16) {
        pt[(LBH + r) * PROW + lane] = __float2bfloat16(p0 - __bfloat162float(hi0));
        pt[(LBH + r) * PROW + lane + 32] = __float2bfloat16(p1 - __bfloat162float(hi1));
      }
      if (lane == 0) {
        ls[r] = ls[r] * alpha + psum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();

    // (3) O = O * alpha + P V over this warp's 128 value columns
    const float al0 = as[g], al1 = as[g + 8];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
#pragma unroll
    for (int j = 0; j < LBK / 16; ++j) {
      uint32_t a[4], bv[NB][2];
      ldmatrix_x4(a, pt + (rr + 8 * (mi & 1)) * PROW + j * 16 + 8 * (mi >> 1));
#pragma unroll
      for (int h = 0; h < NB / 2; ++h) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, kst + (j * 16 + 8 * (mi & 1) + rr) * LROW + warp * (LDV / 4) +
                                  (2 * h + (mi >> 1)) * 8);
        bv[2 * h][0] = r4[0];
        bv[2 * h][1] = r4[1];
        bv[2 * h + 1][0] = r4[2];
        bv[2 * h + 1][1] = r4[3];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) mma_bf16(o[n], a, bv[n]);
      if (!p_bf16) {   // the remainder of float32 p, through the same fragments
        ldmatrix_x4(a, pt + (LBH + rr + 8 * (mi & 1)) * PROW + j * 16 + 8 * (mi >> 1));
#pragma unroll
        for (int n = 0; n < NB; ++n) mma_bf16(o[n], a, bv[n]);
      }
    }
    __syncthreads();   // every warp is done with this stage and the p tile
  }
  cp_async_wait<0>();
  __syncthreads();     // ls is initialised even when no tile ran

  const float inv0 = 1.f / fmaxf(ls[g], 1e-30f), inv1 = 1.f / fmaxf(ls[g + 8], 1e-30f);
  bf16* o0 = out + ((long long)b * H + h0 + g) * LDV + warp * (LDV / 4) + c2;
  bf16* o1 = o0 + 8 * LDV;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(o0 + n * 8) =
        __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(o1 + n * 8) =
        __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

extern "C" {

// K1 (B1 / B6). q [B,T,H,128] bf16 with batch stride q_bstride (elements;
// the other dimensions contiguous); out [B,T,H,128] bf16; k, v [R,ps,KV,128]
// bf16 (v may be k); table [B,P] int64 or null (identity: page
// row_offset + b); seq_len [B] int64; qpos int64 with stride qpos_stride or
// null. Query rows T*H/KV <= 64. The context is cut into `splits` chunks
// of `chunk` keys (a multiple of 64), one block each; with splits > 1,
// o_part [B,KV,splits,R,128] and ml_part [B,KV,splits,R,2] are float32
// scratch that decode_merge reduces.
int dstts_decode_attention(const void* q, long long q_bstride, const void* k,
                           const void* v, const void* table, int P, long long row_offset,
                           const void* seq_len, const void* qpos, int qpos_stride,
                           int min_one, int max_keys, void* out, int B, int T, int H,
                           int KV, int ps, float scale, int p_bf16, int splits, int chunk,
                           void* o_part, void* ml_part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = T * (H / KV);
  // m-tiles of 16 rows: the smallest instance that covers the block's R rows
  using Launch = int (*)(const void*, long long, const void*, const void*, const void*,
                         int, long long, const void*, const void*, int, int, int, void*,
                         int, int, int, int, int, float, int, int, int, void*, void*,
                         cudaStream_t);
  if (R > DROWS || splits < 1 || chunk % DBK) return (int)cudaErrorInvalidValue;
  const Launch launch =
      R <= 16 ? &launch_decode<1> : R <= 32 ? &launch_decode<2> : &launch_decode<4>;
  return launch(q, q_bstride, k, v, table, P, row_offset, seq_len, qpos, qpos_stride,
                min_one, max_keys, out, B, T, H, KV, ps, scale, p_bf16, splits, chunk,
                o_part, ml_part, st);
}

// K3 (B1's shared variant and B6 at MLA's latent width). q [B,H,576] bf16
// contiguous; pool [R,ps,1,576] bf16; table [B,P] int64 or null (identity:
// page row_offset + b); seq_len [B] int64; qpos int64 with stride
// qpos_stride or null; out [B,H,512] bf16 (the value columns only). H % 16 == 0.
int dstts_latent_attention(const void* q, const void* pool, const void* table, int P,
                           long long row_offset, const void* seq_len, const void* qpos,
                           int qpos_stride, int min_one, int max_keys, void* out, int B,
                           int H, int ps, float scale, int p_bf16, void* stream) {
  if (H % LBH) return (int)cudaErrorInvalidValue;
  constexpr int bytes = latent_smem_bytes();
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(latent_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  latent_attention<<<dim3(B, H / LBH), NTH, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pool),
      static_cast<const long long*>(table), P, row_offset,
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos),
      qpos_stride, min_one, max_keys, static_cast<bf16*>(out), H, ps, scale, p_bf16);
  return (int)cudaGetLastError();
}

// K2 (B2). q, out [B,T,H,128]; k, v [B,S,KV,128]; all bf16, contiguous,
// 16-byte aligned. 128 % (H / KV) == 0. The TMA tensor maps are encoded here
// on each call and passed by value (__grid_constant__), so a captured CUDA
// graph replays them with the same tensors.
int dstts_flash_attention(const void* q, const void* k, const void* v, void* out,
                          int B, int T, int S, int H, int KV, float scale, void* stream) {
  if (KV < 1 || H % KV || FBM % (H / KV) || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  CUtensorMap tq, tk, tv;
  // q as (D, H, T, B): a box of (64 columns, G heads, FBM/G positions, one
  // batch row) is half of a tile's folded rows t*G + g
  const cuuint64_t qdim[4] = {HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t qstride[3] = {HD * 2, (cuuint64_t)H * HD * 2, (cuuint64_t)T * H * HD * 2};
  const cuuint32_t qbox[4] = {SWZ, (cuuint32_t)G, (cuuint32_t)(FBM / G), 1};
  // k, v as (KV*D, S, B): kv head kh's keys are columns kh*D .. kh*D + 127;
  // a tile past S reads zeros in every batch row, not the next row's keys
  const cuuint64_t kdim[3] = {(cuuint64_t)KV * HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstride[2] = {(cuuint64_t)KV * HD * 2, (cuuint64_t)S * KV * HD * 2};
  const cuuint32_t kbox[3] = {SWZ, FBN, 1};
  if (!bf16_map(&tq, q, 4, qdim, qstride, qbox) || !bf16_map(&tk, k, 3, kdim, kstride, kbox) ||
      !bf16_map(&tv, v, 3, kdim, kstride, kbox))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = flash_smem_bytes();
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_attention, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attr_set = true;
  }
  flash_attention<<<dim3(KV, B, (T * G + FBM - 1) / FBM), FTH, bytes,
                    static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, static_cast<bf16*>(out), T,
                                                         S, H, KV, scale * LOG2E);
  return (int)cudaGetLastError();
}

// Blocks an SM can hold, as the runtime computes them from each kernel's
// registers, threads and shared memory: out[0..4] = K1 (1, 2 and 4 m-tiles),
// K2, K3.
int dstts_attention_occupancy(int* out) {
  // the opt-in above 48 KB first: without it a block of this size fits nowhere
  cudaFuncSetAttribute(decode_attention<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       decode_smem_bytes());
  cudaFuncSetAttribute(decode_attention<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       decode_smem_bytes());
  cudaFuncSetAttribute(decode_attention<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       decode_smem_bytes());
  cudaFuncSetAttribute(flash_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       flash_smem_bytes());
  cudaFuncSetAttribute(latent_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       latent_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], decode_attention<1>, NTH,
                                                decode_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], decode_attention<2>, NTH,
                                                decode_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], decode_attention<4>, NTH,
                                                decode_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], flash_attention, FTH,
                                                flash_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], latent_attention, NTH,
                                                latent_smem_bytes());
  return (int)cudaGetLastError();
}

}  // extern "C"
