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
//   2*H*(576 + 512) FLOP (H = 128: 242 FLOP a byte), so it wants the
//   tensor cores' full rate and every SM streaming. The design follows the
//   published shape of FlashMLA (DeepSeek's MLA decode kernel):
//   - one block holds 64 query heads (one wgmma m64 tile; H % 64 == 0 covers
//     deepseek-v3's 128 and kimi-k2's 64) and one chunk of one row's
//     context: grid (B, H/64, splits), the split chosen from static sizes
//     and the SM count (ops/paged_attention.py latent_splits: K1's policy
//     with one block an SM and chunks of >= 256 keys, the least chunk set by
//     scripts/sweep_hopper_kernels.py). An empty split writes m = -inf and
//     exits; decode_merge<512> combines the splits' (m, l, O) and never
//     reads an empty one's O;
//   - a producer warpgroup: one thread issues every TMA load, the q tile
//     (nine 64-column boxes, 72 KB) once, then 64-key tiles (72 KB) into a
//     2-stage full / empty mbarrier ring; a slot row's tile is one box
//     column of 64 consecutive pool rows, a paged tile one box per page
//     (pages of 64 keys or more: one; of 8 .. 32: several), and boxes wholly
//     past the row's limit are not loaded;
//   - consumer warpgroup 0 computes S = Q K^T (64 x 64, both K-major from
//     shared memory, 36 k-steps) and the online softmax in registers (exp2,
//     log2 e in the scale), hands p to warpgroup 1 as bf16 A fragments in
//     shared memory (each thread's slots: the thread with the same rows
//     reads its own fragment back) with the rescale factors, and
//     accumulates O over value columns 0..255; warpgroup 1 accumulates
//     columns 256..511 from the same p. PV takes p from registers and V
//     from the same tile's first 512 columns (MN-major), so a tile is read
//     once for both products; a 64 x 512 float32 accumulator would be 256
//     registers a thread in one warpgroup, two hold 128 each;
//   - shared memory: q 72 KB + 2 key tiles 144 KB + p 8 KB = 226 KB, one
//     block an SM (12 warps), as the runtime's occupancy query reports;
//     ptxas gives 168 registers a thread at entry, moved by setmaxnreg to
//     24 (producer) and 240 (consumers) (NVIDIA H100 80GB HBM3, 700.00 W,
//     CUDA 12.8).
//
// Numerics of K3: float32 scores scaled after the product, float32 softmax
// sum. With p_bf16 (B1) PV takes p rounded to bf16; without it (B6, float32
// p) PV runs twice, on bf16(p) and on the bf16 remainder p - bf16(p), which
// carries p to ~16 significant bits in the float32 accumulator; the
// remainder goes to warpgroup 1 through the tile's rope box, which QK no
// longer needs. Value rows past the limit are zeroed in shared memory
// before PV: they weigh p = 0 but may hold anything (a never-written slot,
// an unloaded box).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma

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

// grid (R, KV, B), D threads: out row r of (b, kv head) from the splits'
// partials (D columns: K1's HD, K3's LDV); splits with no key (m = -inf)
// are skipped, never read
template <int D>
__global__ void __launch_bounds__(D)
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
      acc += o_part[pr * D + d] * w;
    }
  }
  const int t = r / G, g = r % G;
  out[(((long long)b * T + t) * H + kh * G + g) * D + d] =
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
    decode_merge<HD><<<dim3(T * (H / KV), KV, B), HD, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<bf16*>(out), T, H, KV, splits);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K2

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
    mbar_init_fence();
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
    if (wg == 1) bar_arrive(1, 256);
    mbar_wait(q_full, 0);
    bar_sync(1 + wg, 256);
    issue_qk(0);
    bar_arrive(2 - wg, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, pk, m0, m1, l0, l1, al0, al1, 0, rows);
    // every tile but the last: the QK of tile kt+1 is issued before the PV
    // of tile kt, and the softmax of kt+1 runs while PV kt is on the tensor
    // cores (no branch inside, so ptxas sees which group each wait retires)
    for (int kt = 0; kt + 1 < ntiles; ++kt) {
      bar_sync(1 + wg, 256);
      issue_qk(kt + 1);
      issue_pv(kt);
      bar_arrive(2 - wg, 256);
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
    bar_sync(1 + wg, 256);
    issue_pv(ntiles - 1);
    bar_arrive(2 - wg, 256);
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

// ------------------------------------------------------------------- K3

constexpr int LDK = 576;            // latent row: kv_lora_rank 512 + rope 64
constexpr int LDV = 512;            // value columns (the latent part of the row)
constexpr int LHB = 64;             // query heads a block: one wgmma m64 tile
constexpr int LBK = 64;             // keys a tile
constexpr int LCH = LDK / SWZ;      // 64-column boxes of a row: 8 value + 1 rope
constexpr int LBOX = LBK * 128;     // bytes of one box of a key tile (and of the q tile)
constexpr int LTILE = LCH * LBOX;   // one key tile (and the q tile): 72 KB
constexpr int LSTAGES = 2;          // key-tile ring depth
constexpr int LTH = 384;            // two consumer warpgroups + the producer warpgroup
static_assert(LHB == LBK, "the q tile and a key tile share one box size");

constexpr int latent_smem_bytes() {
  return 1024                       // slack: the tiles start 1024-byte aligned
         + LTILE * (1 + LSTAGES)    // q, then LSTAGES key tiles
         + LBOX                     // p as bf16 A fragments, warpgroup 0 -> 1
         + 2 * 128 * 4              // the rescale factors of each thread's two rows
         + 8 * (1 + 2 * LSTAGES);   // mbarriers
}
static_assert(latent_smem_bytes() <= 232448, "K3's shared memory exceeds a block's");

// grid (B, H / LHB, splits), LTH threads, one block an SM. Block (b, hb, z)
// holds query heads hb*64 .. hb*64 + 63 of row b, which all see keys
//   j < limit = min(seq_len[b] (>= 1 if min_one), qpos[b*qpos_stride] + 1
//               (qpos not null), max_keys),
// and walks keys [z*chunk, (z+1)*chunk) of them in 64-key tiles. Key j is
// row page*ps + j % ps of the pool seen as [R*ps, 576], page = table[b*P +
// j/ps] (table == nullptr: row_offset + b, a slot row: a tile is 64
// consecutive rows, TMA boxes of 64 keys); a paged tile is 64 / box_rows
// boxes of one page each (box_rows = 64 where ps % 64 == 0, else ps), and
// boxes wholly past the limit are not loaded. Warpgroup 2 is the producer:
// one thread issues every TMA load (q once, then the key ring). Warpgroup 0
// computes S = Q K^T over all 576 columns (both from shared memory), the
// online softmax in registers (log2 units), hands p (bf16 A fragments: each
// thread's slots, so warpgroup 1's thread with the same rows reads its own
// fragment) and the rescale factors to warpgroup 1 through shared memory,
// and accumulates O over value columns 0..255; warpgroup 1 accumulates
// columns 256..511 from the same p. F32P (B6's float32 p): PV also runs on
// the bf16 remainder of p, which warpgroup 0 writes into the tile's rope box
// (QK is done with it). Value rows past the limit are zeroed in shared
// memory before PV (whatever lies there, never-written pool slots or an
// unloaded box, weighs p = 0 but must not be NaN). With one split the block
// writes out; with more it writes its unnormalised O and (m, l) (m in log2
// units) to o_part / ml_part, and decode_merge<LDV> finishes.
template <bool F32P>
__global__ void __launch_bounds__(LTH, 1)
latent_attention(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const long long* __restrict__ table, int P, long long row_offset,
                 const long long* __restrict__ seq_len, const long long* __restrict__ qpos,
                 int qpos_stride, int min_one, int max_keys, bf16* __restrict__ out, int H,
                 int ps, int box_rows, float scale_log2, int chunk, float* __restrict__ o_part,
                 float* __restrict__ ml_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                                 // LCH boxes of 64 heads
  unsigned char* ks = qs + LTILE;                           // [LSTAGES] key tiles
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(ks + LSTAGES * LTILE);   // [16][128]
  float* abuf = reinterpret_cast<float*>(pbuf + LBOX / 4);               // [2][128]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(abuf + 256);
  uint64_t* k_full = q_full + 1;
  uint64_t* empty = k_full + LSTAGES;

  const int b = blockIdx.x, h0 = blockIdx.y * LHB, z = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x;
  long long lim = seq_len[b];
  if (min_one) lim = lim > 1 ? lim : 1;
  if (qpos) {
    const long long v = qpos[(long long)b * qpos_stride] + 1;
    lim = lim < v ? lim : v;
  }
  lim = lim < max_keys ? lim : max_keys;
  const int nkeys = lim > 0 ? (int)lim : 0;
  const int k0 = z * chunk;
  const int k1 = min(k0 + chunk, nkeys);
  const int ntiles = k1 > k0 ? (k1 - k0 + LBK - 1) / LBK : 0;
  const long long prow = ((long long)b * splits + z) * H + h0;   // the block's partial rows
  if (ntiles == 0) {   // no key here: an empty partial for the merge, or (unsplit) zeros
    if (splits > 1) {
      for (int r = tid; r < LHB; r += LTH) {
        ml_part[2 * (prow + r)] = -INFINITY;
        ml_part[2 * (prow + r) + 1] = 0.f;
      }
    } else {
      for (int i = tid; i < LHB * LDV / 2; i += LTH)
        reinterpret_cast<__nv_bfloat162*>(out + ((long long)b * H + h0) * LDV)[i] =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < LSTAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&empty[s], 256);   // every consumer thread releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = tid / 128;

  if (wg == 2) {
    // ---- producer: registers go to the consumers; one thread issues the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      mbar_expect_tx(q_full, LTILE);
      for (int c = 0; c < LCH; ++c)
        tma_load_2d(qs + c * LBOX, &tq, q_full, c * SWZ, b * H + h0);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % LSTAGES;
        if (kt >= LSTAGES) mbar_wait(&empty[s], (kt / LSTAGES - 1) & 1);
        unsigned char* dst = ks + s * LTILE;
        const int j0 = k0 + kt * LBK;
        if (!table) {
          mbar_expect_tx(&k_full[s], LTILE);
          const int row = (int)((row_offset + b) * ps + j0);
          for (int c = 0; c < LCH; ++c) tma_load_2d(dst + c * LBOX, &tk, &k_full[s], c * SWZ, row);
        } else {
          const int nb = (min(LBK, k1 - j0) + box_rows - 1) / box_rows;
          mbar_expect_tx(&k_full[s], nb * box_rows * 128 * LCH);
          for (int i = 0; i < nb; ++i) {
            const int j = j0 + i * box_rows;
            const int row = (int)(table[(long long)b * P + j / ps] * ps + j % ps);
            for (int c = 0; c < LCH; ++c)
              tma_load_2d(dst + c * LBOX + i * box_rows * 128, &tk, &k_full[s], c * SWZ, row);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns value columns 256*wg .. 256*wg + 255
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = tid & 127, lane = tid & 31, wq = t >> 5;
    const int c2 = (lane & 3) * 2;
    const int r0 = wq * 16 + (lane >> 2);   // this thread's heads h0 + r0, h0 + r0 + 8
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    uint32_t pk[16], pl[16];

    // zero the value rows of this warpgroup's four boxes past the limit
    auto zero_tail = [&](unsigned char* kst, int valid) {
      if (valid >= LBK) return;
      const int n = 4 * (LBK - valid) * 8;   // 16-byte pieces
      for (int i = t; i < n; i += 128) {
        const int box = 4 * wg + i / ((LBK - valid) * 8), rem = i % ((LBK - valid) * 8);
        *reinterpret_cast<uint4*>(kst + box * LBOX + (valid + rem / 8) * 128 + (rem % 8) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async();   // the zeros before the value product reads them
      bar_sync(3 + wg, 128);
    };
    // O = O * alpha + P V over this warpgroup's columns (asynchronous, waited)
    auto pv = [&](unsigned char* kst, float al0, float al1) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }
      unsigned char* v = kst + 4 * wg * LBOX;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < LBK / 16; ++j)
        wgmma_rs_n256_tb(o, pk[4 * j], pk[4 * j + 1], pk[4 * j + 2], pk[4 * j + 3],
                         sw128_desc(v + j * 16 * 128, LBOX, 1024));
      if (F32P) {
#pragma unroll
        for (int j = 0; j < LBK / 16; ++j)
          wgmma_rs_n256_tb(o, pl[4 * j], pl[4 * j + 1], pl[4 * j + 2], pl[4 * j + 3],
                           sw128_desc(v + j * 16 * 128, LBOX, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pk);
      if (F32P) fence_regs(pl);
    };

    if (wg == 0) {
      mbar_wait(q_full, 0);
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % LSTAGES;
        unsigned char* kst = ks + s * LTILE;
        mbar_wait(&k_full[s], (kt / LSTAGES) & 1);
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < LDK / 16; ++kk) {   // box kk / 4, 32 bytes a k-step within it
          const int off = (kk / 4) * LBOX + (kk % 4) * 32;
          wgmma_ss_n64(sc, sw128_desc(qs + off, 16, 1024), sw128_desc(kst + off, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // mask and online softmax: row r0 in sc[4i], sc[4i+1], row r0 + 8 in
        // sc[4i+2], sc[4i+3], key 8i + c2 (+1) of the tile
        const int valid = k1 - (k0 + kt * LBK);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = 8 * i + c2 + (e & 1) < valid ? sc[4 * i + e] * scale_log2 : -INFINITY;
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
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);   // finite: the tile has a key
        const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float ms = (i & 1) ? mn1 : mn0;
          const float p0 = fast_exp2(sc[2 * i] - ms), p1 = fast_exp2(sc[2 * i + 1] - ms);
          if (i & 1) ps1 += p0 + p1;
          else ps0 += p0 + p1;
          pk[i] = pack_bf16(p0, p1);
          if (F32P) pl[i] = pack_bf16(p0 - bf16_round(p0), p1 - bf16_round(p1));
        }
        l0 = l0 * al0 + ps0;   // per-thread partial sums; reduced over the quad at the end
        l1 = l1 * al1 + ps1;

        // hand p and the factors to warpgroup 1 once it has taken the last ones
        bar_sync(1, 256);
#pragma unroll
        for (int i = 0; i < 16; ++i) pbuf[i * 128 + t] = pk[i];
        abuf[t] = al0;
        abuf[128 + t] = al1;
        if (F32P) {
          uint32_t* lo = reinterpret_cast<uint32_t*>(kst + (LCH - 1) * LBOX);
#pragma unroll
          for (int i = 0; i < 16; ++i) lo[i * 128 + t] = pl[i];
        }
        bar_arrive(2, 256);
        zero_tail(kst, valid);
        pv(kst, al0, al1);
        if (F32P) fence_proxy_async();   // the remainder's bytes before the next TMA load there
        mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // the sums to warpgroup 1 through the q tile, which no product reads now
      bar_sync(1, 256);
      float* lbuf = reinterpret_cast<float*>(qs);
      lbuf[t] = l0;
      lbuf[128 + t] = l1;
      bar_arrive(2, 256);
    } else {
      bar_arrive(1, 256);   // the p buffer starts free
      for (int kt = 0; kt < ntiles; ++kt) {
        const int s = kt % LSTAGES;
        unsigned char* kst = ks + s * LTILE;
        bar_sync(2, 256);
#pragma unroll
        for (int i = 0; i < 16; ++i) pk[i] = pbuf[i * 128 + t];
        const float al0 = abuf[t], al1 = abuf[128 + t];
        if (F32P) {
          const uint32_t* lo = reinterpret_cast<const uint32_t*>(kst + (LCH - 1) * LBOX);
#pragma unroll
          for (int i = 0; i < 16; ++i) pl[i] = lo[i * 128 + t];
        }
        bar_arrive(1, 256);
        mbar_wait(&k_full[s], (kt / LSTAGES) & 1);
        zero_tail(kst, k1 - (k0 + kt * LBK));
        pv(kst, al0, al1);
        if (F32P) fence_proxy_async();
        mbar_arrive(&empty[s]);
      }
      bar_sync(2, 256);
      const float* lbuf = reinterpret_cast<const float*>(qs);
      l0 = lbuf[t];
      l1 = lbuf[128 + t];
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const long long col0 = 256 * wg + c2;
      if (splits == 1) {
        const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
        bf16* orow = out + ((long long)b * H + h0 + r) * LDV + col0;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
              o[4 * i + 2 * half] * inv, o[4 * i + 2 * half + 1] * inv);
      } else {
        float* prw = o_part + (prow + r) * LDV + col0;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          *reinterpret_cast<float2*>(prw + 8 * i) =
              make_float2(o[4 * i + 2 * half], o[4 * i + 2 * half + 1]);
        if (wg == 0 && (lane & 3) == 0) {
          ml_part[2 * (prow + r)] = half ? m1 : m0;
          ml_part[2 * (prow + r) + 1] = half ? l1 : l0;
        }
      }
    }
  }
}

template <bool F32P>
int launch_latent(const CUtensorMap& tq, const CUtensorMap& tk, const void* table, int P,
                  long long row_offset, const void* seq_len, const void* qpos, int qpos_stride,
                  int min_one, int max_keys, void* out, int B, int H, int ps, int box_rows,
                  float scale, int splits, int chunk, void* o_part, void* ml_part,
                  cudaStream_t st) {
  constexpr int bytes = latent_smem_bytes();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(latent_attention<F32P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  latent_attention<F32P><<<dim3(B, H / LHB, splits), LTH, bytes, st>>>(
      tq, tk, static_cast<const long long*>(table), P, row_offset,
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos), qpos_stride,
      min_one, max_keys, static_cast<bf16*>(out), H, ps, box_rows, scale * LOG2E, chunk,
      static_cast<float*>(o_part), static_cast<float*>(ml_part));
  if (splits > 1) {
    decode_merge<LDV><<<dim3(H, 1, B), LDV, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<bf16*>(out), 1, H, 1, splits);
  }
  return (int)cudaGetLastError();
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
// contiguous; pool [R,ps,1,576] bf16 contiguous; table [B,P] int64 or null
// (identity: page row_offset + b); seq_len [B] int64; qpos int64 with
// stride qpos_stride or null; out [B,H,512] bf16 (the value columns only).
// H % 64 == 0; with a table, ps % 64 == 0 or ps a multiple of 8 dividing
// 64. p_bf16: p rounded to bf16 for PV (B1), else float32 p (B6). The
// context is cut into `splits` chunks of `chunk` keys (a multiple of 64),
// one block each; with splits > 1, o_part [B,splits,H,512] and ml_part
// [B,splits,H,2] are float32 scratch that decode_merge<512> reduces. The
// TMA tensor maps are encoded here on each call (passed by value).
int dstts_latent_attention(const void* q, const void* pool, const void* table, int P,
                           long long row_offset, const void* seq_len, const void* qpos,
                           int qpos_stride, int min_one, int max_keys, void* out, int B, int H,
                           long long R, int ps, float scale, int p_bf16, int splits, int chunk,
                           void* o_part, void* ml_part, void* stream) {
  const int box_rows = !table || ps % LBK == 0 ? LBK : (LBK % ps == 0 && ps % 8 == 0 ? ps : 0);
  if (H % LHB || splits < 1 || chunk % LBK || box_rows == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk;
  const cuuint64_t qdim[2] = {LDK, (cuuint64_t)B * H}, kdim[2] = {LDK, (cuuint64_t)R * ps};
  const cuuint64_t stride[1] = {LDK * 2};
  const cuuint32_t qbox[2] = {SWZ, LHB}, kbox[2] = {SWZ, (cuuint32_t)box_rows};
  if (!bf16_map(&tq, q, 2, qdim, stride, qbox) || !bf16_map(&tk, pool, 2, kdim, stride, kbox))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (p_bf16 ? &launch_latent<false> : &launch_latent<true>)(
      tq, tk, table, P, row_offset, seq_len, qpos, qpos_stride, min_one, max_keys, out, B, H,
      ps, box_rows, scale, splits, chunk, o_part, ml_part, st);
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
// registers, threads and shared memory: out[0..5] = K1 (1, 2 and 4 m-tiles),
// K2, K3 (bf16 p, float32 p).
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
  cudaFuncSetAttribute(latent_attention<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       latent_smem_bytes());
  cudaFuncSetAttribute(latent_attention<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       latent_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], decode_attention<1>, NTH,
                                                decode_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], decode_attention<2>, NTH,
                                                decode_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], decode_attention<4>, NTH,
                                                decode_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], flash_attention, FTH,
                                                flash_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], latent_attention<false>, LTH,
                                                latent_smem_bytes());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], latent_attention<true>, LTH,
                                                latent_smem_bytes());
  return (int)cudaGetLastError();
}

}  // extern "C"
