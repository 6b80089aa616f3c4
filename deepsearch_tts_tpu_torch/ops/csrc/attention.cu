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
//     and its paged mode, flash_attention<PAGED = true>: a prefill chunk over
//     the pages its row has after the chunk's own K/V was written, JAX's
//     re-prefill over a cached prefix (ops/attention.py:167
//     prefix_chunk_attention, XLA code: no Pallas kernel to replace). Query
//     t of row b at position p = qpos[b,t] sees keys j < min(p + 1, seq_len,
//     P*ps); a tail-padding query (p < 0) keys j < chunk_start = qpos[b,0],
//     unless every query of its block of floor(128/G) positions is padding:
//     such a block, and a row with chunk_start < 0, sees none and writes
//     zeros. A slot row is one page of max_seq_len keys.
// K1 and K2's paged mode also read int8 pages: the int8 branch of JAX's
//     paged_attention (ops/attention.py:122-139, XLA code: a gather, then
//     (int8.float() * scale).to(bf16), then masked_context_attention), the
//     int8-KV engine's decode and re-prefill. Each pool row holds D int8
//     and one float32 scale a (slot, kv head) in a pool of its own. K1's
//     int8 mode is a kernel of its own, decode_i8 (a plan kernel, then a
//     persistent grid), which widens each key and value in registers
//     straight into its products' fragments; K2's int8 paged mode is
//     widen_kv_pages (the rows' pages into bf16 scratch pages) and then the
//     bf16 paged mode over them. Both widen with the plain path's
//     arithmetic, its values bit for bit, so only the accumulation order
//     differs from the plain version.
// K3  latent_attention: T=1 MQA decode over MLA's latent rows (v is k), at
//     the DeepSeek-V3 / Kimi-K2 width D = 576 (kv_lora_rank 512 + rope 64):
//       B1 slot_attention, v_pool=None (_slot_attn_kernel_shared, :116)
//       B6's three entries above when the pool is both k and v
//     (models/deepseek_v3.py:381-389, :409-413). Only the first 512 columns
//     of the value product are computed: MLA keeps [..., :kv_lora_rank].
//     Its prefill mode (prefill = 1, T > 1 positions a row) serves MLA's
//     three prefill branches, all XLA code in JAX (no Pallas kernel to
//     replace): the fresh prefill (models/deepseek_v3.py:368-372,
//     ops/attention.py:39 causal_attention), a slot window at T > 1
//     (:373-397, ops/attention.py:205 masked_context_attention) and the
//     re-prefill over a cached prefix (:398-408, ops/attention.py:167
//     prefix_chunk_attention), each over the pool after the chunk's rows
//     were written: query t of row b at position p sees keys j < min(p + 1,
//     seq_len, max_keys), a padding query (p < 0) none (zeros).
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
//   - one persistent block an SM walks items, a (row, kv head, block of
//     floor(128/G) query positions) each: 128 folded query rows (row =
//     t*G + g: the G query heads of one kv head, so each K / V tile is read
//     once per group) on two consumer warpgroups of 64 rows, one wgmma m64
//     tile each, plus a producer warpgroup (setmaxnreg 24 / 240) whose
//     first warp takes the items from a counter, longest first (dense: the
//     last query blocks first), and issues every TMA load;
//   - the Q tile is two TMA boxes of a 4-D map over q as (D, H, T, B), box
//     (64, G, floor(128/G), 1); K and V tiles (128 keys x 128 columns, two
//     64-column boxes each under 128-byte swizzle, of 3-D maps over k and v
//     as (KV*D, S, B), so past S each batch row reads zeros, never the next
//     row's keys) come through a 3-stage ring with full barriers for K and
//     V and an empty barrier a stage, continued across items, so the next
//     item's tiles load under the current one's math;
//   - the producer writes each item (and its positions' key limits) into
//     one of two shared slots with full / empty barriers, and its Q once
//     the consumers' last QK of the item before is done (q_empty): the
//     consumers meet no global read, atomic or block barrier between items;
//   - S = Q K^T takes both operands from shared memory (K-major, 128-byte
//     swizzle descriptors); O += P V takes P from registers as bf16 and V
//     from shared memory transposed by its descriptor (MN-major); S and O
//     are float32 registers (64 + 64 a thread);
//   - the online softmax runs in registers with exp2 (ex2.approx), log2(e)
//     folded into the scale; only diagonal and ragged tiles are masked, and
//     tiles above the diagonal are never loaded;
//   - each warpgroup issues tile kt+1's QK before tile kt's PV and runs the
//     softmax of kt+1 while PV kt is on the tensor cores; the two consumer
//     warpgroups take turns issuing products (named barriers 1 and 2), so
//     one's softmax runs under the other's products;
//   - O leaves as 8-byte stores (lanes q and q^1 trade one word a column
//     pair); the next item's QK waits only for its tiles;
//   - shared memory: Q 32 KB + 3 stages of K and V (192 KB) + two item
//     slots (1 KB) = 225 KB, one block an SM (12 warps), as the runtime's
//     occupancy query reports; ptxas gives 168 registers a thread at entry
//     (the paged mode: an 88-byte stack, 116 bytes of spill stores, its
//     producer at 24), moved by setmaxnreg to 24 (producer) and 240
//     (consumers); the plan kernel 42 registers and 17 KB of static shared
//     memory, the merge 80 registers (NVIDIA H100 80GB HBM3, 700.00 W,
//     CUDA 12.8).
//   The paged mode serves a multi-turn follow-up: a short chunk after a
//   long cached prefix, its tail padded to a power of two, rows of ragged
//   lengths. Its work is set by each unit's prefix, not by its place in
//   the chunk, so the plan kernel (flash_paged_plan, one block) turns
//   positions and seq_len on the card (no host read: a captured prefill
//   replays it) into each unit's key limit and the items longest first by
//   real key tiles (a counting sort); units with no key (a padding row, a
//   block of tail padding) take no item and the producer warpgroup's other
//   warps write their zeros. Where the wrapper's static gate allows it
//   (fewer than 4 units an SM, rows of more than 2 key tiles), a unit
//   longer than an SM's mean load is cut into key ranges of about C = W /
//   (2 SMs) tiles, each a float32 partial (m, l, O) in its own slot, and
//   flash_paged_merge combines them. The attention kernel and the merge
//   are programmatic dependent launches: their blocks start under the
//   kernel before and wait (griddepcontrol) only where they read its
//   output. K / V
//   come through a 2-D map over the pool as (KV*D, pages*ps) in boxes that
//   each lie in one page (64 keys, or 32 / 16 / 8 where ps is a multiple of
//   those), at pool row table[b, j/ps]*ps + j%ps: the producer warp loads
//   32 boxes' rows with one coalesced read of the table and hands them out
//   by shuffle. Value rows past an item's key end in its last tile (an
//   unloaded box, stale pool rows) are zeroed in shared memory by each
//   consumer warpgroup itself (the same zeros; each meets only its own
//   warps). Bound by operations like K2: ~4*H*D a visible (query, key)
//   pair of a real query.
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
//   The prefill mode is bound by operations: 2*H*(576 + 512) a visible
//   (query, key) pair of a real query (1.29 TFLOP a layer over a
//   3044-token prompt at H = 128: 1.305 ms). Its item is K3's block, one
//   query position's 64 heads over a chunk of its keys (the tile that
//   fills K3's shared memory and two warpgroups' O registers), so each
//   72 KB key tile feeds only 64 query rows and a layer loads ~19 GB of
//   tiles at T = 4096: the design keeps them in L2 by order. A 1-D grid of
//   B*T*(H/64)*splits items in the order the hardware hands blocks out:
//   the table rows longest first (latent_prefill_plan, one block: each
//   row's largest key limit, then its rank, from positions and seq_len on
//   the card: no host read, so a captured prefill replays it; skipped for
//   one row), each row's positions from the last (the longest) down, a
//   position's head blocks and splits together. The blocks on the card at
//   one moment are then ~66 neighbouring positions of one row at 128 heads,
//   which walk the same prefix from key 0 in step: each tile comes from
//   HBM about once a wave and from L2 for the rest. The context is split
//   (latent_splits over the B*T query rows, decode_merge<512> after) only
//   where the items cannot fill the card (B*T*H/64 < SMs: a verify
//   window, a few tokens after a long prefix at 64 heads); a longer
//   prefill balances by dynamic block order, its items are never split.
//   p is rounded to bf16 (JAX's masked_context_attention / prefix_chunk
//   round points), K3's B1 instance.
//
// Numerics of K3: float32 scores scaled after the product, float32 softmax
// sum. With p_bf16 (B1) PV takes p rounded to bf16; without it (B6, float32
// p) PV runs twice, on bf16(p) and on the bf16 remainder p - bf16(p), which
// carries p to ~16 significant bits in the float32 accumulator; the
// remainder goes to warpgroup 1 through the tile's rope box, which QK no
// longer needs. Value rows past the limit are zeroed in shared memory
// before PV: they weigh p = 0 but may hold anything (a never-written slot,
// an unloaded box).
// * The int8 modes widen every value (~3.5 instructions: a byte permute
//   into 2^23, a subtract, a float32 product with the row's scale, half a
//   bf16 pack).
//   - K1's int8 mode, decode_i8. Its parent (K1's split-context kernel
//     with an int8 ring widened into a bf16 stage) took bf16 K1's
//     time; its timeline (scripts/time_k1_i8.py, PERF.md) put 2.9 us on each
//     64-key tile (1.3 of table reads and copy issue: each thread read the
//     page table before each cp.async; 1.0 of widening; 0.5 of products),
//     12-13 tiles and a 4-us prologue in series (the static split) and 5-10
//     us in the merge launch. The design answers each:
//     . key ranges from the rows' real lengths, on the card: decode_i8_plan
//       (one block: warp 0 plans, every warp writes items) reads seq_len and
//       the positions, cuts each (row group, kv head)'s visible tiles into
//       balanced pieces, ceil(t / C) of them with C = W / blocks (t / C
//       rounded where ceil's pieces longer than C / 2 would outnumber the
//       blocks: rows of one length), and lists them longest first; the
//       persistent grid (3 blocks an SM) takes them from a counter, a block
//       its next piece only once its current one's tiles are all issued, so
//       the blocks that drew short pieces take more; a split unit's last
//       piece to finish (a counter the plan zeroes) merges the pieces'
//       partials itself: no merge launch. Sizes come from static shapes (B,
//       KV, the SM count): no host read, a captured call replays;
//     . loads off the compute warps: a producer warp reads the page table
//       32 pages a load, issues each tile's K and V as TMA boxes of 64 / 32
//       / 16 / 8 keys, each in one page, of 2-D maps over the int8 pools as
//       (KV*128 B, pages*ps rows) under 128-byte swizzle, and the tile's 64
//       scales of each by cp.async (zeros past the piece's end, so those
//       keys widen to 0), into a 3-stage full / empty mbarrier ring that
//       runs on across pieces; it loads each piece's q rows and key limits
//       into one of two slots;
//     . the widening in registers: 4 consumer warps, warp w keys 16w ..
//       16w + 15 of each tile. Both products put the 16 keys (or value
//       columns) on mma.sync m16n8k16's rows and the queries on its n = 8
//       columns, so G = 8 fills the tile (the parent padded 8 query rows to
//       16: half its mma issue was padding). K's A fragment is widened from
//       two 16-byte loads of each of its two key rows, conflict-free under
//       the swizzle (the head dimension permuted, and q's B fragment with
//       it), V's from one 16-byte load of each of four value rows, each
//       value with its own row's scale (dequant_cross); p becomes the value
//       product's B fragment by movmatrix.trans. No bf16 stage in shared
//       memory and no block barrier in the tile loop.
//     71.5 KB of shared memory (92.3 KB at 16 query rows an item), 3 blocks
//     an SM (2), as the runtime's occupancy query reports; ptxas gives 128
//     registers (168, with 44 bytes of spills, at 16 rows), the plan 40 and
//     33 KB. At qwen3-32b's heads over 19,613 keys (SEQS) 0.0274 ms against
//     the parent's 0.0557 and bf16 K1's 0.0562 in the same call (bound
//     0.0125, SDPA 0.0976; NVIDIA H100 80GB HBM3, 700.00 W, CUDA 12.8). What
//     holds it, by its timeline: the plan, ~3.8 us before any load; the
//     first tile ~3 us after it; ~14 us of streaming at ~3 TB/s; a unit's
//     merge, ~2 us more on its last piece, in the tail.
//   - K2 (int8 paged): widen_kv_pages writes each row's pages below its
//     seq_len as bf16 into scratch pages b*P + p (a thread one 16-byte
//     piece of K and one of V), then the bf16 paged mode runs over them
//     unchanged. The widening moves 3x the int8 bytes (~19 MB at 3044 keys
//     and 8 kv heads: 0.011 ms) and the scratch is B*P bf16 pages; widening
//     inside the persistent kernel (producer warps 9-11 turning int8 TMA
//     stages into the swizzled tiles) ran at 1.9x this design's time
//     (0.6433 against 0.3319 ms over the 3044-token prompt at qwen3-32b's
//     heads). A kernel of its own that read the int8 pages by TMA, widened
//     each 64-key stage to fp16 on three warps and folded the scales into
//     the softmax ran at 1.6x (0.5256 against 0.3251 ms; slower at every
//     timed shape): each item widens its own tiles (~19,000 128-key tiles
//     at the long prompt, against 48 pages widened once and read back from
//     L2 here), and the consumers waited for widened tiles.
//     NVIDIA H100 80GB HBM3, 700.00 W, CUDA 12.8.
//
// Numerics. Scores are float32 and the scale D^-1/2 (times log2 e) is
// applied to them: the TPU kernels scale q in float32 first, which agrees
// within bf16 tolerance. p is rounded to bf16 before PV in K2 (wgmma
// operand) and, when p_bf16 is set, in K1 — the B1 round point
// (slot_attention.py:98); B9 rounds p like B1 (slot_attention.py:178). The
// B6 kernels keep p in float32 (paged_attention.py:106): K1 with p_bf16 = 0
// runs PV on bf16(p) and on its bf16 remainder, as K3 does. K1's int8 mode
// rounds p to bf16 (the int8 branch's masked_context_attention takes p in
// the value dtype, bf16). K1 (and its int8 mode) rounds p
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
// 4-byte global -> shared copy (an int8 row's scale); src_bytes = 0 writes zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
// one arrival on `bar` once every cp.async this thread issued before has landed
// (the barrier's count includes it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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

// int8 KV: bytes i, i + 1 of w (four int8 with the sign bit flipped, x + 128)
// as the bf16 pair round(float(x) * s): the byte permute puts x + 128 in the
// low mantissa of 2^23 and one subtract gives float(x) exactly, then one
// float32 product and round to nearest even, the plain path's
// (int8.float() * scale).to(bf16) bit for bit
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, int i, float s) {
  uint32_t a, b;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(a) : "r"(w), "r"(0x4B000000u), "r"(0x7440 | i));
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(b) : "r"(w), "r"(0x4B000000u), "r"(0x7440 | (i + 1)));
  return pack_bf16((__uint_as_float(a) - 8388736.f) * s, (__uint_as_float(b) - 8388736.f) * s);
}
// sixteen int8 of one row (scale s) -> sixteen bf16 in order (lo: 0-7, hi: 8-15)
__device__ __forceinline__ void dequant16(const uint4& v, float s, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  lo = make_uint4(dequant_pair(w[0], 0, s), dequant_pair(w[0], 2, s),
                  dequant_pair(w[1], 0, s), dequant_pair(w[1], 2, s));
  hi = make_uint4(dequant_pair(w[2], 0, s), dequant_pair(w[2], 2, s),
                  dequant_pair(w[3], 0, s), dequant_pair(w[3], 2, s));
}

// ------------------------------------------------------------------- K1

constexpr int DWIDE = 2 * DBK * ROW * (int)sizeof(bf16);   // one K/V stage in bf16
// the K/V ring (q staged in it first)
constexpr int decode_smem_bytes() { return DSTAGES * DWIDE; }
constexpr int OROW = HD + 4;   // merge buffer row (floats)
static_assert(DROWS * OROW * 4 + 2 * DROWS * 4 <= DWIDE,
              "the merge buffers must fit in one bf16 stage");
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
  constexpr int RS = DSTAGES;   // ring stages
  bf16* kvs = reinterpret_cast<bf16*>(smem);   // [RS][2][DBK][ROW]

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
  bf16* qs = kvs + (RS - 1) * 2 * DBK * ROW;
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
  for (int s = 0; s < RS - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }

  const int mt = warp % MT, kpart = warp / MT;
  const int mi = lane >> 3, rr = lane & 7, c2 = (lane & 3) * 2;
  cp_async_wait<RS - 1>();   // the q group
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
    cp_async_wait<RS - 2>();
    __syncthreads();   // tile kt landed for every thread; tile kt-1's stage is free
    {
      const int nt = kt + RS - 1;
      if (nt < ntiles) load_tile(nt % RS, nt);
      cp_async_commit();
    }
    const bf16* kst = kvs + (kt % RS) * 2 * DBK * ROW + kpart * KW * ROW;
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
                  const void* qpos, int qpos_stride, int min_one, int max_keys, void* out, int B,
                  int T, int H, int KV, int ps, float scale, int p_bf16, int splits, int chunk,
                  void* o_part, void* ml_part, cudaStream_t st) {
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

constexpr int FBM = 128;       // folded query rows an item: two consumer warpgroups x 64
constexpr int FBN = 128;       // keys a K / V tile
constexpr int FSTAGES = 3;     // K / V ring depth
constexpr int FTH = 384;       // two consumer warpgroups + the producer warpgroup
constexpr int SWZ = 64;        // bf16 columns of one 128-byte swizzle atom: a TMA box's width
constexpr int FTILE = FBN * HD * 2;   // bytes of one K or V tile (and of the Q tile)
constexpr int FHALF = FTILE / 2;      // one 64-column half of a tile
constexpr int FBN_PAGE = 64;   // the most keys of one paged box (a page holds whole boxes)
constexpr int META = 8 + FBM;  // ints of an item's slot: row, query block, kv head, first
                               // key, tiles, key end, partial slot; then its positions' limits
constexpr int PLAN_HDR = 8;    // the plan's header: items, C, split units, the work counter,
                               // the split threshold
constexpr int PLAN_TH = 1024;  // threads of the plan kernel
constexpr int PLAN_SMEM_UNITS = 32768;   // units whose limits the plan keeps in shared memory
constexpr int PIECE_MIN = 2;   // a piece of a split unit holds at least this many tiles
constexpr int PIECES_PER_SM = 2;      // pieces hold at most W / (PIECES_PER_SM * SMs) tiles
constexpr int ORDER_BUCKETS = 4096;   // the plan's counting sort (longer items share the last)
constexpr int MERGE_TH = 256;  // merge threads: 8 rows x 32 lanes of 4 columns
constexpr int MERGE_BATCH = 4; // pieces whose partials a merge thread loads at once
static_assert(FBM == FBN, "the Q tile and a K / V tile share one size");
static_assert(FBN % FBN_PAGE == 0, "a paged tile is whole boxes");

// the paged mode's plan in its int32 workspace: the header; the split
// units, each (u, pieces, first partial slot, 0) for unit u = b*nqb + m
// (query block m of row b); per unit its key limit and its first partial
// slot (-1: not split); then (16-byte aligned) the items longest first,
// each (u*KV + kh, first key, key end, partial slot or -1)
struct Plan {
  int *hdr, *ulim, *sbase;
  int4 *slist, *items;
  __device__ Plan(int* ws, int U)
      : hdr(ws), ulim(ws + PLAN_HDR + 4 * U), sbase(ulim + U),
        slist(reinterpret_cast<int4*>(ws + PLAN_HDR)),
        items(reinterpret_cast<int4*>(ws + ((PLAN_HDR + 6 * U + 3) & ~3))) {}
};
static_assert(PLAN_HDR % 4 == 0, "the split units' records start 16-byte aligned");

// a unit of `tiles` key tiles in z pieces of `per` tiles (the last one may
// hold fewer, none is empty): floor(tiles / C) pieces, at least 2, of about
// C tiles or more where it holds more than `thr`, else one (so the pieces
// of all units number at most W / C, and an SM's share of them is whole
// pieces); ops/flash_attention.py unit_pieces
__device__ __forceinline__ void unit_pieces(int tiles, int C, int thr, int& z, int& per) {
  if (tiles <= thr) {
    z = tiles > 0;
    per = tiles;
    return;
  }
  z = max(2, tiles / C);
  per = (tiles + z - 1) / z;
  z = (tiles + per - 1) / per;
}

// exclusive prefix sum of v over the warp's lanes in order, `total` the sum
__device__ __forceinline__ int warp_scan(int v, int& total) {
  const int lane = threadIdx.x & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  total = __shfl_sync(0xffffffffu, x, 31);
  return x - v;
}

// one block of PLAN_TH threads: the paged mode's plan (ops/flash_attention.py
// paged_plan is its model). A query's limit is its position + 1, or
// chunk_start for a tail-padding query of a unit that holds a real query,
// else 0 (a whole tail-padding block, a padding row), at most seq_len and
// S. A unit ends at ulim, the largest min(max(p + 1, chunk_start), cap) of
// its real queries (p >= 0, chunk_start >= 0; cap = min(seq_len, S)): the
// largest limit of its queries where positions follow chunk_start, and 0
// for a unit with no key to see (the attention kernel writes its zeros).
// W = KV * the units' tiles summed.
// With `split`, a unit longer than thr = max(C, ceil(W / sms)) tiles (more
// than an SM's mean load) is cut into max(2, tiles / C) pieces, C =
// max(PIECE_MIN, ceil(W / (PIECES_PER_SM * sms))) (a split unit's pieces
// take partial slots in unit order); every other unit is one piece. The items,
// one a (piece, kv head), go into `items` longest first by a counting sort
// over their tile counts; the work counter is reset here, so a captured
// call replays with it.
__global__ void __launch_bounds__(PLAN_TH)
flash_paged_plan(const long long* __restrict__ qpos, const long long* __restrict__ seq_len,
                 int B, int T, int S, int TQ, int KV, int sms, int split, int* __restrict__ ws) {
  __shared__ int hist[ORDER_BUCKETS];
  __shared__ int s_c[2];            // C, thr
  extern __shared__ int s_ulim[];   // [U] where U <= PLAN_SMEM_UNITS
  const int tid = threadIdx.x, lane = tid & 31;
  const int nqb = (T + TQ - 1) / TQ, U = B * nqb, BT = B * T;
  const int nb = min((S + FBN - 1) / FBN + 1, ORDER_BUCKETS);   // tile counts 0 .. nb - 1
  const Plan pl(ws, U);
  grid_dep_launch();   // the attention kernel's blocks may take their SMs and set up
  int* ulim = U <= PLAN_SMEM_UNITS ? s_ulim : pl.ulim;
  for (int i = tid; i < U; i += PLAN_TH) ulim[i] = 0;
  for (int i = tid; i < nb; i += PLAN_TH) hist[i] = 0;
  __syncthreads();
  // a query's position, its row's chunk start and seq_len: three loads in
  // flight, those of the thread's next query issued before this one's atomic
  auto load = [&](int i, long long& p, long long& cs, long long& cap) {
    const int b = i / T;
    p = i < BT ? qpos[i] : -1;
    cs = i < BT ? qpos[(long long)b * T] : -1;
    cap = i < BT ? min((long long)S, seq_len[b]) : 0;
  };
  long long np, ncs, ncap;
  load(tid, np, ncs, ncap);
  for (int i0 = 0; i0 < BT; i0 += PLAN_TH) {   // the same trip count in every warp
    const int i = i0 + tid, b = i / T;
    const long long p = np, cs = ncs, cap = ncap;
    if (i0 + PLAN_TH < BT) load(i + PLAN_TH, np, ncs, ncap);
    int u = -1, l = 0;
    if (p >= 0 && cs >= 0) {
      l = (int)max(0LL, min(max(p + 1, cs), cap));
      if (l > 0) u = b * nqb + (i - b * T) / TQ;
    }
    // one atomic a unit a warp: the largest limit of the warp's queries of it
    const unsigned peers = __match_any_sync(0xffffffffu, u);
    const int lm = (int)__reduce_max_sync(peers, (unsigned)l);
    if (u >= 0 && lane == __ffs(peers) - 1) atomicMax(&ulim[u], lm);
  }
  __syncthreads();
  if (tid < 32) {
    // warp 0: W, the pieces and slots of each unit, the buckets' starts
    int w = 0;
    for (int u = lane; u < U; u += 32) w += (ulim[u] + FBN - 1) / FBN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
    const long long W = (long long)w * KV, pieces = (long long)PIECES_PER_SM * sms;
    const int C = (int)max((long long)PIECE_MIN, (W + pieces - 1) / pieces);
    const int thr = split ? (int)max((long long)C, (W + sms - 1) / sms) : nb;
    int slots = 0, nsplit = 0;
    for (int base = 0; base < U; base += 32) {
      const int u = base + lane;
      int t = 0, z = 0, per = 0;
      if (u < U) {
        t = (ulim[u] + FBN - 1) / FBN;
        unit_pieces(t, C, thr, z, per);
      }
      int tot_slots, tot_split;
      const int e_slot = warp_scan(z > 1 ? z : 0, tot_slots);
      const int e_split = warp_scan(z > 1 ? 1 : 0, tot_split);
      if (u < U) {
        pl.ulim[u] = ulim[u];
        pl.sbase[u] = z > 1 ? slots + e_slot : -1;
        if (z > 1) pl.slist[nsplit + e_split] = make_int4(u, z, slots + e_slot, 0);
        if (z > 1) atomicAdd(&hist[min(per, nb - 1)], (z - 1) * KV);
        if (t) atomicAdd(&hist[min(t - (z - 1) * per, nb - 1)], KV);
      }
      slots += tot_slots;
      nsplit += tot_split;
    }
    __syncwarp();
    int n_items = 0;   // each bucket's first item, the longest bucket first
    for (int base = 0; base < nb; base += 32) {
      const int c = nb - 1 - (base + lane);
      int tot;
      const int e = warp_scan(c >= 0 ? hist[c] : 0, tot);
      if (c >= 0) hist[c] = n_items + e;
      n_items += tot;
    }
    if (lane == 0) {
      pl.hdr[0] = n_items;
      pl.hdr[1] = s_c[0] = C;
      pl.hdr[2] = nsplit;
      pl.hdr[3] = 0;
      pl.hdr[4] = s_c[1] = thr;
    }
  }
  __syncthreads();
  // a warp a unit: its z * KV items, one bucket atomic for the lanes that
  // share a length
  const int C = s_c[0], thr = s_c[1];
  for (int u = tid >> 5; u < U; u += PLAN_TH / 32) {
    const int ul = ulim[u], t = (ul + FBN - 1) / FBN, sb = pl.sbase[u];
    int z, per;
    unit_pieces(t, C, thr, z, per);
    for (int k0 = 0; k0 < z * KV; k0 += 32) {
      const int k = k0 + lane, zi = k / KV, kh = k - zi * KV;
      const int c = k < z * KV ? min(min(per, t - zi * per), nb - 1) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, c);
      const int leader = __ffs(peers) - 1;
      int at = 0;
      if (lane == leader && c >= 0) at = atomicAdd(&hist[c], __popc(peers));
      at = __shfl_sync(0xffffffffu, at, leader) + __popc(peers & ((1u << lane) - 1));
      if (c >= 0)
        pl.items[at] = make_int4(u * KV + kh, zi * per * FBN, min((zi + 1) * per * FBN, ul),
                                 z > 1 ? (sb + zi) * KV + kh : -1);
    }
  }
}

// what the softmax of one score tile needs of its rows: the exclusive key
// limits of the thread's rows r0 and r0 + 8, the least limit of the warp's
// rows (a tile wholly below it is not masked), the column pair of the
// thread and the scale in log2 units
struct SoftmaxRows {
  int lim0, lim1, mask_from, c2;
  float scale_log2;
};

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// scale, mask (only a tile that reaches a row's limit) and online softmax of the 64 x 128 score tile of keys kbase ..
// kbase + 127 in registers (row r0: sc[4i], sc[4i+1]; row r0 + 8: sc[4i+2],
// sc[4i+3]; key kbase + 8i + c2 (+1)); p leaves as bf16 pairs, pk[i] =
// (p[2i], p[2i+1]): the wgmma A fragments of the value product; m, l are
// updated and al0 / al1 are the factors of the old sums
__device__ __forceinline__ void softmax_tile(float (&sc)[64], uint32_t (&pk)[32], float& m0,
                                             float& m1, float& l0, float& l1, float& al0,
                                             float& al1, int kbase, const SoftmaxRows& r) {
  const bool masked = kbase + FBN > r.mask_from;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * i + e] * r.scale_log2;
      if (masked) {
        const int key = kbase + 8 * i + r.c2 + (e & 1);
        if (key >= (e < 2 ? r.lim0 : r.lim1)) v = -INFINITY;
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
         + 8 * (2 + 3 * FSTAGES + 4)           // mbarriers
         + 4 * 2 * META;                       // two item slots
}
static_assert(flash_smem_bytes() <= 232448, "K2's shared memory exceeds a block's");

// one persistent block an SM, FTH threads. An item is (row b, kv head kh,
// query block m, keys [k0, kend)): positions t = m*TQ .. +TQ-1, TQ =
// floor(FBM / G), as tile rows r = (t - m*TQ)*G + g, query head kh*G + g
// (the TMA box (64, G, TQ, 1) over q as (D, H, T, B) writes them in this
// order); where G does not divide FBM (qwen3-14b: G = 5, 125 rows) the rows
// r >= TQ*G hold no query: they see no key and are not written. Row r sees
// keys j < its limit (dense: j <= t, j < S, the TPU kernel's top-left mask,
// flash_attention.py:49; PAGED: the plan's). Tiles are 128 rows of 256 B in
// two 64-column halves of 128-byte swizzle atoms, as TMA writes them and
// wgmma reads them.
// Warp 8 (the producer warpgroup's first) takes items from the work
// counter: dense, index i is query block nqb - 1 - i / (B*KV) (the longest
// first) of row (i % (B*KV)) / KV; PAGED, the plan's i-th item. It writes
// the item and its positions' limits into one of two slots, issues its Q
// once the consumers' last QK of the item before is done, and its K / V
// tiles into the ring as stages free up; a paged tile's boxes take their
// pool rows from a register of the warp (32 boxes a coalesced load of the
// table). Warps 9-11 write zeros over the units with no key (PAGED).
// Warpgroups 0 and 1 each own 64 rows: S = Q K^T (both from shared
// memory), the online softmax in registers (log2 units), O += P V (P from
// registers, V from shared memory, transposed by its descriptor); an
// unsplit item's O leaves normalised as bf16 (8-byte stores), a piece of a
// split unit's as float32 partials (unnormalised O, m in log2 units, l) in
// partial slot `slot` for flash_paged_merge.
// PAGED: k and v are 2-D maps over the pools as (KV*D, pages*ps) with boxes
// of (64, box_rows) that each lie in one page (one page a row, P = 1: boxes
// of 64 that may run past it into keys past every limit); key j of row b is
// pool row table[b*P + j/ps]*ps + j%ps, S = P*ps.
template <bool PAGED>
__global__ void __launch_bounds__(FTH, 1)
flash_attention(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int B, int T,
                int S, int H, int KV, float scale_log2, const long long* __restrict__ table,
                int P, int ps, int box_rows, const long long* __restrict__ qpos,
                const long long* __restrict__ seq_len, int* __restrict__ ws,
                float* __restrict__ o_part, float* __restrict__ ml_part) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;
  unsigned char* ks = qs + FTILE;                  // [FSTAGES] K tiles
  unsigned char* vs = ks + FSTAGES * FTILE;        // [FSTAGES] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + FSTAGES * FTILE);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + FSTAGES;
  uint64_t* empty = v_full + FSTAGES;
  uint64_t* meta_full = empty + FSTAGES;
  uint64_t* meta_empty = meta_full + 2;
  int* meta = reinterpret_cast<int*>(meta_empty + 2);   // [2][META]

  const int G = H / KV, TQ = FBM / G, RB = TQ * G;   // RB: the tile rows that hold a query
  const int nqb = (T + TQ - 1) / TQ;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);       // every consumer thread, once its last QK of an item is done
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);   // every consumer thread releases the stage
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&meta_full[s], 32);    // every lane of the producer warp, after its writes
      mbar_init(&meta_empty[s], 256);  // every consumer thread, once it has read the slot
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup: registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const Plan pl(ws, B * nqb);
    if (PAGED) grid_dep_wait();   // the plan's items (the consumers read only shared memory)
    if (warp == 0) {
      const int n_items = PAGED ? pl.hdr[0] : B * KV * nqb;
      int* counter = PAGED ? pl.hdr + 3 : ws;
      int g = 0;      // K / V tiles issued by this block: the ring position
      int rows = 0;   // this lane's box of the current 32: its pool row
      int nxt = blockIdx.x;   // the first item is the block's own; the rest from the counter
      for (int it = 0;; ++it) {
        const int idx = __shfl_sync(0xffffffffu, nxt, 0);
        // the next item's index, in flight while this one's loads are issued
        if (lane == 0 && idx < n_items) nxt = gridDim.x + atomicAdd(counter, 1);
        int* mt = meta + (it & 1) * META;
        if (it >= 2) mbar_wait(&meta_empty[it & 1], ((it >> 1) - 1) & 1);
        if (idx >= n_items) {   // no work left: the consumers stop at b = -1
          if (lane == 0) mt[0] = -1;
          mbar_arrive(&meta_full[it & 1]);
          break;
        }
        int b, m, kh, k0, kend, slot;
        if (PAGED) {
          const int4 rec = pl.items[idx];
          const int u = rec.x / KV;
          kh = rec.x - u * KV;
          b = u / nqb;
          m = u - b * nqb;
          k0 = rec.y;
          kend = rec.z;
          slot = rec.w;
        } else {
          m = nqb - 1 - idx / (B * KV);
          b = (idx % (B * KV)) / KV;
          kh = idx % KV;
          k0 = 0;
          kend = min(S, min(m * TQ + TQ, T));   // no tile above the diagonal
          slot = -1;
        }
        const int nt = (kend - k0 + FBN - 1) / FBN;
        auto issue_q = [&]() {
          mbar_expect_tx(q_full, RB * 256);   // two halves of RB rows of 128 B
          for (int h = 0; h < 2; ++h)
            tma_load_4d(qs + h * FHALF, &tq, q_full, h * SWZ, kh * G, m * TQ, b);
        };
        if (lane == 0 && it == 0) issue_q();   // the block's first q under the limits' loads
        if (PAGED) {   // the item's first 32 boxes' pool rows, loaded beside the limits
          const int j = k0 + lane * box_rows;
          rows = j < kend ? (int)(table[(long long)b * P + j / ps] * ps + j % ps) : 0;
        }
        if (lane == 0) {
          mt[0] = b;
          mt[1] = m;
          mt[2] = kh;
          mt[3] = k0;
          mt[4] = nt;
          mt[5] = kend;
          mt[6] = slot;
        }
        // the limits of the item's positions (PAGED: the plan's rule; every
        // unit with an item holds a real query, so padding sees chunk_start)
        long long cs = 0, cap = S;
        if (PAGED) {
          if (lane == 0) cs = qpos[(long long)b * T];
          if (lane == 1) cap = min(cap, seq_len[b]);
          cs = __shfl_sync(0xffffffffu, cs, 0);
          cap = __shfl_sync(0xffffffffu, cap, 1);
        }
        for (int i = lane; i < TQ; i += 32) {
          const int t = m * TQ + i;
          const long long p = PAGED && t < T ? qpos[(long long)b * T + t] : t;
          mt[8 + i] = t >= T ? 0 : (int)max(0LL, min(p >= 0 ? p + 1 : cs, cap));
        }
        mbar_arrive(&meta_full[it & 1]);
        if (lane == 0 && it > 0) {
          mbar_wait(q_empty, (it - 1) & 1);
          issue_q();
        }
        for (int kt = 0; kt < nt; ++kt, ++g) {
          const int s = g % FSTAGES, j0 = k0 + kt * FBN;
          if (g >= FSTAGES) mbar_wait(&empty[s], (g / FSTAGES - 1) & 1);
          if (PAGED) {
            // the tile's boxes up to the item's key end, each in one page
            const int box0 = kt * (FBN / box_rows);
            if (kt > 0 && (box0 & 31) == 0) {   // the next 32 boxes' pool rows
              const int j = k0 + (box0 + lane) * box_rows;
              rows = j < kend ? (int)(table[(long long)b * P + j / ps] * ps + j % ps) : 0;
            }
            const int nb = (min(FBN, kend - j0) + box_rows - 1) / box_rows;
            if (lane == 0) {
              mbar_expect_tx(&k_full[s], nb * box_rows * 256);
              mbar_expect_tx(&v_full[s], nb * box_rows * 256);
            }
            for (int i = 0; i < nb; ++i) {
              const int row = __shfl_sync(0xffffffffu, rows, (box0 + i) & 31);
              if (lane == 0) {
                for (int h = 0; h < 2; ++h) {
                  const int off = s * FTILE + h * FHALF + i * box_rows * 128;
                  tma_load_2d(ks + off, &tk, &k_full[s], kh * HD + h * SWZ, row);
                  tma_load_2d(vs + off, &tv, &v_full[s], kh * HD + h * SWZ, row);
                }
              }
            }
          } else if (lane == 0) {
            mbar_expect_tx(&k_full[s], FTILE);
            for (int h = 0; h < 2; ++h)
              tma_load_3d(ks + s * FTILE + h * FHALF, &tk, &k_full[s], kh * HD + h * SWZ, j0, b);
            mbar_expect_tx(&v_full[s], FTILE);
            for (int h = 0; h < 2; ++h)
              tma_load_3d(vs + s * FTILE + h * FHALF, &tv, &v_full[s], kh * HD + h * SWZ, j0, b);
          }
        }
      }
    } else if (PAGED) {
      // zeros over the units that take no item (no query of theirs sees a
      // key): each block its share of each such unit's rows
      const int zt = threadIdx.x - 288;
      for (int u = 0; u < B * nqb; ++u) {
        if (pl.ulim[u]) continue;
        const int b = u / nqb, t0 = (u - b * nqb) * TQ, t1 = min(t0 + TQ, T);
        uint4* dst = reinterpret_cast<uint4*>(out + ((long long)b * T + t0) * H * HD);
        const long long n = (long long)(t1 - t0) * H * (HD / 8);
        const long long i0 = n * blockIdx.x / gridDim.x, i1 = n * (blockIdx.x + 1) / gridDim.x;
        for (long long i = i0 + zt; i < i1; i += 96) dst[i] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64*wg .. 64*wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int c2 = (lane & 3) * 2;
    const int r0 = wg * 64 + wq * 16 + (lane >> 2);   // this thread's rows r0, r0 + 8
    float o[64];
    float sc[64];
    uint32_t pk[32], pn[32];   // p of the tile in the value product, and of the next
    int g0 = 0;                // the ring position of the item's first tile

    // S = Q K^T of ring tile g into sc (asynchronous: committed, not waited)
    auto issue_qk = [&](int g) {
      const unsigned char* kst = ks + (g % FSTAGES) * FTILE;
      mbar_wait(&k_full[g % FSTAGES], (g / FSTAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {   // steps 4..7 in the second 64-column half
        const int off = (kk / 4) * FHALF + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(qs + off + wg * 64 * 128, 16, 1024),
                 sw128_desc(kst + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };

    // O += P V of ring tile g (asynchronous): V is [keys][columns] in shared
    // memory (MN-major): its two 64-column halves lie 16 KB apart (LBO),
    // 8-key groups 1 KB apart (SBO)
    auto issue_pv = [&](int g) {
      mbar_wait(&v_full[g % FSTAGES], (g / FSTAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < FBN / 16; ++j)
        wgmma_rs_tb(o, pk[4 * j], pk[4 * j + 1], pk[4 * j + 2], pk[4 * j + 3],
                    sw128_desc(vs + (g % FSTAGES) * FTILE + j * 16 * 128, FHALF, 1024));
      wgmma_commit();
    };

    // ping-pong: warpgroup wg issues its products between bar_sync(1 + wg)
    // and bar_arrive(2 - wg), so the two take turns on the tensor cores and
    // one's softmax runs under the other's products; warpgroup 1 lets
    // warpgroup 0 go first. Both run the same items and tiles, so turns pair
    // up across items.
    if (wg == 1) bar_arrive(1, 256);
    for (int it = 0;; ++it) {
      const int* mt = meta + (it & 1) * META;
      mbar_wait(&meta_full[it & 1], (it >> 1) & 1);
      const int b = mt[0];
      if (b < 0) break;
      const int m = mt[1], kh = mt[2], k0 = mt[3], nt = mt[4], kend = mt[5], slot = mt[6];
      // exclusive key limits of the thread's rows: 0 for a row that holds no
      // query (its q row in shared memory was never loaded); a tile below
      // the warp's least limit is not masked
      const int lim0 = r0 < RB ? mt[8 + r0 / G] : 0;
      const int lim1 = r0 + 8 < RB ? mt[8 + (r0 + 8) / G] : 0;
      mbar_arrive(&meta_empty[it & 1]);
      const SoftmaxRows rows = {lim0, lim1, __reduce_min_sync(0xffffffffu, min(lim0, lim1)),
                                c2, scale_log2};
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;

      mbar_wait(q_full, it & 1);
      bar_sync(1 + wg, 256);
      issue_qk(g0);
      bar_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, pk, m0, m1, l0, l1, al0, al1, k0, rows);
      // every tile but the last: the QK of tile kt+1 is issued before the PV
      // of tile kt, and the softmax of kt+1 runs while PV kt is on the tensor
      // cores (no branch inside, so ptxas sees which group each wait retires)
      for (int kt = 0; kt + 1 < nt; ++kt) {
        bar_sync(1 + wg, 256);
        issue_qk(g0 + kt + 1);
        issue_pv(g0 + kt);
        bar_arrive(2 - wg, 256);
        wgmma_wait<1>();
        fence_regs(sc);
        softmax_tile(sc, pn, m0, m1, l0, l1, al0, al1, k0 + (kt + 1) * FBN, rows);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pk);   // pk stays untouched until the product that reads it is done
        mbar_arrive(&empty[(g0 + kt) % FSTAGES]);
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
      mbar_arrive(q_empty);   // the item's every QK is done: the next item's q may load
      const int gl = g0 + nt - 1;   // the last tile's ring position
      if (PAGED && kend < k0 + nt * FBN) {
        // zero the value rows of the last tile past the item's key end (an
        // unloaded box, stale pool rows: p = 0 there, but 0 * NaN is NaN).
        // Both warpgroups' value products read the whole tile, so each
        // writes all of them (the same zeros) and meets only its own warps
        const int s = gl % FSTAGES, valid = kend - (k0 + (nt - 1) * FBN);
        mbar_wait(&v_full[s], (gl / FSTAGES) & 1);
        const int n = (FBN - valid) * 16;   // 16-byte pieces of both halves
        for (int i = threadIdx.x & 127; i < n; i += 128) {
          const int half = i / ((FBN - valid) * 8), rem = i % ((FBN - valid) * 8);
          *reinterpret_cast<uint4*>(vs + s * FTILE + half * FHALF + (valid + rem / 8) * 128 +
                                    (rem % 8) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async();   // the zeros before the value product reads them
        bar_sync(3 + wg, 128);
      }
      bar_sync(1 + wg, 256);
      issue_pv(gl);
      bar_arrive(2 - wg, 256);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[gl % FSTAGES]);
      g0 += nt;

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      if (PAGED && slot >= 0) {
        // a piece of a split unit: its float32 partial rows for the merge
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half, t = m * TQ + r / G;
          if (r >= RB || t >= T) continue;
          const long long pr = (long long)slot * FBM + r;
          float* prow = o_part + pr * HD + c2;
#pragma unroll
          for (int i = 0; i < 16; ++i)
            *reinterpret_cast<float2*>(prow + 8 * i) =
                make_float2(o[4 * i + 2 * half], o[4 * i + 2 * half + 1]);
          if ((lane & 3) == 0)
            *reinterpret_cast<float2*>(ml_part + 2 * pr) =
                make_float2(half ? m1 : m0, half ? l1 : l0);
        }
      } else {
        // normalised bf16, 8-byte stores: lanes q and q ^ 1 trade one word
        // of each pair of 8-column groups, so that the even lane holds 4
        // columns of the first group and the odd lane 4 of the second
        const bool odd = lane & 1;
        const int col = odd ? 8 + c2 - 2 : c2;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half, t = m * TQ + r / G;
          const bool ok = r < RB && t < T;
          bf16* orow = out + (((long long)b * T + t) * H + kh * G + r % G) * HD;
          const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t we = pack_bf16(o[8 * j + 2 * half] * inv,
                                          o[8 * j + 2 * half + 1] * inv);
            const uint32_t wo = pack_bf16(o[8 * j + 4 + 2 * half] * inv,
                                          o[8 * j + 4 + 2 * half + 1] * inv);
            const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? we : wo, 1);
            if (ok)
              *reinterpret_cast<uint2*>(orow + 16 * j + col) =
                  odd ? make_uint2(got, wo) : make_uint2(we, got);
          }
        }
      }
    }
  }
}

// a persistent grid of MERGE_TH threads a block: each split unit's rows of
// out from its pieces' partials, 16 rows a work item of (split unit, kv
// head, row group), a warp two of them (rows r and r + 8), 4 columns a
// lane; one pass over the pieces with a running maximum, the loads of
// MERGE_BATCH pieces of both rows issued at once; a piece with m = -inf (no
// key of that row in it) weighs nothing
__global__ void __launch_bounds__(MERGE_TH)
flash_paged_merge(const float* __restrict__ o_part, const float* __restrict__ ml_part,
                  int* __restrict__ ws, bf16* __restrict__ out, int B, int T, int H, int KV) {
  const int G = H / KV, TQ = FBM / G, RB = TQ * G, nqb = (T + TQ - 1) / TQ;
  const Plan pl(ws, B * nqb);
  grid_dep_wait();   // the attention kernel's partials
  const int groups = (RB + 15) / 16, n = pl.hdr[2] * KV * groups;
  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x; w < n; w += gridDim.x) {
    const int uk = w / groups, kh = uk % KV;
    const int4 su = pl.slist[uk / KV];   // (u, pieces, first slot)
    const int u = su.x, z = su.y;
    const int r0 = (w % groups) * 16 + (threadIdx.x >> 5);
    const int b = u / nqb;
    const long long step = (long long)KV * FBM;   // from one piece's rows to the next's
    const long long p0 = ((long long)su.z * KV + kh) * FBM + r0;
    float M[2] = {-INFINITY, -INFINITY}, L[2] = {0.f, 0.f};
    float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int z0 = 0; z0 < z; z0 += MERGE_BATCH) {
      float2 ml[2][MERGE_BATCH];
      float4 ov[2][MERGE_BATCH];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < MERGE_BATCH; ++j) {
          const long long pr = p0 + 8 * h + (long long)min(z0 + j, z - 1) * step;
          ml[h][j] = reinterpret_cast<const float2*>(ml_part)[pr];
          ov[h][j] = reinterpret_cast<const float4*>(o_part + pr * HD)[lane];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < MERGE_BATCH; ++j) {
          if (z0 + j >= z || ml[h][j].x == -INFINITY) continue;
          const float mn = fmaxf(M[h], ml[h][j].x);
          const float a = exp2f(M[h] - mn), wz = exp2f(ml[h][j].x - mn);   // M = -inf: a = 0
          M[h] = mn;
          L[h] = L[h] * a + ml[h][j].y * wz;
          acc[h].x = acc[h].x * a + ov[h][j].x * wz;
          acc[h].y = acc[h].y * a + ov[h][j].y * wz;
          acc[h].z = acc[h].z * a + ov[h][j].z * wz;
          acc[h].w = acc[h].w * a + ov[h][j].w * wz;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, t = (u - b * nqb) * TQ + r / G;
      if (r >= RB || t >= T) continue;   // no partial there: a row that holds no query
      const float inv = 1.f / fmaxf(L[h], 1e-30f);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[h].x * inv, acc[h].y * inv);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[h].z * inv, acc[h].w * inv);
      uint2 pair;
      pair.x = *reinterpret_cast<const uint32_t*>(&lo);
      pair.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + (((long long)b * T + t) * H + kh * G + r % G) * HD +
                                4 * lane) = pair;
    }
  }
}

// K2's int8 paged mode, its first launch: grid (B*P, pieces / WIDEN_TH).
// Block (b*P + p, y) widens 16-byte pieces y*WIDEN_TH .. of page p of row b
// (pool page table[b*P + p]: ps slots of KV rows of 128 int8, one float32
// scale a row), one of K and one of V a thread, into bf16 page b*P + p of
// kw / vw with dequant16 (the plain path's values bit for bit), where the
// page holds a key below the row's seq_len: the paged mode after it reads
// no other page. Block (b*P + p, 0) writes b*P + p into wtable, the table
// the bf16 paged mode then runs over kw / vw with.
constexpr int WIDEN_TH = 256;
__global__ void __launch_bounds__(WIDEN_TH)
widen_kv_pages(const unsigned char* __restrict__ k, const unsigned char* __restrict__ v,
               const float* __restrict__ ksc, const float* __restrict__ vsc,
               const long long* __restrict__ table, const long long* __restrict__ seq_len,
               int P, int ps, int KV, bf16* __restrict__ kw, bf16* __restrict__ vw,
               long long* __restrict__ wtable) {
  const int bp = blockIdx.x, b = bp / P, p = bp - b * P;
  if (blockIdx.y == 0 && threadIdx.x == 0) wtable[bp] = bp;
  const long long rows = (long long)ps * KV;   // (slot, kv head) rows of a page
  const int i = blockIdx.y * WIDEN_TH + threadIdx.x;   // the thread's 16-byte piece
  if ((long long)p * ps >= seq_len[b] || i >= rows * (HD / 16)) return;
  const long long src = table[bp] * rows, dst = (long long)bp * rows * HD / 8 + 2 * i;
  const float ks = ksc[src + i / (HD / 16)], vs = vsc[src + i / (HD / 16)];
  const uint4 kx = reinterpret_cast<const uint4*>(k + src * HD)[i];
  const uint4 vx = reinterpret_cast<const uint4*>(v + src * HD)[i];
  uint4 lo, hi;
  dequant16(kx, ks, lo, hi);
  reinterpret_cast<uint4*>(kw)[dst] = lo;
  reinterpret_cast<uint4*>(kw)[dst + 1] = hi;
  dequant16(vx, vs, lo, hi);
  reinterpret_cast<uint4*>(vw)[dst] = lo;
  reinterpret_cast<uint4*>(vw)[dst + 1] = hi;
}

// ------------------------------------------------------- K1's int8 mode

constexpr int IBK = 64;              // keys a tile
constexpr int ISTAGES = 3;           // ring depth: a stage holds a tile's K, V and scales
constexpr int ICW = 4;               // consumer warps: warp w takes keys 16w .. 16w + 15
constexpr int ITH = 32 * (ICW + 1);  // + the producer warp
constexpr int IKB = IBK * HD;        // bytes of a tile's int8 K (or V)
constexpr int I8_PIECES = 1;         // pieces of about W / (I8_PIECES * blocks) key tiles,
constexpr int I8_MIN_TILES = 2;      // and at least this many
constexpr int IPLAN_TH = 512;        // threads of the plan kernel
constexpr int IBUCKETS = 2048;       // the plan's counting sort (longer pieces share the last)
constexpr int IPLAN_HDR = 8;         // items, C, the work counter, W
constexpr int IPLAN_SMEM_ROWS = 1024;   // row groups whose records the plan keeps in shared memory
constexpr int IMETA = 8 + 16;        // an item's slot: b, kv head, query group, first key, key
                                     // end, tiles, partial slot, unit; its rows' key limits
constexpr int IOROW = HD + 4;        // merge buffer row (floats)
constexpr int I8_MERGE_BATCH = 10;   // pieces whose partials a merging thread loads at once
static_assert(IPLAN_HDR % 4 == 0, "the row records start 16-byte aligned");

// resident blocks an SM: 3 with 8 query rows an item (73 KB of shared
// memory, <= 136 registers), 2 with 16
template <int NQ>
constexpr int i8_blocks_per_sm() { return NQ == 1 ? 3 : 2; }

template <int NQ>
constexpr int i8_smem_bytes() {
  return 1024                                   // slack: the ring starts 1024-byte aligned
         + 2 * ISTAGES * IKB                    // K and V stages (128-byte swizzled)
         + ISTAGES * 2 * IBK * 4                // their scales
         + 2 * 8 * NQ * HD * 2                  // two q slots
         + ICW * 8 * NQ * (IOROW + 2) * 4       // the warps' partials (O, then m, l)
         + 2 * IMETA * 4                        // two item slots
         + 8 * (2 * ISTAGES + 4);               // mbarriers
}
static_assert(3 * (i8_smem_bytes<1>() + 1024) <= 233472, "three blocks an SM");
static_assert(2 * (i8_smem_bytes<2>() + 1024) <= 233472, "two blocks an SM");

// the plan in its int32 workspace: the header; per row group rw = b*QG + qg
// (lim, tiles, z, slot base or -1); per unit u = rw*KV + kh the count of its
// pieces done (split units); per row group the first place of its longer and
// of its shorter pieces within their buckets; then (16-byte aligned) the
// items longest first, each (u, first key, key end, partial slot or -1)
struct I8Plan {
  int* hdr;
  int4* rows;
  int* cnt;
  int2* offs;
  int4* items;
  __device__ I8Plan(int* ws, int RW, int U)
      : hdr(ws), rows(reinterpret_cast<int4*>(ws + IPLAN_HDR)), cnt(ws + IPLAN_HDR + 4 * RW),
        offs(reinterpret_cast<int2*>(ws + IPLAN_HDR + 4 * RW + U + (U & 1))),
        items(reinterpret_cast<int4*>(ws + ((IPLAN_HDR + 6 * RW + U + (U & 1) + 3) & ~3))) {}
};

// a query at chunk position t of a row: keys j < min(seq_len, q0 + t + 1, max_keys)
__device__ __forceinline__ int i8_limit(long long sl, long long q0, int t, int max_keys) {
  long long v = q0 + t + 1;
  v = v < sl ? v : sl;
  v = v < max_keys ? v : (long long)max_keys;
  return v > 0 ? (int)v : 0;
}

// the pieces of a unit of t tiles: none where t = 0, else ceil(t / C), or
// (round) t / C rounded to the nearest, at least 1; piece zi holds tiles
// zi*t/z .. (zi+1)*t/z - 1, so a unit's pieces differ by one tile at most
// (its last piece is no straggler that finishes after the rest);
// ops/paged_attention.py i8_pieces
__device__ __forceinline__ int i8_pieces(int t, int C, bool round) {
  return t == 0 ? 0 : round ? max(1, (2 * t + C) / (2 * C)) : (t + C - 1) / C;
}

// of a unit's ceil(t / C) pieces, those longer than C / 2
__device__ __forceinline__ int i8_long_pieces(int t, int C) {
  const int z = i8_pieces(t, C, false), lo = z ? t / z : 0, hi = t - lo * z;
  return (2 * (lo + 1) > C ? hi : 0) + (2 * lo > C ? z - hi : 0);
}

// one block of IPLAN_TH threads: the int8 mode's plan
// (ops/paged_attention.py decode_i8_plan is its model). Row group rw = b*QG
// + qg holds the query rows qg*RQ .. of row b (r = t*G + g); it ends at the
// key limit of its last query (the widest), lim, and takes t = ceil(lim /
// 64) tiles for each kv head: W = KV * the groups' tiles summed. C =
// max(I8_MIN_TILES, ceil(W / (I8_PIECES * nblocks))); a group is cut into
// ceil(t / C) pieces (i8_pieces), but where more pieces longer than C / 2
// than blocks would come of that (a second wave of long pieces: rows of one
// length), into t / C rounded (one wave); their float32 partials take slots in
// group order; a group with no key takes none (the attention kernel's
// producer warps write its zeros); the items, one a (piece, kv head), go
// into the list longest first by a counting sort over their tile counts.
// The work counter and the
// units' piece counts are reset here, so a captured call replays with
// them; nothing is read on the host.
__global__ void __launch_bounds__(IPLAN_TH)
decode_i8_plan(const long long* __restrict__ seq_len, const long long* __restrict__ qpos,
               int qpos_stride, int min_one, int max_keys, int B, int T, int G, int KV, int RQ,
               int nblocks, int* __restrict__ ws) {
  constexpr int NW = IPLAN_TH / 32;
  __shared__ int hist[IBUCKETS];
  __shared__ int4 s_rows[IPLAN_SMEM_ROWS];
  __shared__ int2 s_offs[IPLAN_SMEM_ROWS];
  __shared__ int s_nb;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int R = T * G, QG = (R + RQ - 1) / RQ, RW = B * QG;
  const I8Plan pl(ws, RW, RW * KV);
  grid_dep_launch();   // the attention kernel's blocks may take their SMs and set up
  const bool in_smem = RW <= IPLAN_SMEM_ROWS;
  int4* rows = in_smem ? s_rows : pl.rows;
  int2* offs = in_smem ? s_offs : pl.offs;
  if (wid == 0) {
    // warp 0 plans (no block barrier on its way), a row group a lane in turn:
    // each group's key limit and tiles; W, C
    int w = 0;
    for (int rw = lane; rw < RW; rw += 32) {
      const int b = rw / QG, qg = rw - b * QG;
      long long sl = seq_len[b];
      if (min_one) sl = sl > 1 ? sl : 1;
      const long long q0 = qpos ? qpos[(long long)b * qpos_stride] : sl - 1;
      const int lim = i8_limit(sl, q0, (min(qg * RQ + RQ, R) - 1) / G, max_keys);
      rows[rw] = make_int4(lim, (lim + IBK - 1) / IBK, 0, -1);
      w += (lim + IBK - 1) / IBK;
    }
    const long long W = (long long)__reduce_add_sync(0xffffffffu, (unsigned)w) * KV;
    const long long per_block = (long long)I8_PIECES * nblocks;
    const int C = (int)max((long long)I8_MIN_TILES, (W + per_block - 1) / per_block);
    const int nb = min(2 * C + 1, IBUCKETS);   // tile counts 1 .. < 1.5 C
    for (int i = lane; i < nb; i += 32) hist[i] = 0;
    // rounded piece counts where ceil's long pieces would outnumber the blocks
    int nlong = 0;
    for (int rw = lane; rw < RW; rw += 32) nlong += i8_long_pieces(rows[rw].y, C);
    const bool round =
        (long long)__reduce_add_sync(0xffffffffu, (unsigned)nlong) * KV > nblocks;
    __syncwarp();
    // each group's pieces and (split groups) first partial slot, in group
    // order; t % z pieces of ceil(t / z) tiles, the rest of floor(t / z):
    // each kind's first place within its bucket
    int carry = 0;
    for (int base = 0; base < RW; base += 32) {
      const int rw = base + lane;
      int4 r = make_int4(0, 0, 0, -1);
      if (rw < RW) {
        r = rows[rw];
        r.z = i8_pieces(r.y, C, round);
      }
      int tot;
      const int e = warp_scan(r.z > 1 ? r.z : 0, tot);
      if (rw < RW) {
        if (r.z > 1) r.w = carry + e;
        rows[rw] = r;
        const int lo = r.z ? r.y / r.z : 0, hi = r.y - lo * r.z;
        offs[rw] = make_int2(hi ? atomicAdd(&hist[min(lo + 1, nb - 1)], hi * KV) : 0,
                             lo ? atomicAdd(&hist[min(lo, nb - 1)], (r.z - hi) * KV) : 0);
      }
      carry += tot;
    }
    __syncwarp();
    int n = 0;   // each bucket's first item, the longest bucket first
    for (int base = 0; base < nb; base += 32) {
      const int c = nb - 1 - (base + lane);
      int t;
      const int e = warp_scan(c >= 0 ? hist[c] : 0, t);
      if (c >= 0) hist[c] = n + e;
      n += t;
    }
    if (lane == 0) {
      s_nb = nb;
      pl.hdr[0] = n;
      pl.hdr[1] = C;
      pl.hdr[2] = 0;
      pl.hdr[3] = (int)min(W, (long long)INT32_MAX);
    }
  }
  __syncthreads();
  const int nb = s_nb;
  // a warp a row group: its z * KV items, (piece zi, kv head kh) a lane,
  // each at its bucket's start + its kind's place + its rank among the
  // group's pieces of that kind
  for (int rw = wid; rw < RW; rw += NW) {
    const int4 r = rows[rw];
    const int2 of = offs[rw];
    if (lane == 0 && in_smem) pl.rows[rw] = r;
    for (int k = lane; k < KV; k += 32) pl.cnt[rw * KV + k] = 0;
    const int lo = r.z ? r.y / r.z : 0;
    for (int k = lane; k < r.z * KV; k += 32) {
      const int zi = k / KV, kh = k - zi * KV;
      const int t0 = zi * r.y / r.z, t1 = (zi + 1) * r.y / r.z;   // the piece's tiles
      const int longer = t0 - zi * lo;   // the longer pieces before this one
      const int at = t1 - t0 > lo ? hist[min(lo + 1, nb - 1)] + of.x + longer * KV + kh
                                  : hist[min(lo, nb - 1)] + of.y + (zi - longer) * KV + kh;
      pl.items[at] = make_int4(rw * KV + kh, t0 * IBK, min(t1 * IBK, r.x),
                               r.z > 1 ? (r.w + zi) * KV + kh : -1);
    }
  }
}

// the bf16 pair (round(float(x0) * s0), round(float(x1) * s1)) of byte i of
// w0 and of w1 (int8 with the sign bit flipped, x + 128): dequant_pair's
// arithmetic with the pair's bytes from two rows, so each value is the plain
// path's (int8.float() * scale).to(bf16) bit for bit
__device__ __forceinline__ uint32_t dequant_cross(uint32_t w0, uint32_t w1, int i, float s0,
                                                  float s1) {
  uint32_t a, b;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(a) : "r"(w0), "r"(0x4B000000u), "r"(0x7440 | i));
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(b) : "r"(w1), "r"(0x4B000000u), "r"(0x7440 | i));
  return pack_bf16((__uint_as_float(a) - 8388736.f) * s0, (__uint_as_float(b) - 8388736.f) * s1);
}

// atomicAdd at gpu scope with acquire-release order: after a block barrier,
// one thread's call publishes the block's earlier writes and, where it sees
// the others' count, lets the block read theirs after the next barrier
__device__ __forceinline__ int atom_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// the 8x8 b16 matrix whose fragment (row lane / 4, columns 2 (lane % 4), +1)
// this thread holds, transposed, in the same fragment layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// a persistent grid of ITH threads a block (i8_blocks_per_sm an SM),
// launched early under the plan. An item (the plan's) is a piece of keys
// [k0, k1) of row b, kv head kh, query group qg: the RQ = 8*NQ query rows
// qg*RQ .. (r = t*G + g, query head kh*G + g; rows past R = T*G hold none).
// Warp ICW, the producer: waits for the plan (griddepcontrol); takes the
// block's first item, and each next one from the work counter once the
// current one's tiles are all issued; writes each item's meta and its rows'
// key limits into one of two slots, with its q rows (cp.async); keeps 32
// page-table entries of the row, one a lane; for each 64-key tile, as a
// stage frees up, its keys' scales of K and V (cp.async, zeros past k1) and
// its K and V as TMA boxes of box_rows keys (each in one page) of 2-D maps
// over the int8 pools as (KV*128 bytes, pages*ps rows) under 128-byte
// swizzle; a stage's full barrier takes 32 cp.async arrivals and the boxes'
// bytes. With no item left it writes the zeros of the row groups that see
// no key (no item), its block's share.
// Warps 0..ICW-1, the consumers: warp w takes tile rows 16w .. 16w + 15 of
// every tile and keeps its own running (m, l, O) of the item's queries.
// Both products run on mma.sync m16n8k16 with the keys (or the value
// columns) as the 16 rows and the queries as the 8 columns, so a query
// group of 8 fills the n tile (G = 8 wastes nothing; NQ = 2 for 16):
//   S^T = K Q^T: the A fragment is dequantized in registers from 32
//     consecutive bytes of key rows g and g + 8 (lane = 4g + c, bytes 32c
//     .. 32c + 31, two 16-byte loads conflict-free under the swizzle); the
//     head dimension is permuted (k-step kk, columns 2c, 2c+1, 2c+8, 2c+9 =
//     dims 32c + 4kk + 0..3), and q's B fragment with it: words 2kk, 2kk+1
//     of q row g's dims 32c .. 32c + 31;
//   softmax over the keys in registers (log2 units), p rounded to bf16 and
//     turned into the B fragment of the value product by movmatrix.trans;
//   O^T += V^T P^T: the A fragment is dequantized from one 16-byte load of
//     each of the value rows 2c, 2c+1, 2c+8, 2c+9 (dims 16g .. 16g + 15:
//     m-tile mt takes dims 16g + 2mt and 16g + 2mt + 1 as its rows g, g+8),
//     each byte with its own row's scale (dequant_cross).
// At an item's end the warps' partials meet in shared memory, a thread 8
// columns of a row: an unsplit item writes out, a piece of a split unit its
// float32 partial (unnormalised O, m in log2 units, l) in slot `pslot`, and
// the last of the unit's pieces to finish (a counter the plan zeroes)
// merges the unit's partials into out.
template <int NQ>
__global__ void __launch_bounds__(ITH, i8_blocks_per_sm<NQ>())
decode_i8(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
          const bf16* __restrict__ q, long long q_bstride, const float* __restrict__ ksc,
          const float* __restrict__ vsc, const long long* __restrict__ table, int P, int ps,
          int box_rows, const long long* __restrict__ seq_len, const long long* __restrict__ qpos,
          int qpos_stride, int min_one, int max_keys, bf16* __restrict__ out, int B, int T, int H,
          int KV, float scale_log2, int* __restrict__ ws, float* __restrict__ o_part,
          float* __restrict__ ml_part) {
  constexpr int RQ = 8 * NQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int s_last;
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kring = smem;                                      // [ISTAGES][IBK][128]
  unsigned char* vring = kring + ISTAGES * IKB;
  float* scs = reinterpret_cast<float*>(vring + ISTAGES * IKB);      // [ISTAGES][2][IBK]
  bf16* qsl = reinterpret_cast<bf16*>(scs + ISTAGES * 2 * IBK);      // [2][RQ][HD]
  float* mbuf = reinterpret_cast<float*>(qsl + 2 * RQ * HD);         // [ICW][RQ][IOROW]
  float* mlb = mbuf + ICW * RQ * IOROW;                               // [ICW][RQ][2]
  int* meta = reinterpret_cast<int*>(mlb + ICW * RQ * 2);             // [2][IMETA]
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + 2 * IMETA);
  uint64_t* empty = full + ISTAGES;
  uint64_t* meta_full = empty + ISTAGES;
  uint64_t* meta_empty = meta_full + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV, R = T * G, QG = (R + RQ - 1) / RQ;
  const I8Plan pl(ws, B * QG, B * QG * KV);
  if (tid == 0) {
    for (int s = 0; s < ISTAGES; ++s) {
      mbar_init(&full[s], 33);        // 32 lanes' scale copies + the boxes' expect_tx
      mbar_init(&empty[s], ICW);      // each consumer warp, once it holds the stage
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&meta_full[s], 64);   // 32 lanes' writes + their q copies
      mbar_init(&meta_empty[s], ICW);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == ICW) {
    // ---- producer
    grid_dep_wait();   // the plan
    const int n_items = pl.hdr[0];
    int* counter = pl.hdr + 2;
    int idx = blockIdx.x;   // the block's first item; the rest from the counter
    int g = 0;              // tiles issued: the ring position
    for (int it = 0;; ++it) {
      const int slot = it & 1;
      int* mt = meta + slot * IMETA;
      if (it >= 2) mbar_wait(&meta_empty[slot], ((it >> 1) - 1) & 1);
      if (idx >= n_items) {   // no work left: the consumers stop at b = -1
        if (lane == 0) mt[0] = -1;
        cp_async_mbar_arrive(&meta_full[slot]);
        mbar_arrive(&meta_full[slot]);
        break;
      }
      const int4 item = pl.items[idx];
      const int u = item.x, k0 = item.y, k1 = item.z;
      const int rw = u / KV, kh = u - rw * KV, b = rw / QG, qg = rw - b * QG;
      const int nt = (k1 - k0 + IBK - 1) / IBK;
      long long sl = seq_len[b];
      if (min_one) sl = sl > 1 ? sl : 1;
      const long long q0 = qpos ? qpos[(long long)b * qpos_stride] : sl - 1;
      // the window: pages wb .. wb + 31 of row b, one a lane (0 past k1)
      int wb = k0 / ps;
      long long win = 0;
      if ((wb + lane) * (long long)ps < k1) win = table[(long long)b * P + wb + lane];
      if (lane == 0) {
        mt[0] = b;
        mt[1] = kh;
        mt[2] = qg;
        mt[3] = k0;
        mt[4] = k1;
        mt[5] = nt;
        mt[6] = item.w;
        mt[7] = u;
      }
      if (lane < RQ) {
        const int r = qg * RQ + lane;
        mt[8 + lane] = r < R ? i8_limit(sl, q0, r / G, max_keys) : 0;
      }
      bf16* qd = qsl + slot * RQ * HD;
#pragma unroll
      for (int i = 0; i < RQ * (HD / 8) / 32; ++i) {   // 16 bytes a copy; rows past R: zeros
        const int p = lane + 32 * i, r = p / (HD / 8), c = (p % (HD / 8)) * 8;
        const int ra = qg * RQ + r;
        const bool ok = ra < R;
        const int t = ok ? ra / G : 0, gq = ok ? ra % G : 0;
        cp_async16(qd + r * HD + c, q + b * q_bstride + ((long long)t * H + kh * G + gq) * HD + c,
                   ok ? 16 : 0);
      }
      cp_async_mbar_arrive(&meta_full[slot]);
      mbar_arrive(&meta_full[slot]);
      for (int kt = 0; kt < nt; ++kt, ++g) {
        const int s = g % ISTAGES, j0 = k0 + kt * IBK, jn = min(IBK, k1 - j0);
        if ((j0 + jn - 1) / ps >= wb + 32) {   // the next 32 pages
          wb = j0 / ps;
          win = (wb + lane) * (long long)ps < k1 ? table[(long long)b * P + wb + lane] : 0;
        }
        if (g >= ISTAGES) mbar_wait(&empty[s], ((g / ISTAGES) - 1) & 1);
        float* sd = scs + s * 2 * IBK;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // keys lane and lane + 32 of the tile
          const int kk = lane + 32 * h, j = j0 + kk;
          const bool ok = kk < jn;
          const long long pg = __shfl_sync(0xffffffffu, win, ok ? j / ps - wb : 0);
          const long long so = (pg * ps + (ok ? j % ps : 0)) * KV + kh;
          cp_async4(sd + kk, ksc + so, ok ? 4 : 0);
          cp_async4(sd + IBK + kk, vsc + so, ok ? 4 : 0);
        }
        cp_async_mbar_arrive(&full[s]);
        const int nbox = (jn + box_rows - 1) / box_rows, jb = j0 + lane * box_rows;
        const long long pb = __shfl_sync(0xffffffffu, win, lane < nbox ? jb / ps - wb : 0);
        if (lane == 0) mbar_expect_tx(&full[s], 2u * nbox * box_rows * HD);
        __syncwarp();
        if (lane < nbox) {
          const int row = (int)(pb * ps + jb % ps);
          tma_load_2d(kring + s * IKB + lane * box_rows * HD, &tk, &full[s], kh * HD, row);
          tma_load_2d(vring + s * IKB + lane * box_rows * HD, &tv, &full[s], kh * HD, row);
        }
      }
      // the next item, taken once this one's tiles are all issued (the
      // block is then a few tiles from free): a block that drew a short
      // piece comes back sooner and takes more, so the pieces balance
      int nxt = 0;
      if (lane == 0) nxt = gridDim.x + atomicAdd(counter, 1);
      idx = __shfl_sync(0xffffffffu, nxt, 0);
    }
    // zeros over the row groups with no key (no item): each block its share
    // of each such group's 16-byte pieces of out (the groups' limits read
    // 32 a load)
    for (int base = 0; base < B * QG; base += 32) {
      unsigned keyless =
          __ballot_sync(0xffffffffu, base + lane < B * QG && pl.rows[base + lane].x == 0);
      for (; keyless; keyless &= keyless - 1) {
        const int rw = base + __ffs(keyless) - 1, b = rw / QG, qg = rw - b * QG;
        const long long n = (long long)min(RQ, R - qg * RQ) * KV * (HD / 8);
        const long long i1 = n * (blockIdx.x + 1) / gridDim.x;
        for (long long i = n * blockIdx.x / gridDim.x + lane; i < i1; i += 32) {
          const int r = (int)(i / (KV * (HD / 8))), rem = (int)(i % (KV * (HD / 8)));
          const int ra = qg * RQ + r, kh = rem / (HD / 8);
          *reinterpret_cast<uint4*>(out + (((long long)b * T + ra / G) * H + kh * G + ra % G) *
                                              HD + (rem % (HD / 8)) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    return;
  }

  // ---- consumers
  const int w = warp, gq = lane >> 2, c = lane & 3;
  const int kr = 16 * w + gq;      // key rows kr, kr + 8 (kr % 8 == gq)
  const int vr = 16 * w + 2 * c;   // value rows vr, vr + 1, vr + 8, vr + 9 (vr % 8 == 2c)
  int g0 = 0;                      // the ring position of the item's first tile
  for (int it = 0;; ++it) {
    const int slot = it & 1;
    const int* mt = meta + slot * IMETA;
    mbar_wait(&meta_full[slot], (it >> 1) & 1);
    const int b = mt[0];
    if (b < 0) break;
    const int kh = mt[1], qg = mt[2], k0 = mt[3], nt = mt[5], pslot = mt[6], u = mt[7];
    int lim[NQ][2];
    uint32_t qf[NQ][16];   // q row 8j + gq, dims 32c .. 32c + 31 as bf16 pairs
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      lim[j][0] = mt[8 + 8 * j + 2 * c];
      lim[j][1] = mt[8 + 8 * j + 2 * c + 1];
      const uint4* qr =
          reinterpret_cast<const uint4*>(qsl + (slot * RQ + 8 * j + gq) * HD + 32 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 x = qr[i];
        qf[j][4 * i] = x.x;
        qf[j][4 * i + 1] = x.y;
        qf[j][4 * i + 2] = x.z;
        qf[j][4 * i + 3] = x.w;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&meta_empty[slot]);
    float o[8][NQ][4];
#pragma unroll
    for (int mi = 0; mi < 8; ++mi)
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[mi][j][i] = 0.f;
    float m[NQ][2], l[NQ][2];
#pragma unroll
    for (int j = 0; j < NQ; ++j) m[j][0] = m[j][1] = -INFINITY, l[j][0] = l[j][1] = 0.f;

    for (int kt = 0; kt < nt; ++kt) {
      const int gg = g0 + kt, s = gg % ISTAGES;
      mbar_wait(&full[s], (gg / ISTAGES) & 1);
      const unsigned char* kst = kring + s * IKB;
      const unsigned char* vst = vring + s * IKB;
      const float* sd = scs + s * 2 * IBK;
      uint4 ka[2], kb[2], va[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ka[h] = *reinterpret_cast<const uint4*>(kst + kr * HD + ((2 * c + h) ^ gq) * 16);
        kb[h] = *reinterpret_cast<const uint4*>(kst + (kr + 8) * HD + ((2 * c + h) ^ gq) * 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = vr + (i & 1) + 8 * (i >> 1);
        va[i] = *reinterpret_cast<const uint4*>(vst + r * HD + (gq ^ (2 * c + (i & 1))) * 16);
      }
      const float sk0 = sd[kr], sk1 = sd[kr + 8];
      const float sv[4] = {sd[IBK + vr], sd[IBK + vr + 1], sd[IBK + vr + 8], sd[IBK + vr + 9]};
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // the stage is in registers

      // S^T = K Q^T over the warp's 16 keys
      float sc[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t x0 = word_of(ka[kk >> 2], kk & 3) ^ 0x80808080u;
        const uint32_t x1 = word_of(kb[kk >> 2], kk & 3) ^ 0x80808080u;
        const uint32_t a[4] = {dequant_pair(x0, 0, sk0), dequant_pair(x1, 0, sk1),
                               dequant_pair(x0, 2, sk0), dequant_pair(x1, 2, sk1)};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const uint32_t bq[2] = {qf[j][2 * kk], qf[j][2 * kk + 1]};
          mma_bf16(sc[j], a, bq);
        }
      }
      // mask, online softmax (log2 units) of each query column over the
      // keys: rows kr (sc[.][0..1]) and kr + 8 (sc[.][2..3])
      const int key = k0 + kt * IBK + kr;
      float al[NQ][2];
      uint32_t pb[NQ][2];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = key < lim[j][e] ? sc[j][e] * scale_log2 : -INFINITY;
          const float v1 = key + 8 < lim[j][e] ? sc[j][2 + e] * scale_log2 : -INFINITY;
          float mx = fmaxf(v0, v1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
          const float mn = fmaxf(m[j][e], mx);
          // a query with no key yet keeps m = -inf; 2^(-inf - 0) = 0 leaves it empty
          const float ms = mn == -INFINITY ? 0.f : mn;
          al[j][e] = fast_exp2(m[j][e] - ms);
          m[j][e] = mn;
          const float p0 = fast_exp2(v0 - ms), p1 = fast_exp2(v1 - ms);
          l[j][e] = l[j][e] * al[j][e] + p0 + p1;   // this thread's keys; reduced at the end
          sc[j][e] = p0;
          sc[j][2 + e] = p1;
        }
        pb[j][0] = movmatrix_trans(pack_bf16(sc[j][0], sc[j][1]));   // keys 2c, 2c+1; query gq
        pb[j][1] = movmatrix_trans(pack_bf16(sc[j][2], sc[j][3]));   // keys 2c+8, 2c+9
      }
      bool grew = false;   // a running maximum moved: rescale (x 1 changes nothing)
#pragma unroll
      for (int j = 0; j < NQ; ++j) grew |= al[j][0] != 1.f || al[j][1] != 1.f;
      if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
        for (int mi = 0; mi < 8; ++mi)
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            o[mi][j][0] *= al[j][0];
            o[mi][j][1] *= al[j][1];
            o[mi][j][2] *= al[j][0];
            o[mi][j][3] *= al[j][1];
          }
      }
      // O^T += V^T P^T: m-tile mi holds dims 16gq + 2mi (row gq) and + 1 (row gq + 8)
      uint32_t y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        y[i][0] = va[i].x ^ 0x80808080u;
        y[i][1] = va[i].y ^ 0x80808080u;
        y[i][2] = va[i].z ^ 0x80808080u;
        y[i][3] = va[i].w ^ 0x80808080u;
      }
#pragma unroll
      for (int mi = 0; mi < 8; ++mi) {
        const int wi = mi >> 1, by = 2 * (mi & 1);
        const uint32_t a[4] = {dequant_cross(y[0][wi], y[1][wi], by, sv[0], sv[1]),
                               dequant_cross(y[0][wi], y[1][wi], by + 1, sv[0], sv[1]),
                               dequant_cross(y[2][wi], y[3][wi], by, sv[2], sv[3]),
                               dequant_cross(y[2][wi], y[3][wi], by + 1, sv[2], sv[3])};
#pragma unroll
        for (int j = 0; j < NQ; ++j) mma_bf16(o[mi][j], a, pb[j]);
      }
    }
    g0 += nt;

    // the warps' partials meet: query 8j + 2c + e's dims 16gq .. 16gq + 15
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float lv = l[j][e];
        lv += __shfl_xor_sync(0xffffffffu, lv, 4);
        lv += __shfl_xor_sync(0xffffffffu, lv, 8);
        lv += __shfl_xor_sync(0xffffffffu, lv, 16);
        const int qr = 8 * j + 2 * c + e;
        float* row = mbuf + (w * RQ + qr) * IOROW + 16 * gq;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(row + 4 * i) =
              make_float4(o[2 * i][j][e], o[2 * i][j][2 + e], o[2 * i + 1][j][e],
                          o[2 * i + 1][j][2 + e]);
        if (gq == 0) {
          mlb[(w * RQ + qr) * 2] = m[j][e];
          mlb[(w * RQ + qr) * 2 + 1] = lv;
        }
      }
    bar_sync(1, 32 * ICW);
    // thread: 8 columns (segment seg) of rows r = tid / 16, + 8
    const int seg = tid & 15;
    for (int r = tid >> 4; r < RQ; r += 8) {
      const int ra = qg * RQ + r;
      if (ra >= R) continue;   // no query in this row
      float M = -INFINITY, L = 0.f, acc[8];
#pragma unroll
      for (int k = 0; k < ICW; ++k) M = fmaxf(M, mlb[(k * RQ + r) * 2]);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      if (M != -INFINITY) {
#pragma unroll
        for (int k = 0; k < ICW; ++k) {
          const float wt = fast_exp2(mlb[(k * RQ + r) * 2] - M);   // 0 for a warp with no key
          const float4* src =
              reinterpret_cast<const float4*>(mbuf + (k * RQ + r) * IOROW + 8 * seg);
          const float4 x0 = src[0], x1 = src[1];
          L += mlb[(k * RQ + r) * 2 + 1] * wt;
          acc[0] += x0.x * wt;
          acc[1] += x0.y * wt;
          acc[2] += x0.z * wt;
          acc[3] += x0.w * wt;
          acc[4] += x1.x * wt;
          acc[5] += x1.y * wt;
          acc[6] += x1.z * wt;
          acc[7] += x1.w * wt;
        }
      }
      if (pslot < 0) {
        const float inv = 1.f / fmaxf(L, 1e-30f);
        *reinterpret_cast<uint4*>(out + (((long long)b * T + ra / G) * H + kh * G + ra % G) * HD +
                                  8 * seg) =
            make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv),
                       pack_bf16(acc[2] * inv, acc[3] * inv),
                       pack_bf16(acc[4] * inv, acc[5] * inv),
                       pack_bf16(acc[6] * inv, acc[7] * inv));
      } else {
        const long long pr = (long long)pslot * RQ + r;
        float4* dst = reinterpret_cast<float4*>(o_part + pr * HD + 8 * seg);
        dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        if (seg == 0) reinterpret_cast<float2*>(ml_part)[pr] = make_float2(M, L);
      }
    }
    if (pslot >= 0) {
      // the unit's last piece to finish merges its pieces' partials, the
      // loads of I8_MERGE_BATCH pieces at once, with a running maximum; one
      // thread's fence after the barrier releases the block's partials
      bar_sync(1, 32 * ICW);
      const int4 rr = pl.rows[u / KV];   // (lim, tiles, z, first slot)
      if (tid == 0) s_last = atom_add_acq_rel(&pl.cnt[u], 1) == rr.z - 1;
      bar_sync(1, 32 * ICW);
      if (s_last) {
        for (int r = tid >> 4; r < RQ; r += 8) {
          const int ra = qg * RQ + r;
          if (ra >= R) continue;
          float M = -INFINITY, L = 0.f, acc[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = 0.f;
          for (int z0 = 0; z0 < rr.z; z0 += I8_MERGE_BATCH) {
            float2 ml[I8_MERGE_BATCH];
            float4 ov[I8_MERGE_BATCH][2];
#pragma unroll
            for (int j = 0; j < I8_MERGE_BATCH; ++j) {
              const long long pr = ((long long)(rr.w + min(z0 + j, rr.z - 1)) * KV + kh) * RQ + r;
              ml[j] = __ldcg(reinterpret_cast<const float2*>(ml_part) + pr);
              ov[j][0] = __ldcg(reinterpret_cast<const float4*>(o_part + pr * HD + 8 * seg));
              ov[j][1] = __ldcg(reinterpret_cast<const float4*>(o_part + pr * HD + 8 * seg) + 1);
            }
#pragma unroll
            for (int j = 0; j < I8_MERGE_BATCH; ++j) {
              if (z0 + j >= rr.z || ml[j].x == -INFINITY) continue;   // no key of it there
              const float mn = fmaxf(M, ml[j].x);
              const float a = fast_exp2(M - mn), wz = fast_exp2(ml[j].x - mn);   // M = -inf: 0
              M = mn;
              L = L * a + ml[j].y * wz;
              acc[0] = acc[0] * a + ov[j][0].x * wz;
              acc[1] = acc[1] * a + ov[j][0].y * wz;
              acc[2] = acc[2] * a + ov[j][0].z * wz;
              acc[3] = acc[3] * a + ov[j][0].w * wz;
              acc[4] = acc[4] * a + ov[j][1].x * wz;
              acc[5] = acc[5] * a + ov[j][1].y * wz;
              acc[6] = acc[6] * a + ov[j][1].z * wz;
              acc[7] = acc[7] * a + ov[j][1].w * wz;
            }
          }
          const float inv = 1.f / fmaxf(L, 1e-30f);
          *reinterpret_cast<uint4*>(out + (((long long)b * T + ra / G) * H + kh * G + ra % G) *
                                              HD + 8 * seg) =
              make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv),
                         pack_bf16(acc[2] * inv, acc[3] * inv),
                         pack_bf16(acc[4] * inv, acc[5] * inv),
                         pack_bf16(acc[6] * inv, acc[7] * inv));
        }
      }
    }
    bar_sync(1, 32 * ICW);   // the merge buffers are free again
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

// LTH threads, one block an SM. Block (bt, hb, z) holds query heads hb*64
// .. hb*64 + 63 of query row bt, of table row b = bt / T, which all see keys
//   j < limit = min(seq_len[b] (>= 1 if min_one), qpos[bt*qpos_stride] + 1
//               (qpos not null), max_keys),
// and walks keys [z*chunk, (z+1)*chunk) of them in 64-key tiles. Decode (T =
// 1): grid (B, H / LHB, splits), block (b, hb, z). Prefill mode (prefill):
// a 1-D grid over the B*T*(H/LHB)*splits items in the order the hardware
// hands blocks out, z fastest, then hb, then the query row: the k-th row of
// that order is position T-1 - k%T of table row rowof[k/T] (rowof null: row
// k/T), so each row's positions run from the last, the longest, down, and
// the rows go in the plan's order (latent_prefill_plan: longest row first).
// A query at a padding position (qpos < 0) sees no key and writes zeros. Key j is
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
                 int ps, int box_rows, float scale_log2, int splits, int chunk,
                 float* __restrict__ o_part, float* __restrict__ ml_part, int T, int prefill,
                 const int* __restrict__ rowof) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                                 // LCH boxes of 64 heads
  unsigned char* ks = qs + LTILE;                           // [LSTAGES] key tiles
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(ks + LSTAGES * LTILE);   // [16][128]
  float* abuf = reinterpret_cast<float*>(pbuf + LBOX / 4);               // [2][128]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(abuf + 256);
  uint64_t* k_full = q_full + 1;
  uint64_t* empty = k_full + LSTAGES;

  int bt = blockIdx.x, hb = blockIdx.y, z = blockIdx.z;
  if (prefill) {
    const int HB = H / LHB, k = blockIdx.x / (splits * HB), r = k / T;
    z = blockIdx.x % splits;
    hb = blockIdx.x / splits % HB;
    bt = (rowof ? rowof[r] : r) * T + (T - 1 - k % T);
  }
  const int b = bt / T, h0 = hb * LHB;
  const int tid = threadIdx.x;
  long long lim = seq_len[b];
  if (min_one) lim = lim > 1 ? lim : 1;
  if (qpos) {
    const long long v = qpos[(long long)bt * qpos_stride] + 1;
    lim = lim < v ? lim : v;
  }
  lim = lim < max_keys ? lim : max_keys;
  const int nkeys = lim > 0 ? (int)lim : 0;
  const int k0 = z * chunk;
  const int k1 = min(k0 + chunk, nkeys);
  const int ntiles = k1 > k0 ? (k1 - k0 + LBK - 1) / LBK : 0;
  const long long prow = ((long long)bt * splits + z) * H + h0;   // the block's partial rows
  if (ntiles == 0) {   // no key here: an empty partial for the merge, or (unsplit) zeros
    if (splits > 1) {
      for (int r = tid; r < LHB; r += LTH) {
        ml_part[2 * (prow + r)] = -INFINITY;
        ml_part[2 * (prow + r) + 1] = 0.f;
      }
    } else {
      for (int i = tid; i < LHB * LDV / 2; i += LTH)
        reinterpret_cast<__nv_bfloat162*>(out + ((long long)bt * H + h0) * LDV)[i] =
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
        tma_load_2d(qs + c * LBOX, &tq, q_full, c * SWZ, bt * H + h0);
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
        bf16* orow = out + ((long long)bt * H + h0 + r) * LDV + col0;
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

// K3's prefill mode, the plan: rowof[r] = the table row of rank r, rows by
// their longest query's key limit (min(qpos + 1, seq_len, S), 0 for a
// padding query), the longest first, ties by row index. One block: each
// thread takes queries in turn (a row's largest limit by a shared-memory
// atomic), then one thread a row counts the rows ahead of it. Only what a
// captured prefill replays is read: positions and seq_len on the card.
constexpr int LPLAN_TH = 1024;     // threads of the plan kernel
constexpr int LPLAN_ROWS = 4096;   // table rows the plan takes (shared memory)
__global__ void __launch_bounds__(LPLAN_TH)
latent_prefill_plan(const long long* __restrict__ qpos, const long long* __restrict__ seq_len,
                    int B, int T, int S, int* __restrict__ rowof) {
  __shared__ int rmax[LPLAN_ROWS];
  const int tid = threadIdx.x;
  for (int b = tid; b < B; b += LPLAN_TH) rmax[b] = 0;
  __syncthreads();
  for (long long i = tid; i < (long long)B * T; i += LPLAN_TH) {
    const int b = (int)(i / T);
    long long l = qpos[i] + 1;
    l = l < seq_len[b] ? l : seq_len[b];
    l = l < S ? l : S;
    if (l > 0) atomicMax(&rmax[b], (int)l);
  }
  __syncthreads();
  for (int b = tid; b < B; b += LPLAN_TH) {
    const int m = rmax[b];
    int rank = 0;
    for (int c = 0; c < B; ++c) rank += rmax[c] > m || (rmax[c] == m && c < b);
    rowof[rank] = b;
  }
}

// decode (T = 1, prefill 0): grid (B, H / LHB, splits); prefill: the plan
// (rowof not null: more than one table row), then a 1-D grid of
// B*T*(H/LHB)*splits items; with splits > 1 decode_merge<LDV> over the B*T
// query rows
template <bool F32P>
int launch_latent(const CUtensorMap& tq, const CUtensorMap& tk, const void* table, int P,
                  long long row_offset, const void* seq_len, const void* qpos, int qpos_stride,
                  int min_one, int max_keys, void* out, int B, int T, int prefill, void* rowof,
                  int H, int ps, int box_rows, float scale, int splits, int chunk, void* o_part,
                  void* ml_part, cudaStream_t st) {
  constexpr int bytes = latent_smem_bytes();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(latent_attention<F32P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  if (prefill && rowof)
    latent_prefill_plan<<<1, LPLAN_TH, 0, st>>>(static_cast<const long long*>(qpos),
                                                 static_cast<const long long*>(seq_len), B, T,
                                                 max_keys, static_cast<int*>(rowof));
  const dim3 grid = prefill ? dim3((unsigned)((long long)B * T * (H / LHB) * splits))
                            : dim3(B, H / LHB, splits);
  latent_attention<F32P><<<grid, LTH, bytes, st>>>(
      tq, tk, static_cast<const long long*>(table), P, row_offset,
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos), qpos_stride,
      min_one, max_keys, static_cast<bf16*>(out), H, ps, box_rows, scale * LOG2E, splits, chunk,
      static_cast<float*>(o_part), static_cast<float*>(ml_part), T, prefill,
      static_cast<const int*>(rowof));
  if (splits > 1) {
    decode_merge<LDV><<<dim3(H, 1, B * T), LDV, 0, st>>>(
        static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
        static_cast<bf16*>(out), 1, H, 1, splits);
  }
  return (int)cudaGetLastError();
}

// K2's q map: q [B,T,H,128] as (D, H, T, B); a box of (64 columns, G
// heads, floor(FBM/G) positions, one batch row) is half of a tile's folded
// rows t*G + g
bool flash_q_map(CUtensorMap* tq, const void* q, int B, int T, int H, int G) {
  const cuuint64_t qdim[4] = {HD, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t qstride[3] = {HD * 2, (cuuint64_t)H * HD * 2, (cuuint64_t)T * H * HD * 2};
  const cuuint32_t qbox[4] = {SWZ, (cuuint32_t)G, (cuuint32_t)(FBM / G), 1};
  return bf16_map(tq, q, 4, qdim, qstride, qbox);
}

// a launch that may begin (early: allowed and PDL) while the kernel
// before it on the stream still runs (programmatic dependent launch; the
// kernel waits, grid_dep_wait, before it reads what that one wrote); graph
// capture keeps the edge
constexpr int PDL = 1;
template <typename... Params, typename... Args>
cudaError_t launch_after(bool early, void (*kernel)(Params...), int grid, int block, int smem,
                         cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = early && PDL;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <bool PAGED>
int launch_flash(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                 void* out, int B, int T, int S, int H, int KV, float scale, const void* table,
                 int P, int ps, int box_rows, const void* qpos, const void* seq_len, void* ws,
                 void* o_part, void* ml_part, int grid, cudaStream_t st) {
  constexpr int bytes = flash_smem_bytes();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(flash_attention<PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  // PAGED: early, under the plan, which its producer warpgroup waits for
  launch_after(PAGED, flash_attention<PAGED>, grid, FTH, bytes, st, tq, tk, tv,
               static_cast<bf16*>(out), B, T, S, H, KV, scale * LOG2E,
               static_cast<const long long*>(table), P, ps, box_rows,
               static_cast<const long long*>(qpos), static_cast<const long long*>(seq_len),
               static_cast<int*>(ws), static_cast<float*>(o_part), static_cast<float*>(ml_part));
  return (int)cudaGetLastError();
}

// K1's int8 mode: the plan (one block), then the persistent grid of
// sms * i8_blocks_per_sm blocks, early under the plan (its producer waits)
template <int NQ>
int launch_decode_i8(const CUtensorMap& tk, const CUtensorMap& tv, const void* q,
                     long long q_bstride, const void* ks, const void* vs, const void* table,
                     int P, int ps, int box_rows, const void* seq_len, const void* qpos,
                     int qpos_stride, int min_one, int max_keys, void* out, int B, int T, int H,
                     int KV, float scale, void* ws, void* o_part, void* ml_part, int sms,
                     cudaStream_t st) {
  constexpr int bytes = i8_smem_bytes<NQ>();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(decode_i8<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attr_set = true;
  }
  const int nblocks = sms * i8_blocks_per_sm<NQ>();
  decode_i8_plan<<<1, IPLAN_TH, 0, st>>>(
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos), qpos_stride,
      min_one, max_keys, B, T, H / KV, KV, 8 * NQ, nblocks, static_cast<int*>(ws));
  launch_after(true, decode_i8<NQ>, nblocks, ITH, bytes, st, tk, tv, static_cast<const bf16*>(q),
               q_bstride, static_cast<const float*>(ks), static_cast<const float*>(vs),
               static_cast<const long long*>(table), P, ps, box_rows,
               static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos),
               qpos_stride, min_one, max_keys, static_cast<bf16*>(out), B, T, H, KV,
               scale * LOG2E, static_cast<int*>(ws), static_cast<float*>(o_part),
               static_cast<float*>(ml_part));
  return (int)cudaGetLastError();
}

// blocks of `kernel` an SM holds (occupancy query)
template <typename Kernel>
void occupancy(int* out, Kernel kernel, int threads, int bytes) {
  // the opt-in above 48 KB first: without it a block of this size fits nowhere
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, bytes);
}

}  // namespace

extern "C" {

// K1's int8 mode (B6 over int8 pages: the int8 branch of JAX's
// paged_attention). q [B,T,H,128] bf16 with batch stride q_bstride (the
// other dimensions contiguous); k, v pools [R,ps,KV,128] int8 with ks, vs
// [R,ps,KV] float32, one scale a (slot, kv head), all contiguous; table
// [B,P] int64 (pool pages); seq_len [B] int64; qpos int64 with stride
// qpos_stride or null. Query t of row b sees keys j < min(seq_len (>= 1 if
// min_one), qpos[b*qpos_stride] + t + 1, max_keys, P*ps). T*H/KV <= 64;
// with P > 1, ps a multiple of 8 (boxes of the largest of 64, 32, 16, 8
// keys that divides it); one page a row takes any ps. ws, o_part, ml_part:
// int32 / float32 scratch of the sizes ops/paged_attention.py i8_plan_sizes
// gives for the SM count sms (static shapes only). Launches the plan, then
// the persistent grid. The TMA tensor maps are encoded here on each call
// and passed by value.
int dstts_decode_i8(const void* q, long long q_bstride, const void* k, const void* v,
                    const void* ks, const void* vs, const void* table, int P, long long R,
                    const void* seq_len, const void* qpos, int qpos_stride, int min_one,
                    int max_keys, void* out, int B, int T, int H, int KV, int ps, float scale,
                    void* ws, void* o_part, void* ml_part, int sms, void* stream) {
  int box_rows = IBK;
  while (P > 1 && box_rows >= 8 && ps % box_rows) box_rows /= 2;
  const int rows = KV > 0 && H % KV == 0 ? T * (H / KV) : 0;
  if (B < 1 || T < 1 || rows < 1 || rows > DROWS || !table || P < 1 || box_rows < 8 || sms < 1 ||
      !ws || !o_part || !ml_part || !ks || !vs || R * ps > INT32_MAX ||
      (long long)P * ps > INT32_MAX || (long long)B * P > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  // the pools as (KV*128 bytes, R*ps rows): kv head kh's keys are bytes kh*128 ..
  if (!u8_map(&tk, k, (cuuint64_t)KV * HD, (cuuint64_t)(R * ps), box_rows) ||
      !u8_map(&tv, v, (cuuint64_t)KV * HD, (cuuint64_t)(R * ps), box_rows))
    return (int)cudaErrorInvalidValue;
  max_keys = max_keys < P * ps ? max_keys : P * ps;
  return (rows <= 8 ? &launch_decode_i8<1> : &launch_decode_i8<2>)(
      tk, tv, q, q_bstride, ks, vs, table, P, ps, box_rows, seq_len, qpos, qpos_stride, min_one,
      max_keys, out, B, T, H, KV, scale, ws, o_part, ml_part, sms,
      static_cast<cudaStream_t>(stream));
}

// K1's int8 mode's plan alone (decode_i8_plan), as dstts_decode_i8 launches
// it, into ws.
int dstts_decode_i8_plan(const void* seq_len, const void* qpos, int qpos_stride, int min_one,
                         int max_keys, int B, int T, int H, int KV, int sms, void* ws,
                         void* stream) {
  const int rows = KV > 0 && H % KV == 0 ? T * (H / KV) : 0;
  if (B < 1 || T < 1 || rows < 1 || rows > DROWS || sms < 1 || !ws)
    return (int)cudaErrorInvalidValue;
  const int NQ = rows <= 8 ? 1 : 2;
  decode_i8_plan<<<1, IPLAN_TH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos), qpos_stride,
      min_one, max_keys, B, T, H / KV, KV, 8 * NQ,
      sms * (NQ == 1 ? i8_blocks_per_sm<1>() : i8_blocks_per_sm<2>()), static_cast<int*>(ws));
  return (int)cudaGetLastError();
}

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
  if (R > DROWS || splits < 1 || chunk % DBK) return (int)cudaErrorInvalidValue;
  // m-tiles of 16 rows: the smallest instance that covers the block's R rows
  return (R <= 16 ? &launch_decode<1> : R <= 32 ? &launch_decode<2> : &launch_decode<4>)(
      q, q_bstride, k, v, table, P, row_offset, seq_len, qpos, qpos_stride, min_one, max_keys,
      out, B, T, H, KV, ps, scale, p_bf16, splits, chunk, o_part, ml_part, st);
}

// K3 (B1's shared variant and B6 at MLA's latent width) and its prefill
// mode. q [B,T,H,576] bf16 contiguous (decode: T = 1); pool [R,ps,1,576]
// bf16 contiguous; table [B,P] int64 or null (identity: page row_offset +
// b); seq_len [B] int64; qpos int64 with stride qpos_stride (decode) or
// null, [B,T] contiguous (prefill: qpos_stride 1); out [B,T,H,512] bf16 (the
// value columns only). H % 64 == 0; with a table, ps % 64 == 0 or ps a
// multiple of 8 dividing 64. p_bf16: p rounded to bf16 for PV (B1, the
// prefill mode), else float32 p (B6). The context is cut into `splits`
// chunks of `chunk` keys (a multiple of 64), one block each; with splits >
// 1, o_part [B*T,splits,H,512] and ml_part [B*T,splits,H,2] are float32
// scratch that decode_merge<512> reduces. prefill: rowof is int32 [B]
// scratch for the plan (needed where B > 1). The TMA tensor maps are
// encoded here on each call (passed by value).
int dstts_latent_attention(const void* q, const void* pool, const void* table, int P,
                           long long row_offset, const void* seq_len, const void* qpos,
                           int qpos_stride, int min_one, int max_keys, void* out, int B, int T,
                           int prefill, void* rowof, int H, long long R, int ps, float scale,
                           int p_bf16, int splits, int chunk, void* o_part, void* ml_part,
                           void* stream) {
  const int box_rows = !table || ps % LBK == 0 ? LBK : (LBK % ps == 0 && ps % 8 == 0 ? ps : 0);
  if (H % LHB || splits < 1 || chunk % LBK || box_rows == 0 || T < 1 || (!prefill && T != 1) ||
      (prefill && (!qpos || (B > 1 && !rowof) || B > LPLAN_ROWS)) ||
      (splits > 1 && (long long)B * T > 65535) || (long long)B * T * H > INT32_MAX ||
      (long long)B * T * (H / LHB) * splits > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk;
  const cuuint64_t qdim[2] = {LDK, (cuuint64_t)B * T * H}, kdim[2] = {LDK, (cuuint64_t)R * ps};
  const cuuint64_t stride[1] = {LDK * 2};
  const cuuint32_t qbox[2] = {SWZ, LHB}, kbox[2] = {SWZ, (cuuint32_t)box_rows};
  if (!bf16_map(&tq, q, 2, qdim, stride, qbox) || !bf16_map(&tk, pool, 2, kdim, stride, kbox))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (p_bf16 ? &launch_latent<false> : &launch_latent<true>)(
      tq, tk, table, P, row_offset, seq_len, qpos, qpos_stride, min_one, max_keys, out, B, T,
      prefill, B > 1 ? rowof : nullptr, H, ps, box_rows, scale, splits, chunk, o_part, ml_part,
      st);
}

// K2 (B2). q, out [B,T,H,128]; k, v [B,S,KV,128]; all bf16, contiguous,
// 16-byte aligned. H / KV <= 128. counter: one int32 of scratch, zeroed
// here (a memset on the stream) before the persistent grid of
// min(items, sms) blocks takes items from it. The TMA tensor maps are
// encoded here on each call and passed by value (__grid_constant__), so a
// captured CUDA graph replays them with the same tensors.
int dstts_flash_attention(const void* q, const void* k, const void* v, void* out,
                          int B, int T, int S, int H, int KV, float scale, void* counter,
                          int sms, void* stream) {
  if (KV < 1 || H % KV || H / KV > FBM || T < 1 || S < 1 || sms < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  // k, v as (KV*D, S, B): kv head kh's keys are columns kh*D .. kh*D + 127;
  // a tile past S reads zeros in every batch row, not the next row's keys
  const cuuint64_t kdim[3] = {(cuuint64_t)KV * HD, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t kstride[2] = {(cuuint64_t)KV * HD * 2, (cuuint64_t)S * KV * HD * 2};
  const cuuint32_t kbox[3] = {SWZ, FBN, 1};
  if (!flash_q_map(&tq, q, B, T, H, H / KV) || !bf16_map(&tk, k, 3, kdim, kstride, kbox) ||
      !bf16_map(&tv, v, 3, kdim, kstride, kbox))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int TQ = FBM / (H / KV), items = B * KV * ((T + TQ - 1) / TQ);
  cudaMemsetAsync(counter, 0, sizeof(int), st);
  return launch_flash<false>(tq, tk, tv, out, B, T, S, H, KV, scale, nullptr, 0, 0, 0, nullptr,
                             nullptr, counter, nullptr, nullptr, items < sms ? items : sms, st);
}

// K2's paged mode's plan alone (flash_paged_plan): qpos [B,T] int64
// contiguous, seq_len [B] int64; ws int32 of the size
// ops/flash_attention.py paged_plan_sizes gives; split: may cut the units
// longer than an SM's mean load into pieces (fewer than 2 * PIECES_PER_SM *
// sms of them).
int dstts_flash_paged_plan(const void* qpos, const void* seq_len, int B, int T, int S, int G,
                           int KV, int sms, int split, void* ws, void* stream) {
  if (G < 1 || G > FBM || T < 1 || KV < 1 || S < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(flash_paged_plan, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         PLAN_SMEM_UNITS * 4);
    attr_set = true;
  }
  const int U = B * ((T + FBM / G - 1) / (FBM / G));
  flash_paged_plan<<<1, PLAN_TH, U <= PLAN_SMEM_UNITS ? U * 4 : 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(qpos), static_cast<const long long*>(seq_len), B, T, S,
      FBM / G, KV, sms, split, static_cast<int*>(ws));
  return (int)cudaGetLastError();
}

// K2's paged mode (JAX's prefix_chunk_attention after the chunk's write).
// q, out [B,T,H,128] bf16 contiguous; k, v pools [R,ps,KV,128] bf16
// contiguous; table [B,P] int64 (pool pages, the layer offset applied);
// seq_len [B] int64; qpos [B,T] int64 contiguous, qpos[b,0] the chunk's
// start. With P > 1 pages a row, ps a multiple of 8 (boxes of the largest of
// 64, 32, 16 and 8 keys that divides ps); one page a row (a slot row) takes
// any ps. H / KV <= 128. ws: the plan's int32 workspace; with split,
// o_part [slots*128, 128] and ml_part [slots*128, 2] float32 take the
// pieces' partials (slots = 2 * PIECES_PER_SM * sms) and
// dstts_flash_paged_merge must follow. Launches the plan, then the
// persistent grid of sms blocks. The TMA tensor maps are encoded here on
// each call and passed by value.
int dstts_flash_attention_paged(const void* q, const void* k, const void* v, const void* table,
                                int P, const void* seq_len, const void* qpos, void* out, int B,
                                int T, int H, int KV, long long R, int ps, float scale, void* ws,
                                void* o_part, void* ml_part, int sms, int split, void* stream) {
  int box_rows = FBN_PAGE;
  while (P > 1 && box_rows >= 8 && ps % box_rows) box_rows /= 2;
  if (KV < 1 || H % KV || H / KV > FBM || T < 1 || P < 1 || box_rows < 8 || sms < 1 ||
      (long long)P * ps > INT32_MAX || R * ps > INT32_MAX || (split && (!o_part || !ml_part)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  // the pools as (KV*D, R*ps): kv head kh's keys are columns kh*D .. kh*D + 127
  const cuuint64_t kdim[2] = {(cuuint64_t)KV * HD, (cuuint64_t)R * ps};
  const cuuint64_t kstride[1] = {(cuuint64_t)KV * HD * 2};
  const cuuint32_t kbox[2] = {SWZ, (cuuint32_t)box_rows};
  if (!flash_q_map(&tq, q, B, T, H, H / KV) || !bf16_map(&tk, k, 2, kdim, kstride, kbox) ||
      !bf16_map(&tv, v, 2, kdim, kstride, kbox))
    return (int)cudaErrorInvalidValue;
  const int err = dstts_flash_paged_plan(qpos, seq_len, B, T, P * ps, H / KV, KV, sms, split, ws,
                                         stream);
  if (err) return err;
  return launch_flash<true>(tq, tk, tv, out, B, T, P * ps, H, KV, scale, table, P, ps, box_rows,
                            qpos, seq_len, ws, o_part, ml_part, sms,
                            static_cast<cudaStream_t>(stream));
}

// K2's int8 paged mode, the widening (widen_kv_pages): k, v [R,ps,KV,128]
// int8 with ksc, vsc [R,ps,KV] float32; table [B,P] int64 (pool pages);
// seq_len [B] int64; kw, vw [B*P,ps,KV,128] bf16 scratch; wtable [B,P]
// int64. dstts_flash_attention_paged over kw, vw and wtable follows.
int dstts_widen_kv_pages(const void* k, const void* v, const void* ksc, const void* vsc,
                         const void* table, const void* seq_len, int B, int P, int ps, int KV,
                         void* kw, void* vw, void* wtable, void* stream) {
  const long long pieces = (long long)ps * KV * (HD / 16);   // a page's K (or V) in 16 B
  const long long gy = (pieces + WIDEN_TH - 1) / WIDEN_TH;
  if (B < 1 || P < 1 || ps < 1 || KV < 1 || (long long)B * P > INT32_MAX || gy > 65535)
    return (int)cudaErrorInvalidValue;
  widen_kv_pages<<<dim3(B * P, (unsigned)gy), WIDEN_TH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
      static_cast<const float*>(ksc), static_cast<const float*>(vsc),
      static_cast<const long long*>(table), static_cast<const long long*>(seq_len), P, ps, KV,
      static_cast<bf16*>(kw), static_cast<bf16*>(vw), static_cast<long long*>(wtable));
  return (int)cudaGetLastError();
}

// The merge of K2's paged mode: out's rows of the split units that the
// plan in ws lists, from o_part / ml_part (dstts_flash_attention_paged's,
// same shapes); a persistent grid of 4 * sms blocks.
int dstts_flash_paged_merge(const void* o_part, const void* ml_part, void* ws, void* out, int B,
                            int T, int H, int KV, int sms, void* stream) {
  if (KV < 1 || H % KV || H / KV > FBM || T < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  launch_after(true, flash_paged_merge, 4 * sms, MERGE_TH, 0, static_cast<cudaStream_t>(stream),
               static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
               static_cast<int*>(ws), static_cast<bf16*>(out), B, T, H, KV);
  return (int)cudaGetLastError();
}

// Blocks an SM can hold, as the runtime computes them from each kernel's
// registers, threads and shared memory: out[0..8] = K1 (1, 2 and 4
// m-tiles), K2, K3 (bf16 p, float32 p), K2's paged mode, K1's int8 mode (8
// and 16 query rows an item).
int dstts_attention_occupancy(int* out) {
  occupancy(&out[0], decode_attention<1>, NTH, decode_smem_bytes());
  occupancy(&out[1], decode_attention<2>, NTH, decode_smem_bytes());
  occupancy(&out[2], decode_attention<4>, NTH, decode_smem_bytes());
  occupancy(&out[3], flash_attention<false>, FTH, flash_smem_bytes());
  occupancy(&out[4], latent_attention<false>, LTH, latent_smem_bytes());
  occupancy(&out[5], latent_attention<true>, LTH, latent_smem_bytes());
  occupancy(&out[6], flash_attention<true>, FTH, flash_smem_bytes());
  occupancy(&out[7], decode_i8<1>, ITH, i8_smem_bytes<1>());
  occupancy(&out[8], decode_i8<2>, ITH, i8_smem_bytes<2>());
  return (int)cudaGetLastError();
}

}  // extern "C"
