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
// * K1 is bound by KV bytes: every key and value of a row's context is read
//   once per layer (2*ctx*K*D*2 B: 8.4 MB a row at ctx 2048 and qwen3-8b,
//   134 MB a layer at B=16), against ~4 FLOP per byte. One block per
//   (row, kv head) walks the row's pages up to that row's own limit only —
//   the TPU kernels' per-row-block clamping and the clamp kernel's elided
//   reads come free, since a block never reads past its row. 64-key tiles of
//   K and V are staged in shared memory by a 3-stage cp.async ring (two
//   tiles in flight per block). Products run on the CUDA cores in float32:
//   at G = H/K = 4 query rows per block the tensor cores would idle on
//   padding. Only B*K blocks exist (128 at B=16, 8 at B=1): too few at small
//   batch to keep the card's memory system busy — a split over the context
//   (a second reduction pass) is the next step.
// * K2 is bound by tensor-core FLOPs: ~2*T^2*H*D for causal attention (75
//   GFLOP a layer at T=3030, qwen3-8b). One block per (64-row query tile,
//   kv head, batch row), the G query heads of the kv head folded into the
//   tile's rows (row = t*G + g) so each K/V tile is read once per group;
//   key tiles past the tile's last query position are never loaded (the
//   causal skip). QK^T and PV run on mma.sync m16n8k16 bf16 -> float32
//   from ldmatrix fragments, the online softmax lives in registers, K/V tiles
//   are double-buffered with cp.async. Blocks start from the longest tiles.
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
// Numerics. Scores are float32 and the scale D^-1/2 is applied to them: the
// TPU kernels scale q in float32 first (K1 does the same; K2 scales the
// float32 product), which agrees within bf16 tolerance. p is rounded to bf16
// before PV in K2 (mma operand) and, when p_bf16 is set, in K1 — the B1
// round point (slot_attention.py:98); the B6 kernels keep p in float32
// (paged_attention.py:106), and so does K1 with p_bf16 = 0. B9 rounds p
// like B1 (slot_attention.py:178). The softmax sum
// always uses the unrounded p. Masked keys get p = 0 exactly; keys past the
// sequence are loaded as zeros (flash_attention.py:58-61 zeroes such v rows).
//
// Interface: plain C, raw pointers, launched on the caller's stream; no
// allocation; each entry returns the cudaGetLastError() code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 128;        // head_dim both kernels are written for
constexpr int ROW = HD + 8;    // padded shared-memory row (272 B: conflict-free)
constexpr int NTH = 128;       // threads per block (4 warps)

// K1
constexpr int DBK = 64;        // keys per tile
constexpr int DSTAGES = 3;     // cp.async ring depth

// K2
constexpr int FBQ = 64;        // query rows per block (4 warps x 16)
constexpr int FBK = 64;        // keys per tile

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

template <int RPT>
constexpr int decode_smem_bytes() {
  return DSTAGES * 2 * DBK * ROW * (int)sizeof(bf16)       // K/V ring
         + 2 * RPT * HD * (int)sizeof(float)               // scaled q
         + 2 * RPT * DBK * (int)sizeof(float)              // scores / p
         + 3 * 2 * RPT * (int)sizeof(float);               // m, l, alpha
}

// grid (B, KV), NTH threads. Query rows of the block: r = t*G + g for the
// T tokens and the G = H/KV query heads of kv head blockIdx.y; at most
// MAXR = 2*RPT of them. Query t of row b sees keys
//   j < min(seq_len[b] (>= 1 if min_one), qpos[b*qpos_stride] + t + 1, max_keys)
// (qpos == nullptr: j < min(seq_len, max_keys) for every t). Key j of row b
// lies at page table[b*P + j/ps] (table == nullptr: row_offset + b), slot
// j % ps of the [R, ps, KV, HD] pools.
template <int RPT>
__global__ void __launch_bounds__(NTH)
decode_attention(const bf16* __restrict__ q, long long q_bstride,
                 const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const long long* __restrict__ table,
                 int P, long long row_offset, const long long* __restrict__ seq_len,
                 const long long* __restrict__ qpos, int qpos_stride, int min_one,
                 int max_keys, bf16* __restrict__ out, int T, int H, int KV, int ps,
                 float scale, int p_bf16) {
  constexpr int MAXR = 2 * RPT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kvs = reinterpret_cast<bf16*>(smem);                // [DSTAGES][2][DBK][ROW]
  float* qs = reinterpret_cast<float*>(kvs + DSTAGES * 2 * DBK * ROW);  // [MAXR][HD]
  float* ss = qs + MAXR * HD;                               // [MAXR][DBK]
  float* ms = ss + MAXR * DBK;
  float* ls = ms + MAXR;
  float* as = ls + MAXR;

  const int b = blockIdx.x, kh = blockIdx.y, tid = threadIdx.x;
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
  const int lim_blk = limit(T - 1);
  const int ntiles = (lim_blk + DBK - 1) / DBK;

  for (int i = tid; i < MAXR * HD; i += NTH) {
    const int r = i / HD, d = i % HD;
    float v = 0.f;
    if (r < R) {
      const int t = r / G, g = r % G;
      v = __bfloat162float(q[b * q_bstride + ((long long)t * H + kh * G + g) * HD + d]) *
          scale;
    }
    qs[i] = v;
  }
  if (tid < MAXR) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
    as[tid] = 1.f;
  }

  const long long kv_row = (long long)KV * HD;   // elements between slots
  auto load_tile = [&](int stage, int kt) {
    bf16* kd = kvs + stage * 2 * DBK * ROW;
    bf16* vd = kd + DBK * ROW;
    for (int i = tid; i < DBK * (HD / 8); i += NTH) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int j = kt * DBK + r;
      const bool ok = j < lim_blk;
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

  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  const int jj = tid % DBK, half = tid / DBK;   // QK roles: one key, every other row
  const int warp = tid >> 5, lane = tid & 31;
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();  // tile kt landed for every thread; tile kt-1 is consumed
    {
      const int nt = kt + DSTAGES - 1;
      if (nt < ntiles) load_tile(nt % DSTAGES, nt);
      cp_async_commit();
    }
    const bf16* kt_s = kvs + (kt % DSTAGES) * 2 * DBK * ROW;
    const bf16* vt_s = kt_s + DBK * ROW;

    // (1) scores of this thread's key against its rows
    float sc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(kt_s + jj * ROW + d);
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&u);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float* qr = qs + (half + 2 * i) * HD + d;
        const float4 a = *reinterpret_cast<const float4*>(qr);
        const float4 c = *reinterpret_cast<const float4*>(qr + 4);
        sc[i] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                 c.x * kf[4] + c.y * kf[5] + c.z * kf[6] + c.w * kf[7];
      }
    }
    const int key = kt * DBK + jj;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = half + 2 * i;
      float v = 0.f;                      // rows past R: p = 0, never stored
      if (r < R) v = key < limit(r / G) ? sc[i] : -INFINITY;
      ss[r * DBK + jj] = v;
    }
    __syncthreads();

    // (2) online softmax, one warp per row
    for (int r = warp; r < R; r += NTH / 32) {
      const float s0 = ss[r * DBK + lane], s1 = ss[r * DBK + lane + 32];
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = 0.f, p1 = 0.f, alpha = 1.f;
      if (m_new != -INFINITY) {
        p0 = s0 == -INFINITY ? 0.f : expf(s0 - m_new);
        p1 = s1 == -INFINITY ? 0.f : expf(s1 - m_new);
        alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
      }
      const float psum = warp_sum(p0 + p1);
      if (p_bf16) {
        p0 = __bfloat162float(__float2bfloat16(p0));
        p1 = __bfloat162float(__float2bfloat16(p1));
      }
      ss[r * DBK + lane] = p0;
      ss[r * DBK + lane + 32] = p1;
      if (lane == 0) {
        ls[r] = ls[r] * alpha + psum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();

    // (3) acc[r] = acc[r] * alpha[r] + p[r, :] . v[:, d], thread d = tid
#pragma unroll
    for (int r = 0; r < MAXR; ++r) acc[r] *= as[r];
#pragma unroll 2
    for (int j = 0; j < DBK; j += 4) {
      const float v0 = __bfloat162float(vt_s[(j + 0) * ROW + tid]);
      const float v1 = __bfloat162float(vt_s[(j + 1) * ROW + tid]);
      const float v2 = __bfloat162float(vt_s[(j + 2) * ROW + tid]);
      const float v3 = __bfloat162float(vt_s[(j + 3) * ROW + tid]);
#pragma unroll
      for (int r = 0; r < MAXR; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ss + r * DBK + j);
        acc[r] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // ls is initialised even when no tile ran

#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < R) {
      const int t = r / G, g = r % G;
      const float l = ls[r] > 1e-30f ? ls[r] : 1e-30f;
      out[(((long long)b * T + t) * H + kh * G + g) * HD + tid] =
          __float2bfloat16(acc[r] / l);
    }
  }
}

template <int RPT>
int launch_decode(const void* q, long long q_bstride, const void* k, const void* v,
                  const void* table, int P, long long row_offset, const void* seq_len,
                  const void* qpos, int qpos_stride, int min_one, int max_keys,
                  void* out, int B, int T, int H, int KV, int ps, float scale,
                  int p_bf16, cudaStream_t st) {
  constexpr int bytes = decode_smem_bytes<RPT>();
  static bool attr_set = false;  // the opt-in above 48 KB, once per process
  if (!attr_set) {
    cudaFuncSetAttribute(decode_attention<RPT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    attr_set = true;
  }
  decode_attention<RPT><<<dim3(B, KV), NTH, bytes, st>>>(
      static_cast<const bf16*>(q), q_bstride, static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const long long*>(table), P, row_offset,
      static_cast<const long long*>(seq_len), static_cast<const long long*>(qpos),
      qpos_stride, min_one, max_keys, static_cast<bf16*>(out), T, H, KV, ps, scale,
      p_bf16);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K2

constexpr int flash_smem_bytes() {
  return (FBQ + 4 * FBK) * ROW * (int)sizeof(bf16);   // q tile + 2 stages of K and V
}

// grid (ceil(T*G/FBQ), KV, B), NTH threads. Row rho = t*G + g of batch row b
// is query head kh*G + g at position t; it sees keys j <= t, j < S (the TPU
// kernel's top-left aligned mask, flash_attention.py:49).
__global__ void __launch_bounds__(NTH)
flash_attention(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int T, int S,
                int H, int KV, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);     // [FBQ][ROW]
  bf16* ks = qs + FBQ * ROW;                    // [2][FBK][ROW]
  bf16* vs = ks + 2 * FBK * ROW;                // [2][FBK][ROW]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest tiles first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / KV, R = T * G;
  const int rho0 = tile * FBQ;
  const int t_last = (min(rho0 + FBQ, R) - 1) / G;
  const int kend = min(S, t_last + 1);
  const int ntiles = (kend + FBK - 1) / FBK;
  const long long kv_row = (long long)KV * HD;
  const bf16* kb = k + ((long long)b * S * KV + kh) * HD;
  const bf16* vb = v + ((long long)b * S * KV + kh) * HD;

  for (int i = tid; i < FBQ * (HD / 8); i += NTH) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const int rho = rho0 + r;
    const bool ok = rho < R;
    const int t = ok ? rho / G : 0, g = ok ? rho % G : 0;
    cp_async16(qs + r * ROW + c, q + (((long long)b * T + t) * H + kh * G + g) * HD + c,
               ok ? 16 : 0);
  }
  auto load_kv = [&](int stage, int kt) {
    for (int i = tid; i < FBK * (HD / 8); i += NTH) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      const int j = kt * FBK + r;
      const bool ok = j < S;                  // rows past S load as zeros
      const long long off = (long long)(ok ? j : 0) * kv_row + c;
      cp_async16(ks + (stage * FBK + r) * ROW + c, kb + off, ok ? 16 : 0);
      cp_async16(vs + (stage * FBK + r) * ROW + c, vb + off, ok ? 16 : 0);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's two rows of the warp's 16: lr0 = lane/4 and lr0 + 8
  const int lr0 = warp * 16 + (lane >> 2);
  const int t0 = (rho0 + lr0) / G, t1 = (rho0 + lr0 + 8) / G;
  const int mi = lane >> 3, rr = lane & 7, c2 = (lane & 3) * 2;

  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) load_kv((kt + 1) & 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldmatrix_x4(qf[kk],
                    qs + (warp * 16 + rr + 8 * (mi & 1)) * ROW + kk * 16 + 8 * (mi >> 1));
    }
    const bf16* kst = ks + (kt & 1) * FBK * ROW;
    const bf16* vst = vs + (kt & 1) * FBK * ROW;

    // S = Q K^T: 8 n-blocks of 8 keys
    float s[FBK / 8][4];
#pragma unroll
    for (int n = 0; n < FBK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int h = 0; h < FBK / 16; ++h) {
        uint32_t r4[4];
        ldmatrix_x4(r4, kst + (h * 16 + 8 * (mi >> 1) + rr) * ROW + kk * 16 + 8 * (mi & 1));
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        mma_bf16(s[2 * h], qf[kk], b0);
        mma_bf16(s[2 * h + 1], qf[kk], b1);
      }
    }

    // scale, mask, online softmax (rows lr0: s[.][0..1], lr0 + 8: s[.][2..3])
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < FBK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kt * FBK + n * 8 + c2 + (i & 1);
        const int t = i < 2 ? t0 : t1;
        const float val = (key <= t && key < S) ? s[n][i] * scale : -INFINITY;
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
    const float al0 = mn0 == -INFINITY ? 1.f : (m0 == -INFINITY ? 0.f : expf(m0 - mn0));
    const float al1 = mn1 == -INFINITY ? 1.f : (m1 == -INFINITY ? 0.f : expf(m1 - mn1));
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < FBK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mn = i < 2 ? mn0 : mn1;
        const float p = s[n][i] == -INFINITY ? 0.f : expf(s[n][i] - mn);
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

    // O += P V: P from the score registers (bf16), V by ldmatrix.trans
#pragma unroll
    for (int j = 0; j < FBK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int h = 0; h < HD / 16; ++h) {
        uint32_t r4[4];
        ldmatrix_x4_trans(r4,
                          vst + (j * 16 + 8 * (mi & 1) + rr) * ROW + (2 * h + (mi >> 1)) * 8);
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        mma_bf16(o[2 * h], a, b0);
        mma_bf16(o[2 * h + 1], a, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rho = rho0 + lr0 + 8 * half;
    if (rho >= R) continue;
    const int t = rho / G, g = rho % G;
    bf16* orow = out + (((long long)b * T + t) * H + kh * G + g) * HD;
    const float inv = half ? inv1 : inv0;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + c2) =
          __floats2bfloat162_rn(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
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
// null. Query rows T*H/KV <= 64.
int dstts_decode_attention(const void* q, long long q_bstride, const void* k,
                           const void* v, const void* table, int P, long long row_offset,
                           const void* seq_len, const void* qpos, int qpos_stride,
                           int min_one, int max_keys, void* out, int B, int T, int H,
                           int KV, int ps, float scale, int p_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = T * (H / KV);
  // rows per QK thread: the smallest instance that covers the block's R rows
  using Launch = int (*)(const void*, long long, const void*, const void*,
                         const void*, int, long long, const void*, const void*, int,
                         int, int, void*, int, int, int, int, int, float, int,
                         cudaStream_t);
  if (R > 64) return (int)cudaErrorInvalidValue;
  const Launch launch =
      R <= 4 ? &launch_decode<2> : R <= 16 ? &launch_decode<8> : &launch_decode<32>;
  return launch(q, q_bstride, k, v, table, P, row_offset, seq_len, qpos, qpos_stride,
                min_one, max_keys, out, B, T, H, KV, ps, scale, p_bf16, st);
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

// K2 (B2). q, out [B,T,H,128]; k, v [B,S,KV,128]; all bf16.
int dstts_flash_attention(const void* q, const void* k, const void* v, void* out,
                          int B, int T, int S, int H, int KV, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int bytes = flash_smem_bytes();
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(flash_attention, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         bytes);
    attr_set = true;
  }
  const int tiles = (T * (H / KV) + FBQ - 1) / FBQ;
  flash_attention<<<dim3(tiles, KV, B), NTH, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, S, H, KV, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
