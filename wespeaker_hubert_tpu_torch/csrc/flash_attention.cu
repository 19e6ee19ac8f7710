// Flash-attention forward for Hopper (sm_90a), head dim 64:
//     out = softmax(q k^T * scale + bias, keys >= key_len masked) v
// per (batch, head), with q, k, v and out in the JAX layout (B, T, h, 64),
// read and written through their strides (no transposes).  The bias is
// either anything that broadcasts to (B, h, T, T), or WavLM's gated position
// bias in factored form: a (h, T, T) table and a (B, h, T) gate, the
// effective bias round_to_bias_dtype(gate[b, h, query] * table[h, query, key]),
// formed in the kernel (the product of two bf16 values is exact in float32,
// so this is the bias the encoder would have materialized).
//
// Replaces the TPU kernel that wespeaker_hubert_tpu/frontend/ssl_encoder.py
// :_flash_mha reaches: the upstream Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention (its forward,
// _flash_attention_impl).  There, padded keys are masked by an additive
// -1e9 in `ab` or by SegmentIds and T is padded to a multiple of 128; here a
// per-row key length masks them (the same softmax: exp(-1e9 - max) is 0 in
// float32) and key tiles at or past it are skipped.
//
// What bounds it.  WavLM-Large at 16 x 10 s (B = 16, T = 499, h = 16, bf16)
// does 4 B h T^2 64 = 16.3 GFLOP per launch, 0.0165 ms at 989 TFLOP/s of
// dense bf16, and must move q, k, v and out (65.4 MB), the (h, T, T) table
// (8.0 MB) and the gate (0.26 MB): 0.022 ms at 3.35 TB/s, a byte bound.  The
// materialized (B, h, T, T) gated bias it replaces was 127.5 MB more.
//
// bf16 design (flash_fwd_bf16_sm90).  One block per (64-query tile, head,
// batch row): one consumer warpgroup owns the 64 query rows, one producer
// warp keeps a 2-stage ring of K, V and bias tiles in flight.
//   - Q, K, V come in by TMA through rank-4 tensor maps of the (B, T, h, 64)
//     tensors (128B swizzle; rows past T arrive as zeros), the bias tile
//     (64 queries x BN keys of the table, or of a broadcast bias) by TMA too:
//     the table is read by every batch row and all 24 layers, so it stays in
//     L2.  Each stage completes on an mbarrier; the consumers release it on
//     another.
//   - S = Q K^T runs as wgmma m64nBNk16 from shared memory; the bias tile
//     is read from shared memory while it runs, gated by the row's gate (one
//     register per row) and rounded to bf16.  P stays in registers: the
//     accumulator layout is wgmma's A-register layout, so O += P V runs as
//     wgmma with P from registers and V as the transposed (MN-major) B.
//   - The online softmax is float32 in registers (log2 domain); the output
//     goes out through shared memory by a TMA store, which clips rows past T;
//     the row log-sum-exp (for csrc/flash_attention_bwd.cu) by plain stores.
//   - The key tile width BN is a compile-time choice; the wrapper picks it
//     per T (ops/flash_attention.py:key_tile) and passes it as `tile`: 80
//     when all keys fit one tile (T <= 80, the training shape T = 75), else
//     64 (128-byte bias rows, swizzled like the other tiles).
// f32 design (flash_fwd_f32_sm90): 3xTF32 on wgmma, for float32 accuracy
// with TF32 off (the JAX flash path does not round to TF32).  Whisper-large-v2
// at (16, 1500, 20) does 1.84e11 FLOP: 2.75 ms on the CUDA cores' 67 TFLOP/s,
// 1.12 ms as three tf32 products at 495 TFLOP/s, against 0.15 ms of bytes,
// so the operations bound it; the earlier design (one thread per query row,
// FP32 FMA) ran at 0.26 of the CUDA-core bound and at half SDPA's speed.
// Every operand x is split into tf32 hi + lo (flash_sm90.cuh) and each
// product is the three wgmma passes lo x hi, hi x lo, hi x hi.
//   - One block per (128-query tile, head, batch row): two consumer
//     warpgroups of 64 rows each, one producer warp keeping a 2-stage TMA
//     ring of raw float32 K and V tiles (64 keys; each tile two boxes of 32
//     columns, 128B-swizzled).  Q is loaded once and split in place (hi)
//     and into a lo tile.
//   - The split pass: both warpgroups turn the stage's raw K into hi / lo
//     tiles of the same layout and raw V into hi / lo tiles of V^T (64 rows
//     of d x 64 keys), since wgmma takes tf32 B operands K-major only; the
//     keys of each 8-key step are permuted (perm8) so that P goes from the
//     scores' accumulator to wgmma's A registers as it lies.  The stage is
//     released, and one barrier of the 256 consumers precedes the products.
//   - S = Q K^T runs as 3 x 8 wgmma m64n64k8 from shared memory; the online
//     softmax is float32 in registers (log2 domain); P is split in
//     registers and O += P V runs as 3 x 8 wgmma with P from registers.  A
//     second barrier keeps the split tiles until both warpgroups' products
//     are done.
//   - The bias (anything broadcasting to (B, h, T, T), or the factored table
//     and gate, whose product is taken in float32) is read with plain loads
//     through its strides: it is off Whisper's path, and an f32 bias row of
//     odd T is no 16-byte stride for TMA, so nothing is padded or copied.
//   - Keys at or past key_len are masked, tiles past it are not loaded; rows
//     and keys past T arrive as zeros and rows past T are not written.  The
//     output and lse leave by plain stores (float2 per thread and row).
// Shared memory: Q hi / lo 64 KB, the raw ring 64 KB, K and V^T hi / lo
// 64 KB: 192 KB, one block per SM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int HD = 64;       // head dim, the kernels' only one
constexpr int BM = 64;       // query rows per block (bf16), per warpgroup (f32)

// ------------------------------------------------------------------- bf16
struct FwdParams {
  CUtensorMap tq, tk, tv, to, tbias;
  const __nv_bfloat16* gate;  // null: the bias is used as it is
  long long gate_sb, gate_sh, gate_st;
  const int* key_len;         // null: every key is valid
  float* lse;                 // null: not written; else (B, h, T)
  int T, H;
  int has_bias, bias_bcast_b, bias_bcast_h;
  float scale;
};

template <int BN>
struct FwdTile {
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * 128;
  static constexpr int KV_BYTES = BN * 128;
  static constexpr int BIAS_BYTES = BM * BN * 2;  // a multiple of 1024
  static constexpr int STAGE_BYTES = 2 * KV_BYTES + BIAS_BYTES;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int NACC = BN / 2;  // S accumulator registers per thread
};

template <int BN>
__global__ void __launch_bounds__(160) flash_fwd_bf16_sm90(const __grid_constant__ FwdParams p) {
  using C = FwdTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES], q_bar;
  uint8_t* const sq = align1024(smem_raw);
  uint8_t* const ring = sq + C::Q_BYTES;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int T = p.T;
  const int kv_len = p.key_len == nullptr ? T : min(max(p.key_len[b], 0), T);
  const int n_tiles = (kv_len + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(&q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp; one lane issues the copies
    if (threadIdx.x == 128) {
      prefetch_map(&p.tq);
      prefetch_map(&p.tk);
      prefetch_map(&p.tv);
      if (p.has_bias) prefetch_map(&p.tbias);
      mbar_arrive_expect_tx(&q_bar, C::Q_BYTES);
      tma_load_4d(sq, &p.tq, &q_bar, 0, h, q0, b);
      const int bb = p.bias_bcast_b ? 0 : b, bh = p.bias_bcast_h ? 0 : h;
      const uint32_t bytes = 2 * C::KV_BYTES + (p.has_bias ? C::BIAS_BYTES : 0);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        uint8_t* st = ring + s * C::STAGE_BYTES;
        mbar_wait(&empty_bar[s], ((i / C::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_bar[s], bytes);
        tma_load_4d(st, &p.tk, &full_bar[s], 0, h, i * BN, b);
        tma_load_4d(st + C::KV_BYTES, &p.tv, &full_bar[s], 0, h, i * BN, b);
        if (p.has_bias)
          tma_load_4d(st + 2 * C::KV_BYTES, &p.tbias, &full_bar[s], i * BN, q0, bh, bb);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows r0 and r0 + 8 of the tile per thread
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = warp * 16 + g;
  float gate[2] = {1.f, 1.f};
  if (p.gate != nullptr) {
    const __nv_bfloat16* gp = p.gate + b * p.gate_sb + h * p.gate_sh;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      gate[i] = __bfloat162float(gp[min(q0 + r0 + 8 * i, T - 1) * p.gate_st]);
  }
  const bool gated_bias = p.gate != nullptr;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  const float scale2 = p.scale * LOG2E;  // scores in the log2 domain
  const uint64_t qdesc = desc_k(sq);

  mbar_wait(&q_bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const uint8_t* st = ring + s * C::STAGE_BYTES;
    mbar_wait(&full_bar[s], (i / C::STAGES) & 1);

    // S = Q K^T (64 x BN), four k16 steps over the head dim
    float sacc[C::NACC];
#pragma unroll
    for (int j = 0; j < C::NACC; ++j) sacc[j] = 0.f;
    const uint64_t kdesc = desc_k(st);
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss<BN>(sacc, qdesc + ks * K_STEP, kdesc + ks * K_STEP, ks);
    wgmma_commit();
    // the bias of this thread's pairs, read while the product runs
    uint32_t bv[BN / 8][2];
    if (p.has_bias) {
      const uint8_t* sb = st + 2 * C::KV_BYTES;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
          bv[j][ii] = *reinterpret_cast<const uint32_t*>(sb + bias_off<BN>(r0 + 8 * ii, 8 * j + c2));
    }
    wgmma_wait0();
    fence_regs(sacc);

    // scale, bias and key mask; the tile's row max
    const int k0 = i * BN;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1;
        const int key = k0 + 8 * j + c2 + (e & 1);
        float x = -CUDART_INF_F;
        if (key < kv_len) {
          x = sacc[4 * j + e] * scale2;
          if (p.has_bias) {
            const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&bv[j][ii]);
            float bias = __bfloat162float((e & 1) ? pair.y : pair.x);
            if (gated_bias) bias = gated(gate[ii], bias);
            x = fmaf(bias, LOG2E, x);
          }
        }
        sacc[4 * j + e] = x;
        mx[ii] = fmaxf(mx[ii], x);
      }
    }
    // a row's columns are spread over the 4 lanes of its quad; key k0 is
    // valid, so the max is finite
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
      const float alpha = exp2f(m[ii] - mx[ii]);  // 0 on the first tile
      m[ii] = mx[ii];
      l[ii] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 2 * ii] *= alpha;
        o[4 * j + 2 * ii + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < C::NACC; ++j) {
      sacc[j] = exp2f(sacc[j] - m[(j >> 1) & 1]);
      l[(j >> 1) & 1] += sacc[j];  // this lane's part of the row sum
    }

    // O += P V: P from registers, V (BN keys x 64) as the MN-major B
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) acc_to_a(pa[ks], sacc, ks);
    const uint64_t vdesc = desc_mn(st + C::KV_BYTES);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) wgmma_rs_t64(o, pa[ks], vdesc + ks * MN_STEP);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty_bar[s]);
  }

  // the output tile through shared memory (Q's, no longer read) and a TMA store
#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 1);
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 2);
    const float inv = l[ii] > 0.f ? 1.f / l[ii] : 0.f;  // no valid key: 0
    const int r = r0 + 8 * ii, t = q0 + r;
    // m is in the log2 domain; one lane of the quad writes the row's value
    if (p.lse != nullptr && (lane & 3) == 0 && t < T)
      p.lse[((long long)b * p.H + h) * T + t] =
          l[ii] > 0.f ? (m[ii] + log2f(l[ii])) / LOG2E : -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(sq + swz128(r, 8 * j + c2)) =
          __floats2bfloat162_rn(o[4 * j + 2 * ii] * inv, o[4 * j + 2 * ii + 1] * inv);
  }
  fence_proxy_async();
  named_barrier(1, 128);
  if (tid == 0) {
    tma_store_4d(&p.to, sq, 0, h, q0, b);
    tma_store_commit_and_wait();
  }
}

// -------------------------------------------------------------------- f32
struct F32Params {
  CUtensorMap tq, tk, tv;
  const float* bias;    // null: no bias; else read through its strides
  const float* gate;    // null: the bias is used as it is
  const int* key_len;   // null: every key is valid
  float* out;
  float* lse;           // null: not written; else (B, h, T) row log-sum-exp
  long long o_sb, o_st, o_sh;
  // element strides of the bias over (B, h, query, key); 0 broadcasts
  long long bias_sb, bias_sh, bias_sq, bias_sk;
  long long gate_sb, gate_sh, gate_st;
  int T, H;
  float scale;
};

struct F32Tile {
  static constexpr int NWG = 2;               // consumer warpgroups, 64 rows each
  static constexpr int NT = 128 * NWG;        // consumer threads
  static constexpr int BMQ = BM * NWG;        // query rows per block
  static constexpr int BN = 64;               // keys per tile
  static constexpr int Q_BYTES = BMQ * HD * 4;  // Q hi or lo: two chunks of BMQ x 128 B
  static constexpr int KV_BYTES = BN * HD * 4;  // a K or V tile, raw or split: 16 KB
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // raw K, then raw V
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + 4 * KV_BYTES;
};

__global__ void __launch_bounds__(F32Tile::NT + 32, 1)
    flash_fwd_f32_sm90(const __grid_constant__ F32Params p) {
  using C = F32Tile;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::STAGES], empty_bar[C::STAGES], q_bar;
  uint8_t* const qhi = align1024(smem_raw);   // Q as loaded, then its hi part
  uint8_t* const qlo = qhi + C::Q_BYTES;
  uint8_t* const ring = qlo + C::Q_BYTES;
  uint8_t* const khi = ring + C::STAGES * C::STAGE_BYTES;
  uint8_t* const klo = khi + C::KV_BYTES;
  uint8_t* const vthi = klo + C::KV_BYTES;    // V^T: 64 rows of d x 64 keys
  uint8_t* const vtlo = vthi + C::KV_BYTES;

  const int q0 = blockIdx.x * C::BMQ, h = blockIdx.y, b = blockIdx.z;
  const int T = p.T;
  const int kv_len = p.key_len == nullptr ? T : min(max(p.key_len[b], 0), T);
  const int n_tiles = (kv_len + C::BN - 1) / C::BN;

  if (threadIdx.x == 0) {
    mbar_init(&q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], C::NT);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= C::NT) {  // the producer warp; one lane issues the copies
    if (threadIdx.x == C::NT) {
      prefetch_map(&p.tq);
      prefetch_map(&p.tk);
      prefetch_map(&p.tv);
      mbar_arrive_expect_tx(&q_bar, C::Q_BYTES);
      for (int kc = 0; kc < 2; ++kc)
        tma_load_4d(qhi + kc * C::BMQ * 128, &p.tq, &q_bar, 32 * kc, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        uint8_t* st = ring + s * C::STAGE_BYTES;
        mbar_wait(&empty_bar[s], ((i / C::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full_bar[s], C::STAGE_BYTES);
        for (int kc = 0; kc < 2; ++kc) {
          tma_load_4d(st + kc * C::BN * 128, &p.tk, &full_bar[s], 32 * kc, h, i * C::BN, b);
          tma_load_4d(st + C::KV_BYTES + kc * C::BN * 128, &p.tv, &full_bar[s], 32 * kc, h,
                      i * C::BN, b);
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63; a thread
  // rows r0 and r0 + 8 of them
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int r0 = wg * BM + warp * 16 + g;
  const float* brow[2] = {nullptr, nullptr};  // this thread's rows of the bias
  float gate[2] = {1.f, 1.f};
  if (p.bias != nullptr) {
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int t = min(q0 + r0 + 8 * ii, T - 1);
      brow[ii] = p.bias + b * p.bias_sb + h * p.bias_sh + t * p.bias_sq;
      if (p.gate != nullptr) gate[ii] = p.gate[b * p.gate_sb + h * p.gate_sh + t * p.gate_st];
    }
  }

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  const float scale2 = p.scale * LOG2E;  // scores in the log2 domain
  const uint32_t qrows = wg * BM * 128;   // this warpgroup's rows in each Q chunk

  mbar_wait(&q_bar, 0);
  split_tile(qhi, qhi, qlo, C::Q_BYTES / 16, tid, C::NT);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::STAGES;
    const uint8_t* st = ring + s * C::STAGE_BYTES;
    mbar_wait(&full_bar[s], (i / C::STAGES) & 1);
    split_tile(st, khi, klo, C::KV_BYTES / 16, tid, C::NT);
    split_transposed<C::BN>(st + C::KV_BYTES, vthi, vtlo, tid, C::NT);
    mbar_arrive(&empty_bar[s]);
    fence_proxy_async();  // the split tiles, written by threads, read by wgmma
    named_barrier(1, C::NT);

    // S = Q K^T (64 x 64): lo x hi, hi x lo, hi x hi, 8 k8 steps each
    float sacc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
    fence_regs(sacc);
    wgmma_fence();
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const uint8_t* a = (term == 0 ? qlo : qhi) + qrows;
      const uint8_t* kb = term == 1 ? klo : khi;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        wgmma_tf32_ss<64>(sacc, desc_k(a + (ks >> 2) * C::BMQ * 128) + (ks & 3) * K_STEP,
                          desc_k(kb + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sacc);

    // scale, bias and key mask; the tile's row max
    const int k0 = i * C::BN;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = e >> 1;
        const int key = k0 + 8 * j + c2 + (e & 1);
        float x = -CUDART_INF_F;
        if (key < kv_len) {
          x = sacc[4 * j + e] * scale2;
          if (brow[ii] != nullptr) x = fmaf(gate[ii] * brow[ii][key * p.bias_sk], LOG2E, x);
        }
        sacc[4 * j + e] = x;
        mx[ii] = fmaxf(mx[ii], x);
      }
    }
    // a row's columns are spread over the 4 lanes of its quad; key k0 is
    // valid, so the max is finite
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
      mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
      const float alpha = exp2f(m[ii] - mx[ii]);  // 0 on the first tile
      m[ii] = mx[ii];
      l[ii] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 2 * ii] *= alpha;
        o[4 * j + 2 * ii + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sacc[j] = exp2f(sacc[j] - m[(j >> 1) & 1]);
      l[(j >> 1) & 1] += sacc[j];  // this lane's part of the row sum
    }

    // O += P V: P split in registers, V^T (hi, lo) as the K-major B
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) acc_to_a_tf32(ph[ks], pl[ks], sacc, ks);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_tf32_rs64(o, pl[ks], desc_k(vthi + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_tf32_rs64(o, ph[ks], desc_k(vtlo + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      wgmma_tf32_rs64(o, ph[ks], desc_k(vthi + (ks >> 2) * C::BN * 128) + (ks & 3) * K_STEP);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    named_barrier(1, C::NT);  // both warpgroups are done with the split tiles
  }

#pragma unroll
  for (int ii = 0; ii < 2; ++ii) {
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 1);
    l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 2);
    const float inv = l[ii] > 0.f ? 1.f / l[ii] : 0.f;  // no valid key: 0
    const int t = q0 + r0 + 8 * ii;
    if (t >= T) continue;
    // m is in the log2 domain; one lane of the quad writes the row's value
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[((long long)b * p.H + h) * T + t] =
          l[ii] > 0.f ? (m[ii] + log2f(l[ii])) / LOG2E : -CUDART_INF_F;
    float* orow = p.out + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + c2) =
          make_float2(o[4 * j + 2 * ii] * inv, o[4 * j + 2 * ii + 1] * inv);
  }
}

int launch_f32(F32Params& p, const void* q, const void* k, const void* v, int B, int T, int H,
               const long long* s, cudaStream_t stream) {
  using C = F32Tile;
  int rc = sm90_host::encode_rows_f32(&p.tq, q, B, T, H, s + 0, C::BMQ);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tk, k, B, T, H, s + 3, C::BN);
  if (rc == 0) rc = sm90_host::encode_rows_f32(&p.tv, v, B, T, H, s + 6, C::BN);
  if (rc != 0) return rc;
  static bool smem_set[sm90_host::MAX_DEVICES] = {};  // per device
  const int dev = sm90_host::current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const dim3 grid((T + C::BMQ - 1) / C::BMQ, H, B);
  flash_fwd_f32_sm90<<<grid, C::NT + 32, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_bf16(FwdParams& p, const void* q, const void* k, const void* v, const void* bias,
                void* out, int B, int T, int H, const long long* s, cudaStream_t stream) {
  int rc = sm90_host::encode_rows(&p.tq, q, B, T, H, s + 0, BM);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tk, k, B, T, H, s + 3, BN);
  if (rc == 0) rc = sm90_host::encode_rows(&p.tv, v, B, T, H, s + 6, BN);
  if (rc == 0) rc = sm90_host::encode_rows(&p.to, out, B, T, H, s + 9, BM);
  if (rc == 0 && bias != nullptr) rc = sm90_host::encode_bias(&p.tbias, bias, B, T, H, s + 12, BM, BN);
  if (rc != 0) return rc;
  using C = FwdTile<BN>;
  static bool smem_set[sm90_host::MAX_DEVICES] = {};  // per device
  const int dev = sm90_host::current_device();
  if (dev < 0) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_sm90<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const dim3 grid((T + BM - 1) / BM, H, B);
  flash_fwd_bf16_sm90<BN><<<grid, 160, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v, bias, gate and out alike).  q, k,
// v, out (B, T, H, 64) with a contiguous head dim; `strides` (host memory)
// holds the element strides q_sb, q_st, q_sh, k_*, v_*, out_*, then the
// bias's (b, h, query, key) strides (0 broadcasts), then the gate's (b, h,
// query).  bias, gate and key_len (B int32) may be null; with a gate the
// effective bias is round(gate * bias).  lse may be null, or a contiguous
// (B, H, T) float32 output of each row's log-sum-exp (natural log) for the
// backward.  q, k, v need what TMA takes: 16-byte aligned bases and
// strides of multiples of 16 bytes; a bf16 bias also a key stride 1 and b
// and h strides 0 or multiples of 8 (the float32 kernel reads the bias and
// gate through any strides).  `tile` is the bf16 kernel's key-tile width,
// 64 or 80 (ops/flash_attention.py:key_tile picks it per T); float32
// ignores it.  Launches on `stream` and returns cudaGetLastError() or an
// encoding error (flash_attention_error_string).
int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        const void* bias, const void* gate, const int* key_len, void* out,
                        float* lse, int B, int T, int H, const long long* strides, float scale,
                        int tile, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    FwdParams p;
    p.gate = static_cast<const __nv_bfloat16*>(bias != nullptr ? gate : nullptr);
    p.gate_sb = strides[16];
    p.gate_sh = strides[17];
    p.gate_st = strides[18];
    p.key_len = key_len;
    p.lse = lse;
    p.T = T;
    p.H = H;
    p.has_bias = bias != nullptr;
    p.bias_bcast_b = strides[12] == 0;
    p.bias_bcast_h = strides[13] == 0;
    p.scale = scale;
    if (tile == 80) return launch_bf16<80>(p, q, k, v, bias, out, B, T, H, strides, s);
    if (tile == 64) return launch_bf16<64>(p, q, k, v, bias, out, B, T, H, strides, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  F32Params p;
  p.bias = static_cast<const float*>(bias);
  p.gate = static_cast<const float*>(bias != nullptr ? gate : nullptr);
  p.key_len = key_len;
  p.out = static_cast<float*>(out);
  p.lse = lse;
  p.o_sb = strides[9];
  p.o_st = strides[10];
  p.o_sh = strides[11];
  p.bias_sb = strides[12];
  p.bias_sh = strides[13];
  p.bias_sq = strides[14];
  p.bias_sk = strides[15];
  p.gate_sb = strides[16];
  p.gate_sh = strides[17];
  p.gate_st = strides[18];
  p.T = T;
  p.H = H;
  p.scale = scale;
  return launch_f32(p, q, k, v, B, T, H, strides, s);
}

const char* flash_attention_error_string(int code) {
  if (code == sm90_host::ERR_NO_ENCODER)
    return "the driver has no cuTensorMapEncodeTiled (TMA needs a Hopper driver)";
  if (code == sm90_host::ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
