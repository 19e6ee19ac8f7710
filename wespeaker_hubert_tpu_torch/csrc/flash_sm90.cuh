// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA tile loads and
// stores, wgmma with 128-byte-swizzled shared-memory descriptors, and the
// host-side tensor-map encoder.  Everything is inline PTX: no CuTe or
// CUTLASS header, so nvcc takes seconds.
//
// Layout conventions.  A bf16 head-dim row of 64 elements is 128 bytes, so a
// tile of R rows loaded by TMA with CU_TENSOR_MAP_SWIZZLE_128B is R x 128 B,
// 1024-byte aligned, with the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8) (swz128 below).  wgmma reads such a tile through a descriptor
// with the 128B-swizzle layout type and a stride of 1024 B between 8-row
// groups:
//   K-major (the reduction dim is the contiguous head dim, as Q or K in
//     Q K^T): one k16 step is 32 bytes along the row, so step s adds 2 to
//     the descriptor's 16-byte address field;
//   MN-major (the reduction dim runs over rows, as V in P V: "transposed
//     B"): one k16 step is 16 rows, 2048 bytes, so step s adds 128.
// The wgmma accumulator of an m64nN tile gives thread (warp w, lane l), with
// g = l / 4 and c = 2 (l % 4), rows 16 w + g and 16 w + g + 8 and, for each
// 8-column block j, columns 8 j + c and 8 j + c + 1:
//   d[4 j + 0] = (16 w + g, 8 j + c),     d[4 j + 1] = (16 w + g, 8 j + c + 1),
//   d[4 j + 2] = (16 w + g + 8, 8 j + c), d[4 j + 3] = (16 w + g + 8, 8 j + c + 1).
// That is the A-register layout of a k16 step over columns 16 s .. 16 s + 15:
//   a = {pack(d[8s], d[8s+1]), pack(d[8s+2], d[8s+3]),
//        pack(d[8s+4], d[8s+5]), pack(d[8s+6], d[8s+7])},
// so P (or dS) goes from the scores' accumulator to the next product
// without shared memory.
//
// float32 (3xTF32).  A float32 row of 64 elements is 256 bytes, two 128-byte
// swizzle atoms: a tile of R rows is stored K-major as two chunks of R x 128 B
// (columns 0-31, then 32-63), each loaded by its own TMA box of 32 floats
// (f32_off below).  wgmma .tf32 takes k8 steps of 32 bytes, so the K_STEP
// and the descriptors of the bf16 tiles serve unchanged, and step s of a
// 64-wide contraction reads chunk s / 4 at 32 (s % 4) bytes.  wgmma takes
// both tf32 operands K-major only (no transpose flag for .tf32), so a B
// operand whose contraction runs over rows (V in P V; Q and dO in dK/dV) is
// written transposed into shared memory by the pass that splits it.  Each
// float32 x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and a
// product is A_lo B_hi + A_hi B_lo + A_hi B_hi in float32 accumulation, the
// small terms first (A_lo B_lo, about 2^-22 of the product, is dropped).
// The accumulator's layout is not the tf32 A-register layout: a k8 step's A
// fragment holds columns (l % 4, l % 4 + 4) of rows (g, g + 8), the
// accumulator columns (c, c + 1).  acc_to_a_tf32 hands the accumulator's
// columns over as they lie, so fragment column l % 4 is key 8 s + c and
// column l % 4 + 4 is key 8 s + c + 1: the B operand's contraction index j
// of each k8 step holds row 8 s + perm8(j), which the transposing split
// writes (perm8 below).

#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (128B swizzle atoms)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// byte offset of element (r, col) of a bf16 tile with 128-byte rows stored
// with the 128B swizzle (the tile 1024-byte aligned)
__device__ __forceinline__ uint32_t swz128(int r, int col) {
  return r * 128 + ((((col >> 3) ^ r) & 7) << 4) + (col & 7) * 2;
}

// byte offset of element (query row r, key col) of a bias or dS tile of
// BN keys: 128-byte rows swizzled (BN = 64), else plain rows of BN * 2 bytes
template <int BN>
__device__ __forceinline__ uint32_t bias_off(int r, int col) {
  if constexpr (BN == 64) return swz128(r, col);
  else return r * (BN * 2) + col * 2;
}

// byte offset of float32 element (r, col), col < 64, of a tile of `rows`
// rows stored as two 128B-swizzled chunks of 32 columns (the tile 1024-byte
// aligned, `rows` a multiple of 8)
__device__ __forceinline__ uint32_t f32_off(int rows, int r, int col) {
  return (col >> 5) * rows * 128 + r * 128 + ((((col >> 2) ^ r) & 7) << 4) + (col & 3) * 4;
}

// the row of a k8 step (0-7) that a transposed B operand holds at
// contraction index j: the accumulator's columns c, c + 1 (c = 2 (l % 4))
// are the A fragment's l % 4 and l % 4 + 4
__device__ __forceinline__ int perm8(int j) { return j < 4 ? 2 * j : 2 * (j - 4) + 1; }

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32 for every finite x, in two integer
// operations, which took the float32 forward 9% less time on an H100 than
// the conversion (perf_k2_f32_ablate.py, variant cvt_split)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to about 2^-22 |x|, both tf32 (the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A float32 tile as TMA wrote it (f32_off's layout, `n16` 16-byte units)
// split into hi and lo tiles of the same layout by `nt` threads (`hi` may
// be `raw`: each unit is read, then written, by one thread).
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo, int n16,
                                           int tid, int nt) {
  for (int u = tid; u < n16; u += nt) {
    const float4 x = reinterpret_cast<const float4*>(raw)[u];
    uint4 a, b;
    split_tf32(x.x, a.x, b.x);
    split_tf32(x.y, a.y, b.y);
    split_tf32(x.z, a.z, b.z);
    split_tf32(x.w, a.w, b.w);
    reinterpret_cast<uint4*>(hi)[u] = a;
    reinterpret_cast<uint4*>(lo)[u] = b;
  }
}

// A float32 tile of R rows x 64 columns (f32_off's layout) split into hi and
// lo tiles of its transpose, 64 rows x R columns, column 8 s + j holding row
// 8 s + perm8(j): the K-major B operand of a product contracting over the
// R rows.  A warp reads 32 columns of one row (distinct banks) and writes a
// 16-byte unit of 32 rows (8 distinct units per quarter warp).
template <int R>
__device__ __forceinline__ void split_transposed(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                                 int tid, int nt) {
  for (int u = tid; u < 64 * (R / 4); u += nt) {
    const int d = u & 63, grp = u >> 6;  // columns 4 grp .. 4 grp + 3 of row d
    const int r = 8 * (grp >> 1) + (grp & 1);  // perm8 of 4 (grp & 1) + e is 2 e + (grp & 1)
    uint4 a, b;
    split_tf32(*reinterpret_cast<const float*>(raw + f32_off(R, r, d)), a.x, b.x);
    split_tf32(*reinterpret_cast<const float*>(raw + f32_off(R, r + 2, d)), a.y, b.y);
    split_tf32(*reinterpret_cast<const float*>(raw + f32_off(R, r + 4, d)), a.z, b.z);
    split_tf32(*reinterpret_cast<const float*>(raw + f32_off(R, r + 6, d)), a.w, b.w);
    const uint32_t off = f32_off(64, d, 4 * grp);
    *reinterpret_cast<uint4*>(hi + off) = a;
    *reinterpret_cast<uint4*>(lo + off) = b;
  }
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------- TMA
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// a box of a rank-4 tensor map into shared memory; completion counts its
// bytes on `bar`.  Elements out of the tensor's bounds arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory out to a rank-4 tensor map; elements out of the
// tensor's bounds are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// waits until this thread's committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  tma_store_commit();
  tma_store_wait_read();
}

// generic-proxy writes to shared memory made visible to TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among the `count` threads of one role (id 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ wgmma
// a descriptor of a 128B-swizzled tile; the byte offsets in 16-byte units
__device__ __forceinline__ uint64_t desc128(const void* tile, uint32_t lbo_bytes,
                                            uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(tile) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // 128B swizzle
  return d;
}
// K-major (leading byte offset unused by the swizzled layout)
__device__ __forceinline__ uint64_t desc_k(const void* tile) { return desc128(tile, 16, 1024); }
// MN-major with one 64-wide swizzle atom across N (head dim 64)
__device__ __forceinline__ uint64_t desc_mn(const void* tile) { return desc128(tile, 8192, 1024); }
constexpr uint64_t K_STEP = 2;     // 32 bytes
constexpr uint64_t MN_STEP = 128;  // 2048 bytes

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator (or A
// fragment) registers across the asynchronous wgmma region
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define SM90_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_F32                                                                          \
  SM90_F4(0), SM90_F4(4), SM90_F4(8), SM90_F4(12), SM90_F4(16), SM90_F4(20), SM90_F4(24), \
      SM90_F4(28)
#define SM90_D32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_D40                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39}"

// d (64 x N, f32) (+)= A (64 x 16, shared, K-major) B (16 x N, shared,
// K-major); `accumulate` 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_F32
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float (&d)[40], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 " SM90_D40
      ", %40, %41, p, 1, 1, 0, 0;\n}\n"
      : SM90_F32, SM90_F4(32), SM90_F4(36)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, registers) B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_t64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define SM90_D16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x N, f32) += A (64 x 8, shared, K-major) B (8 x N, shared, K-major),
// tf32 operands
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : SM90_F32
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SM90_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : SM90_F4(0), SM90_F4(4), SM90_F4(8), SM90_F4(12)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 8, registers) B (8 x 64, shared, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_rs64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SM90_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef SM90_F4
#undef SM90_F32
#undef SM90_D16
#undef SM90_D32
#undef SM90_D40

// two floats as one bf16x2 register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k16 step s from an accumulator in the layout above
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N], int s) {
  a[0] = pack_bf16x2(d[8 * s], d[8 * s + 1]);
  a[1] = pack_bf16x2(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack_bf16x2(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack_bf16x2(d[8 * s + 6], d[8 * s + 7]);
}

// the tf32 A fragments (hi and lo) of k8 step s from an accumulator in the
// layout above: rows (g, g + 8) x fragment columns (l % 4, l % 4 + 4) take
// the accumulator's keys 8 s + c and 8 s + c + 1 (see perm8)
template <int N>
__device__ __forceinline__ void acc_to_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                              const float (&d)[N], int s) {
  split_tf32(d[4 * s], hi[0], lo[0]);
  split_tf32(d[4 * s + 2], hi[1], lo[1]);
  split_tf32(d[4 * s + 1], hi[2], lo[2]);
  split_tf32(d[4 * s + 3], hi[3], lo[3]);
}

// the effective bias of one (query, key) pair: the bias element, or with a
// gate the product rounded to bf16 (exact in float32, so this is the bf16
// product the encoder would have materialized)
__device__ __forceinline__ float gated(float gate, float table) {
  return __bfloat162float(__float2bfloat16_rn(gate * table));
}

}  // namespace sm90

// ------------------------------------------------------------------- host
namespace sm90_host {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point: no -lcuda
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// error codes of the entry points beyond cudaError_t
constexpr int ERR_NO_ENCODER = 10001;  // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 10002;      // cuTensorMapEncodeTiled refused a map

// the launch caches (a kernel's shared-memory attribute, the blocks a card
// holds at once) are kept per device: the current one, or -1 past MAX_DEVICES
constexpr int MAX_DEVICES = 64;
inline int current_device() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
  return dev;
}

// A rank-4 tensor map (bf16 unless `type` says otherwise): dims innermost
// first, element strides of dims 1..3 (a dim of extent 1 gets a stride TMA
// accepts; it is never stepped), the box, and the swizzle.  Returns 0 or an
// error code.
inline int encode4(CUtensorMap* map, const void* base, const long long dims_in[4],
                   const long long strides_elems[3], const int box_in[4],
                   CUtensorMapSwizzle swizzle,
                   CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return ERR_NO_ENCODER;
  // the driver call needs the device's context current on this thread, which
  // a thread that has made no runtime call yet (autograd's backward thread)
  // lacks: it then returns CUDA_ERROR_INVALID_CONTEXT
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return ERR_ENCODE;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(dims_in[i]);
    box[i] = static_cast<cuuint32_t>(box_in[i]);
  }
  cuuint64_t span = dims[0] * elem_bytes;  // bytes spanned by the dims so far
  for (int i = 0; i < 3; ++i) {
    cuuint64_t s = static_cast<cuuint64_t>(strides_elems[i]) * elem_bytes;
    if (dims[i + 1] == 1) s = (span + 15) / 16 * 16;
    strides[i] = s;
    span = s * dims[i + 1];
  }
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// a (B, T, H, 64) tensor read or written through its (b, t, h) element
// strides, in boxes of `rows` rows of one (batch, head)
inline int encode_rows(CUtensorMap* map, const void* base, int B, int T, int H,
                       const long long* sbth, int rows) {
  const long long dims[4] = {64, H, T, B};
  const long long strides[3] = {sbth[2], sbth[1], sbth[0]};
  const int box[4] = {64, 1, rows, 1};
  return encode4(map, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// a float32 (B, T, H, 64) tensor read through its (b, t, h) element
// strides, in boxes of `rows` rows x 32 columns of one (batch, head): the
// two 128B-swizzled chunks of a tile (f32_off) are two boxes, at columns 0
// and 32
inline int encode_rows_f32(CUtensorMap* map, const void* base, int B, int T, int H,
                           const long long* sbth, int rows) {
  const long long dims[4] = {64, H, T, B};
  const long long strides[3] = {sbth[2], sbth[1], sbth[0]};
  const int box[4] = {32, 1, rows, 1};
  return encode4(map, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

// a bias (Bb, Hb, T, T) (Bb in {1, B}: a stride of 0 broadcasts) read in
// boxes of `rows` queries x `cols` keys; 128-byte rows are swizzled
inline int encode_bias(CUtensorMap* map, const void* base, int B, int T, int H,
                       const long long* bhqk, int rows, int cols) {
  const long long dims[4] = {T, T, bhqk[1] == 0 ? 1 : H, bhqk[0] == 0 ? 1 : B};
  const long long strides[3] = {bhqk[2], bhqk[1], bhqk[0]};
  const int box[4] = {cols, rows, 1, 1};
  return encode4(map, base, dims, strides, box,
                 cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace sm90_host
