// Causal (or full) attention with an online softmax, for sm_90a: a
// tensor-core instance for bf16 (the "wgmma" route) and a CUDA-core
// instance for f32 and for bf16 head dims that 8 does not divide (the "fma"
// route). The wrapper (`flash_attn.py _route`) picks one by dtype and head
// dim; neither falls back to the other.
//
// Replaces the TPU kernel `src/repro/kernels/flash_attn.py:27 _kernel`
// (pallas_call :82, launched by `flash_attention` :69). Same function:
// q, k, v (B*H, S, D), logits s = (q . k) * scale in f32, causal mask with
// NEG_INF = -1e30 (not -inf), a running max m, denominator l and output
// accumulator acc kept in f32 across KV tiles, KV tiles wholly above the
// diagonal skipped, out = acc / max(l, 1e-30) rounded to the input type only
// at the store.
//
// Bound on this card: the two products take 4 B H S^2 D / 2 FLOP when
// causal; with bf16 inputs the least time is that over the tensor cores'
// 989 TFLOP/s (the bytes, each of q, k, v read once and o written once, take
// a few percent of that at S = 32768).
//
// wgmma route (bf16, D % 8 == 0, D <= 128). One block of two consumer
// warpgroups owns a q-tile of BQ = 128 rows of one (batch, head), 64 rows
// per warpgroup, and loops over KV tiles of TC_BK rows up to the diagonal.
// - Products. S = Q K^T is `wgmma.mma_async` bf16 -> f32 with both operands
//   in shared memory, K-major (D contiguous), 128-byte swizzled. O += P V
//   takes P from registers as the A operand (the S accumulator's fragment
//   is the A fragment's layout, so P needs no shuffle) and V from shared
//   memory through the transpose bit (V is MN-major: D contiguous).
// - Why P is split. The PV product rounds its A operand to bf16, and a P
//   rounded to bf16 (8 bits) moves outputs by up to 50x the one-bf16-ulp
//   element check that holds this kernel to the plain version (which keeps
//   P in f32, as the reference does). So P = P_hi + P_lo with
//   P_hi = bf16(P) and P_lo = bf16(P - P_hi) (16 bits together), and both
//   products go into the same f32 accumulator. That doubles the PV work:
//   the kernel's tensor work is 1.5x the function's FLOPs. l is summed from
//   the f32 P.
// - Loads. Q, K and V reach shared memory by TMA (`cp.async.bulk.tensor`,
//   3-D maps over (D, S, B*H) so a tile never reads into the next head) with
//   `mbarrier` completion. D is padded to DP in {64, 128} in shared memory:
//   TMA zero-fills columns >= D and rows >= S, and zero columns add nothing
//   to S or to the stored O. K and V go round a ring of TC_STAGES stages;
//   the second warpgroup to release a stage starts the load of the tile
//   TC_STAGES ahead into it, so no thread waits to start a load.
// - Masks apply only to a tile that crosses the diagonal or S; keys >= S
//   weigh NEG_INF and rows >= S are not stored.
// - Order. Under the causal mask the grid hands out q-tiles longest first
//   (q-tile major, reversed), so the heaviest blocks do not launch last.
// - Tile. TC_BK = 128 fits in 227 registers with no spills at D = 128
//   (ptxas), so the larger KV tile, with half the barrier round trips per
//   key of a 64-row one, is kept; two ring stages (PERF.md §6). Each
//   warpgroup waits on its own products: the softmax of a tile overlaps
//   only the other warpgroup's products.
//
// fma route (f32; bf16 with D % 8 != 0). One block of 256 threads (a 16 x 16
// thread grid) per 128-row q-tile, 128-row KV tiles, both
// products as f32 FMAs on CUDA cores from f32 tiles in shared memory (rows
// padded to D + 1 floats against bank conflicts; 193 KB at D = 128, one
// block per SM), tile loads not overlapped. f32 stays here because the
// reference's 2e-4 f32 tolerance needs full f32 products (TF32 keeps 10
// mantissa bits). A multiple of 128 runs the instance without masks.

#include <cuda.h>  // CUtensorMap and its enums (types only; libcuda not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int DMAX = 128;        // largest head dim of both routes

// ---------------------------------------------------------------------------
// fma route
// ---------------------------------------------------------------------------
namespace cudacore {

constexpr int THREADS = 256;
constexpr int TG = 16;           // thread grid edge: 16 x 16 threads
constexpr int BQ = 128;          // query rows per block
constexpr int BK = 128;          // key rows per KV tile
constexpr int TM = BQ / TG;      // rows per thread
constexpr int TN = BK / TG;      // logits columns per thread
constexpr int DJ = DMAX / TG;    // output columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copy `rows` x D elements of one head, starting at row r0, into shared
// memory as f32 with row stride ld; if MASKED, rows at or past S load as
// zeros.
template <bool MASKED, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int S, int D, int ld) {
  const T* base = src + (size_t)r0 * D;
  const int valid = min(rows, S - r0) * D;
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    dst[r * ld + d] = (!MASKED || e < valid) ? to_f32(base[e]) : 0.f;
  }
}

template <typename T, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int D,
                  float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;              // BQ x ld
  float* kvs = qs + BQ * ld;     // BK x ld: the K tile, then the V tile
  float* ps = kvs + BK * ld;     // BQ x BK probabilities

  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * BQ;
  const size_t head = (size_t)bh * S * D;
  const int ty = threadIdx.x / TG, tx = threadIdx.x % TG;

  load_tile<MASKED>(qs, q + head, q0, BQ, S, D, ld);

  float m_i[TM], l_i[TM], acc[TM][DJ];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // KV tiles strictly above the diagonal are skipped: k0 < q0 + BQ. The
  // first tile holds key 0, which no row masks, so m is finite after it.
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();             // the previous V tile is consumed
    load_tile<MASKED>(kvs, k + head, k0, BK, S, D, ld);
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = qs[(ty + TG * i) * ld + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kv[j] = kvs[(tx + TG * j) * ld + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty + TG * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int key = k0 + tx + TG * j;
        float x = s[i][j] * scale;
        if ((MASKED && key >= S) || (causal && key > row)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TG / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + TG * i) * BK + tx + TG * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TG / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();             // K reads are done and P is written
    load_tile<MASKED>(kvs, v + head, k0, BK, S, D, ld);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[TM], vv[DJ];
#pragma unroll
      for (int i = 0; i < TM; ++i) pv[i] = ps[(ty + TG * i) * BK + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        vv[j] = (tx + TG * j < D) ? kvs[c * ld + tx + TG * j] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty + TG * i;
    if (MASKED && row >= S) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    T* orow = o + head + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + TG * j;
      if (d < D) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, bool MASKED>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int S, int D, float scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_attn_kernel<T, MASKED>;
  const int ld = D + 1;
  const size_t smem = sizeof(float) * ((size_t)(BQ + BK) * ld + BQ * BK);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh * (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int bh, int S, int D, float scale, int causal,
                     cudaStream_t stream) {
  static_assert(BQ == BK, "one mask decision covers both tiles");
  return S % BQ == 0
             ? launch<T, false>(q, k, v, o, bh, S, D, scale, causal, stream)
             : launch<T, true>(q, k, v, o, bh, S, D, scale, causal, stream);
}

}  // namespace cudacore

// ---------------------------------------------------------------------------
// wgmma route
// ---------------------------------------------------------------------------
namespace tc {

constexpr int WG = 128;          // threads of a warpgroup
constexpr int BQ = 128;          // query rows per block: 2 warpgroups x 64
constexpr int THREADS = 2 * WG;
constexpr int TC_BK = 128;       // key rows per KV tile
constexpr int TC_STAGES = 2;     // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA box (64 columns x rows x 1 head) into shared memory at dst,
// completing on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers at this point of the program, so that no
// access to them moves across an asynchronous product's start or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) += A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += a (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += a (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, scale_d);
  else wgmma_rs_n128(d, a, db, scale_d);
}

// 2^x, flushing results below the smallest normal float to 0 (a weight
// under 2^-126 of the row's largest adds nothing to an f32 sum)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared memory, from a 1024-byte aligned base: the Q tile, then
// TC_STAGES x (K tile, V tile), then the mbarriers and release counters.
// A tile of R rows is DP / 64 chunks of R x 64 bf16 (128-byte rows, as one
// TMA box writes them, swizzled), chunk c holding columns 64c .. 64c + 63.
template <int DP>
struct Layout {
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = TC_BK * DP * 2;
  static constexpr uint32_t TILES = Q_BYTES + TC_STAGES * 2 * KV_BYTES;
  static constexpr uint32_t BAR_BYTES = 8 * (1 + 2 * TC_STAGES);
  static constexpr uint32_t BYTES = 1024 + TILES + BAR_BYTES + 4 * TC_STAGES;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, int BH, int S, int D,
                float scale_log2, int causal) {
  using L = Layout<DP>;
  constexpr int NS = TC_BK / 2;  // S accumulator floats per thread
  constexpr int NO = DP / 2;     // O accumulator floats per thread
  constexpr int KQ = DP / 16;    // k-steps of the QK product
  constexpr int KP = TC_BK / 16; // k-steps of each PV product
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + L::TILES;
  const uint32_t qbar = bars;
  auto kbar = [&](int s) { return bars + 8u * (1 + s); };
  auto vbar = [&](int s) { return bars + 8u * (1 + TC_STAGES + s); };
  auto ktile = [&](int s) { return base + L::Q_BYTES + s * 2 * L::KV_BYTES; };
  auto vtile = [&](int s) { return ktile(s) + L::KV_BYTES; };
  unsigned* released = reinterpret_cast<unsigned*>(
      smem_raw + (bars + L::BAR_BYTES - raw));

  const int n_qt = (S + BQ - 1) / BQ;
  const int bh = blockIdx.x % BH;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x / BH
                        : (int)blockIdx.x / BH;
  const int q0 = qt * BQ;
  const int kv_len = causal ? min(S, q0 + BQ) : S;
  const int n_kv = (kv_len + TC_BK - 1) / TC_BK;

  const int tid = threadIdx.x;
  const int wg = tid / WG, wtid = tid % WG;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // this thread's rows:
  const int row1 = row0 + 8;                       // row0 and row0 + 8
  const int wg_first = q0 + 64 * wg, wg_last = wg_first + 63;

  const CUtensorMap* kmp = &kmap;
  const CUtensorMap* vmp = &vmap;
  auto load_kv = [&](int t) {   // one thread: tile t into stage t % STAGES
    const int s = t % TC_STAGES;
    mbar_expect_tx(kbar(s), L::KV_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(ktile(s) + c * TC_BK * 128, kmp, kbar(s), 64 * c,
               t * TC_BK, bh);
    mbar_expect_tx(vbar(s), L::KV_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(vtile(s) + c * TC_BK * 128, vmp, vbar(s), 64 * c,
               t * TC_BK, bh);
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(kbar(s), 1);
      mbar_init(vbar(s), 1);
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
    for (int c = 0; c < DP / 64; ++c)
      tma_load(sq + c * BQ * 128, &qmap, qbar, 64 * c, q0, bh);
    for (int t = 0; t < min(TC_STAGES, n_kv); ++t) load_kv(t);
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // K-major descriptors (Q, K): 8-row groups 1024 bytes apart; a k-step of
  // 16 columns is 32 bytes into a 64-column chunk. V (MN-major): 8-row
  // groups of keys 1024 bytes apart, 64-column chunks TC_BK * 128 apart.
  const uint32_t q_wg = sq + wg * 64 * 128;
  mbar_wait(qbar, 0);

  for (int t = 0; t < n_kv; ++t) {
    const int s = t % TC_STAGES;
    const uint32_t parity = (t / TC_STAGES) & 1;
    const int k0 = t * TC_BK;
    // under the causal mask the diagonal tile may lie wholly past this
    // warpgroup's rows (TC_BK < BQ): nothing to add
    if (!(causal && k0 > wg_last)) {
      mbar_wait(kbar(s), parity);
      float sc[NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // within chunk kk / 4
        wgmma_ss<TC_BK>(
            sc, make_desc(q_wg + (kk / 4) * BQ * 128 + off, 16, 1024),
            make_desc(ktile(s) + (kk / 4) * TC_BK * 128 + off, 16, 1024),
            kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      // online softmax on the unscaled logits q . k (the scale is positive,
      // so their max is the scaled max): p = 2^((q . k - m) * scale log2 e)
      // = exp(s - max s), one FFMA and one ex2 per logit
      const bool masked = (k0 + TC_BK > S) ||
                          (causal && k0 + TC_BK - 1 > wg_first);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (masked) {
          const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
          const int row = (i & 2) ? row1 : row0;
          if (key >= S || (causal && key > row)) sc[i] = NEG_INF;
        }
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float alpha0 = exp2_ftz((m0 - mx0) * scale_log2);
      const float alpha1 = exp2_ftz((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
      const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
      uint32_t p_hi[KP][4], p_lo[KP][4];
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;   // a pair of columns of one row
          const float mr = (r & 1) ? ms1 : ms0;
          const float pa = exp2_ftz(fmaf(sc[i], scale_log2, -mr));
          const float pb = exp2_ftz(fmaf(sc[i + 1], scale_log2, -mr));
          if (r & 1) l1 += pa + pb;
          else l0 += pa + pb;
          const __nv_bfloat162 h = __floats2bfloat162_rn(pa, pb);
          p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
          p_lo[kk][r] = pack_bf16(pa - __low2float(h), pb - __high2float(h));
        }
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? alpha1 : alpha0;

      mbar_wait(vbar(s), parity);
      wg_fence();
      pin(acc);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_rs<DP>(acc, p_hi[kk],
                     make_desc(vtile(s) + kk * 16 * 128, TC_BK * 128, 1024),
                     1);
#pragma unroll
      for (int kk = 0; kk < KP; ++kk)
        wgmma_rs<DP>(acc, p_lo[kk],
                     make_desc(vtile(s) + kk * 16 * 128, TC_BK * 128, 1024),
                     1);
      wg_commit();
      wg_wait_all();
      pin(acc);
    }
    // release stage s: this warpgroup's products on it are complete
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG) : "memory");
    if (wtid == 0) {
      __threadfence_block();
      const unsigned before = atomicAdd(&released[s], 1u);
      if ((before & 1u) && t + TC_STAGES < n_kv) load_kv(t + TC_STAGES);
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < NO; i += 2) {
    const int row = (i & 2) ? row1 : row0;
    const int col = 8 * (i / 4) + 2 * t4;
    if (row < S && col < D) {
      const float dn = (i & 2) ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * S + row) * D +
                                         col) =
          __floats2bfloat162_rn(acc[i] / dn, acc[i + 1] / dn);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, reached through the runtime (no
// link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous (bh, S, D) bf16 tensor, boxes of 64 columns x
// rows x 1 head, 128-byte swizzle, zeros outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int bh, int S, int D,
              int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int S, int D, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, bh, S, D, BQ) || !make_map(&km, k, bh, S, D, TC_BK) ||
      !make_map(&vm, v, bh, S, D, TC_BK))
    return cudaErrorInvalidValue;
  auto kern = flash_tc_kernel<DP>;
  const int smem = (int)Layout<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh * (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>(qm, km, vm,
                                        static_cast<__nv_bfloat16*>(o), bh, S,
                                        D, scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// fma route. dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous
// (bh, S, D) with 1 <= D <= 128. Returns the CUDA error of the launch
// (0 = launched).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, int bh, int S, int D,
                              float scale, int causal, void* stream) {
  if (D < 1 || D > DMAX || bh < 1 || S < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cudacore::dispatch<float>(q, k, v, o, bh, S, D, scale, causal, st);
  if (dtype == 1)
    return cudacore::dispatch<__nv_bfloat16>(q, k, v, o, bh, S, D, scale, causal,
                                        st);
  return cudaErrorInvalidValue;
}

// wgmma route: bfloat16 only. q, k, v, o: contiguous (bh, S, D), 16-byte
// aligned, with D % 8 == 0 and 8 <= D <= 128. Returns the CUDA error of the
// launch (0 = launched); cudaErrorInvalidValue also when a TMA map cannot be
// made.
extern "C" int flash_attn_fwd_wgmma(const void* q, const void* k,
                                    const void* v, void* o, int bh, int S,
                                    int D, float scale, int causal,
                                    void* stream) {
  if (D < 8 || D > DMAX || D % 8 || bh < 1 || S < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D <= 64 ? tc::launch<64>(q, k, v, o, bh, S, D, scale, causal, st)
                 : tc::launch<128>(q, k, v, o, bh, S, D, scale, causal, st);
}

// Dynamic shared memory of one wgmma-route block for a padded head dim of
// 64 or 128 (0 otherwise), as its launch asks for it.
extern "C" int flash_attn_wgmma_smem_bytes(int dp) {
  return dp == 64 ? (int)tc::Layout<64>::BYTES
                  : dp == 128 ? (int)tc::Layout<128>::BYTES : 0;
}
