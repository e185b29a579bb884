// Causal (or full) attention with an online softmax, on CUDA cores, for sm_90a.
//
// Replaces the TPU kernel `src/repro/kernels/flash_attn.py:27 _kernel`
// (pallas_call :82, launched by `flash_attention` :69). Same function:
// q, k, v (B*H, S, D), logits s = (q . k) * scale in f32, causal mask with
// NEG_INF = -1e30 (not -inf), a running max m, denominator l and output
// accumulator acc kept in f32 across KV tiles, KV tiles wholly above the
// diagonal skipped, out = acc / max(l, 1e-30) rounded to the input type only
// at the store.
//
// Design. One block of 256 threads (a 16 x 16 thread grid) owns one q-tile of
// BQ = 128 rows of one (batch, head) and loops over the KV tiles of BK = 128
// rows up to the causal diagonal; the TPU's sequential KV grid axis becomes
// that loop, and m/l/acc live in registers instead of VMEM scratch. The tile
// is this kernel's own: the caller's bq/bk (the TPU kernel's block shape)
// change only the order of summation, so they are validated by the wrapper
// and not passed here. When S % 128 != 0 the masked instance runs: the
// last tile's missing rows load as zeros, its missing keys weigh NEG_INF and
// its missing output rows are not stored. A multiple of 128 runs the
// unmasked instance, since those masks cost 11% at llama3-8b width
// (PERF.md).
//
// Thread (ty, tx) owns rows ty + 16 i (i < BQ/16) of both products: columns
// tx + 16 j of the logits tile and output columns tx + 16 j (j < 8, so
// D <= 128), so every row statistic a thread needs comes from one 16-lane
// shuffle reduction. Q, K and V tiles are staged in shared memory as f32
// (rows padded to D + 1 floats, so the 16 rows a warp reads at one d fall
// in distinct banks); K and V share one buffer and the probabilities P go
// through shared memory between the two products. At D = 128 that is
// 193 KB of dynamic shared memory, above the 48 KB default, so each launch
// opts in with cudaFuncSetAttribute; one block fits on an SM. A 64 x 64
// tile fits two blocks on an SM but does half the FMAs per shared-memory
// load, and was 1.35x slower at llama3-8b width (PERF.md).
//
// Bound on this card: the two products take 4 B H S^2 D / 2 FLOP when
// causal; with bf16 inputs the least time is that over the tensor cores'
// 989 TFLOP/s. This kernel uses no tensor core: every product is an f32 FMA
// on CUDA cores (67 TFLOP/s peak), fed from shared memory, and tile loads
// are not overlapped with compute. It is the simple, exact version: f32
// inputs are computed in full f32 (no TF32), as the reference's 2e-4
// tolerance needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TG = 16;           // thread grid edge: 16 x 16 threads
constexpr int BQ = 128;          // query rows per block
constexpr int BK = 128;          // key rows per KV tile
constexpr int TM = BQ / TG;      // rows per thread
constexpr int TN = BK / TG;      // logits columns per thread
constexpr int DMAX = 128;        // largest head dim
constexpr int DJ = DMAX / TG;    // output columns per thread
constexpr float NEG_INF = -1e30f;

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (bh, S, D) with
// 1 <= D <= 128. Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_attn_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, int bh, int S, int D,
                              float scale, int causal, void* stream) {
  if (D < 1 || D > DMAX || bh < 1 || S < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, bh, S, D, scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, bh, S, D, scale, causal, st);
  return cudaErrorInvalidValue;
}
