// NATSA diagonal-streaming matrix profile, two-sided, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `src/repro/kernels/natsa_mp.py:113 _kernel`
// (launched by `rowmax_profile_ab`). It computes what that kernel computes,
// over the signed diagonals k = j - i in [k_start, k_start + n_diag) of the
// (l_i, l_j) rectangle:
//
//   cov(i, k) = cov0[k - k_start] + sum_{t <= i} df_i[t]*dg_j[t+k] + df_j[t+k]*dg_i[t]
//   corr      = cov * invn_i[i] * invn_j[i+k]
//
// masked to NEG = -2 where j = i + k falls outside [0, l_j), i >= l_i,
// k >= k_end, or either invn < 0 (missing data); then, from the same cells,
// the row max + argmax (best j per row i) and the column max + argmax (best i
// per column j). The j streams are zero-PREPADDED by `jpad` (as in the
// reference, `kernels/ops.py _pad_streams_ab`): a negative diagonal's deltas
// before its first cell read the zero pad, so its covariance holds the seed
// until the diagonal enters the rectangle. Column outputs are indexed j + jpad.
//
// Design (a simple one, right first):
//   * one block of DB = 128 threads per group of 128 consecutive diagonals,
//     one thread per diagonal, its covariance carried in a register;
//   * the TPU's sequential row grid becomes a loop over row tiles of TR = 64
//     rows inside the block, clamped to the rows where any of the block's
//     diagonals lies in the rectangle (rows before it only add zero deltas);
//   * each tile stages the i-side rows and the (TR + DB)-wide j window of
//     df/dg/invn in shared memory (upcast to f32 on load: streams may be
//     f32, bf16 or f16; all arithmetic is f32, as on the TPU);
//   * the tile's TR x DB correlations go to shared memory; each warp reduces
//     rows across the block's diagonals with shuffles, each thread reduces
//     columns over the anti-diagonals of the (TR + DB - 1)-wide window;
//   * each row / column best is merged into global accumulators with one
//     packed 64-bit atomicMax (order-preserving float bits high, index low),
//     skipped when a plain L2 read already shows a better value; a second
//     kernel unpacks the accumulators into corr / idx.
//
// Bound on this card: FP32 issue. Each cell costs ~9 operations (delta,
// carry, corr, two max-compares) against a few bytes of streams per row, so
// the bytes are ~MBs while the cells are ~1e10. This simple design spends
// more instructions on the shared-memory round trip and the two reductions
// than on the recurrence itself, and one atomic per row and column per tile
// (1 per ~32 cells); the read-before-atomic check removes most atomics once
// the profile has converged. More diagonals per thread (register tiles that
// reduce without shared memory) is the next step.
//
// Tie order: within a tile the larger index wins (largest j on the row side,
// largest i on the column side), as does the packed atomicMax across tiles;
// the TPU kernel keeps the earlier tile. Indices may differ at exact ties.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DB = 128;  // diagonals per block (= threads per block)
constexpr int TR = 64;   // rows per tile
constexpr int TW = TR + DB;  // j-window width of one tile
constexpr float NEG = -2.0f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// order-preserving map float -> uint32 (larger float -> larger uint)
__device__ __forceinline__ unsigned int ordered(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int o) {
  unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ void merge_max(unsigned long long* acc, float v, int idx) {
  unsigned long long key =
      (static_cast<unsigned long long>(ordered(v)) << 32) | static_cast<unsigned int>(idx);
  // a stale read is never above the true value, so the skip is safe
  if (key > __ldcg(acc)) atomicMax(acc, key);
}

template <typename T>
__global__ void __launch_bounds__(DB)
natsa_sweep(const T* __restrict__ df_i, const T* __restrict__ dg_i,
            const T* __restrict__ invn_i, const T* __restrict__ df_j,
            const T* __restrict__ dg_j, const T* __restrict__ invn_j,
            const float* __restrict__ cov0, int rows, int n_diag, int jp,
            int k_start, int k_end, int l_i, int l_j, int jpad,
            unsigned long long* row_acc, unsigned long long* col_acc) {
  __shared__ float s_dfi[TR], s_dgi[TR], s_invi[TR];
  __shared__ float s_dfj[TW], s_dgj[TW], s_invj[TW];
  __shared__ float s_corr[TR][DB];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int d0 = blockIdx.x * DB;
  const int kb = k_start + d0;          // first diagonal of the block
  const int d = d0 + t;
  const int k = kb + t;                 // this thread's diagonal
  const bool live = d < n_diag && k < k_end;

  // rows where any diagonal of the block has a cell inside the rectangle
  const int lo = max(0, -(kb + DB - 1));
  const int hi = min(min(rows, l_i), l_j - kb);
  if (hi <= lo) return;

  float cov = d < n_diag ? cov0[d] : 0.0f;

  for (int r0 = lo; r0 < hi; r0 += TR) {
    for (int x = t; x < TR; x += DB) {
      const int i = r0 + x;
      const bool in = i < rows;
      s_dfi[x] = in ? to_f32(df_i[i]) : 0.0f;
      s_dgi[x] = in ? to_f32(dg_i[i]) : 0.0f;
      s_invi[x] = in ? to_f32(invn_i[i]) : -1.0f;
    }
    const int jb = r0 + kb + jpad;      // flat j position of window entry 0
    for (int x = t; x < TW; x += DB) {
      const int p = jb + x;
      const bool in = p >= 0 && p < jp;
      s_dfj[x] = in ? to_f32(df_j[p]) : 0.0f;
      s_dgj[x] = in ? to_f32(dg_j[p]) : 0.0f;
      s_invj[x] = in ? to_f32(invn_j[p]) : -1.0f;
    }
    __syncthreads();

    // the recurrence: one diagonal per thread, rows in order
#pragma unroll 8
    for (int r = 0; r < TR; ++r) {
      const int x = r + t;
      cov += s_dfi[r] * s_dgj[x] + s_dfj[x] * s_dgi[r];
      const int i = r0 + r;
      const int j = i + k;
      const float ii = s_invi[r];
      const float ij = s_invj[x];
      const bool valid = live && i < hi && j >= 0 && j < l_j && ii >= 0.0f && ij >= 0.0f;
      s_corr[r][t] = valid ? cov * ii * ij : NEG;
    }
    __syncthreads();

    // row side: warp w reduces rows w, w + 4, ... over the block's diagonals
    for (int r = warp; r < TR; r += DB / 32) {
      float best = NEG;
      int bt = -1;
#pragma unroll
      for (int q = 0; q < DB / 32; ++q) {
        const int tt = lane + 32 * q;
        const float v = s_corr[r][tt];
        if (v > best || (v == best && tt > bt)) { best = v; bt = tt; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int ot = __shfl_down_sync(0xffffffffu, bt, off);
        if (ov > best || (ov == best && ot > bt)) { best = ov; bt = ot; }
      }
      if (lane == 0 && best > NEG) {
        const int i = r0 + r;
        merge_max(row_acc + i, best, i + kb + bt);
      }
    }

    // column side: local column c = r + tt holds the cells (r, c - r)
    for (int c = t; c < TR + DB - 1; c += DB) {
      float best = NEG;
      int br = -1;
      const int rlo = max(0, c - (DB - 1));
      const int rhi = min(TR - 1, c);
      for (int r = rlo; r <= rhi; ++r) {
        const float v = s_corr[r][c - r];
        if (v >= best) { best = v; br = r; }   // ties: the larger row
      }
      if (best > NEG) merge_max(col_acc + jb + c, best, r0 + br);
    }
    __syncthreads();
  }
}

__global__ void unpack(const unsigned long long* __restrict__ acc, int n,
                       float* __restrict__ corr, int* __restrict__ idx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  const unsigned long long key = acc[x];
  const float v = unordered(static_cast<unsigned int>(key >> 32));
  const bool hit = v > NEG;
  corr[x] = hit ? v : NEG;
  idx[x] = hit ? static_cast<int>(key & 0xffffffffu) : -1;
}

template <typename T>
void launch_sweep(const void* df_i, const void* dg_i, const void* invn_i,
                  const void* df_j, const void* dg_j, const void* invn_j,
                  const float* cov0, int rows, int n_diag, int jp, int k_start,
                  int k_end, int l_i, int l_j, int jpad,
                  unsigned long long* row_acc, unsigned long long* col_acc,
                  cudaStream_t stream) {
  const int blocks = (n_diag + DB - 1) / DB;
  natsa_sweep<T><<<blocks, DB, 0, stream>>>(
      static_cast<const T*>(df_i), static_cast<const T*>(dg_i),
      static_cast<const T*>(invn_i), static_cast<const T*>(df_j),
      static_cast<const T*>(dg_j), static_cast<const T*>(invn_j), cov0, rows,
      n_diag, jp, k_start, k_end, l_i, l_j, jpad, row_acc, col_acc);
}

}  // namespace

// Plain C interface (bound with ctypes). `dtype`: 0 = f32, 1 = bf16, 2 = f16
// for the six streams; cov0 is f32. `row_acc` (rows,) and `col_acc`
// (col_len,) are packed accumulators the caller initialised to the packed
// (NEG, -1) key; corr/idx (rows,) and col_corr/col_idx (col_len,) receive the
// unpacked result. Launches on `stream`, does not synchronise, allocates
// nothing. Returns cudaGetLastError() after the launches.
extern "C" int natsa_mp_rowmax_ab(
    int dtype, const void* df_i, const void* dg_i, const void* invn_i,
    const void* df_j, const void* dg_j, const void* invn_j, const void* cov0,
    int rows, int n_diag, int jp, int k_start, int k_end, int l_i, int l_j,
    int jpad, int col_len, void* row_acc, void* col_acc, void* corr,
    void* idx, void* col_corr, void* col_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* racc = static_cast<unsigned long long*>(row_acc);
  auto* cacc = static_cast<unsigned long long*>(col_acc);
  const float* c0 = static_cast<const float*>(cov0);
  if (n_diag > 0) {
    switch (dtype) {
      case 0:
        launch_sweep<float>(df_i, dg_i, invn_i, df_j, dg_j, invn_j, c0, rows, n_diag, jp,
                            k_start, k_end, l_i, l_j, jpad, racc, cacc, s);
        break;
      case 1:
        launch_sweep<__nv_bfloat16>(df_i, dg_i, invn_i, df_j, dg_j, invn_j, c0, rows, n_diag,
                                    jp, k_start, k_end, l_i, l_j, jpad, racc, cacc, s);
        break;
      case 2:
        launch_sweep<__half>(df_i, dg_i, invn_i, df_j, dg_j, invn_j, c0, rows, n_diag, jp,
                             k_start, k_end, l_i, l_j, jpad, racc, cacc, s);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int threads = 256;
  if (rows > 0)
    unpack<<<(rows + threads - 1) / threads, threads, 0, s>>>(
        racc, rows, static_cast<float*>(corr), static_cast<int*>(idx));
  if (col_len > 0)
    unpack<<<(col_len + threads - 1) / threads, threads, 0, s>>>(
        cacc, col_len, static_cast<float*>(col_corr), static_cast<int*>(col_idx));
  return static_cast<int>(cudaGetLastError());
}
