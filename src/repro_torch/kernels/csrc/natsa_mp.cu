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
// Design: register tiles of diagonals, reduced along the warp.
//   * A block is one warp. Lane t owns DPT = 4 consecutive diagonals
//     k = kb + DPT*t + q and carries their covariances in registers, row by
//     row, with the expression and order of the TPU kernel's recurrence.
//   * The lanes walk the rows skewed in time: at step s lane t is at row
//     i = s - t. Row i then reaches lane t one step after lane t-1 finished
//     its cells, and column j reaches lane t in the very step in which lane
//     t+1 finished its cells of j. So both reductions run along the warp by
//     shuffles and need no shared-memory round trip: the row partial (max,
//     argmax) moves up one lane per step and leaves lane 31 complete; the
//     column partial moves down one lane every DPT-1 steps and leaves lane
//     0 complete. Inside a lane the DPT cells of a row merge in registers,
//     and a ring of DPT column partials in registers completes one column
//     per step. There is no shared-memory atomic: on sm_90a a 64-bit
//     atomicMax on shared memory compiles to a compare-and-swap loop
//     (ATOMS.CAST.SPIN.64 in `cuobjdump -sass`), not to one instruction.
//   * j side: a lane's cells at step s read DPT consecutive j entries, and
//     step s+1 reads the same window shifted by one, so each step loads ONE
//     new (df, dg, invn) triple per lane, as one 16-byte shared load at
//     lane stride 16*(DPT-1) bytes (no bank conflicts); DPT steps are
//     unrolled so that the window rotates through registers by renaming.
//     i side: lane t reads row s - t, consecutive 16-byte entries.
//   * Masks are out of the cell path. Staging writes invn as NaN where the
//     cell lies outside the rectangle (i >= l_i, j outside [0, l_j)) or the
//     window is missing (invn < 0), and a diagonal at or past k_end or
//     n_diag starts from a NaN covariance. A NaN correlation never passes a
//     `>=`, so its cell drops out (exact under -O3 without fast math; the
//     build sets none). Rows before the block's first row add zero deltas
//     (zero prepad on the j side, zeroed i side), as the TPU grid's do.
//   * The warp stages TS = 64 steps of the i and j streams in shared memory
//     (upcast to f32: streams may be f32, bf16 or f16; all arithmetic is
//     f32), loading each stage from global memory into registers while the
//     stage before it computes. It buffers the rows and columns that
//     complete in those steps and flushes them once per stage into global
//     packed accumulators (order-preserving float bits high, index low)
//     with atomicMax, skipped when a plain L2 read already shows a key at
//     least as large; a second kernel unpacks them into corr / idx. Flushes
//     are 2 per DB = 128 cells.
//   * Work balance: one warp per 128 diagonals gives ~2000 blocks at
//     n = 262144, ~15 warps per SM, all resident at once (72-81 registers,
//     5 KB of shared memory each); blocks start longest first.
//
// Bound on this card: the function's FP32 operations (~9 per cell) put
// its floor at the FP32 rate; the bytes are MBs against ~1e10 cells. The
// kernel issues ~14.5 instructions per cell: per lane-step of 4 cells, 20
// FP32 for the recurrence and the correlations, 26 compares and selects
// for the two sides, 4 shuffles, 2 shared loads and the bookkeeping (four
// rotations of DPT steps per loop trip). What holds it below that issue
// rate is latency: a warp's step waits on its shuffles and its compare
// chains, and at 128 diagonals per warp a sweep has only ~2-4 warps per
// scheduler to cover the wait. `chip_smoke.py` times the kernel at 1, 2
// and 4 warps per SM (`warps_per_sm_probe`).
//
// Tie order: the larger index wins an exact tie (largest j on the row side,
// largest i on the column side), within the warp by the order of the chains
// and across blocks by the packed atomicMax, so the result is the key max
// over all cells, bitwise the same from launch to launch; the TPU kernel
// keeps the earlier tile. Indices may differ at exact ties.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DPT = 4;                  // diagonals per lane
constexpr int DB = 32 * DPT;            // diagonals per block (one warp)
constexpr int TS = 64;                  // steps per stage
constexpr int NI = TS + 32;             // i window: rows s0-31 .. s0+TS-1
constexpr int NJ = TS + 32 * (DPT - 1);  // j window of a stage
constexpr float NEG = -2.0f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(TS % 32 == 0 && TS % DPT == 0 && NJ % 32 == 0,
              "a stage is whole lanes and whole rotations");

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

__device__ __forceinline__ unsigned long long packed_key(float v, int idx) {
  return (static_cast<unsigned long long>(ordered(v)) << 32) | static_cast<unsigned int>(idx);
}

template <typename T>
__global__ void __launch_bounds__(32)
natsa_sweep(const T* __restrict__ df_i, const T* __restrict__ dg_i,
            const T* __restrict__ invn_i, const T* __restrict__ df_j,
            const T* __restrict__ dg_j, const T* __restrict__ invn_j,
            const float* __restrict__ cov0, int rows, int n_diag, int jp,
            int k_start, int k_end, int l_i, int l_j, int jpad,
            unsigned long long* row_acc, unsigned long long* col_acc) {
  // (df, dg, invn, -) of each staged row and j entry: one 16-byte load each
  __shared__ float4 s_i[NI], s_j[NJ];
  // (value bits, index) of the rows leaving lane 31 and the columns leaving
  // lane 0 in this stage
  __shared__ int2 s_row[TS], s_col[TS];

  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * DB;
  const int kb = k_start + d0;          // first diagonal of the block
  // rows where any diagonal of the block has a cell inside the rectangle
  const int lo = max(0, -(kb + DB - 1));
  const int hi = min(min(rows, l_i), l_j - kb);
  if (hi <= lo) return;
  const float qnan = __int_as_float(0x7fffffff);

  float cov[DPT], cv[DPT];
  int ci[DPT];
#pragma unroll
  for (int q = 0; q < DPT; ++q) {
    const int d = d0 + DPT * lane + q;
    cov[q] = (d < n_diag && k_start + d < k_end) ? cov0[d] : qnan;
    cv[q] = NEG;
    ci[q] = 0;
  }
  float rv = NEG;                       // row partial: value, diagonal offset
  int rj = 0;
  float edf[DPT], edg[DPT], einv[DPT];  // the lane's j window
  const int xl = (DPT - 1) * lane;      // lane's offset in the j window
  const int yl = 31 - lane;             // lane's offset in the i window
  int row = lo - lane;                  // lane's row at the current step
  // The stream entries of the next stage are loaded into registers while
  // the current stage computes (global loads take hundreds of cycles); rows
  // before lo and entries past the streams load as (0, 0, -1).
  T gi[3][NI / 32], gj[3][NJ / 32];
  auto load = [&](int s0) {
#pragma unroll
    for (int c = 0; c < NI / 32; ++c) {
      const int i = s0 - 31 + lane + 32 * c;
      const bool in = i >= lo && i < rows;
      gi[0][c] = in ? df_i[i] : T(0.0f);
      gi[1][c] = in ? dg_i[i] : T(0.0f);
      gi[2][c] = in ? invn_i[i] : T(-1.0f);
    }
#pragma unroll
    for (int c = 0; c < NJ / 32; ++c) {
      const int p = s0 + kb + jpad + lane + 32 * c;  // >= 0
      const bool in = p < jp;
      gj[0][c] = in ? df_j[p] : T(0.0f);
      gj[1][c] = in ? dg_j[p] : T(0.0f);
      gj[2][c] = in ? invn_j[p] : T(-1.0f);
    }
  };
  load(lo);
  // the last column leaves lane 0 at step hi + DB - 2
  const int s_end = hi + DB - 1;
  for (int s0 = lo; s0 < s_end; s0 += TS) {
#pragma unroll
    for (int c = 0; c < NI / 32; ++c) {
      const int i = s0 - 31 + lane + 32 * c;
      const float inv = to_f32(gi[2][c]);
      s_i[lane + 32 * c] = make_float4(to_f32(gi[0][c]), to_f32(gi[1][c]),
                                       (i < l_i && inv >= 0.0f) ? inv : qnan, 0.0f);
    }
    const int jb = s0 + kb + jpad;      // flat j of the window's entry 0
#pragma unroll
    for (int c = 0; c < NJ / 32; ++c) {
      const int j = jb + lane + 32 * c - jpad;
      const float inv = to_f32(gj[2][c]);
      s_j[lane + 32 * c] = make_float4(to_f32(gj[0][c]), to_f32(gj[1][c]),
                                       (j >= 0 && j < l_j && inv >= 0.0f) ? inv : qnan, 0.0f);
    }
    __syncwarp();
    if (s0 + TS < s_end) load(s0 + TS);
#pragma unroll
    for (int q = 0; q < DPT - 1; ++q) {
      const float4 nj = s_j[xl + q];
      edf[q] = nj.x;
      edg[q] = nj.y;
      einv[q] = nj.z;
    }

#pragma unroll 4
    for (int u = 0; u < TS; u += DPT) {
#pragma unroll
      for (int w = 0; w < DPT; ++w) {
        const int st = u + w;
        // cell q of this step reads window slot (w + q) % DPT; the new
        // entry is cell DPT-1's
        const int nw = (w + DPT - 1) % DPT;
        const float4 nj = s_j[xl + st + DPT - 1];  // lane stride 16*(DPT-1) B
        edf[nw] = nj.x;
        edg[nw] = nj.y;
        einv[nw] = nj.z;
        const float4 fi = s_i[yl + st];
        const float dfi = fi.x, dgi = fi.y, ii = fi.z;
        float v[DPT];
#pragma unroll
        for (int q = 0; q < DPT; ++q) {
          const int e = (w + q) % DPT;
          cov[q] += dfi * edg[e] + edf[e] * dgi;
          v[q] = cov[q] * ii * einv[e];
        }
        // row side: lane t-1's partial of this row, then this lane's cells
        // in increasing j; `>=` lets the larger j win a tie. (An index
        // beside NEG is never read, so lane 0 resets the value only.)
        const float rin = __shfl_up_sync(FULL, rv, 1);
        rj = __shfl_up_sync(FULL, rj, 1);
        rv = lane == 0 ? NEG : rin;
#pragma unroll
        for (int q = 0; q < DPT; ++q) {
          if (v[q] >= rv) {
            rv = v[q];
            rj = DPT * lane + q;
          }
        }
        // column side: cell q continues the column in ring slot (w + q) %
        // DPT; cell 0 completes its column in this lane, cell DPT-1 starts
        // one from lane t+1's completed partial (its rows are all earlier,
        // so `>=` lets the larger i win a tie)
        const int e0 = w % DPT;
        if (v[0] >= cv[e0]) {
          cv[e0] = v[0];
          ci[e0] = row;
        }
        const float done_v = cv[e0];
        const int done_i = ci[e0];
#pragma unroll
        for (int q = 1; q < DPT - 1; ++q) {
          const int e = (w + q) % DPT;
          if (v[q] >= cv[e]) {
            cv[e] = v[q];
            ci[e] = row;
          }
        }
        const float cin = __shfl_down_sync(FULL, done_v, 1);
        const int iin = __shfl_down_sync(FULL, done_i, 1);
        cv[nw] = lane == 31 ? NEG : cin;
        ci[nw] = iin;
        if (v[DPT - 1] >= cv[nw]) {
          cv[nw] = v[DPT - 1];
          ci[nw] = row;
        }
        if (lane == 31) s_row[st] = make_int2(__float_as_int(rv), rj);  // row s - 31
        if (lane == 0) s_col[st] = make_int2(__float_as_int(done_v), done_i);  // column s + kb
        ++row;
      }
    }
    __syncwarp();
    // flush: all keys first, then all L2 reads, then the atomics that raise
    // a key (an entry left at NEG reads and compares against key 0)
    unsigned long long* addr[2 * (TS / 32)];
    unsigned long long key[2 * (TS / 32)], seen[2 * (TS / 32)];
#pragma unroll
    for (int c = 0; c < TS / 32; ++c) {
      const int x = lane + 32 * c;
      const int i = s0 + x - 31;
      const int2 r = s_row[x], cl = s_col[x];
      const float vr = __int_as_float(r.x), vc = __int_as_float(cl.x);
      addr[2 * c] = vr > NEG ? row_acc + i : row_acc;
      key[2 * c] = vr > NEG ? packed_key(vr, i + kb + r.y) : 0ull;
      addr[2 * c + 1] = vc > NEG ? col_acc + jb + x : col_acc;
      key[2 * c + 1] = vc > NEG ? packed_key(vc, cl.y) : 0ull;
    }
    // a stale read is never above the true value, so the skip is safe
#pragma unroll
    for (int c = 0; c < 2 * (TS / 32); ++c) seen[c] = __ldcg(addr[c]);
#pragma unroll
    for (int c = 0; c < 2 * (TS / 32); ++c)
      if (key[c] > seen[c]) atomicMax(addr[c], key[c]);
    __syncwarp();
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
  natsa_sweep<T><<<blocks, 32, 0, stream>>>(
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

// The launch shape of the sweep kernel: threads per block, diagonals per
// block, steps per stage and dynamic shared memory in bytes (none).
extern "C" void natsa_mp_launch_shape(int* out) {
  out[0] = 32;
  out[1] = DB;
  out[2] = TS;
  out[3] = 0;
}
