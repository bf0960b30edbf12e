// Cholesky factor and its inverse of one small SPD matrix, for Hopper
// (sm_90a): a blocked (panel) right-looking factorization in one launch, on
// one thread block or on one thread block cluster.
//
// Replaces the Pallas TPU kernel zhusuan_tpu/ops/linalg.py::_chol_inv_kernel
// (pallas_call at :110, entry cholesky_inverse :134-153): for one [n, n]
// float32 symmetric positive-definite A, n <= 512, L lower-triangular with
// zeros above (A = L L^T) and L^{-1} lower-triangular with zeros above, in
// one launch. The sparse-GP step (SVGP's inducing Gram matrix, n = 100) calls
// it once per training step, and everything downstream whitens by matmuls.
//
// Algorithm. One lower-triangular working matrix W holds both the Schur
// complement M and the running inverse X: before the panel of columns
// J = [j0, j0 + 16) is taken, the columns c < j0 of W hold X (forward
// substitution of L X = I as far as it has come) and the columns k >= j0
// hold M. With I the rows below J, a panel is three steps:
//   1. diagonal block, one warp, no block barrier: M_JJ = L11 L11^T by the
//      column recurrence, a row per lane in registers, the pivots and
//      columns passed by warp shuffles; the pivot test (> 0, finite) happens
//      here;
//   2. panel rows, a thread per row or column, no dependence between them:
//      L21 = M_IJ L11^{-T} for the rows below (each row its own 16-step
//      forward substitution in registers), and rows J of the inverse,
//      X_J,c<j0 = L11^{-1} W_J,c<j0 and X_JJ = X11 = L11^{-1} I (each column
//      the same substitution; final: written out at once). Substitution,
//      not a product with an explicit X11: on an inducing Gram matrix of
//      condition 1e8 the product's residual, cond(L11) eps, is larger than
//      the jitter that keeps the next pivots positive;
//   3. one rank-16 update of everything below the panel: with
//      V = [ X_J (columns < j0 + 16) | L21^T (columns beyond) ], 16 x n,
//      W[i][e] -= sum_p V[p][i] V[p][e] for every row i in I over e <= i
//      (the panel's own columns start from 0: X was 0 there). A thread owns
//      an 8 x 4 patch of W and reads V as float4 (update_patch).
//      The 16 columns are subtracted from W one after the other and not
//      summed first: on a Gram matrix of crowded points the entries shrink
//      by orders of magnitude along the panel and the roundings with them,
//      where a sum of 16 products rounds 16 times at the entry's first size,
//      enough to turn a pivot of 1e-6 negative.
// That is ceil(n / 16) dependent steps of three barriers, where the first
// version of this kernel took n steps of two (200 barriers at n = 100, now
// 21), and step 3 is a small matrix product.
//
// FP32 CUDA cores, not the tensor cores: wgmma/mma take float32 only as TF32
// (about three decimal digits), which cannot hold L within 2e-5 on Gram
// matrices of condition 4e3-1e8. This source alone is built with FMA
// contraction on (ops/_build.py): it is compared with a library
// factorization, which rounds differently anyway, never bit for bit.
//
// What bounds it on an H100: the work is about n^3/3 multiply-subtracts
// (0.67 MFLOP at n = 100), a few ns at 67 TFLOP/s, and it moves 3 n^2
// floats. The real floor is the chain of dependent pivots (reciprocal
// square root, multiply, shuffle, multiply-subtract; rsqrtf, 2 ulp, where
// sqrtf and a division would double the chain). Measured with clock64 at
// n = 100 on one block, a panel takes about 8,500 cycles: step 1 3,200 (its
// loop 1,800, 110 a column, which is that chain: a lane for every row, two
// lanes a row, or every lane factoring the whole block by itself all came
// to the same; loading and storing the block and the barrier are the rest),
// step 2 2,600, step 3 2,000. On a cluster of 8 at n = 512 a panel takes
// 15,600, a third of it the two cluster barriers and the reads back from L2
// behind them.
//
// Memory and blocks. W is cut into row panels of 16 rows; row panel P keeps
// (P + 1) 16 + 4 floats a row (its lower part, the diagonal block whole) in
// dynamic shared memory, beside V and L11. One block holds all of it up to
// n = 304 (19 panels, 215 KB of the 227 KB a block may have). Above that,
// and wherever it is faster (from n = 113 on), the kernel runs as ONE thread
// block cluster of up to 8 blocks on neighbouring SMs: block r owns the row
// panels P = r (mod blocks) in its own shared memory (114 KB a block at
// n = 512), step 1 and the rows J run in the block that owns panel J, every
// block computes L21 for its own rows and updates them in step 3, and the
// hardware cluster barrier takes the block barrier's place between the
// steps. L11, X_J and L21 are outputs anyway (rows of L^{-1}, columns of L),
// so the blocks pass them through the output arrays in L2: written before a
// cluster barrier (release), read after it (acquire, ld.cg) into each
// block's own shared memory. (Writing them into every block's shared memory
// instead, through the cluster's distributed shared memory, was measured and
// lost: 128 remote stores a thread cost more than the read back from L2.)
//
// Non-SPD input: no clamp. When any pivot is <= 0 or not finite, the kernel
// writes L = NaN on and below the diagonal (0 above) and L^{-1} = NaN
// everywhere, the pattern of the JAX package's reference path (Cholesky, then
// a triangular solve), with no host sync. The TPU kernel clamps the pivot at
// 1e-30 and returns finite garbage instead. The failed panel's owner marks
// L11[0][0] NaN, which every thread of every block reads with L11.
//
// A shared library with a plain C interface (nvcc, loaded through ctypes); the
// entries return the launch's CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kB = 16;  // panel width
constexpr int kThreads = 512;
constexpr int kMaxN = 512;
constexpr int kTilePitch = kB + 1;  // L11's rows, off the banks' stride
constexpr int kPatchRows = 8;       // step 3's patch: 8 rows by 4 columns
constexpr int kRowPad = 4;          // W's rows likewise (and float4-aligned)
constexpr int kMaxBlocks = 8;       // the portable cluster size
constexpr int kSharedBytesMax = 232448;
// Above this size the automatic choice is a cluster (see blocks_for).
constexpr int kOneBlockMaxN = 112;
constexpr int kMaxDevices = 64;
constexpr unsigned kFullMask = 0xffffffffu;
// Whether chol_inv_kernel's shared-memory limit is raised, per device. Two
// threads may both raise it; setting it twice is harmless.
std::atomic<bool> g_shared_limit_set[kMaxDevices];

// V's row pitch in floats for T panels: every column up to the padded T 16,
// a multiple of 4 (float4 reads) that is 4 or 20 modulo 32, so that the 16
// rows of one column spread over 8 banks.
__host__ __device__ inline int v_pitch(int T) { return T * kB + 4; }

// W's row pitch in row panel P: the lower part, the diagonal block whole.
__host__ __device__ inline int w_pitch(int P) {
  return (P + 1) * kB + kRowPad;
}

// Floats of row-panel storage in block `rank` of `blocks` before its local
// panel lp: local panel k is row panel P = k blocks + rank, 16 rows.
__host__ __device__ inline int panel_offset(int lp, int rank, int blocks) {
  return kB * kB * (blocks * (lp * (lp - 1) / 2) + (rank + 1) * lp) +
         kB * kRowPad * lp;
}

__host__ __device__ inline int local_panels(int T, int rank, int blocks) {
  return rank < T ? (T - rank + blocks - 1) / blocks : 0;
}

// Step 1, by warp 0 of the block that owns row panel `cur`: factors the
// diagonal block (rows and columns j0 .. j0 + bw of W, lower triangle) as
// L11 L11^T by the column recurrence. Lane r < 16 keeps row r of the block in
// registers; lanes 16-31 mirror them and write nothing. Every lane also
// keeps the whole running diagonal (each column of L11 reaches every lane
// anyway), so that the next pivot is at hand without a second shuffle on the
// chain of dependent pivots. Rows beyond bw (the ragged last panel) are those
// of the identity. Writes L11 to l_out and to l11, there with zeros above
// the diagonal and, on it, the RECIPROCALS of L11's (what the substitutions
// of step 2 multiply by); a failed pivot makes both l11[0] and L[j0][j0]
// NaN.
__device__ __forceinline__ void factor_diagonal_block(
    const float* rows, int ld, int j0, int bw, int n, int lane, float* l11,
    float* __restrict__ l_out) {
  const int r = lane & (kB - 1);
  const bool writer = lane < kB && r < bw;
  float t[kB], diag[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    t[k] = (r < bw && k <= r) ? rows[r * ld + j0 + k]
                              : (k == r ? 1.0f : 0.0f);
    diag[k] = k < bw ? rows[k * ld + j0 + k] : 1.0f;
  }
  bool good = true;
  float d = 1.0f;  // this lane's diagonal entry of L11
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const float p = diag[k];
    good = good && p > 0.0f && isfinite(p);
    const float inv = rsqrtf(p);
    t[k] *= inv;  // L11[r][k] for r >= k (d on the diagonal)
    // The update runs on every lane, unpredicated: above the diagonal it
    // changes only entries that are never read and are written out as 0.
#pragma unroll
    for (int m = k + 1; m < kB; ++m) {
      const float lm = __shfl_sync(kFullMask, t[k], m);
      t[m] -= t[k] * lm;
      diag[m] -= lm * lm;
    }
    if (r == k) {
      d = t[k];
      t[k] = inv;
    }
  }
  if (!good && r == 0) t[0] = d = NAN;
  if (lane < kB) {
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      l11[r * kTilePitch + k] = k <= r ? t[k] : 0.0f;
      if (writer && k <= r) l_out[(j0 + r) * n + j0 + k] = k == r ? d : t[k];
    }
  }
}

// Solves L11 x = m in place (16 unknowns in registers) by forward
// substitution; l11 holds the reciprocals on its diagonal.
__device__ __forceinline__ void solve_panel(float (&m)[kB],
                                            const float* l11) {
#pragma unroll
  for (int q = 0; q < kB; ++q) {
    m[q] *= l11[q * kTilePitch + q];
#pragma unroll
    for (int p = q + 1; p < kB; ++p) m[p] -= l11[p * kTilePitch + q] * m[q];
  }
}

// Step 3 on one 8 x 4 patch of W (rows i0.., columns e0.., w its first
// entry, ld its rows' pitch): W -= V[:, i0..]^T V[:, e0..]. The patch starts
// from W (from 0 in the panel's own columns, `from_zero`) and the panel's 16
// columns are subtracted one after the other, as the column recurrence
// would: see the note above. Eight rows, because the rows' entries of V are
// the same for a whole strip of patches (one shared-memory read serves the
// warp) and the columns' are not: 3 float4 reads feed 32 multiply-subtracts.
__device__ __forceinline__ void update_patch(float* w, int ld, const float* V,
                                             int nV, int i0, int e0,
                                             bool from_zero) {
  float acc[kPatchRows][4];
#pragma unroll
  for (int r = 0; r < kPatchRows; ++r) {
    const float4 o = from_zero
                         ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                         : *reinterpret_cast<const float4*>(w + r * ld);
    acc[r][0] = o.x;
    acc[r][1] = o.y;
    acc[r][2] = o.z;
    acc[r][3] = o.w;
  }
#pragma unroll
  for (int p = 0; p < kB; ++p) {
    const float4 a0 = *reinterpret_cast<const float4*>(&V[p * nV + i0]);
    const float4 a1 = *reinterpret_cast<const float4*>(&V[p * nV + i0 + 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&V[p * nV + e0]);
    const float ar[kPatchRows] = {a0.x, a0.y, a0.z, a0.w,
                                  a1.x, a1.y, a1.z, a1.w};
    const float bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int r = 0; r < kPatchRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] -= ar[r] * bs[c];
  }
#pragma unroll
  for (int r = 0; r < kPatchRows; ++r) {
    *reinterpret_cast<float4*>(w + r * ld) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// One launch is `blocks` thread blocks: 1, or one cluster of `blocks`.
__global__ void __launch_bounds__(kThreads)
    chol_inv_kernel(const float* __restrict__ a, int n, int blocks,
                    float* __restrict__ l_out, float* __restrict__ linv_out) {
  extern __shared__ __align__(16) float smem[];
  const int T = (n + kB - 1) / kB;
  const int nV = v_pitch(T);
  float* l11 = smem;                  // [16][17], reciprocal diagonal
  float* V = smem + kB * kTilePitch;  // [16][nV]
  float* W = V + kB * nV;             // this block's row panels
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = blockIdx.x;
  const int nn = n * n;
  const int nl = local_panels(T, rank, blocks);
  auto sync_blocks = [&]() {
    if (blocks > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  };

  // The upper triangles are 0; V's columns beyond n stay 0; W = lower
  // triangle of A (this block's row panels).
  for (int idx = rank * kThreads + tid; idx < nn; idx += blocks * kThreads) {
    const int i = idx / n, k = idx - i * n;
    if (k > i) {
      l_out[idx] = 0.0f;
      linv_out[idx] = 0.0f;
    }
  }
  for (int idx = tid; idx < kB * (nV - n); idx += kThreads) {
    const int p = idx / (nV - n);
    V[p * nV + n + idx - p * (nV - n)] = 0.0f;
  }
  for (int lp = 0; lp < nl; ++lp) {
    const int P = lp * blocks + rank;
    const int ld = w_pitch(P);
    float* rows = W + panel_offset(lp, rank, blocks);
    for (int idx = tid; idx < kB * ld; idx += kThreads) {
      const int r = idx / ld, c = idx - r * ld;
      const int i = P * kB + r;
      rows[idx] = (i < n && c <= i) ? a[i * n + c] : 0.0f;
    }
  }
  __syncthreads();

  bool ok = true;  // uniform over all threads of all blocks
  for (int cur = 0; cur < T; ++cur) {
    const int j0 = cur * kB;
    const int bw = min(kB, n - j0);
    const int owner = cur % blocks;
    if (rank == owner) {
      if (warp == 0) {
        factor_diagonal_block(W + panel_offset(cur / blocks, rank, blocks),
                              w_pitch(cur), j0, bw, n, lane, l11, l_out);
      }
      __syncthreads();
    }
    if (blocks > 1) {
      // The other blocks read L11 back from the output (the reciprocals on
      // the diagonal, as the owner has it).
      cg::this_cluster().sync();
      if (rank != owner && tid < kB * kB) {
        const int k = tid / kB, r = tid - k * kB;
        float v = k == r ? 1.0f : 0.0f;
        if (r < bw && k <= r) {
          v = __ldcg(&l_out[(j0 + r) * n + j0 + k]);
          if (k == r) v = 1.0f / v;
        }
        l11[r * kTilePitch + k] = v;
      }
      __syncthreads();
    }
    ok = ok && !isnan(l11[0]);

    // Step 2, a thread per column or row, every one the same substitution.
    // In the owner, rows J of the inverse: L11 X_J,c = W_J,c for the columns
    // left of the panel, and = I for the panel's own (X11, zeros above).
    if (rank == owner) {
      const float* rows = W + panel_offset(cur / blocks, rank, blocks);
      const int ld = w_pitch(cur);
      const int c = tid;  // j0 + 16 <= 512 = kThreads: one column a thread
      if (c < j0 + kB) {
        float m[kB];
#pragma unroll
        for (int q = 0; q < kB; ++q)
          m[q] = c < j0 ? rows[q * ld + c] : (q == c - j0 ? 1.0f : 0.0f);
        solve_panel(m, l11);
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          if (q < bw && c <= j0 + q) linv_out[(j0 + q) * n + c] = m[q];
        }
        if (blocks == 1) {
#pragma unroll
          for (int q = 0; q < kB; ++q) V[q * nV + c] = m[q];
        }
      }
    }
    if (cur == T - 1) break;  // no rows below the last panel

    // This block's rows below the panel (from the far end of the block: the
    // near end may be at the columns above): L21[i] L11^T = M[i][J].
    const int lp_first = (cur - rank + blocks) / blocks;
    const int lrow = kThreads - 1 - tid;  // at most 304 rows below: one each
    const int row_lp = lp_first + lrow / kB;
    const int row_P = row_lp * blocks + rank;
    if (lrow < (nl - lp_first) * kB && row_P * kB + lrow % kB < n) {
      const int lp = row_lp, P = row_P, r = lrow % kB;
      const int i = P * kB + r;
      const float4* wi = reinterpret_cast<const float4*>(
          W + panel_offset(lp, rank, blocks) + r * w_pitch(P) + j0);
      float m[kB];
#pragma unroll
      for (int q = 0; q < kB / 4; ++q) {
        const float4 w4 = wi[q];
        m[4 * q] = w4.x;
        m[4 * q + 1] = w4.y;
        m[4 * q + 2] = w4.z;
        m[4 * q + 3] = w4.w;
      }
      solve_panel(m, l11);
#pragma unroll
      for (int q = 0; q < kB; ++q) l_out[i * n + j0 + q] = m[q];
      if (blocks == 1) {
#pragma unroll
        for (int q = 0; q < kB; ++q) V[q * nV + i] = m[q];
      }
    }
    if (blocks > 1) {
      // Every block reads the whole of V back from the outputs, 8 loads in
      // flight a thread: rows J of L^{-1} (a warp a row, columns up to the
      // panel's end), then L21 transposed.
      cg::this_cluster().sync();
      constexpr int kBatch = 8;
      const int j1 = j0 + kB;
      {
        const int p = warp;  // 16 warps, 16 rows
        const float* src = linv_out + (j0 + p) * n;
        for (int base = lane; base < j1; base += kBatch * 32) {
          float v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = base + u * 32;
            v[u] = e <= j0 + p ? __ldcg(&src[e]) : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int e = base + u * 32;
            if (e < j1) V[p * nV + e] = v[u];
          }
        }
      }
      for (int base = tid; base < (n - j1) * kB; base += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * kThreads;
          v[u] = idx < (n - j1) * kB
                     ? __ldcg(&l_out[(j1 + idx / kB) * n + j0 + idx % kB])
                     : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = base + u * kThreads;
          if (idx < (n - j1) * kB) V[(idx % kB) * nV + j1 + idx / kB] = v[u];
        }
      }
    }
    __syncthreads();

    // Step 3. This block's strips of 8 rows below the panel, in rising
    // order, have rising numbers of 8 x 4 patches (strip i0 has i0 / 4 + 2:
    // the last one reaches past the diagonal, into entries that are stored
    // and never read), so the first is paired with the last, the second
    // with the last but one: every pair has the same number (a strip beyond
    // the matrix's last row has none, so its pair has fewer), and one
    // division deals the pairs' patches to the threads.
    constexpr int kPerPanel = kB / kPatchRows;
    const int strips = (nl - lp_first) * kPerPanel;
    auto strip_row = [&](int s) {  // first row of this block's strip s
      const int lp = lp_first + s / kPerPanel;
      return (lp * blocks + rank) * kB + (s % kPerPanel) * kPatchRows;
    };
    const int pairs = (strips + 1) / 2;
    const int per_pair =
        strips == 0 ? 1
                    : strip_row(0) / 4 + 2 +
                          (strips > 1 ? strip_row(strips - 1) / 4 + 2 : 0);
    for (int g = tid; g < pairs * per_pair; g += kThreads) {
      const int pair = g / per_pair;
      int f = g - pair * per_pair;
      int s = pair;
      const int na = strip_row(s) / 4 + 2;
      if (f >= na) {
        if (strips - 1 - pair == pair) continue;  // the middle strip, alone
        s = strips - 1 - pair;
        f -= na;
      }
      const int i0 = strip_row(s);
      const int e0 = 4 * f;
      if (i0 >= n || e0 > i0 + 4) continue;
      const int lp = lp_first + s / kPerPanel;
      const int ld = w_pitch(lp * blocks + rank);
      update_patch(W + panel_offset(lp, rank, blocks) +
                       (s % kPerPanel) * kPatchRows * ld + e0,
                   ld, V, nV, i0, e0, e0 >= j0 && e0 < j0 + kB);
    }
    __syncthreads();
  }

  if (!ok) {
    sync_blocks();  // every block's ordinary writes come first
    for (int idx = rank * kThreads + tid; idx < nn;
         idx += blocks * kThreads) {
      const int i = idx / n, k = idx - i * n;
      if (k <= i) l_out[idx] = NAN;
      linv_out[idx] = NAN;
    }
  }
}

// Bytes of dynamic shared memory a block needs (the largest over the ranks).
size_t shared_bytes(int n, int blocks) {
  const int T = (n + kB - 1) / kB;
  int panels = 0;
  for (int rank = 0; rank < blocks; ++rank) {
    const int floats =
        panel_offset(local_panels(T, rank, blocks), rank, blocks);
    if (floats > panels) panels = floats;
  }
  return sizeof(float) *
         (static_cast<size_t>(kB * kTilePitch) + kB * v_pitch(T) + panels);
}

// The blocks of an automatic launch: one block while the matrix is small
// (a cluster barrier costs more than a block barrier, and step 3 is short),
// one cluster of 8 above that.
int blocks_for(int n) { return n <= kOneBlockMaxN ? 1 : kMaxBlocks; }

int launch(const void* a, int n, void* l, void* linv, int blocks,
           void* stream) {
  if (a == nullptr || l == nullptr || linv == nullptr || n < 1 ||
      n > kMaxN || blocks < 0 || blocks > kMaxBlocks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) blocks = blocks_for(n);
  const size_t bytes = shared_bytes(n, blocks);
  if (bytes > static_cast<size_t>(kSharedBytesMax))
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of dynamic shared memory a launch is refused unless the
  // function's limit is raised first: once per device, on its first launch
  // there (a training loop calls this every step).
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_shared_limit_set[device].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(chol_inv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedBytesMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_shared_limit_set[device].store(true, std::memory_order_release);
  }
  const float* af = static_cast<const float*>(a);
  float* lf = static_cast<float*>(l);
  float* xf = static_cast<float*>(linv);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = blocks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = blocks > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&config, chol_inv_kernel, af, n, blocks, lf, xf);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* zs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, l, linv: device pointers to contiguous row-major [n, n] float32 arrays
// (a is read only; l and linv are written; none may overlap). blocks: 0 for
// the kernel's own choice (blocks_for); 1 for one thread block, 2-8 for one
// cluster of that many, the measurements' and the tests' way to every layout
// at every size (a size that does not fit `blocks` is refused). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int zs_cholesky_inverse(const void* a, int n, void* l, void* linv,
                                   int blocks, void* stream) {
  return launch(a, n, l, linv, blocks, stream);
}
