// Batched symmetric eigensolver, float64, for matrices of order n <= 64,
// hand-written for Hopper (sm_90a): cyclic two-sided Jacobi, one launch a
// batch.
//
// It replaces no TPU kernel.  It stands in for torch.linalg.eigh on the
// card, which profiling showed to bound the fragment SCF
// (quemb_tpu_torch/embed/fragment_scf.py): cuSOLVER's syevd solves a batch
// one matrix at a time, each a tridiagonal reduction, divide and conquer
// and a back-transform in about a hundred small launches, and the host
// then reads its error flags back.  quemb_tpu_torch/ops/jacobi_eigh.py
// binds it and holds its arithmetic in plain torch (jacobi_eigh_plain).
//
// What bounds it.  Not bytes (n^2 doubles in and out, 32 KB at n = 64) and
// not operations (a sweep is about 8 n^3 flop, 2 MFLOP at n = 64):
// latency.  A sweep is m - 1 steps that depend on each other (m the order
// rounded up to even), a matrix takes 6-9 sweeps, and each step is a
// rotation's arithmetic (a hypot, a division and a reciprocal square root
// in float64), a block-wide barrier, a pass over A and V in shared memory
// and a second barrier.  The pass over A alone reads and writes 2 m^2
// doubles, 54 KB at m = 58, about 420 cycles at the SM's 128 bytes a
// cycle.  So a matrix takes about (m - 1) x sweeps such steps whatever the
// card's peak.  What the design does about that:
// - one launch for the whole batch and nothing read back by the host;
// - A and V stay in shared memory from the first load to the last store;
// - the k = m / 2 pairs of a step always sit in adjacent slots (2i, 2i+1):
//   between steps the rows and columns move to the slots of the next
//   step's pairs (the circle method of round-robin scheduling: slot 0
//   stays, the others move one place round a cycle of the other m - 1
//   slots), so a thread reads a 2x2 block as two 16-byte loads with no
//   index table, and after m - 1 steps every index is back in its own
//   slot;
// - A and V are double-buffered: a step reads one copy and writes the
//   moved result into the other, so it needs two barriers, one after the
//   rotations are known and one after the pass;
// - a step applies its k rotations to A in 2x2 blocks, block (i, j)
//   becoming R_i^T A_ij R_j, one thread a block, rows and columns in one
//   pass, and the k threads that computed the rotations write the diagonal
//   blocks themselves;
// - V's rows are split over several blocks of the grid for one matrix
//   (ROWS rows each): every such block holds all of A and repeats the same
//   arithmetic on it bit for bit (the same code on the same data), so they
//   stop after the same sweep with no word between them, and each rotates
//   only its own rows of V.  This takes the V half of each step's pass off
//   the critical path where the batch leaves SMs idle;
// - each block decides by itself when to stop: a block reduction of the
//   off-diagonal norm after each sweep against tol x ||A||_F.
//
// The method.  The lower triangle is read and mirrored (what
// torch.linalg.eigh reads).  An odd order is padded by one row and column,
// zero off the diagonal, so every rotation with the pad is the identity and
// the pad never mixes in.  Each rotation is the symmetric Schur
// decomposition of its 2x2 block (Golub and Van Loan, Algorithm 8.4.1),
// written without the quotient tau: with d = a_qq - a_pp and e = 2 a_pq,
// t = sign(d) e / (|d| + hypot(d, e)), c = 1 / sqrt(1 + t^2), s = t c, then
// a_pp -= t a_pq, a_qq += t a_pq and a_pq = 0.  At the end each
// eigenvalue's rank (ascending, NaN last, ties by index) places it and its
// eigenvector column in the output.  The number of sweeps of each matrix
// goes to a small device output.  A matrix whose squared Frobenius norm is
// not finite (a NaN or an infinity, or entries beyond about 1e150) gets NaN
// eigenvalues and eigenvectors.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_N = 64;
constexpr int MAX_PAIRS = MAX_N / 2;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_DEVICES = 64;
// rows of V a block rotates, where the batch leaves SMs for more blocks
constexpr int ROWS = 8;
// shared memory at the largest order, A and all of V double-buffered
constexpr int SMEM_MAX = 4 * MAX_N * MAX_N * static_cast<int>(sizeof(double));

// Sum of x over the block, returned to every thread.  blockDim.x is a
// multiple of 32; red holds a partial sum per warp.
__device__ double block_sum(double x, double* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double t = 0.0;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) t += red[i];
  __syncthreads();
  return t;
}

// Squared off-diagonal norm of the m x m matrix a (row-major).
__device__ double off_norm2(const double* a, int m, double* red) {
  double x = 0.0;
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
    const int i = e / m;
    if (i != e - i * m) x += a[e] * a[e];
  }
  return block_sum(x, red);
}

// The slot that the index in slot s moves to after a step, for k pairs:
// slot 0 stays; top 2i -> 2i + 2, the last top -> the last bottom,
// bottom 2i + 1 -> 2i - 1, bottom 1 -> top 2.
__device__ __forceinline__ int next_slot(int s, int k) {
  if (s == 0 || k == 1) return s;
  if ((s & 1) == 0) return s + 2 < 2 * k ? s + 2 : 2 * k - 1;
  return s > 1 ? s - 2 : 2;
}

// Total order for the ranks: ascending, NaN after every number.
__device__ bool before(double x, double y) {
  return x < y || (isnan(y) && !isnan(x));
}

__device__ bool same(double x, double y) {
  return x == y || (isnan(x) && isnan(y));
}

// Grid: (matrices, blocks a matrix).  Block y of a matrix rotates rows
// [y * rows, min(n, (y + 1) * rows)) of V; block 0 writes w and sweeps.
__global__ void __launch_bounds__(MAX_THREADS)
jacobi_eigh_kernel(const double* __restrict__ A, double* __restrict__ w,
                   double* __restrict__ V, int* __restrict__ sweeps, int n,
                   int rows, int max_sweeps, double tol) {
  extern __shared__ double2 smem2[];
  __shared__ double2 cs[MAX_PAIRS];
  __shared__ int src[MAX_N];
  __shared__ double red[MAX_WARPS];

  const int m = n + (n & 1);  // even order; an odd n gets a decoupled pad
  const int k = m / 2;        // rotations a step
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, n - r0);  // rows of V this block rotates
  double* smem = reinterpret_cast<double*>(smem2);
  double* a = smem;                 // [m][m], slot order
  double* an = smem + m * m;        // the other copy
  double* v = smem + 2 * m * m;     // [nr][m], columns in slot order
  double* vn = v + rows * m;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;
  const double* Ab = A + b * n * n;

  double sq = 0.0;
  for (int e = tid; e < m * m; e += nt) {
    const int i = e / m, j = e - i * m;
    double x = 0.0;
    if (i < n && j < n) x = i >= j ? Ab[i * n + j] : Ab[j * n + i];
    a[e] = x;
    sq += x * x;
  }
  for (int e = tid; e < nr * m; e += nt) {
    const int r = e / m;
    v[e] = r0 + r == e - r * m ? 1.0 : 0.0;
  }
  const double norm2 = block_sum(sq, red);  // its barrier publishes a, v
  if (!isfinite(norm2)) {
    for (int e = tid; e < nr * n; e += nt) V[(b * n + r0) * n + e] = nan("");
    if (blockIdx.y == 0) {
      for (int e = tid; e < n; e += nt) w[b * n + e] = nan("");
      if (tid == 0) sweeps[b] = 0;
    }
    return;
  }
  const double thr2 = tol * tol * norm2;
  double off2 = off_norm2(a, m, red);
  int sweep = 0;
  while (off2 > thr2 && sweep < max_sweeps) {
    for (int step = 0; step < m - 1; ++step) {
      if (tid < k) {
        // the rotation of pair tid, and its diagonal block, moved
        const int p = 2 * tid, q = p + 1;
        const double app = a[p * m + p], aqq = a[q * m + q];
        const double apq = a[p * m + q];
        const double d = aqq - app, e = 2.0 * apq;
        double t = 0.0;
        if (e != 0.0) t = (d >= 0.0 ? e : -e) / (fabs(d) + hypot(d, e));
        const double c = rsqrt(1.0 + t * t);
        cs[tid] = make_double2(c, t * c);
        const int np = next_slot(p, k), nq = next_slot(q, k);
        an[np * m + np] = app - t * apq;
        an[nq * m + nq] = aqq + t * apq;
        an[np * m + nq] = 0.0;
        an[nq * m + np] = 0.0;
      }
      __syncthreads();
      // A <- J^T A J, block (i, j) <- R_i^T A_ij R_j, R = [[c, s], [-s, c]]
      for (int e = tid; e < k * k; e += nt) {
        const int i = e / k, j = e - i * k;
        if (i == j) continue;
        const double2 ri = cs[i], rj = cs[j];
        const double2* a2 = reinterpret_cast<const double2*>(a);
        const double2 x0 = a2[i * m + j];              // rows 2i, 2i + 1,
        const double2 x1 = a2[(2 * i + 1) * m / 2 + j];  // columns 2j, 2j + 1
        const double y00 = ri.x * x0.x - ri.y * x1.x;
        const double y01 = ri.x * x0.y - ri.y * x1.y;
        const double y10 = ri.y * x0.x + ri.x * x1.x;
        const double y11 = ri.y * x0.y + ri.x * x1.y;
        const int pi = next_slot(2 * i, k), qi = next_slot(2 * i + 1, k);
        const int pj = next_slot(2 * j, k), qj = next_slot(2 * j + 1, k);
        an[pi * m + pj] = y00 * rj.x - y01 * rj.y;
        an[pi * m + qj] = y00 * rj.y + y01 * rj.x;
        an[qi * m + pj] = y10 * rj.x - y11 * rj.y;
        an[qi * m + qj] = y10 * rj.y + y11 * rj.x;
      }
      // V <- V J, columns moved
      for (int e = tid; e < nr * k; e += nt) {
        const int r = e / k, i = e - r * k;
        const double2 ri = cs[i];
        const double2 x = reinterpret_cast<const double2*>(v)[(r * m) / 2 + i];
        vn[r * m + next_slot(2 * i, k)] = x.x * ri.x - x.y * ri.y;
        vn[r * m + next_slot(2 * i + 1, k)] = x.x * ri.y + x.y * ri.x;
      }
      __syncthreads();
      double* t = a;
      a = an;
      an = t;
      t = v;
      v = vn;
      vn = t;
    }
    ++sweep;
    off2 = off_norm2(a, m, red);
  }

  // after whole sweeps every index is back in its own slot; ascending
  // order: eigenvalue i goes to its rank, src[rank] = i
  if (tid < n) {
    const double dd = a[tid * m + tid];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const double dj = a[j * m + j];
      r += before(dj, dd) || (same(dj, dd) && j < tid);
    }
    src[r] = tid;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int e = tid; e < n; e += nt) w[b * n + e] = a[src[e] * m + src[e]];
    if (tid == 0) sweeps[b] = sweep;
  }
  for (int e = tid; e < nr * n; e += nt) {
    const int r = e / n, c = e - r * n;
    V[(b * n + r0 + r) * n + c] = v[r * m + src[c]];
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.
//   A           device f64 [batch, n, n], contiguous; the lower triangle
//               is read
//   w           device f64 [batch, n], eigenvalues ascending
//   V           device f64 [batch, n, n], eigenvectors in the columns
//   sweeps      device int32 [batch], sweeps each matrix took
//   max_sweeps  the cap on sweeps; tol the relative off-diagonal norm at
//               which a matrix stops
//   stream      the cudaStream_t to launch on, of the current device
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int jacobi_eigh_f64(const void* A, void* w, void* V, void* sweeps,
                               int batch, int n, int max_sweeps, double tol,
                               void* stream) {
  if (batch <= 0 || n <= 0 || n > MAX_N || max_sweeps < 0 || !(tol >= 0.0))
    return static_cast<int>(cudaErrorInvalidValue);
  // the attribute and the SM count are per device: read once on each
  static bool set[MAX_DEVICES] = {};
  static int nsm[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!set[dev]) {
    err = cudaFuncSetAttribute(jacobi_eigh_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&nsm[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    set[dev] = true;
  }
  const int m = n + (n & 1), k = m / 2;
  // split V's rows over blocks of ROWS while the batch leaves SMs idle
  int parts = (n + ROWS - 1) / ROWS;
  const int room = nsm[dev] / batch;
  if (parts > room) parts = room > 1 ? room : 1;
  const int rows = (n + parts - 1) / parts;
  parts = (n + rows - 1) / rows;
  int work = k * k > rows * k ? k * k : rows * k;
  int threads = (work + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const int smem = 2 * (m * m + rows * m) * static_cast<int>(sizeof(double));
  const dim3 grid(batch, parts);
  jacobi_eigh_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(A), static_cast<double*>(w),
      static_cast<double*>(V), static_cast<int*>(sweeps), n, rows,
      max_sweeps, tol);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's attributes as loaded on the current device, for the build
// check of a process that found the library already built (ptxas prints
// nothing then): registers a thread, local-memory bytes a thread (register
// spills land there; the kernel has no local arrays), and static shared
// bytes a block.  Returns the CUDA error, 0 on success.
extern "C" int jacobi_eigh_attributes(int* regs, int* local_bytes,
                                      int* static_smem) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, jacobi_eigh_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
