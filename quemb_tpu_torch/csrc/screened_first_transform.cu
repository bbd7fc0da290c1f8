// Screened first quarter transform of a density-fitting factor, FP32,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel quemb_tpu/ops/pallas_df.py:_kernel.  It computes
//
//     out[r, i] = sum over kept blocks k of
//                 sum_{nu in [16k, 16k+16), nu < nao} B[r, nu] * TA[nu, i]
//
// with B the factor [naux, nao, nao] seen as [rows = naux*nao, nao], TA the
// embedding basis [nao, nemb] and out [rows, nemb], all row-major f32 in
// their natural layout (no transpose, no padding of rows or of nemb).  The
// kept 16-AO nu blocks arrive as a compacted list; the loop runs over that
// list only, so the columns of B in a skipped block are never read.  (The
// TPU kernel computed every block and multiplied it by the mask.)
//
// What bounds it: bytes.  At octane (naux 777, nao 58, nemb 40-41) one call
// reads about 10.5 MB of B and writes about 7.6 MB for about 0.22 GFLOP,
// roughly 12 FLOP/byte, below the H100's f32 ridge of about 20 (67 TFLOP/s
// over 3.35 TB/s).  So skipping blocks saves bytes, and a tile of B is read
// from device memory once per 64-column tile of the output (once in all
// while nemb <= 64).
//
// Design, simple first: one thread block of 256 threads per 64 x 64 output
// tile; for each kept block it stages B[rows, nu0:nu0+16] (64 contiguous
// bytes per row) and TA[nu0:nu0+16, cols] in shared memory, and each thread
// accumulates a 4 x 4 register tile with FP32 FMAs.  No TF32 and no tensor
// cores: the TPU kernel ran at Precision.HIGHEST.  Ragged edges (rows,
// columns and the nu tail when nao is not a multiple of 16) are masked.

#include <cuda_runtime.h>

namespace {

constexpr int NU_BLOCK = 16;   // AOs per screening block (= tile depth)
constexpr int TILE_M = 64;     // output rows per thread block
constexpr int TILE_N = 64;     // output columns per thread block
constexpr int THREADS = 256;
constexpr int MICRO = 4;       // each thread owns MICRO x MICRO outputs
constexpr int MAX_BLOCKS = 512;  // nao <= 8192

// The kept-block list travels by value in the kernel's parameter space: no
// device allocation and no host-to-device copy before the launch.
struct BlockList {
  int n;
  int idx[MAX_BLOCKS];
};

__global__ void __launch_bounds__(THREADS)
screened_first_transform_kernel(const float* __restrict__ B,
                                const float* __restrict__ TA,
                                const __grid_constant__ BlockList kept,
                                float* __restrict__ out,
                                int rows, int nao, int nemb) {
  // B tile stored nu-major so the inner loop reads a row vector; +4 pads
  // the rows apart in the shared-memory banks
  __shared__ float b_tile[NU_BLOCK][TILE_M + 4];
  __shared__ float ta_tile[NU_BLOCK][TILE_N];

  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * TILE_M;
  const int col0 = blockIdx.y * TILE_N;
  // thread (ty, tx) owns rows ty + 16 a and columns tx + 16 b, a, b < 4
  const int ty = tid / (TILE_N / MICRO);
  const int tx = tid % (TILE_N / MICRO);

  float acc[MICRO][MICRO];
#pragma unroll
  for (int a = 0; a < MICRO; ++a)
#pragma unroll
    for (int b = 0; b < MICRO; ++b) acc[a][b] = 0.0f;

  for (int k = 0; k < kept.n; ++k) {
    const int nu0 = kept.idx[k] * NU_BLOCK;
    // 64 rows x 16 nu of B: 16 neighbouring threads read one row's 64 bytes
#pragma unroll
    for (int l = 0; l < TILE_M * NU_BLOCK / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / NU_BLOCK;
      const int c = e % NU_BLOCK;
      const long long row = row0 + r;
      const int nu = nu0 + c;
      b_tile[c][r] =
          (row < rows && nu < nao) ? B[row * nao + nu] : 0.0f;
    }
    // 16 nu x 64 columns of TA
#pragma unroll
    for (int l = 0; l < NU_BLOCK * TILE_N / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / TILE_N;
      const int c = e % TILE_N;
      const int nu = nu0 + r;
      const int col = col0 + c;
      ta_tile[r][c] = (nu < nao && col < nemb)
                          ? TA[static_cast<long long>(nu) * nemb + col]
                          : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < NU_BLOCK; ++kk) {
      float av[MICRO], bv[MICRO];
#pragma unroll
      for (int a = 0; a < MICRO; ++a) av[a] = b_tile[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < MICRO; ++b) bv[b] = ta_tile[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < MICRO; ++a)
#pragma unroll
        for (int b = 0; b < MICRO; ++b)
          acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < MICRO; ++a) {
    const long long row = row0 + ty + 16 * a;
    if (row >= rows) continue;
#pragma unroll
    for (int b = 0; b < MICRO; ++b) {
      const int col = col0 + tx + 16 * b;
      if (col < nemb) out[row * nemb + col] = acc[a][b];
    }
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.
//   B       device f32 [rows, nao], contiguous (the factor [naux, nao, nao])
//   TA      device f32 [nao, nemb], contiguous
//   blocks  HOST int32 [nkept], indices of the kept 16-AO nu blocks
//   out     device f32 [rows, nemb], contiguous; every element is written
//   stream  the cudaStream_t to launch on
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int screened_first_transform_f32(const void* B, const void* TA,
                                            const void* blocks, int nkept,
                                            void* out, int rows, int nao,
                                            int nemb, void* stream) {
  if (rows <= 0 || nao <= 0 || nemb <= 0 || nkept < 0 ||
      nkept > MAX_BLOCKS || (nkept > 0 && blocks == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockList kept;
  kept.n = nkept;
  const int* src = static_cast<const int*>(blocks);
  const int nblk = (nao + NU_BLOCK - 1) / NU_BLOCK;
  for (int k = 0; k < nkept; ++k) {
    if (src[k] < 0 || src[k] >= nblk) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    kept.idx[k] = src[k];
  }
  const dim3 grid((rows + TILE_M - 1) / TILE_M,
                  (nemb + TILE_N - 1) / TILE_N);
  screened_first_transform_kernel<<<grid, THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(B), static_cast<const float*>(TA), kept,
      static_cast<float*>(out), rows, nao, nemb);
  return static_cast<int>(cudaGetLastError());
}
