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
// kept 16-AO nu blocks arrive as a compacted host list that travels by
// value in the launch parameters; the columns of B in a skipped block are
// never read.  (The TPU kernel computed every block and multiplied it by the
// mask.)
//
// What bounds it.  Each input byte read once and each output byte written
// once: at octane (naux 777, nao 58, nemb 41, every block kept) 17.85 MB
// for 0.214 GFLOP, 5.3 us at 3.35 TB/s against 3.2 us of FP32 at
// 67 TFLOP/s: bytes, near the ridge, and B (10.5 MB) stays in the 50 MB L2
// across the six calls of a BE construction.  At C40 shapes (naux 3460,
// nao 282, nemb 42, 8 of 18 blocks kept) 0.66 GB for 10.5 GFLOP: 198 us of
// bytes against 157 us of FP32, with B (1.1 GB) far beyond L2.  So the
// kernel has to stream the kept columns of B at the memory's rate and keep
// the arithmetic fed at the same time.  On the card (PERF.md) the octane
// call is held back by fixed latency per tile (staging TA, the first
// copies, the write-back), not by bytes.
//
// Design, and what each part answers.  Times are device microseconds at
// the C40 window on an H100 (700 W) from tools/profile_port.py part
// kernel_parts, which builds each route the design did not take as an
// edit of this file; PERF.md has the runs.
// - Persistent CTAs: the grid is as many 128-thread CTAs as fit on the
//   card at once (occupancy query; two an SM where shared memory allows),
//   each walking the output tiles blockIdx.x, + gridDim.x, ...  A CTA
//   stages the kept rows of TA once per 64-column chunk of the output
//   (once in all while nemb <= 64), not once per tile and block.
// - Copies by the TMA.  Rows of B are only as aligned as nao*4 bytes, so B
//   is handed to the TMA as a 2D tensor of G rows at a time, [rows/G,
//   G*nao], with G the least of 1, 2, 4 that makes the row stride a
//   multiple of 16 bytes.  One 2D load fetches one kept block (from the
//   16-byte boundary at or before it: 20 floats) of one row phase g < G for
//   the whole 128-row tile, into one slot of a 2-slot ring with an
//   mbarrier each; thread 0 issues them.  So the copies of the next step
//   are in flight while the tensor cores work on this one, and no thread
//   spends instructions or shared-memory bandwidth on them.  Columns of a
//   skipped block are never fetched.  Past nao the ragged last block reads
//   on into the next row (finite numbers that meet zero rows of TA) or out
//   of bounds (zeros).  The rows past the last whole group of G (odd nao
//   only) are copied by hand into the last tile.  (Routes not taken: 8-byte
//   cp.async gathers of each row's kept columns, 756 us against 340, and
//   one 1D bulk copy of a row's 20 floats, 531 us.)  Two slots: a deeper
//   ring leaves shared memory for one CTA an SM where two fit, and no
//   measured case gains from it.
// - Steps of KGROUP = 2 kept blocks; a warp computes 32 rows of one row
//   phase, so its rows all start the same distance into their boxes.
// - Tensor cores in 3xTF32: each operand is split into TF32 big and small
//   parts (TA once, when staged; B as it is read) and
//   a_small b_big + a_big b_small + a_big b_big go through mma.sync
//   m16n8k8, 8 AOs at a time from zero, into FP32 sums that round to
//   nearest: the FP32 result to about 1e-6 relative, without the bias of
//   the tensor cores' own truncating accumulation.  Single-pass TF32 is
//   never used.  (Route not taken: FP32 FMAs on the CUDA cores, whose math
//   alone takes 491 us against 301 us for the copies alone, so the FMA
//   rate and not bytes would bound the kernel; this math alone takes
//   266 us.)
// - Output tile 128 rows x (nemb rounded up to 8) columns, the width a
//   template parameter (8 * CN, CN = 1..8); nemb > 64 loops over 64-column
//   chunks.  The tile goes back through the ring slot it was computed from,
//   then to device memory in 16-byte stores, since 128 rows of nemb floats
//   are one aligned span.  (Route not taken: 4-byte stores straight from
//   the accumulator fragments, 462 us.)
// - Accumulate mode (out += ...) lets the host split a kept list whose TA
//   rows do not fit in shared memory over several launches.
// - Where the ring and TA's two TF32 parts leave room for one CTA an SM
//   only (at nemb 42, more than 10 kept blocks), each kept block costs
//   about 1.5 times what it costs with two, and the kernel loses to a
//   library GEMM from about 14 kept blocks of 18 (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <cstdint>

namespace {

constexpr int NU_BLOCK = 16;    // AOs per screening block
constexpr int ROW_TILE = 128;   // rows of B per output tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MT = ROW_TILE / (16 * WARPS);  // m16 tiles a warp
constexpr int KGROUP = 2;       // kept blocks per pipeline step
// width (floats) of a TMA box: a block, fetched from the 16-byte boundary
// at or before its first column; 4 neighbouring box rows fall on distinct
// banks (20 * i mod 32 = 0, 20, 8, 28)
constexpr int BOX_W = NU_BLOCK + 4;
constexpr int BLOCK_TILE = ROW_TILE * BOX_W;  // one block of a tile
constexpr int STAGE_FLOATS = KGROUP * BLOCK_TILE;
constexpr int SMEM_ALIGN = 128;  // alignment of a TMA destination
constexpr int TA_BATCH = 16;    // loads of TA in flight a thread
constexpr int MAX_BLOCKS = 512;  // nao <= 8192
constexpr int STAGES = 2;       // slots of the copy ring
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one CTA

struct Params {
  const float* B;
  const float* TA;
  float* out;
  long long rows;
  int nao, nemb, nk, g, accumulate;
  int slot_floats;  // floats of a ring slot: a step's boxes or the out tile
  int blk[MAX_BLOCKS];
};

// row stride (floats) of TA held transposed in shared memory: the kept
// rows plus 4, so that 8 threads reading 16 bytes each at stride ts hit
// distinct banks
__host__ __device__ constexpr int ta_stride(int nkept) {
  return NU_BLOCK * nkept + 4;
}

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// 2D TMA load of the box at (x, y) of `tmap` into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tmap,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// ---- arithmetic -----------------------------------------------------------

// x rounded to TF32 (10-bit mantissa, nearest, ties away from zero), as
// the bits an mma.sync .tf32 operand takes
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32: the 3xTF32 split
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// d += a b on the tensor cores, m16n8k8, TF32 in and FP32 out
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One kept block of one warp: acc[mt][nt] += B rows (16 mt + [0, 16)) x
// TA columns (8 nt + [0, 8)) over the block's 16 AOs, in 3xTF32:
// a_small b_big + a_big b_small + a_big b_big.  The tensor cores sum each
// 8 AOs from zero, and acc takes that sum in an FP32 add that rounds to
// nearest: their own FP32 accumulation truncates, which over a long sum
// biases it (by about 4e-7 relative at octane, enough to move the f32
// tier's correlation energy by 5e-7 Ha).
//   b    the warp's first B row in the slot, at the block's first AO
//   tb   TA^T big parts at (column gq, the block's first AO + tq), stride ts
//   tsm  the same for the small parts
// The fragments follow the PTX layout of m16n8k8 (gq = lane / 4,
// tq = lane % 4): A rows gq and gq + 8, columns tq and tq + 4; B rows
// (AOs) tq and tq + 4, column gq.
template <int CN>
__device__ __forceinline__ void block_mma(float (&acc)[MT][CN][4],
                                          const float* b, const uint32_t* tb,
                                          const uint32_t* tsm, int ts,
                                          int gq, int tq) {
#pragma unroll
  for (int k8 = 0; k8 < NU_BLOCK; k8 += 8) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* r = b + (16 * mt + gq) * BOX_W + k8 + tq;
      tf32_split(r[0], ab[mt][0], as[mt][0]);
      tf32_split(r[8 * BOX_W], ab[mt][1], as[mt][1]);
      tf32_split(r[4], ab[mt][2], as[mt][2]);
      tf32_split(r[8 * BOX_W + 4], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < CN; ++nt) {
      const int o = nt * 8 * ts + k8;
      const uint32_t bb0 = tb[o], bb1 = tb[o + 4];
      const uint32_t bs0 = tsm[o], bs1 = tsm[o + 4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_tf32(d, as[mt], bb0, bb1);
        mma_tf32(d, ab[mt], bs0, bs1);
        mma_tf32(d, ab[mt], bb0, bb1);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] += d[c];
      }
    }
  }
}

// ---- the kernel -----------------------------------------------------------

template <int CN>
__global__ void __launch_bounds__(THREADS, 2)
screened_first_transform_kernel(const __grid_constant__ CUtensorMap tmap,
                                const __grid_constant__ Params p) {
  constexpr int NEP = 8 * CN;
  extern __shared__ unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int nk = p.nk, nao = p.nao, nemb = p.nemb;
  const int G = p.g;
  const long long rows = p.rows;
  const long long rows_g = rows / G * G;  // rows the tensor map covers
  const int n_rt = static_cast<int>((rows + ROW_TILE - 1) / ROW_TILE);
  const int n_cc = (nemb + NEP - 1) / NEP;
  const int n_tiles = n_rt * n_cc;
  const int nq = max(1, (nk + KGROUP - 1) / KGROUP);
  const int ts = ta_stride(nk);
  const int box_floats = BLOCK_TILE / G;
  // Warp w computes row phase g = w % G: box rows i0 + [0, 16 MT) of that
  // phase, which are tile rows i * G + g.  Their columns start `shift`
  // floats into the boxes.
  const int g = warp % G;
  const int i0 = (warp / G) * 16 * MT;
  const int shift = (g * nao) % 4;

  // shared memory: ring [STAGES][KGROUP][G][ROW_TILE / G][BOX_W] (128-byte
  // aligned) | TA^T big and small parts [2][NEP][ts] | barriers [STAGES] |
  // kept list
  const int slot_floats = p.slot_floats;
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~static_cast<uintptr_t>(SMEM_ALIGN - 1));
  uint32_t* ta_big = reinterpret_cast<uint32_t*>(ring + STAGES * slot_floats);
  uint32_t* ta_small = ta_big + NEP * ts;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ta_small + NEP * ts);
  int* blk_s = reinterpret_cast<int*>(bars + STAGES);

  for (int j = tid; j < nk; j += THREADS) blk_s[j] = p.blk[j];
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int my_tiles =
      static_cast<int>(blockIdx.x) < n_tiles
          ? (n_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;
  const int my_steps = my_tiles * nq;

  // Thread 0: fetch step `step` of this CTA into ring slot `slot`, one box
  // for each kept block of the step and each row phase.  A box holds
  // ROW_TILE / G rows of BOX_W floats; past nao it reads on into the next
  // row (finite numbers that meet zero rows of TA^T) or out of the tensor
  // (zeros).
  auto issue = [&](int step, int slot) {
    if (step >= my_steps) return;
    const int t = blockIdx.x + (step / nq) * gridDim.x;
    const int j0 = (step % nq) * KGROUP;
    const int kb = min(nk, j0 + KGROUP) - j0;
    const int y = (t % n_rt) * (ROW_TILE / G);
    float* dst = ring + slot * slot_floats;
    mbar_arrive_expect_tx(&bars[slot], kb * BLOCK_TILE * 4);
    for (int jj = 0; jj < kb; ++jj)
      for (int gg = 0; gg < G; ++gg)
        tma_load_2d(dst + (jj * G + gg) * box_floats, &tmap,
                    gg * nao - (gg * nao) % 4 + NU_BLOCK * blk_s[j0 + jj], y,
                    &bars[slot]);
  };

  if (tid == 0)
    for (int s = 0; s < STAGES; ++s) issue(s, s);

  float acc[MT][CN][4];
  int cur_chunk = -1;
  for (int step = 0; step < my_steps; ++step) {
    const int t = blockIdx.x + (step / nq) * gridDim.x;
    const int q = step % nq;
    const int chunk = t / n_rt;
    const int c0 = chunk * NEP;
    const long long row0 = static_cast<long long>(t % n_rt) * ROW_TILE;
    const int nr =
        static_cast<int>(min(static_cast<long long>(ROW_TILE), rows - row0));
    const int slot = step % STAGES;
    const int j0 = q * KGROUP;
    const int j1 = min(nk, j0 + KGROUP);

    if (q == 0) {
      if (chunk != cur_chunk) {
        // the kept rows of TA, columns [c0, c0 + NEP), transposed and split
        // into TF32 big and small parts; zero past nao and past nemb
        // (TA_BATCH loads in flight a thread, then their stores)
        const int n_ta = NU_BLOCK * nk * NEP;
        for (int e0 = 0; e0 < n_ta; e0 += TA_BATCH * THREADS) {
          float v[TA_BATCH];
#pragma unroll
          for (int u = 0; u < TA_BATCH; ++u) {
            const int e = e0 + u * THREADS + tid;
            const int kr = e / NEP;
            const int col = c0 + e - kr * NEP;
            const int nu = e < n_ta ? NU_BLOCK * blk_s[kr / NU_BLOCK] +
                                          kr % NU_BLOCK
                                    : nao;
            v[u] = (nu < nao && col < nemb)
                       ? p.TA[static_cast<long long>(nu) * nemb + col]
                       : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < TA_BATCH; ++u) {
            const int e = e0 + u * THREADS + tid;
            const int kr = e / NEP;
            const int cc = e - kr * NEP;
            if (e < n_ta)
              tf32_split(v[u], ta_big[cc * ts + kr], ta_small[cc * ts + kr]);
          }
        }
        cur_chunk = chunk;
        __syncthreads();
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < CN; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;
    }

    mbar_wait(&bars[slot], (step / STAGES) & 1);
    float* slot_s = ring + slot * slot_floats;
    if (row0 + nr > rows_g) {
      // the last rows, past the last whole group of G (odd nao only): by
      // hand, over the zeros the TMA filled in
      const int nl = static_cast<int>(row0 + nr - rows_g);
      const int per = (j1 - j0) * NU_BLOCK;
      for (int e = tid; e < nl * per; e += THREADS) {
        const int r = static_cast<int>(rows_g - row0) + e / per;
        const int jj = (e % per) / NU_BLOCK;
        const int k = e % NU_BLOCK;
        const int nu = NU_BLOCK * blk_s[j0 + jj] + k;
        slot_s[(jj * G + r % G) * box_floats + (r / G) * BOX_W +
               (r % G) * nao % 4 + k] =
            nu < nao ? p.B[(row0 + r) * nao + nu] : 0.0f;
      }
      // these generic writes come before the TMA's next writes to the slot
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    const float* b = slot_s + g * box_floats + i0 * BOX_W + shift;
#pragma unroll 1
    for (int j = j0; j < j1; ++j) {
      const int o = gq * ts + NU_BLOCK * j + tq;
      block_mma<CN>(acc, b + (j - j0) * G * box_floats, ta_big + o,
                    ta_small + o, ts, gq, tq);
    }

    __syncthreads();  // every thread is done with the slot

    if (q == nq - 1) {
      // the tile goes back through the slot: the accumulator fragments
      // (rows gq and gq + 8 of each m tile, columns 2 tq and 2 tq + 1 of
      // each n tile) into [nr][w] there, then to device memory in 16-byte
      // stores, since the tile is one span of nr * nemb floats when w is
      // nemb
      const int w = min(NEP, nemb - c0);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (i0 + 16 * mt + gq + 8 * h) * G + g;
#pragma unroll
          for (int nt = 0; nt < CN; ++nt)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = nt * 8 + 2 * tq + c;
              if (r < nr && col < w)
                slot_s[r * w + col] = acc[mt][nt][2 * h + c];
            }
        }
      __syncthreads();
      float* o = p.out + row0 * nemb + c0;
      if (w == nemb) {
        const int n = nr * nemb;
        float4* o4 = reinterpret_cast<float4*>(o);
        const float4* s4 = reinterpret_cast<const float4*>(slot_s);
        for (int e = tid; e < n / 4; e += THREADS) {
          float4 v = s4[e];
          if (p.accumulate) {
            const float4 x = o4[e];
            v.x += x.x; v.y += x.y; v.z += x.z; v.w += x.w;
          }
          o4[e] = v;
        }
        for (int e = (n & ~3) + tid; e < n; e += THREADS)
          o[e] = p.accumulate ? o[e] + slot_s[e] : slot_s[e];
      } else {
        for (int e = tid; e < nr * w; e += THREADS) {
          const int r = e / w;
          float* gp = o + static_cast<long long>(r) * nemb + (e - r * w);
          *gp = p.accumulate ? *gp + slot_s[e] : slot_s[e];
        }
      }
      // these generic reads of the slot come before the TMA's writes to it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (tid == 0) issue(step + STAGES, slot);
  }
}

// n tiles (8 columns each) of the output tile: nemb / 8 rounded up, at
// most 8
int cols_per_thread(int nemb) {
  const int cn = (nemb + 7) / 8;
  return cn < 8 ? cn : 8;
}

// floats of a ring slot: a step's TMA boxes, or the output tile that goes
// back through it
int slot_floats(int nemb) {
  const int tile = ROW_TILE * 8 * cols_per_thread(nemb);
  return tile > STAGE_FLOATS ? tile : STAGE_FLOATS;
}

// dynamic shared memory of one launch, in bytes
int smem_bytes(int nemb, int nkept) {
  const int nep = 8 * cols_per_thread(nemb);
  return SMEM_ALIGN +
         4 * (STAGES * slot_floats(nemb) + 2 * nep * ta_stride(nkept) +
              nkept) +
         8 * STAGES;
}

// rows of B handed to the TMA together: the least G with G*nao*4 a
// multiple of 16 bytes
int row_group(int nao) { return nao % 4 == 0 ? 1 : nao % 2 == 0 ? 2 : 4; }

// The attribute, the SM count and the occupancy are read once per kernel
// width and shared-memory size, not at every launch.
template <int CN>
int launch(const CUtensorMap& tmap, const Params& p, int smem,
           cudaStream_t stream) {
  auto kernel = screened_first_transform_kernel<CN>;
  static int smem_set = 0, smem_seen = -1, per_sm = 0, nsm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  if (nsm == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem != smem_seen) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_seen = smem;
  }
  constexpr int NEP = 8 * CN;
  const long long n_tiles = ((p.rows + ROW_TILE - 1) / ROW_TILE) *
                            ((p.nemb + NEP - 1) / NEP);
  const long long slots =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * nsm;
  const int grid = static_cast<int>(n_tiles < slots ? n_tiles : slots);
  kernel<<<grid, THREADS, smem, stream>>>(tmap, p);
  return static_cast<int>(cudaGetLastError());
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.
//   B          device f32 [rows, nao], contiguous, 16-byte aligned
//   TA         device f32 [nao, nemb], contiguous
//   blocks     HOST int32 [nkept], indices of the kept 16-AO nu blocks
//   out        device f32 [rows, nemb], contiguous, 16-byte aligned; every
//              element is written (accumulate = 0) or added to (1)
//   stream     the cudaStream_t to launch on
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int screened_first_transform_f32(const void* B, const void* TA,
                                            const void* blocks, int nkept,
                                            void* out, int rows, int nao,
                                            int nemb, int accumulate,
                                            void* stream) {
  const auto misaligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 != 0;
  };
  const int G = nao > 0 ? row_group(nao) : 1;
  if (rows < G || nao <= 0 || nemb <= 0 || nkept < 0 ||
      nkept > MAX_BLOCKS || (nkept > 0 && blocks == nullptr) ||
      misaligned(B) || misaligned(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(nemb, nkept);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.B = static_cast<const float*>(B);
  p.TA = static_cast<const float*>(TA);
  p.out = static_cast<float*>(out);
  p.rows = rows;
  p.nao = nao;
  p.nemb = nemb;
  p.nk = nkept;
  p.g = G;
  p.slot_floats = slot_floats(nemb);
  p.accumulate = accumulate;
  const int* src = static_cast<const int*>(blocks);
  const int nblk = (nao + NU_BLOCK - 1) / NU_BLOCK;
  for (int k = 0; k < nkept; ++k) {
    if (src[k] < 0 || src[k] >= nblk) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    p.blk[k] = src[k];
  }
  const auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(G) * nao,
                              static_cast<cuuint64_t>(rows / G)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(G) * nao * 4};
  const cuuint32_t box[2] = {BOX_W, static_cast<cuuint32_t>(ROW_TILE / G)};
  const cuuint32_t steps[2] = {1, 1};
  CUtensorMap tmap;  // B as [rows / G, G * nao]
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(B), dims, strides, box, steps,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (cols_per_thread(nemb)) {
    case 1: return launch<1>(tmap, p, smem, s);
    case 2: return launch<2>(tmap, p, smem, s);
    case 3: return launch<3>(tmap, p, smem, s);
    case 4: return launch<4>(tmap, p, smem, s);
    case 5: return launch<5>(tmap, p, smem, s);
    case 6: return launch<6>(tmap, p, smem, s);
    case 7: return launch<7>(tmap, p, smem, s);
    default: return launch<8>(tmap, p, smem, s);
  }
}
