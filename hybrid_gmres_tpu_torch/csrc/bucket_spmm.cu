// K2: bucketed block-ELL SpMM, Y = diag(scale) * A * X for X (n, R), for
// NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel hybrid_gmres_tpu/ops/spmv_pallas.py:
// _bucket_matmat together with its wrapper bucketed_bsr_matmat (X padding and
// the (ncb, R, bc) re-layout, bucket concatenation, inv_perm un-sort) and the
// int8 row scale that PallasBSROperator.matmat applies outside the kernel.
// Here all of it is ONE launch per operator application, and every panel
// byte is read from device memory once for all the columns of a tile.
//
// Layout: the flat panel arrays of K1 (bucket_spmv.cu; built in
// hybrid_gmres_tpu_torch/ops/sparse.py).  X and Y are float32 with explicit
// element strides (ldx_n, ldx_r) and (ldy_m, ldy_r), so the caller hands
// over row-major (n, R) tensors or transposed views of (R, n) ones (what the
// batched solver keeps) without a copy.
//
// Design.  One thread block per sorted block-row position and per tile of
// RT = 8 right-hand sides (grid.y walks the tiles: R <= 8 is one tile and
// reads the panel once; past 8 each further tile reads the panel again, so
// the batched solver splits its right-hand sides into groups of at most 8).
// A ragged last tile computes on zeros and masks its loads and stores.
//
//   * Registers.  K1 keeps BR accumulators per thread.  BR x 8 would be 256
//     for A's (32, 128) blocks, which does not fit.  So the block's rows are
//     split into groups of 8 over threadIdx.y: blockDim = (BC, min(BR / 8,
//     512 / BC)), each thread holds 8 rows x 8 columns = 64 float32
//     accumulators for block column t = threadIdx.x, and a thread block with
//     fewer y-threads than row groups loops over them.  For each of the
//     row's blocks a thread loads its 8 X values for column bcol * BC + t
//     once (two float4 loads when X is row-major and aligned, masked past n)
//     and 8 panel values, one per row, converts each once and uses it for 8
//     fused multiply-adds.
//   * Reduction.  64 sums over the BC threads per row group.  A butterfly
//     that halves the values each lane keeps at every step (32 + 16 + 8 + 4
//     + 2 = 62 shuffles instead of 64 x 5) leaves lane l with the two warp
//     sums of row l / 4 and columns 2 * (l % 4) + {0, 1}; a small
//     shared-memory pass adds the warps in order.  At every step a lane adds
//     its own partial and its partner's, exactly the operands K1's
//     __shfl_xor reduction adds (IEEE addition commutes), and the block loop
//     uses the same fmaf in the same order: column j of K2 equals K1 applied
//     to column j bit for bit.
//   * Epilogue as K1's: rows of the ORIGINAL block-row (un-sort in place),
//     the row scale, rows >= m dropped, Y written with the caller's strides.
//
// What bounds it.  At R = 8 an int8 byte carries 16 flops: the float32
// pipe's time for a CT panel (2 * R * entries / 67 TFLOP/s) is about 0.8 of
// the time to read the panel from device memory, so bytes and operations
// are near balance and neither is hidden by the other yet.  This first
// version is simple: byte-wide panel loads (one 32-byte sector per warp
// instruction), one int-to-float conversion per panel value, at most 16
// warps per SM.  Not done yet: 16-byte panel loads, cp.async/TMA staging,
// int8 tensor-core products (mma/wgmma on the integer values with the
// float32 row scale kept outside), more than one position per thread block
// for short rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RT = 8;        // right-hand sides per tile
constexpr int ROWS = 8;      // block rows per thread (one row group)
constexpr int NV = ROWS * RT;
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// One step of the warp butterfly: a lane keeps one half of its 2 * HALF live
// values, sends the other half to the lane O away and adds what it gets.
// Static indices only, so the values stay in registers.
template <int HALF, int O>
__device__ __forceinline__ void butterfly_step(float (&v)[NV], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename T, int BR>
__global__ void __launch_bounds__(MAX_THREADS)
bucket_matmat_kernel(const T* __restrict__ blocks,
                     const int* __restrict__ bcols,
                     const int64_t* __restrict__ pos_off,
                     const int* __restrict__ pos_cnt,
                     const int* __restrict__ pos_row,
                     const float* __restrict__ x,
                     const float* __restrict__ scale, float* __restrict__ y,
                     int m, int n, int R, int64_t ldx_n, int64_t ldx_r,
                     int64_t ldy_m, int64_t ldy_r, int vec) {
  constexpr int NG = BR / ROWS;  // row groups of the block
  const int p = blockIdx.x;
  const int row = pos_row[p];
  if (row < 0) return;  // bucket padding: the whole block leaves together

  const int bc = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = bc >> 5;
  const int r0 = blockIdx.y * RT;
  const int rc = min(RT, R - r0);  // live columns of this tile
  const int64_t off = pos_off[p];
  const int cnt = pos_cnt[p];

  // [row group][warp][value]: the warp sums, two per lane
  extern __shared__ float part[];

  for (int g = threadIdx.y; g < NG; g += blockDim.y) {
    float acc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = 0.0f;

    for (int j = 0; j < cnt; ++j) {
      const int64_t col = static_cast<int64_t>(bcols[off + j]) * bc + t;
      float xv[RT];
      if (col < n) {
        const float* xp = x + col * ldx_n + r0 * ldx_r;
        if (vec && rc == RT) {
          const float4 lo = *reinterpret_cast<const float4*>(xp);
          const float4 hi = *reinterpret_cast<const float4*>(xp + 4);
          xv[0] = lo.x; xv[1] = lo.y; xv[2] = lo.z; xv[3] = lo.w;
          xv[4] = hi.x; xv[5] = hi.y; xv[6] = hi.z; xv[7] = hi.w;
        } else {
#pragma unroll
          for (int r = 0; r < RT; ++r) xv[r] = r < rc ? xp[r * ldx_r] : 0.0f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RT; ++r) xv[r] = 0.0f;
      }
      const T* blk = blocks + ((off + j) * BR + g * ROWS) * bc + t;
      float a[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) a[rr] = to_f32(blk[rr * bc]);
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          acc[rr * RT + r] = fmaf(a[rr], xv[r], acc[rr * RT + r]);
        }
      }
    }

    butterfly_step<32, 16>(acc, lane);
    butterfly_step<16, 8>(acc, lane);
    butterfly_step<8, 4>(acc, lane);
    butterfly_step<4, 2>(acc, lane);
    butterfly_step<2, 1>(acc, lane);
    float* dst = part + (g * nwarps + warp) * NV + 2 * lane;
    dst[0] = acc[0];
    dst[1] = acc[1];
  }
  __syncthreads();

  const int tid = threadIdx.y * bc + t;
  const int nthreads = bc * blockDim.y;
  for (int idx = tid; idx < BR * RT; idx += nthreads) {
    const int rl = idx / RT;  // row inside the block
    const int r = idx % RT;
    const float* src = part + (rl / ROWS) * nwarps * NV + (rl % ROWS) * RT + r;
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += src[w * NV];
    const int i = row * BR + rl;
    if (i < m && r < rc) {
      y[i * ldy_m + (r0 + r) * ldy_r] = scale != nullptr ? scale[i] * s : s;
    }
  }
}

template <typename T, int BR>
cudaError_t launch(int bc, const void* blocks, const int* bcols,
                   const int64_t* pos_off, const int* pos_cnt,
                   const int* pos_row, const float* x, const float* scale,
                   float* y, int n_pos, int m, int n, int R, int64_t ldx_n,
                   int64_t ldx_r, int64_t ldy_m, int64_t ldy_r, int vec,
                   cudaStream_t stream) {
  constexpr int NG = BR / ROWS;
  const int ny = NG < MAX_THREADS / bc ? NG : MAX_THREADS / bc;
  const dim3 block(bc, ny);
  const dim3 grid(n_pos, (R + RT - 1) / RT);
  const size_t smem = static_cast<size_t>(NG) * (bc / 32) * NV * sizeof(float);
  bucket_matmat_kernel<T, BR><<<grid, block, smem, stream>>>(
      static_cast<const T*>(blocks), bcols, pos_off, pos_cnt, pos_row, x,
      scale, y, m, n, R, ldx_n, ldx_r, ldy_m, ldy_r, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int br, int bc, const void* blocks, const int* bcols,
                         const int64_t* pos_off, const int* pos_cnt,
                         const int* pos_row, const float* x,
                         const float* scale, float* y, int n_pos, int m, int n,
                         int R, int64_t ldx_n, int64_t ldx_r, int64_t ldy_m,
                         int64_t ldy_r, int vec, cudaStream_t stream) {
  switch (br) {
    case 8:
      return launch<T, 8>(bc, blocks, bcols, pos_off, pos_cnt, pos_row, x,
                          scale, y, n_pos, m, n, R, ldx_n, ldx_r, ldy_m, ldy_r,
                          vec, stream);
    case 16:
      return launch<T, 16>(bc, blocks, bcols, pos_off, pos_cnt, pos_row, x,
                           scale, y, n_pos, m, n, R, ldx_n, ldx_r, ldy_m,
                           ldy_r, vec, stream);
    case 32:
      return launch<T, 32>(bc, blocks, bcols, pos_off, pos_cnt, pos_row, x,
                           scale, y, n_pos, m, n, R, ldx_n, ldx_r, ldy_m,
                           ldy_r, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16, 2 int8.
// Strides count float32 elements.  vec != 0 promises that X is row-major
// over its columns (ldx_r == 1), that ldx_n is a multiple of 4 and that x is
// 16-byte aligned, so a full tile's 8 values load as two float4.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bucket_matmat(int dtype, int br, int bc, const void* blocks,
                             const void* bcols, const void* pos_off,
                             const void* pos_cnt, const void* pos_row,
                             const void* x, const void* scale, void* y,
                             int n_pos, int m, int n, int R, int64_t ldx_n,
                             int64_t ldx_r, int64_t ldy_m, int64_t ldy_r,
                             int vec, void* stream) {
  if (bc % 32 != 0 || bc < 32 || bc > MAX_THREADS || n_pos <= 0 || R <= 0 ||
      (R + RT - 1) / RT > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* bc_ = static_cast<const int*>(bcols);
  const int64_t* off = static_cast<const int64_t*>(pos_off);
  const int* cnt = static_cast<const int*>(pos_cnt);
  const int* row = static_cast<const int*>(pos_row);
  const float* xf = static_cast<const float*>(x);
  const float* sc = static_cast<const float*>(scale);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_typed<float>(br, bc, blocks, bc_, off, cnt, row, xf, sc, yf,
                                n_pos, m, n, R, ldx_n, ldx_r, ldy_m, ldy_r,
                                vec, s);
      break;
    case 1:
      err = launch_typed<__nv_bfloat16>(br, bc, blocks, bc_, off, cnt, row, xf,
                                        sc, yf, n_pos, m, n, R, ldx_n, ldx_r,
                                        ldy_m, ldy_r, vec, s);
      break;
    case 2:
      err = launch_typed<int8_t>(br, bc, blocks, bc_, off, cnt, row, xf, sc,
                                 yf, n_pos, m, n, R, ldx_n, ldx_r, ldy_m,
                                 ldy_r, vec, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
