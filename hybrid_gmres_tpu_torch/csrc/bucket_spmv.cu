// K1: bucketed block-ELL SpMV, y = diag(scale) * A * x, for NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel hybrid_gmres_tpu/ops/spmv_pallas.py:
// _bucket_matvec together with its wrapper bucketed_bsr_matvec (x padding,
// bucket concatenation, inv_perm un-sort) and the int8 row scale that
// PallasBSROperator.matvec applies outside the kernel.  Here all of it is
// ONE launch per operator application.
//
// Layout (hybrid_gmres_tpu_torch/ops/sparse.py): every bucket's dense
// (BR x BC) blocks concatenated into one array; for each sorted block-row
// position p, pos_off[p] is the index of its first block, pos_cnt[p] its true
// block count and pos_row[p] the original block-row (-1 for bucket padding).
//
// Design: one thread block per position, BC threads (128 for the CT panels).
// For each of the row's blocks, thread t loads x[bcol * BC + t] once (masked
// past n, so x is read unpadded) and FMAs it into BR float32 accumulators
// held in registers against column t of the block.  Warp shuffles plus a
// small shared-memory pass reduce each accumulator across the BC threads;
// the epilogue multiplies by the row scale and writes the rows of the
// ORIGINAL block-row (rows >= m are dropped), which un-sorts in place.
//
// What bounds it: panel bytes.  Each block is read once from device memory
// and used for 2 * BR * BC flops, i.e. 2 flops per int8 byte, 0.5 per f32
// byte -- far below the card's flop/byte balance, so the time floor is
// (panel bytes + x + y) / HBM bandwidth.  This first version keeps every
// panel byte read exactly once with coalesced BC-wide row loads, skips the
// buckets' trailing zero padding through pos_cnt, and keeps x (16 KB at CT
// n=64) in L1/L2 through ordinary cached loads.  Not done yet: 16-byte
// vectorised int8 loads, cp.async/TMA staging of the blocks, x in shared
// memory, and more than one position per block for short rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T, int BR>
__global__ void bucket_matvec_kernel(const T* __restrict__ blocks,
                                     const int* __restrict__ bcols,
                                     const int64_t* __restrict__ pos_off,
                                     const int* __restrict__ pos_cnt,
                                     const int* __restrict__ pos_row,
                                     const float* __restrict__ x,
                                     const float* __restrict__ scale,
                                     float* __restrict__ y, int m, int n) {
  const int p = blockIdx.x;
  const int row = pos_row[p];
  if (row < 0) return;  // bucket padding: the whole block leaves together

  const int bc = blockDim.x;
  const int t = threadIdx.x;
  const int64_t off = pos_off[p];
  const int cnt = pos_cnt[p];

  float acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0f;

  for (int j = 0; j < cnt; ++j) {
    const int64_t col = static_cast<int64_t>(bcols[off + j]) * bc + t;
    const float xv = col < n ? x[col] : 0.0f;
    const T* blk = blocks + (off + j) * static_cast<int64_t>(BR) * bc + t;
#pragma unroll
    for (int r = 0; r < BR; ++r) acc[r] = fmaf(to_f32(blk[r * bc]), xv, acc[r]);
  }

  // Reduce each of the BR accumulators over the block's bc threads.
  __shared__ float part[32][BR];  // [warp][row]
  const int lane = t & 31;
  const int warp = t >> 5;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    float v = acc[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) part[warp][r] = v;
  }
  __syncthreads();
  if (t < BR) {
    float s = 0.0f;
    const int nwarps = bc >> 5;
    for (int w = 0; w < nwarps; ++w) s += part[w][t];
    const int i = row * BR + t;
    if (i < m) y[i] = scale != nullptr ? scale[i] * s : s;
  }
}

template <typename T>
cudaError_t launch_typed(int br, int bc, const void* blocks, const int* bcols,
                         const int64_t* pos_off, const int* pos_cnt,
                         const int* pos_row, const float* x,
                         const float* scale, float* y, int n_pos, int m, int n,
                         cudaStream_t stream) {
  const T* b = static_cast<const T*>(blocks);
  switch (br) {
    case 8:
      bucket_matvec_kernel<T, 8><<<n_pos, bc, 0, stream>>>(
          b, bcols, pos_off, pos_cnt, pos_row, x, scale, y, m, n);
      break;
    case 16:
      bucket_matvec_kernel<T, 16><<<n_pos, bc, 0, stream>>>(
          b, bcols, pos_off, pos_cnt, pos_row, x, scale, y, m, n);
      break;
    case 32:
      bucket_matvec_kernel<T, 32><<<n_pos, bc, 0, stream>>>(
          b, bcols, pos_off, pos_cnt, pos_row, x, scale, y, m, n);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16, 2 int8.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bucket_matvec(int dtype, int br, int bc, const void* blocks,
                             const void* bcols, const void* pos_off,
                             const void* pos_cnt, const void* pos_row,
                             const void* x, const void* scale, void* y,
                             int n_pos, int m, int n, void* stream) {
  if (bc % 32 != 0 || bc < 32 || bc > 1024 || n_pos <= 0) {
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
                                n_pos, m, n, s);
      break;
    case 1:
      err = launch_typed<__nv_bfloat16>(br, bc, blocks, bc_, off, cnt, row, xf,
                                        sc, yf, n_pos, m, n, s);
      break;
    case 2:
      err = launch_typed<int8_t>(br, bc, blocks, bc_, off, cnt, row, xf, sc,
                                 yf, n_pos, m, n, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
