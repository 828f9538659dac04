// K3 and K4: transposed bucketed block-ELL products from the FORWARD panel,
// y = A^T (scale * u) and Y = A^T (diag(scale) U) for U (m, R), for NVIDIA
// Hopper.
//
// Replace the Pallas TPU kernels hybrid_gmres_tpu/ops/spmv_pallas.py:
// _bucket_rmatvec (K3) and _bucket_rmatmat (K4) together with their wrappers
// bucketed_bsr_rmatvec / bucketed_bsr_rmatmat (u padding, the row sort
// through inv_perm, the per-bucket sum, the (ncb, R, bc) re-layout) and the
// int8 row pre-scale that PallasBSROperator.rmatvec / rmatmat apply outside
// the kernel.
//
// The TPU kernels lean on a sequential grid: one resident (ncb, bc) output
// tile that every grid step adds into.  Here thread blocks run in any order,
// so the scatter is turned into a gather at pack time
// (hybrid_gmres_tpu_torch/ops/sparse.py:_transposed_index): for each block
// column, the list of live blocks that carry it (col_blk: index into the flat
// panel, col_row: original block-row), cut into segments of at most seg_len
// blocks (seg_off), and the segments of each column (col_seg).
//
// Design.  Main kernel: one thread block per segment and per tile of RT = 8
// right-hand sides, BC threads; thread c owns output column c of the
// segment's block column.  The block first stages the segment's scaled
// inputs su[e][r][j] = scale[i] * u[i, j] (i = col_row[e] * BR + r, zero past
// m) in shared memory, then every thread walks the segment's blocks in list
// order and sums blk[r, c] * su[e][r][j] over rows with fmaf: the sum over
// rows is per thread, panel loads across c are coalesced, the su reads are
// shared-memory broadcasts, and there is no cross-lane reduction.  The
// segment's partial goes to a scratch array part[segment][j][c].  Finishing
// kernel: thread c of block (column, j) adds the column's partials in segment
// order and writes y[column * BC + c, j] once (zero for an empty column,
// nothing past n).
//
// Every order is fixed by the index: no floating-point atomics, the result
// is the same bit for bit from run to run, and column j of K4 is K3 applied
// to column j exactly (same operands, same order; K3 is the R = 1 kernel
// with the same staging and the same finishing pass).
//
// What bounds it: panel bytes, as K1 (2 flops per int8 byte at R = 1, 16 at
// R = 8, where the float32 pipe's time is 0.8 of the byte time).  Each panel
// byte is read once per tile of right-hand sides; the index adds 8 bytes per
// 1-4 KB block; the partials cost one extra write and read of
// segments x R x BC floats (512 KB at CT n=64, R = 1).  This first version is
// simple: byte-wide panel loads, one conversion per value.  Not done yet:
// 16-byte panel loads, cp.async/TMA staging, tensor-core products, folding
// the finishing pass into the main kernel (last block to arrive).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int RT = 8;  // right-hand sides per tile (K4)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// NR = 1: K3.  NR = RT: K4, grid.y walks the tiles of right-hand sides.
template <typename T, int BR, int NR>
__global__ void bucket_rmat_kernel(const T* __restrict__ blocks,
                                   const int* __restrict__ col_blk,
                                   const int* __restrict__ col_row,
                                   const int* __restrict__ seg_off,
                                   const float* __restrict__ u,
                                   const float* __restrict__ scale,
                                   float* __restrict__ part, int m, int R,
                                   int64_t ldu_m, int64_t ldu_r) {
  const int s = blockIdx.x;
  const int bc = blockDim.x;
  const int c = threadIdx.x;
  const int r0 = blockIdx.y * NR;
  const int rc = min(NR, R - r0);  // live columns of this tile
  const int e0 = seg_off[s];
  const int ne = seg_off[s + 1] - e0;

  // su[(e * BR + r) * NR + j]
  extern __shared__ float su[];
  const int rows = ne * BR;
  if (ldu_r == 1 || NR == 1) {
    // row-major U: the NR values of one row are neighbours in memory
    for (int idx = c; idx < rows * NR; idx += bc) {
      const int er = idx / NR;
      const int j = idx % NR;
      const int64_t i =
          static_cast<int64_t>(col_row[e0 + er / BR]) * BR + er % BR;
      float v = 0.0f;
      if (i < m && j < rc) {
        v = u[i * ldu_m + (r0 + j) * ldu_r];
        if (scale != nullptr) v *= scale[i];
      }
      su[idx] = v;
    }
  } else {
    // column-major U (the batched solver's layout): rows are neighbours
    for (int idx = c; idx < rows * NR; idx += bc) {
      const int j = idx / rows;
      const int er = idx % rows;
      const int64_t i =
          static_cast<int64_t>(col_row[e0 + er / BR]) * BR + er % BR;
      float v = 0.0f;
      if (i < m && j < rc) {
        v = u[i * ldu_m + (r0 + j) * ldu_r];
        if (scale != nullptr) v *= scale[i];
      }
      su[er * NR + j] = v;
    }
  }
  __syncthreads();

  float acc[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) acc[j] = 0.0f;

  for (int e = 0; e < ne; ++e) {
    const T* blk =
        blocks + static_cast<int64_t>(col_blk[e0 + e]) * BR * bc + c;
    const float* sv = su + e * BR * NR;
    float a[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) a[r] = to_f32(blk[r * bc]);
#pragma unroll
    for (int r = 0; r < BR; ++r) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        acc[j] = fmaf(a[r], sv[r * NR + j], acc[j]);
      }
    }
  }

  // part[(s * R + column) * bc + c]
  float* dst = part + (static_cast<int64_t>(s) * R + r0) * bc + c;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    if (j < rc) dst[static_cast<int64_t>(j) * bc] = acc[j];
  }
}

// grid (ncb, R), BC threads: the fixed-order sum of a column's partials.
__global__ void bucket_rmat_finish_kernel(const int* __restrict__ col_seg,
                                          const float* __restrict__ part,
                                          float* __restrict__ y, int n, int R,
                                          int64_t ldy_n, int64_t ldy_r) {
  const int col = blockIdx.x;
  const int j = blockIdx.y;
  const int bc = blockDim.x;
  const int c = threadIdx.x;
  const int64_t i = static_cast<int64_t>(col) * bc + c;
  if (i >= n) return;
  const int s1 = col_seg[col + 1];
  float sum = 0.0f;
  for (int s = col_seg[col]; s < s1; ++s) {
    sum += part[(static_cast<int64_t>(s) * R + j) * bc + c];
  }
  y[i * ldy_n + j * ldy_r] = sum;
}

struct Args {
  int bc;
  const void* blocks;
  const int* col_blk;
  const int* col_row;
  const int* seg_off;
  const int* col_seg;
  const float* u;
  const float* scale;
  float* part;
  float* y;
  int n_seg, seg_len, ncb, m, n, R;
  int64_t ldu_m, ldu_r, ldy_n, ldy_r;
  cudaStream_t stream;
};

template <typename T, int BR, int NR>
cudaError_t launch(const Args& a) {
  if (a.n_seg > 0) {
    const dim3 grid(a.n_seg, (a.R + NR - 1) / NR);
    const size_t smem = static_cast<size_t>(a.seg_len) * BR * NR * sizeof(float);
    bucket_rmat_kernel<T, BR, NR><<<grid, a.bc, smem, a.stream>>>(
        static_cast<const T*>(a.blocks), a.col_blk, a.col_row, a.seg_off, a.u,
        a.scale, a.part, a.m, a.R, a.ldu_m, a.ldu_r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 fgrid(a.ncb, a.R);
  bucket_rmat_finish_kernel<<<fgrid, a.bc, 0, a.stream>>>(
      a.col_seg, a.part, a.y, a.n, a.R, a.ldy_n, a.ldy_r);
  return cudaGetLastError();
}

template <typename T, int NR>
cudaError_t launch_rows(int br, const Args& a) {
  switch (br) {
    case 8:
      return launch<T, 8, NR>(a);
    case 16:
      return launch<T, 16, NR>(a);
    case 32:
      return launch<T, 32, NR>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int NR>
cudaError_t launch_typed(int dtype, int br, const Args& a) {
  // the staging buffer must fit the default 48 KB of shared memory
  if (a.bc % 32 != 0 || a.bc < 32 || a.bc > 1024 || a.R <= 0 ||
      a.R > 65535 || a.ncb <= 0 || a.seg_len <= 0 ||
      static_cast<size_t>(a.seg_len) * br * NR * sizeof(float) > 48 * 1024) {
    return cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return launch_rows<float, NR>(br, a);
    case 1:
      return launch_rows<__nv_bfloat16, NR>(br, a);
    case 2:
      return launch_rows<int8_t, NR>(br, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, loaded with ctypes.  dtype: 0 float32, 1 bfloat16, 2 int8.
// part is scratch of n_seg * R * bc floats; scale may be null.  Strides count
// float32 elements.  Each returns the cudaError_t of its launches (0 on
// success).
extern "C" int bucket_rmatvec(int dtype, int br, int bc, const void* blocks,
                              const void* col_blk, const void* col_row,
                              const void* seg_off, const void* col_seg,
                              const void* u, const void* scale, void* part,
                              void* y, int n_seg, int seg_len, int ncb, int m,
                              int n, void* stream) {
  const Args a{bc,
               blocks,
               static_cast<const int*>(col_blk),
               static_cast<const int*>(col_row),
               static_cast<const int*>(seg_off),
               static_cast<const int*>(col_seg),
               static_cast<const float*>(u),
               static_cast<const float*>(scale),
               static_cast<float*>(part),
               static_cast<float*>(y),
               n_seg,
               seg_len,
               ncb,
               m,
               n,
               1,
               1,
               1,
               1,
               1,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_typed<1>(dtype, br, a));
}

extern "C" int bucket_rmatmat(int dtype, int br, int bc, const void* blocks,
                              const void* col_blk, const void* col_row,
                              const void* seg_off, const void* col_seg,
                              const void* u, const void* scale, void* part,
                              void* y, int n_seg, int seg_len, int ncb, int m,
                              int n, int R, int64_t ldu_m, int64_t ldu_r,
                              int64_t ldy_n, int64_t ldy_r, void* stream) {
  const Args a{bc,
               blocks,
               static_cast<const int*>(col_blk),
               static_cast<const int*>(col_row),
               static_cast<const int*>(seg_off),
               static_cast<const int*>(col_seg),
               static_cast<const float*>(u),
               static_cast<const float*>(scale),
               static_cast<float*>(part),
               static_cast<float*>(y),
               n_seg,
               seg_len,
               ncb,
               m,
               n,
               R,
               ldu_m,
               ldu_r,
               ldy_n,
               ldy_r,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_typed<RT>(dtype, br, a));
}
