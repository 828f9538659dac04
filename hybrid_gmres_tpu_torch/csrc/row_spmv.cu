// K1 and K3 redesigned for NVIDIA Hopper: the single-RHS products on the
// row-packed form, y = diag(out_scale) * Q * (in_scale o x).
//
// Replaces, on every single-RHS operator application of the port, the Pallas
// TPU kernels hybrid_gmres_tpu/ops/spmv_pallas.py:_bucket_matvec (K1, with
// its wrapper bucketed_bsr_matvec and the int8 row scale applied after it)
// and _bucket_rmatvec (K3, with bucketed_bsr_rmatvec and the pre-scale of u).
// One template, two modes:
//   K1: y = diag(s) Q x on the form of the forward panel (out_scale = s);
//   K3: y = Q^T (s o u) on the form of the transpose (in_scale = s, gathered
//       beside u as the kernel reads it): one launch per application, no
//       pre-scale pass, no partials, no finishing pass.
//
// Format (hybrid_gmres_tpu_torch/ops/sparse.py:RowPacked): rows padded to
// vectors of V = 8 entries; values in the panel's storage type (f32, bf16,
// int8), columns as uint16 when the matrix has at most 65536 of them, int32
// otherwise; vec_off[r] the first vector of packed row r, row_map[r] its
// original row.  Inside a row, vectors are interleaved at pack time so that
// the lanes of one step gather neighbouring entries (in the order of the
// source panel's blocks) together.
//
// What bounds it: bytes.  Each stored entry is read once and used for one
// FMA (2 flops per 3-5 bytes at int8), so the floor is (values + indices +
// offsets + x + scales + y) / HBM bandwidth.  The block-ELL panel read about
// 9-15 bytes per nonzero, the library's float32 CSR reads 8; this form reads
// 3 (int8 + uint16) to 5 (int8 + int32).  The design:
//   * a group of `lanes` threads per row (a power of two, chosen per form at
//     pack time: 4 for the 45-entry rows of B^T at CT n=64, 128 for the
//     1600-entry rows of A^T at n=128), so short and long rows both keep
//     every lane busy;
//   * persistent blocks of 1024 threads, each walking a contiguous run of
//     rows: one multiprocessor works on neighbouring rows, whose gathers
//     share cache lines (B's 518 KB x at n=128 lives in L2, not L1);
//   * wide loads: 8 int8 values in one 8-byte load, 8 uint16 indices in one
//     16-byte load (two for int32), coalesced across the lanes of a row, two
//     vectors in flight per lane;
//   * int8 -> float by __byte_perm into a float's mantissa and one FADD
//     (exact), not I2F, which runs at a fraction of the FMA rate;
//   * the gathered vector through the read-only cache (__ldg), or staged in
//     shared memory (XS, when it fits: A's x at CT n=128 is 64 KB), with
//     the gathered scale multiplied in once while staging.
//
// Every sum is in a fixed order: each lane adds its vectors in ascending
// order (one fmaf per entry, slots in order), the lanes of a warp combine
// through a fixed xor-shuffle tree, the warps of a row in warp order.  No
// atomics: the same input gives the same bits, and XS and __ldg give the
// same bits too (the same products in the same order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int V = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 1024;
constexpr int MAX_LANES = 256;
constexpr size_t MAX_SMEM = 200 * 1024;  // of the 227 KB a block may have

template <typename T>
struct Vals;

template <>
struct Vals<int8_t> {
  // int8 v -> float exactly: the byte v ^ 0x80 = v + 128 placed in the
  // mantissa of 2^23, minus 2^23 + 128.
  __device__ __forceinline__ static void load(const int8_t* p, float f[V]) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    const unsigned a = w.x ^ 0x80808080u;
    const unsigned b = w.y ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[k] = __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7440u + k)) -
             8388736.0f;
      f[4 + k] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440u + k)) -
                 8388736.0f;
    }
  }
};

template <>
struct Vals<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float f[V]) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
};

template <>
struct Vals<float> {
  __device__ __forceinline__ static void load(const float* p, float f[V]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

template <typename I>
struct Cols;

template <>
struct Cols<uint16_t> {
  __device__ __forceinline__ static void load(const uint16_t* p, int c[V]) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[2 * k] = static_cast<int>(u[k] & 0xffffu);
      c[2 * k + 1] = static_cast<int>(u[k] >> 16);
    }
  }
};

template <>
struct Cols<int> {
  __device__ __forceinline__ static void load(const int* p, int c[V]) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  }
};

// One entry of the gathered vector: x[c] * in_scale[c] (K3) or x[c] (K1).
template <bool IN, bool XS>
__device__ __forceinline__ float fetch(const float* __restrict__ xs,
                                       const float* __restrict__ x,
                                       const float* __restrict__ in_scale,
                                       int c) {
  if (XS) return xs[c];
  if (IN) return __ldg(x + c) * __ldg(in_scale + c);
  return __ldg(x + c);
}

template <typename T, typename I, bool IN, bool XS>
__device__ __forceinline__ float vector_dot(const T* __restrict__ vals,
                                            const I* __restrict__ cols,
                                            const float* __restrict__ xs,
                                            const float* __restrict__ x,
                                            const float* __restrict__ in_scale,
                                            int64_t k, float acc) {
  float a[V], xv[V];
  int c[V];
  Vals<T>::load(vals + k * V, a);
  Cols<I>::load(cols + k * V, c);
#pragma unroll
  for (int j = 0; j < V; ++j) xv[j] = fetch<IN, XS>(xs, x, in_scale, c[j]);
#pragma unroll
  for (int j = 0; j < V; ++j) acc = fmaf(a[j], xv[j], acc);
  return acc;
}

template <typename T, typename I, bool IN, bool XS>
__global__ void __launch_bounds__(BLOCK)
    row_spmv_kernel(const T* __restrict__ vals, const I* __restrict__ cols,
                    const int* __restrict__ vec_off,
                    const int* __restrict__ row_map,
                    const float* __restrict__ x,
                    const float* __restrict__ in_scale,
                    const float* __restrict__ out_scale,
                    float* __restrict__ y, int rows, int ncols, int lanes,
                    int row_blocks) {
  extern __shared__ float xs[];
  __shared__ float part[BLOCK / 32];
  const int tid = threadIdx.x;
  if (XS) {
    for (int i = tid; i < ncols; i += BLOCK) {
      xs[i] = IN ? x[i] * in_scale[i] : x[i];
    }
    __syncthreads();
  }
  const int rows_per_block = BLOCK / lanes;
  const int g = tid / lanes;
  const int l = tid % lanes;
  const int warp_lanes = lanes < 32 ? lanes : 32;
  // each block walks a contiguous run of row blocks, so one multiprocessor
  // sees neighbouring rows, whose gathers share cache lines
  const int grid = static_cast<int>(gridDim.x);
  const int bx = static_cast<int>(blockIdx.x);
  const int chunk = (row_blocks + grid - 1) / grid;
  const int rb_end = min(row_blocks, (bx + 1) * chunk);
  for (int rb = bx * chunk; rb < rb_end; ++rb) {
    const int r = rb * rows_per_block + g;
    float acc = 0.0f;
    if (r < rows) {
      const int end = vec_off[r + 1];
      int k = vec_off[r] + l;
      // two vectors in flight per lane; the sum stays in vector order
      for (; k + lanes < end; k += 2 * lanes) {
        float a[V], b[V], xa[V], xb[V];
        int ca[V], cb[V];
        Vals<T>::load(vals + static_cast<int64_t>(k) * V, a);
        Cols<I>::load(cols + static_cast<int64_t>(k) * V, ca);
        Vals<T>::load(vals + static_cast<int64_t>(k + lanes) * V, b);
        Cols<I>::load(cols + static_cast<int64_t>(k + lanes) * V, cb);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xa[j] = fetch<IN, XS>(xs, x, in_scale, ca[j]);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xb[j] = fetch<IN, XS>(xs, x, in_scale, cb[j]);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) acc = fmaf(a[j], xa[j], acc);
#pragma unroll
        for (int j = 0; j < V; ++j) acc = fmaf(b[j], xb[j], acc);
      }
      if (k < end) {
        acc = vector_dot<T, I, IN, XS>(vals, cols, xs, x, in_scale, k, acc);
      }
    }
    // the lanes of a row inside a warp: a fixed xor tree (every lane ends
    // with the same bits)
    for (int o = warp_lanes >> 1; o > 0; o >>= 1) {
      acc += __shfl_xor_sync(FULL, acc, o);
    }
    if (lanes > 32) {  // a row over several warps: their sums in warp order
      if ((tid & 31) == 0) part[tid >> 5] = acc;
      __syncthreads();
      if (l == 0) {
        for (int w = 1; w < lanes / 32; ++w) acc += part[(tid >> 5) + w];
      }
      __syncthreads();
    }
    if (l == 0 && r < rows) {
      const int i = row_map[r];
      y[i] = out_scale != nullptr ? out_scale[i] * acc : acc;
    }
  }
}

struct Args {
  const void* vals;
  const void* cols;
  const int* vec_off;
  const int* row_map;
  const float* x;
  const float* in_scale;
  const float* out_scale;
  float* y;
  int rows, ncols, lanes;
  cudaStream_t stream;
};

template <typename T, typename I, bool IN, bool XS>
cudaError_t launch(const Args& a) {
  if (a.lanes < 1 || a.lanes > MAX_LANES || (a.lanes & (a.lanes - 1))) {
    return cudaErrorInvalidValue;
  }
  const int rows_per_block = BLOCK / a.lanes;
  const int row_blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  auto kernel = row_spmv_kernel<T, I, IN, XS>;
  const size_t smem = XS ? static_cast<size_t>(a.ncols) * sizeof(float) : 0;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  // persistent blocks, as many as fit on the card at once; the occupancy
  // query is made once per shared-memory size
  static size_t cached_smem = ~size_t{0};
  static int cached_blocks = 0;
  if (smem != cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        BLOCK, smem);
    if (err != cudaSuccess) return err;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
    cached_smem = smem;
  }
  const int grid = row_blocks < cached_blocks ? row_blocks : cached_blocks;
  kernel<<<grid, BLOCK, smem, a.stream>>>(
      static_cast<const T*>(a.vals), static_cast<const I*>(a.cols), a.vec_off,
      a.row_map, a.x, a.in_scale, a.out_scale, a.y, a.rows, a.ncols, a.lanes,
      row_blocks);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_modes(bool xs, const Args& a) {
  const bool in = a.in_scale != nullptr;
  if (xs) {
    return in ? launch<T, I, true, true>(a) : launch<T, I, false, true>(a);
  }
  return in ? launch<T, I, true, false>(a) : launch<T, I, false, false>(a);
}

template <typename T>
cudaError_t launch_index(int wide, bool xs, const Args& a) {
  return wide ? launch_modes<T, int>(xs, a) : launch_modes<T, uint16_t>(xs, a);
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16, 2 int8;
// wide: 1 for int32 column indices, 0 for uint16; xs: 1 to stage the
// gathered vector in shared memory.  in_scale (ncols,) and out_scale (rows,)
// may be null.  Returns the cudaError_t of the launch (0 on success).
extern "C" int row_spmv(int dtype, int wide, int xs, const void* vals,
                        const void* cols, const void* vec_off,
                        const void* row_map, const void* x,
                        const void* in_scale, const void* out_scale, void* y,
                        int rows, int ncols, int lanes, void* stream) {
  if (rows <= 0 || ncols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{vals,
               cols,
               static_cast<const int*>(vec_off),
               static_cast<const int*>(row_map),
               static_cast<const float*>(x),
               static_cast<const float*>(in_scale),
               static_cast<const float*>(out_scale),
               static_cast<float*>(y),
               rows,
               ncols,
               lanes,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_index<float>(wide, xs != 0, a);
      break;
    case 1:
      err = launch_index<__nv_bfloat16>(wide, xs != 0, a);
      break;
    case 2:
      err = launch_index<int8_t>(wide, xs != 0, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
